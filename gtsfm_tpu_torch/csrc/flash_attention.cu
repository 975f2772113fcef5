// Masked flash attention in float32 for Hopper (sm_90a).
//
// Replaces: gtsfm_tpu/ops/pallas_kernels/attention.py::flash_attention (the
// Pallas TPU kernel _flash_kernel), the one TPU kernel of the JAX package.
// It is called by LightGlue self- and cross-attention (4 launches per layer)
// and computes, for each (batch*head) slice,
//
//     out = softmax(q k^T / sqrt(Dh), masked keys -> -1e9) v
//
// with an online softmax over kv tiles, so the Kq x Kkv score matrix never
// reaches device memory. Semantics match reference_attention exactly:
//   * a real key with kv_mask == 0 scores -1e9 (not -inf), so a fully masked
//     row returns the mean of v over the real keys;
//   * Kq != Kkv is allowed and both may be ragged (not multiples of the
//     tile): key slots past Kkv get weight exactly 0, query rows past Kq are
//     computed on zeros and never stored;
//   * the output is acc / max(l, 1e-20), as the Pallas kernel divides.
//
// What bounds it on this card. The arithmetic is float32 throughout (the JAX
// package runs attention at "highest" precision, so TF32 tensor cores are
// not an option here): 4*Kq*Kkv*Dh flops per slice on the CUDA cores, whose
// peak is 67 TFLOP/s, plus one expf per score. Device-memory traffic is only
// q, k, v, mask in and out back (~1 MB per slice at K=2048, Dh=64), so at
// the LightGlue shapes the kernel is bound by operations, not bytes: its
// arithmetic intensity is ~K/2 flops per byte, far above the 20 flop/byte
// f32 ridge.
//
// What the design does about it. Each block owns one (bh, 64-query tile)
// and loops over 64-key tiles staged in shared memory; 256 threads each hold
// a 4x4 register tile of scores and a 4 x Dh/16 register tile of the output
// accumulator, with the running max and sum for their 4 rows in registers.
// Both inner products are register-blocked so that every 128-bit shared-
// memory load feeds 4 FMAs (Q rows and K^T columns for the scores, P rows
// and V rows for the output), and the layouts are padded so that those loads
// are free of bank conflicts. Row reductions for the online softmax are warp
// shuffles inside the 16 lanes that share a row. The K/V tiles of one bh are
// re-read by its Kq/64 blocks from L2, not from device memory.
// Later work (not this file's): wgmma/TMA pipelines and bf16/TF32 inputs,
// once a precision decision allows tensor cores.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BKV = 64;           // keys per kv tile
constexpr int TX = 16;            // lanes along keys / head dim
constexpr int TY = 16;            // thread rows along queries
constexpr int NT = TX * TY;       // 256 threads per block
constexpr int RQ = BQ / TY;       // 4 query rows per thread
constexpr int RK = BKV / TX;      // 4 keys per thread
constexpr int P_STRIDE = BKV + 4; // padded row stride of the P tile
constexpr float NEG = -1e9f;

template <int DH>
struct Layout {
  static constexpr int Q_STRIDE = DH + 4;             // padded Q row stride
  static constexpr int VW = DH >= 64 ? 4 : 2;         // output vector width
  static constexpr int NG = DH / (TX * VW);           // output column groups
  static constexpr int Q_OFF = 0;                     // Qs[r][d]
  static constexpr int KT_OFF = Q_OFF + BQ * Q_STRIDE;  // Kt[d][c]
  static constexpr int V_OFF = KT_OFF + DH * BKV;     // Vs[c][d]
  static constexpr int P_OFF = V_OFF + BKV * DH;      // Ps[r][c]
  static constexpr int M_OFF = P_OFF + BQ * P_STRIDE; // key class per slot
  static constexpr int FLOATS = M_OFF + BKV;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
};

template <int DH>
__global__ void __launch_bounds__(NT, 2)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ kv_mask,
                       float* __restrict__ out, int Kq, int Kkv, float scale) {
  using L = Layout<DH>;
  constexpr int VW = L::VW;
  constexpr int NG = L::NG;
  constexpr int DC = NG * VW;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem + L::Q_OFF;
  float* Kt = smem + L::KT_OFF;
  float* Vs = smem + L::V_OFF;
  float* Ps = smem + L::P_OFF;
  float* Mk = smem + L::M_OFF;  // 1 = real key, 0 = masked key, -1 = tail

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;

  const float* qb = q + (size_t)bh * Kq * DH;
  const float* kb = k + (size_t)bh * Kkv * DH;
  const float* vb = v + (size_t)bh * Kkv * DH;
  const float* mb = kv_mask + (size_t)bh * Kkv;

  // Q tile, row-major with a padded stride; rows past Kq are zeros.
  for (int idx = tid; idx < BQ * (DH / 4); idx += NT) {
    const int r = idx / (DH / 4);
    const int d4 = idx % (DH / 4);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Kq) val = *reinterpret_cast<const float4*>(qb + (size_t)(q0 + r) * DH + d4 * 4);
    *reinterpret_cast<float4*>(Qs + r * L::Q_STRIDE + d4 * 4) = val;
  }

  float m_run[RQ], l_run[RQ], acc[RQ][DC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DC; ++e) acc[i][e] = 0.f;
  }

  for (int c0 = 0; c0 < Kkv; c0 += BKV) {
    // K tile transposed (Kt[d][c]) so score columns read as float4; V tile
    // row-major. Slots past Kkv are zeros and classed as tail.
    for (int idx = tid; idx < BKV * (DH / 4); idx += NT) {
      const int c = idx % BKV;
      const int d4 = idx / BKV;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c0 + c < Kkv) val = *reinterpret_cast<const float4*>(kb + (size_t)(c0 + c) * DH + d4 * 4);
      Kt[(d4 * 4 + 0) * BKV + c] = val.x;
      Kt[(d4 * 4 + 1) * BKV + c] = val.y;
      Kt[(d4 * 4 + 2) * BKV + c] = val.z;
      Kt[(d4 * 4 + 3) * BKV + c] = val.w;
    }
    for (int idx = tid; idx < BKV * (DH / 4); idx += NT) {
      const int c = idx / (DH / 4);
      const int d4 = idx % (DH / 4);
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c0 + c < Kkv) val = *reinterpret_cast<const float4*>(vb + (size_t)(c0 + c) * DH + d4 * 4);
      *reinterpret_cast<float4*>(Vs + c * DH + d4 * 4) = val;
    }
    if (tid < BKV) {
      const int c = c0 + tid;
      Mk[tid] = c < Kkv ? (mb[c] > 0.f ? 1.f : 0.f) : -1.f;
    }
    __syncthreads();

    // Scores for rows ty*4+i, keys tx*4+j.
    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d0 = 0; d0 < DH; d0 += 4) {
      float4 qv[RQ], kv[4];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * RQ + i) * L::Q_STRIDE + d0);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd)
        kv[dd] = *reinterpret_cast<const float4*>(Kt + (d0 + dd) * BKV + tx * RK);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float qa[4] = {qv[i].x, qv[i].y, qv[i].z, qv[i].w};
#pragma unroll
        for (int dd = 0; dd < 4; ++dd) {
          s[i][0] = fmaf(qa[dd], kv[dd].x, s[i][0]);
          s[i][1] = fmaf(qa[dd], kv[dd].y, s[i][1]);
          s[i][2] = fmaf(qa[dd], kv[dd].z, s[i][2]);
          s[i][3] = fmaf(qa[dd], kv[dd].w, s[i][3]);
        }
      }
    }

    // Online softmax over this tile (16 lanes share each row).
    float cls[RK];
#pragma unroll
    for (int j = 0; j < RK; ++j) cls[j] = Mk[tx * RK + j];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float sv = cls[j] > 0.f ? s[i][j] * scale : (cls[j] == 0.f ? NEG : -INFINITY);
        s[i][j] = sv;
        mx = fmaxf(mx, sv);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float corr = expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = cls[j] < 0.f ? 0.f : expf(s[i][j] - m_new);
        s[i][j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[i] = l_run[i] * corr + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int e = 0; e < DC; ++e) acc[i][e] *= corr;
      *reinterpret_cast<float4*>(Ps + (ty * RQ + i) * P_STRIDE + tx * RK) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

    // acc += P V for rows ty*4+i, columns g*TX*VW + tx*VW + e.
#pragma unroll 2
    for (int cc = 0; cc < BKV; cc += 4) {
      float4 pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty * RQ + i) * P_STRIDE + cc);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vr[DC];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float* src = Vs + (cc + u) * DH + g * TX * VW + tx * VW;
          if constexpr (VW == 4) {
            const float4 t = *reinterpret_cast<const float4*>(src);
            vr[g * 4 + 0] = t.x; vr[g * 4 + 1] = t.y; vr[g * 4 + 2] = t.z; vr[g * 4 + 3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(src);
            vr[g * 2 + 0] = t.x; vr[g * 2 + 1] = t.y;
          }
        }
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const float pa[4] = {pv[i].x, pv[i].y, pv[i].z, pv[i].w};
#pragma unroll
          for (int e = 0; e < DC; ++e) acc[i][e] = fmaf(pa[u], vr[e], acc[i][e]);
        }
      }
    }
    __syncthreads();
  }

  float* ob = out + (size_t)bh * Kq * DH;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty * RQ + i;
    if (r >= Kq) continue;
    const float inv = 1.f / fmaxf(l_run[i], 1e-20f);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      float* dst = ob + (size_t)r * DH + g * TX * VW + tx * VW;
      if constexpr (VW == 4) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][g * 4 + 0] * inv, acc[i][g * 4 + 1] * inv,
                        acc[i][g * 4 + 2] * inv, acc[i][g * 4 + 3] * inv);
      } else {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[i][g * 2 + 0] * inv, acc[i][g * 2 + 1] * inv);
      }
    }
  }
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v, const float* kv_mask,
                   float* out, int BH, int Kq, int Kkv, float scale, cudaStream_t stream) {
  constexpr size_t smem = Layout<DH>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Kq + BQ - 1) / BQ, BH);
  flash_attention_kernel<DH><<<grid, NT, smem, stream>>>(q, k, v, kv_mask, out, Kq, Kkv, scale);
  return cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes). All pointers are device pointers to
// contiguous float32 arrays: q (BH, Kq, Dh), k and v (BH, Kkv, Dh), kv_mask
// (BH, Kkv), out (BH, Kq, Dh), each 16-byte aligned. Launches on `stream`,
// allocates nothing, does not synchronise. Returns the cudaError_t of the
// launch (0 = success); an unsupported Dh returns cudaErrorInvalidValue.
extern "C" int gtsfm_flash_attention_f32(const float* q, const float* k, const float* v,
                                         const float* kv_mask, float* out, int BH, int Kq,
                                         int Kkv, int Dh, float scale, void* stream) {
  if (BH <= 0 || BH > 65535 || Kq <= 0 || Kkv <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 32: return (int)launch<32>(q, k, v, kv_mask, out, BH, Kq, Kkv, scale, s);
    case 64: return (int)launch<64>(q, k, v, kv_mask, out, BH, Kq, Kkv, scale, s);
    case 128: return (int)launch<128>(q, k, v, kv_mask, out, BH, Kq, Kkv, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
