// Masked flash attention in float32 for Hopper (sm_90a): wgmma tensor cores
// at float32 accuracy (3xTF32), fed by TMA into an mbarrier ring.
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
// Precision. The JAX package runs attention at "highest" float32 precision.
// Single-pass TF32 keeps 11 bits per operand (errors ~1e-3 at LightGlue's
// logits), so every product here is 3xTF32: x = hi + lo with
// hi = tf32_rna(x), lo = tf32_rna(x - hi), and a.b ~ lo_a.hi_b + hi_a.lo_b +
// hi_a.hi_b (the two small terms first, into the same f32 accumulator). The
// dropped lo.lo term and the rounding of lo are ~2^-21 relative: f32 grade.
//
// What bounds it on this card: three TF32 tensor-core products of
// 4*Kq*Kkv*Dh flops each, at 495 TFLOP/s dense TF32 (the f32 CUDA cores, at
// 67 TFLOP/s, would take 2.3x longer for one product). One exp2 per score on
// the SFUs and the device-memory bytes (q, k, v, mask read once, out written
// once; ~1 MB per slice at K = 2048, Dh = 64) are far below that. Beside the
// products, 3xTF32 adds CUDA-core work (the softmax, splitting operands into
// hi/lo) that the design keeps off the tensor cores' critical path.
//
// What the design does about it. One call launches three kernels on the
// caller's stream:
//   * A split pass (split_rows, split_transpose_v) writes hi/lo copies of k,
//     and of v transposed to (Dh, keys), into a workspace the caller
//     allocates. TF32 wgmma takes only K-major operands, so P.V needs V^T;
//     within each group of 8 keys V^T is stored in the order 0,2,4,6,1,3,5,7,
//     so that the score accumulator's fragment is the A-operand fragment of
//     P.V as it lies in registers (no shuffles, no shared-memory round trip
//     for P). Splitting in the kernel instead (raw tiles by TMA, split by the
//     producer warpgroup) kept the tensor cores waiting on the split; the
//     pass costs one extra read of k and v and two writes.
//   * The attention kernel: one block per (bh, BQ-query tile), NWG consumer
//     warpgroups of 64 query rows each and one producer warpgroup, which
//     gives its registers to the consumers (setmaxnreg). One producer warp
//     loads raw Q once and keeps the K and V^T hi/lo tiles of the next kv
//     tiles in flight by TMA (128-byte swizzle, zeros past the end) through
//     a STAGES-deep ring with separate full/empty mbarriers for K and V^T:
//     a K slot is refilled as soon as its scores are done, a V^T slot after
//     P.V. It also turns each tile's mask slice into a (scale, bias) pair per
//     key (ordinary loads: the mask's row stride is not 16-byte aligned for
//     TMA), so that each score takes one FMA in the softmax.
//   * Each consumer warpgroup splits its rows of Q into hi/lo A-operand
//     fragments in registers (lo stays in shared memory for Dh = 128), then
//     per kv tile issues S = Q.K^T as 3 x Dh/8 wgmma.m64nBKVk8 (B = K from
//     shared memory), does the online softmax on the accumulator fragment in
//     registers (exp2 on the SFU with log2(e) folded into the scale), splits
//     P into hi/lo registers and issues the tile's P.V as 3 x BKV/8
//     wgmma.m64nDHk8 with A = P from registers. S of tile t + 1 and P.V of
//     tile t are in flight together while the softmax of tile t + 1 runs, and
//     the two consumer warpgroups take turns to issue (ping-pong), so the
//     softmax of one overlaps the products of the other.
//   * Shared memory per block: Dh = 32 and 64 take BQ = 128 (two consumer
//     warpgroups) and 64-key tiles; Dh = 128 takes BQ = 64 and 32-key tiles
//     to fit Q and the K, V^T ring in 227 KB; one block per SM.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e9f;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// 3xTF32 split

// x rounded to TF32 (10 mantissa bits, low 13 bits zero), to nearest with
// ties away from zero: the result of cvt.rna.tf32.f32 for every finite x,
// in two integer operations instead of the conversion unit's quarter rate.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = __uint_as_float(tf32_rna(x));
  lo = __uint_as_float(tf32_rna(x - hi));
}

// hi/lo copies of n contiguous floats (n % 4 == 0).
__global__ void split_rows(const float4* __restrict__ x, float4* __restrict__ hi,
                           float4* __restrict__ lo, size_t n4) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 a = x[i];
    float4 h, l;
    split(a.x, h.x, l.x);
    split(a.y, h.y, l.y);
    split(a.z, h.z, l.z);
    split(a.w, h.w, l.w);
    hi[i] = h;
    lo[i] = l;
  }
}

// v (BH, Kkv, Dh) -> hi/lo of v^T (BH, Dh, Kp), zero past Kkv (Kp % 32 ==
// 0). Position p of each 8-key group holds key 2p (p < 4) or 2(p - 4) + 1
// (p >= 4).
// Grid (Kp/32, Dh/32, BH), block (32, 8).
__global__ void split_transpose_v(const float* __restrict__ v, float* __restrict__ thi,
                                  float* __restrict__ tlo, int Kkv, int Kp, int Dh) {
  __shared__ float tile[32][33];
  const int c0 = blockIdx.x * 32, d0 = blockIdx.y * 32, bh = blockIdx.z;
  const float* vb = v + (size_t)bh * Kkv * Dh;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int c = c0 + r;
    tile[r][threadIdx.x] = c < Kkv ? vb[(size_t)c * Dh + d0 + threadIdx.x] : 0.f;
  }
  __syncthreads();
  const int p = threadIdx.x & 7;
  const int key = (threadIdx.x & ~7) + (p < 4 ? 2 * p : 2 * (p - 4) + 1);
  for (int r = threadIdx.y; r < 32; r += 8) {
    float h, l;
    split(tile[key][r], h, l);
    const size_t o = ((size_t)bh * Dh + d0 + r) * Kp + c0 + threadIdx.x;
    thi[o] = h;
    tlo[o] = l;
  }
}

// 2^x on the SFU (ex2.approx.ftz: ~2 ulp; 2^-inf = +0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// Shared memory, mbarriers, TMA

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the phase with the given parity to complete. A wait of more than
// 10 s can only be a fault (a lost TMA or arrival): trap, so the launch
// fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  uint64_t start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = global_ns();
    else if (global_ns() - start > 10000000000ull) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma (TF32, K-major operands, 128-byte swizzle)

// Descriptor of a K-major tile stored as 8-row x 128-byte swizzle atoms
// (what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B and a 32-float box row).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }

// Keep the compiler from moving register reads or writes across the
// asynchronous wgmma that reads or writes them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][r])::"memory");
}

#define WG_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                 "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_D16(i) WG_D8(i), WG_D8(i + 8)
#define WG_D32(i) WG_D16(i), WG_D16(i + 16)

#define WG_R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_R32                                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_R64                                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x N) += A (64 x 8) . B (8 x N). ss: A from shared memory; rs: A
// from registers (the m16n8k8 TF32 fragment of each warp's 16 rows).
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  __device__ static void ss(float (&d)[16], uint64_t a, uint64_t b, int acc) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " WG_R16
                 ", %16, %17, p, 1, 1;\n}\n"
                 : WG_D16(0)
                 : "l"(a), "l"(b), "r"(acc));
  }
  __device__ static void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int acc) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " WG_R16
                 ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
                 : WG_D16(0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<64> {
  __device__ static void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int acc) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_R32
                 ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
                 : WG_D32(0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<128> {
  __device__ static void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int acc) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WG_R64
                 ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
                 : WG_D32(0), WG_D32(32)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

// ---------------------------------------------------------------------------
// The attention kernel

template <int DH>
struct Config {
  static constexpr int NWG = DH <= 64 ? 2 : 1;       // consumer warpgroups
  static constexpr int BQ = 64 * NWG;                // query rows per block
  static constexpr int BKV = DH <= 64 ? 64 : 32;     // keys per kv tile
  static constexpr int STAGES = DH <= 32 ? 4 : 3;    // depth of the K, V^T ring
  static constexpr int NT = 128 * (NWG + 1);         // + one producer warpgroup
  static constexpr bool QLO_IN_REGS = DH <= 64;      // Q lo as A fragments (else from smem)
  // Byte offsets from the 1024-aligned base. Each operand tile is stored as
  // column blocks of 32 floats (128 bytes) x rows, 128-byte swizzled.
  static constexpr int Q_BYTES = BQ * DH * 4;
  static constexpr int KV_BYTES = BKV * DH * 4;      // one of K hi, K lo, V^T hi, V^T lo
  static constexpr int QLO = 0;                      // raw Q lands here
  static constexpr int STAGE0 = Q_BYTES;             // K hi, K lo, V^T hi, V^T lo
  static constexpr int PAR0 = STAGE0 + STAGES * 4 * KV_BYTES;  // (scale, bias) per key column
  static constexpr int BAR = PAR0 + STAGES * BKV * 8;
  static constexpr size_t SMEM = BAR + 8 * (1 + 4 * STAGES) + 1024;  // + alignment slack
  static_assert(SMEM <= 232448, "shared memory per block");
};

struct Maps {
  CUtensorMap q, khi, klo, vhi, vlo;
};

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float4 lds4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

template <int DH>
__global__ void __launch_bounds__(Config<DH>::NT, 1)
flash_attention_kernel(const __grid_constant__ Maps maps, const float* __restrict__ kv_mask,
                       float* __restrict__ out, int Kq, int Kkv, float scale_log2) {
  using C = Config<DH>;
  constexpr int BQ = C::BQ, BKV = C::BKV, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_q = base + C::BAR;
  // K (with its column parameters) and V^T of a hi/lo slot are filled and
  // freed separately: K of tile t is done with once its scores are, V^T
  // only after P.V.
  auto bar_full_k = [&](int s) { return bar_q + 8 * (1 + s); };
  auto bar_full_v = [&](int s) { return bar_q + 8 * (1 + STAGES + s); };
  auto bar_empty_k = [&](int s) { return bar_q + 8 * (1 + 2 * STAGES + s); };
  auto bar_empty_v = [&](int s) { return bar_q + 8 * (1 + 3 * STAGES + s); };
  auto stage = [&](int t) { return base + C::STAGE0 + (t % STAGES) * 4 * C::KV_BYTES; };
  auto params = [&](int t) { return base + C::PAR0 + (t % STAGES) * BKV * 8; };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int n_tiles = (Kkv + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full_k(s), 32);
      mbar_init(bar_full_v(s), 1);
      mbar_init(bar_empty_k(s), 4 * C::NWG);
      mbar_init(bar_empty_v(s), 4 * C::NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * C::NWG) {
    // Producer warpgroup: its first warp keeps the K and V^T hi/lo tiles
    // of the next kv tiles in flight by TMA and writes each tile's column
    // parameters; the other three only hand their registers to the
    // consumers (with two consumer warpgroups: 168 each at launch for 384
    // threads; 24 + 2 x 240 after).
    if constexpr (C::NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (warp == 4 * C::NWG) {
      if (lane == 0) {
        mbar_expect_tx(bar_q, C::Q_BYTES);
        for (int cb = 0; cb < DH / 32; ++cb)
          tma_load_3d(base + C::QLO + cb * BQ * 128, &maps.q, bar_q, cb * 32, q0, bh);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES, empty_parity = ((t / STAGES) & 1) ^ 1;
        const uint32_t st = stage(t);
        mbar_wait(bar_empty_k(s), empty_parity);
        // Per key column of the tile, the score is fma(s, scale, bias): a
        // real key scales by scale_log2, a masked key scores exactly -1e9
        // (log2 units), a slot past Kkv scores -inf (weight exactly 0). The
        // mask slice is read with ordinary loads: its row stride is not
        // 16-byte aligned for TMA.
        for (int j = lane; j < BKV; j += 32) {
          const int c = t * BKV + j;
          float sc = 0.f, bias = -INFINITY;
          if (c < Kkv) {
            const bool real = __ldg(kv_mask + (size_t)bh * Kkv + c) > 0.f;
            sc = real ? scale_log2 : 0.f;
            bias = real ? 0.f : NEG * LOG2E;
          }
          asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(params(t) + 8 * j), "f"(sc), "f"(bias)
                       : "memory");
        }
        if (lane == 0) {
          mbar_expect_tx(bar_full_k(s), 2 * C::KV_BYTES);
          for (int cb = 0; cb < DH / 32; ++cb) {
            tma_load_3d(st + cb * BKV * 128, &maps.khi, bar_full_k(s), cb * 32, t * BKV, bh);
            tma_load_3d(st + C::KV_BYTES + cb * BKV * 128, &maps.klo, bar_full_k(s), cb * 32, t * BKV, bh);
          }
        } else {
          mbar_arrive(bar_full_k(s));
        }
        if (lane == 0) {
          mbar_wait(bar_empty_v(s), empty_parity);
          mbar_expect_tx(bar_full_v(s), 2 * C::KV_BYTES);
          for (int cb = 0; cb < BKV / 32; ++cb) {
            tma_load_3d(st + 2 * C::KV_BYTES + cb * DH * 128, &maps.vhi, bar_full_v(s), t * BKV + cb * 32, 0, bh);
            tma_load_3d(st + 3 * C::KV_BYTES + cb * DH * 128, &maps.vlo, bar_full_v(s), t * BKV + cb * 32, 0, bh);
          }
        }
        __syncwarp();
      }
    }
  } else {
    // Consumer warpgroups: wg owns query rows q0 + 64 wg + [0, 64); in each
    // accumulator fragment this thread holds rows r0 = 16 (warp % 4) + g and
    // r0 + 8, and columns 8 j + 2 t + {0, 1}.
    if constexpr (C::NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    const int wg = warp / 4;
    const int g = lane / 4, t4 = lane % 4;

    const uint32_t qlo = base + C::QLO + wg * 64 * 128;

    // o: the output rows, accumulated across kv tiles on the CUDA cores;
    // ot: one tile's P.V from the tensor cores (see issue_pv).
    float o[DH / 2], ot[DH / 2], sacc[BKV / 2];
    uint32_t qhi[DH / 8][4], qlo_r[C::QLO_IN_REGS ? DH / 8 : 1][4], phi[BKV / 8][4], plo[BKV / 8][4];
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, corr[2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = ot[i] = 0.f;

    // S = Qlo.Khi + Qhi.Klo + Qhi.Khi for tile t (landed), committed as one
    // group; Q from registers (Qlo from shared memory for Dh = 128).
    auto issue_scores = [&](int t) {
      const uint32_t khi = stage(t), klo = khi + C::KV_BYTES;
      auto desc_k = [&](uint32_t b, int kk) { return smem_desc(b + (kk / 4) * BKV * 128 + (kk % 4) * 32); };
#pragma unroll
      for (int kk = 0; kk < DH / 8; ++kk) {
        if constexpr (C::QLO_IN_REGS)
          Wgmma<BKV>::rs(sacc, qlo_r[kk], desc_k(khi, kk), kk > 0);
        else
          Wgmma<BKV>::ss(sacc, smem_desc(qlo + (kk / 4) * BQ * 128 + (kk % 4) * 32), desc_k(khi, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DH / 8; ++kk) Wgmma<BKV>::rs(sacc, qhi[kk], desc_k(klo, kk), 1);
#pragma unroll
      for (int kk = 0; kk < DH / 8; ++kk) Wgmma<BKV>::rs(sacc, qhi[kk], desc_k(khi, kk), 1);
      wgmma_commit();
    };
    // Ot = Plo.Vhi + Phi.Vlo + Phi.Vhi for tile t, committed as one group,
    // into a fresh accumulator: the tensor cores add into their f32
    // accumulator without rounding to nearest, an error that grows with the
    // number of k8 steps added into it. Summed over a whole row of 2048 keys
    // (768 steps) it reached 3e-5 of the output, 8x further from float64
    // than the plain version, for values with a shared offset under
    // near-uniform attention (scripts/torch_attention_accumulation_probe.py).
    // Per 64-key tile (24 steps) it stays at f32 grade, and
    // rescale_and_split adds the tiles on the CUDA cores.
    auto issue_pv = [&](int t) {
      const uint32_t vhi = stage(t) + 2 * C::KV_BYTES, vlo = vhi + C::KV_BYTES;
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
        const uint32_t b = pass == 1 ? vlo : vhi;
#pragma unroll
        for (int kk = 0; kk < BKV / 8; ++kk) {
          const uint32_t off_b = (kk / 4) * DH * 128 + (kk % 4) * 32;
          Wgmma<DH>::rs(ot, pass == 0 ? plo[kk] : phi[kk], smem_desc(b + off_b), pass > 0 || kk > 0);
        }
      }
      wgmma_commit();
    };
    // Online softmax of sacc (tile t) in the log2 domain: sacc becomes P,
    // corr the factor by which O must shrink; l_run is a per-thread partial
    // sum, reduced at the end.
    auto softmax = [&](int t) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        const float4 pr = lds4(params(t) + 16 * (4 * j + t4));  // columns 8 j + 2 t + {0, 1}
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // row r0 (h = 0) and r0 + 8 (h = 1)
          float& s0 = sacc[4 * j + 2 * h];
          float& s1 = sacc[4 * j + 2 * h + 1];
          s0 = fmaf(s0, pr.x, pr.y);
          s1 = fmaf(s1, pr.z, pr.w);
          mx[h] = fmaxf(mx[h], fmaxf(s0, s1));
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_run[h], mx[h]);
        corr[h] = ex2(m_run[h] - m_new);
        m_run[h] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& sv = sacc[4 * j + 2 * h + e];
            sv = ex2(sv - m_new);
            sum += sv;
          }
        l_run[h] = l_run[h] * corr[h] + sum;
      }
    };
    // O = (O + Ot) * corr, and P as the A fragment of each k8 step: (row g, k t),
    // (g + 8, t), (g, t + 4), (g + 8, t + 4); with V^T's key order
    // 0,2,4,6,1,3,5,7 those are the accumulator's entries 0, 2, 1, 3 of
    // n8 block kk.
    auto rescale_and_split = [&]() {
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          o[4 * j + 2 * h] = (o[4 * j + 2 * h] + ot[4 * j + 2 * h]) * corr[h];
          o[4 * j + 2 * h + 1] = (o[4 * j + 2 * h + 1] + ot[4 * j + 2 * h + 1]) * corr[h];
        }
#pragma unroll
      for (int kk = 0; kk < BKV / 8; ++kk) {
        const int src[4] = {0, 2, 1, 3};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = sacc[4 * kk + src[r]];
          phi[kk][r] = tf32_rna(p);
          plo[kk][r] = tf32_rna(p - __uint_as_float(phi[kk][r]));
        }
      }
    };

    // Software pipeline: while the tensor cores run S of tile t + 1 and
    // then P.V of tile t, the softmax of tile t + 1 runs on the CUDA cores.
    // No branch or wait falls between a wgmma.fence and its commits, so
    // ptxas keeps the wgmma groups asynchronous.
    auto fence_all = [&]() {
      fence_regs(qhi);
      fence_regs(qlo_r);
      fence_regs(sacc);
      fence_regs(o);
      fence_regs(ot);
      fence_regs(phi);
      fence_regs(plo);
    };
    // This warpgroup's 64 rows of raw Q: hi into registers as the A fragment
    // of each k8 step (rows g and g + 8 of this warp's 16, columns t and
    // t + 4), lo written back in place for the shared-memory pass.
    mbar_wait(bar_q, 0);
#pragma unroll
    for (int kk = 0; kk < DH / 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 16 * (warp % 4) + g + 8 * (r % 2), col = 8 * kk + t4 + 4 * (r / 2);
        const uint32_t addr = qlo + (col / 32) * BQ * 128 + row * 128 +
                              ((((col % 32) / 4) ^ (row % 8)) * 16) + (col % 4) * 4;
        const float x = lds(addr);
        qhi[kk][r] = tf32_rna(x);
        const uint32_t lo = tf32_rna(x - __uint_as_float(qhi[kk][r]));
        if constexpr (C::QLO_IN_REGS)
          qlo_r[kk][r] = lo;
        else
          asm volatile("st.shared.f32 [%0], %1;" ::"r"(addr), "f"(__uint_as_float(lo)) : "memory");
      }
    if constexpr (!C::QLO_IN_REGS) {
      fence_proxy_async();  // the lo stores, before wgmma reads them
      named_sync(2 + wg, 128);
    }
    auto full_parity = [&](int t) { return (t / STAGES) & 1; };
    auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
    };
    mbar_wait(bar_full_k(0), 0);
    fence_all();
    // Ping-pong: the two consumer warpgroups take turns to issue their
    // wgmma groups, so the softmax of one overlaps the products of the other.
    auto my_turn = [&]() {
      if constexpr (C::NWG == 2) named_sync(4 + wg, 256);
    };
    auto your_turn = [&]() {
      if constexpr (C::NWG == 2) asm volatile("bar.arrive %0, 256;" ::"r"(5 - wg) : "memory");
    };
    if (wg == 1) your_turn();  // warpgroup 0 goes first
    my_turn();
    wgmma_fence();
    issue_scores(0);
    your_turn();
    wgmma_wait_all();
    fence_all();
    softmax(0);
    release(bar_empty_k(0));
    rescale_and_split();
    for (int t = 0; t + 1 < n_tiles; ++t) {
      mbar_wait(bar_full_k((t + 1) % STAGES), full_parity(t + 1));
      mbar_wait(bar_full_v(t % STAGES), full_parity(t));
      fence_all();
      my_turn();
      wgmma_fence();
      issue_scores(t + 1);
      issue_pv(t);
      your_turn();
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");  // S of t + 1 done
      fence_regs(sacc);
      softmax(t + 1);
      release(bar_empty_k((t + 1) % STAGES));  // K and the column parameters of t + 1
      wgmma_wait_all();  // P.V of tile t done
      fence_all();
      release(bar_empty_v(t % STAGES));
      rescale_and_split();
    }
    mbar_wait(bar_full_v((n_tiles - 1) % STAGES), full_parity(n_tiles - 1));
    fence_all();
    my_turn();
    wgmma_fence();
    issue_pv(n_tiles - 1);
    your_turn();
    if (wg == 0) my_turn();  // take warpgroup 1's last turn
    wgmma_wait_all();
    fence_all();
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] += ot[i];

    float* ob = out + (size_t)bh * Kq * DH;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_run[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int r = q0 + wg * 64 + 16 * (warp % 4) + g + 8 * h;
      if (r >= Kq) continue;
      const float inv = 1.f / fmaxf(l, 1e-20f);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<float2*>(ob + (size_t)r * DH + 8 * j + 2 * t4) =
            make_float2(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return status == cudaDriverEntryPointSuccess ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p)
                                                 : nullptr;
  }();
  return fn;
}

// A 3-D map (Dh, rows, BH) of contiguous float32 with a box of 32 x box_rows
// x 1, 128-byte swizzle, zeros out of bounds.
bool make_map(CUtensorMap* map, const float* ptr, int dh, int rows, int BH, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)rows, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)dh * 4, (cuuint64_t)dh * rows * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_fn()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr), dims, strides, box,
                     elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int padded_keys(int Kkv) { return (Kkv + 31) / 32 * 32; }

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v, const float* kv_mask, float* out,
                   float* ws, int BH, int Kq, int Kkv, float scale, cudaStream_t stream) {
  using C = Config<DH>;
  if (encode_fn() == nullptr) return cudaErrorNotSupported;
  // Split pass: hi/lo of k, and of v transposed (keys padded to Kp).
  const int Kp = padded_keys(Kkv);
  const size_t nk = (size_t)BH * Kkv * DH, nv = (size_t)BH * DH * Kp;
  float* khi = ws;
  float* klo = khi + nk;
  float* vhi = klo + nk;
  float* vlo = vhi + nv;
  split_rows<<<1024, 256, 0, stream>>>(reinterpret_cast<const float4*>(k), reinterpret_cast<float4*>(khi),
                                       reinterpret_cast<float4*>(klo), nk / 4);
  split_transpose_v<<<dim3(Kp / 32, DH / 32, BH), dim3(32, 8), 0, stream>>>(v, vhi, vlo, Kkv, Kp, DH);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  Maps maps;
  if (!make_map(&maps.q, q, DH, Kq, BH, C::BQ) || !make_map(&maps.khi, khi, DH, Kkv, BH, C::BKV) ||
      !make_map(&maps.klo, klo, DH, Kkv, BH, C::BKV) || !make_map(&maps.vhi, vhi, Kp, DH, BH, DH) ||
      !make_map(&maps.vlo, vlo, Kp, DH, BH, DH))
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(flash_attention_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((Kq + C::BQ - 1) / C::BQ, BH);
  flash_attention_kernel<DH><<<grid, C::NT, C::SMEM, stream>>>(maps, kv_mask, out, Kq, Kkv, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the workspace gtsfm_flash_attention_f32 needs: hi/lo copies of k
// and of v transposed with its keys padded to a multiple of 32.
extern "C" long long gtsfm_flash_attention_workspace_bytes(int BH, int Kkv, int Dh) {
  return 4LL * 2 * BH * Dh * ((long long)Kkv + padded_keys(Kkv));
}

// C interface (loaded with ctypes). All pointers are device pointers to
// contiguous float32 arrays: q (BH, Kq, Dh), k and v (BH, Kkv, Dh), kv_mask
// (BH, Kkv), out (BH, Kq, Dh), each 16-byte aligned, and a workspace of
// gtsfm_flash_attention_workspace_bytes bytes. Launches the split pass and
// the attention kernel on `stream`, allocates nothing, does not
// synchronise. Returns the cudaError_t of the launches (0 = success); an
// unsupported Dh returns cudaErrorInvalidValue.
extern "C" int gtsfm_flash_attention_f32(const float* q, const float* k, const float* v,
                                         const float* kv_mask, float* out, float* workspace, int BH,
                                         int Kq, int Kkv, int Dh, float scale, void* stream) {
  if (BH <= 0 || BH > 65535 || Kq <= 0 || Kkv <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 32: return (int)launch<32>(q, k, v, kv_mask, out, workspace, BH, Kq, Kkv, scale, s);
    case 64: return (int)launch<64>(q, k, v, kv_mask, out, workspace, BH, Kq, Kkv, scale, s);
    case 128: return (int)launch<128>(q, k, v, kv_mask, out, workspace, BH, Kq, Kkv, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
