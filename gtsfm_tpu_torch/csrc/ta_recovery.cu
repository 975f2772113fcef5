// Translation averaging's recovery (multiview/translation_averaging.py::
// _recover_translations_gn) as two persistent single-block kernels: one
// launch runs every IRLS sweep, one every Gauss-Newton step.
//
// It replaces no TPU kernel: the JAX package runs this loop as jitted XLA.
// In PyTorch the loop is about 220,000 kernel launches a scene (170 IRLS
// sweeps and 30 Gauss-Newton steps, each a fixed 40-step PCG of ~26 ops),
// each a microsecond or two of device work behind 10-14 us of host
// dispatch. The problem is tiny: the cameras plus a few hundred landmarks,
// a few thousand edges. So one thread block does it all: its working set
// is a few hundred KB, the loop counts are arguments, and a PCG step costs
// four block barriers, one pass over the edges (each edge's product, once)
// and one over the nodes (each gathers its edges' products). What bounds it
// is the latency of those barriers and of the gathers, not bytes or
// operations: one SM of 132 does the work, and the others are idle.
//
// Arithmetic: float32, the constants, loop counts and order of steps of the
// PyTorch loop (its plain version, which the CPU tests hold against the JAX
// package). Two things differ:
//   * segment sums are per-node gathers over an incidence list that the
//     host builds once a call (each node's edges in a fixed order, those it
//     is the b end of first), summed in that order, so the result is
//     deterministic where index_add_'s atomics are not;
//   * Gauss-Newton's 3x3 block-Jacobi inverse is the closed-form adjugate
//     over the determinant (bundle/ba.py::_inv3x3's formula) in place of
//     torch.linalg.inv, so no result check synchronises the host.
// Dots and means are block reductions in a fixed order; every thread gets
// the same bits.
//
// Layout: threads own nodes v = tid, tid + kThreads, ... and edges e = tid,
// tid + kThreads, ... in every phase, so a node's or an edge's own scratch
// needs no barrier. The node vectors and all edge scratch live in the
// global workspace, which L2 holds at these sizes (a scene's ~0.2 MB). On
// the sift128 scene, keeping the node vectors and the PCG's edge products
// in shared memory instead made the kernel ~40 ms a scene faster, under
// 0.5% of the scene, and is not worth a second layout.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
static_assert(kWarps == 32, "block_sum reduces one partial per warp in one warp");
constexpr int kPcgIters = 40;  // translation_averaging._pcg's fixed count
constexpr float kDelta = 0.05f;  // least edge scale in the IRLS
constexpr float kNoiseSigma = 0.01f;  // NOISE_SIGMA
constexpr float kHuberK = 1.345f;  // HUBER_K
// Workspace: per-edge scratch (the larger phase: Gauss-Newton's JtJ and Jt r),
// then the PCG's edge products (3 an edge), then the node vectors.
constexpr int kEdgeFloats = 9;
constexpr int kGnNodeFloats = 24;  // t, dx, r, p, Ap, damping (3 each), M^-1 upper triangle (6)

struct Graph {
  int n, E;
  const long long* ea;  // (E,) the edge's a end (the direction's start)
  const long long* eb;  // (E,) its b end
  const float* u;  // (E, 3) measured direction (or displacement, metric edges)
  const float* w_edge;  // (E,) edge weight (inlier mask)
  const float* is_metric;  // (E,) > 0: metric edge; null: none
  const float* sigma;  // (E,) noise sigma; null: kNoiseSigma
  const int* offsets;  // (n + 1,) node v's incidences are [offsets[v], offsets[v + 1]):
  const int* split;  // (n,) those before split[v] have v as the edge's b end, the rest as its a end
  const int* inc_edge;  // (2E,) the incident edge

  __device__ bool metric(int e) const { return is_metric != nullptr && __ldg(is_metric + e) > 0.f; }
  __device__ float sig(int e) const { return sigma != nullptr ? __ldg(sigma + e) : kNoiseSigma; }
  __device__ int a(int e) const { return static_cast<int>(__ldg(ea + e)); }
  __device__ int b(int e) const { return static_cast<int>(__ldg(eb + e)); }

  // Node v's sums of `vals` (K floats an edge) over the edges whose b end
  // it is (sb) and over those whose a end it is (sa), each in edge order:
  // sb - sa is _segment_sum(vals, edges_b) - _segment_sum(vals, edges_a).
  template <int K>
  __device__ void gather(int v, const float* vals, float (&sb)[K], float (&sa)[K]) const {
#pragma unroll
    for (int i = 0; i < K; ++i) sb[i] = sa[i] = 0.f;
    const int lo = __ldg(offsets + v), mid = __ldg(split + v), hi = __ldg(offsets + v + 1);
#pragma unroll 4
    for (int k = lo; k < mid; ++k) {
      const int e = __ldg(inc_edge + k);
#pragma unroll
      for (int i = 0; i < K; ++i) sb[i] += vals[K * e + i];
    }
#pragma unroll 4
    for (int k = mid; k < hi; ++k) {
      const int e = __ldg(inc_edge + k);
#pragma unroll
      for (int i = 0; i < K; ++i) sa[i] += vals[K * e + i];
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;  // a butterfly: every lane adds the same pairs, so every lane holds the same bits
}

// Block-wide sums of K values, the same bits in every thread; one barrier.
// `red` holds two buffers of 3 * kWarps floats, used in turn: a reduction's
// writes come after the previous reduction's barrier, which every thread
// passed only after reading the buffer before that one.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red, int& phase) {
  float* buf = red + phase * 3 * kWarps;
  phase ^= 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float s = warp_sum(v[k]);
    if (lane == 0) buf[k * kWarps + warp] = s;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(buf[k * kWarps + lane]);
}

// Symmetric 3x3 as its upper triangle: xx, xy, xz, yy, yz, zz. The index
// folds to a constant in the unrolled loops.
__host__ __device__ constexpr int sym_index(int i, int j) {
  return i <= j ? i * (5 - i) / 2 + j : j * (5 - j) / 2 + i;
}

__device__ __forceinline__ float sym(const float* m, int i, int j) { return m[sym_index(i, j)]; }

__device__ __forceinline__ void load3(const float* a, int i, float out[3]) {
  out[0] = a[3 * i];
  out[1] = a[3 * i + 1];
  out[2] = a[3 * i + 2];
}

// The IRLS operator (L_mv): y_e = w_e (p_b - p_a) per edge, gathered by
// endpoint, plus 1e-6 p; the Jacobi preconditioner r / deg.
struct LaplacianOp {
  const float* w;  // (E,) this sweep's weights
  const float* deg;  // (n,)

  __device__ void edge(int e, const float d[3], float y[3]) const {
    const float we = w[e];
#pragma unroll
    for (int i = 0; i < 3; ++i) y[i] = we * d[i];
  }
  __device__ float diag(int v, int i, float pv) const { return 1e-6f * pv; }
  __device__ void precond(int v, const float r[3], float z[3]) const {
    const float d = deg[v];
#pragma unroll
    for (int i = 0; i < 3; ++i) z[i] = r[i] / d;
  }
};

// The Gauss-Newton operator (H_mv): y_e = JtJ_e (p_b - p_a) per edge,
// gathered by endpoint, plus the damping; the block-Jacobi M^-1 r.
struct HessianOp {
  const float* jtj;  // (E, 6)
  const float* damp;  // (n, 3)
  const float* minv;  // (n, 6)

  __device__ void edge(int e, const float d[3], float y[3]) const {
    const float* J = jtj + 6 * e;
#pragma unroll
    for (int i = 0; i < 3; ++i) y[i] = sym(J, i, 0) * d[0] + sym(J, i, 1) * d[1] + sym(J, i, 2) * d[2];
  }
  __device__ float diag(int v, int i, float pv) const { return damp[3 * v + i] * pv; }
  __device__ void precond(int v, const float r[3], float z[3]) const {
    const float* m = minv + 6 * v;
#pragma unroll
    for (int i = 0; i < 3; ++i) z[i] = sym(m, i, 0) * r[0] + sym(m, i, 1) * r[1] + sym(m, i, 2) * r[2];
  }
};

// Y[e] = op.edge(e, p_b - p_a) for the edges this thread owns.
template <class Op>
__device__ void edge_products(const Graph g, const Op& op, const float* p, float* Y) {
  for (int e = threadIdx.x; e < g.E; e += kThreads) {
    const int a = g.a(e), b = g.b(e);
    float d[3], y[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) d[i] = p[3 * b + i] - p[3 * a + i];
    op.edge(e, d, y);
#pragma unroll
    for (int i = 0; i < 3; ++i) Y[3 * e + i] = y[i];
  }
}

// translation_averaging._pcg's 40 steps, from the residual r, the
// direction p = M^-1 r and rz = r . M^-1 r that the caller set up (and
// published with a barrier). Four barriers a step: the edge products, the
// two dots and the new p. Y is (E, 3) scratch.
template <class Op>
__device__ void pcg(const Graph g, const Op& op, float* Y, float* x, float* r, float* p, float* Ap, float rz,
                    float* red, int& phase) {
  const int n = g.n;
  for (int step = 0; step < kPcgIters; ++step) {
    edge_products(g, op, p, Y);
    __syncthreads();
    float pap[1] = {0.f};
    for (int v = threadIdx.x; v < n; v += kThreads) {
      float sb[3], sa[3];
      g.gather<3>(v, Y, sb, sa);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float pv = p[3 * v + i];
        const float q = (sb[i] - sa[i]) + op.diag(v, i, pv);
        Ap[3 * v + i] = q;
        pap[0] += pv * q;
      }
    }
    block_sum<1>(pap, red, phase);
    const float alpha = rz / fmaxf(pap[0], 1e-20f);
    float rzn[1] = {0.f};
    for (int v = threadIdx.x; v < n; v += kThreads) {
      float rv[3], z[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        x[3 * v + i] = x[3 * v + i] + alpha * p[3 * v + i];
        rv[i] = r[3 * v + i] = r[3 * v + i] - alpha * Ap[3 * v + i];
      }
      op.precond(v, rv, z);
#pragma unroll
      for (int i = 0; i < 3; ++i) rzn[0] += rv[i] * z[i];
    }
    block_sum<1>(rzn, red, phase);
    const float beta = rzn[0] / fmaxf(rz, 1e-20f);
    rz = rzn[0];
    for (int v = threadIdx.x; v < n; v += kThreads) {
      float rv[3], z[3];
      load3(r, v, rv);
      op.precond(v, rv, z);
#pragma unroll
      for (int i = 0; i < 3; ++i) p[3 * v + i] = z[i] + beta * p[3 * v + i];
    }
    __syncthreads();
  }
}

// v -= mean over the nodes, per component (the centring after each solve),
// by the nodes' owners.
__device__ void subtract_mean(int n, float* v, float* red, int& phase) {
  float m[3] = {0.f, 0.f, 0.f};
  for (int j = threadIdx.x; j < n; j += kThreads) {
#pragma unroll
    for (int i = 0; i < 3; ++i) m[i] += v[3 * j + i];
  }
  block_sum<3>(m, red, phase);
  const float inv_n = 1.f / static_cast<float>(n);
  for (int j = threadIdx.x; j < n; j += kThreads) {
#pragma unroll
    for (int i = 0; i < 3; ++i) v[3 * j + i] = v[3 * j + i] - m[i] * inv_n;
  }
}

// The workspace's PCG edge products (E, 3) and node vectors.
__device__ float* edge_products_of(float* ws, int E) { return ws + static_cast<size_t>(kEdgeFloats) * E; }
__device__ float* nodes_of(float* ws, int E) { return ws + static_cast<size_t>(kEdgeFloats + 3) * E; }

__global__ void __launch_bounds__(kThreads, 1)
irls_kernel(Graph g, const float* __restrict__ t_in, float* __restrict__ t_out, float* ws, int iters,
            int normalize_gauge) {
  __shared__ float red[2 * 3 * kWarps];
  int phase = 0;
  const int n = g.n, E = g.E, tid = threadIdx.x;
  float* Y = edge_products_of(ws, E);
  float* x = nodes_of(ws, E);  // t, and the PCG's iterate from it
  float* r = x + 3 * n;
  float* p = x + 6 * n;
  float* Ap = x + 9 * n;
  float* deg = x + 12 * n;
  float* scale = ws;  // (E,)
  float* wt = ws + E;  // (E, 3) w * target
  float* w = ws + 4 * E;  // (E,)

  for (int i = tid; i < 3 * n; i += kThreads) x[i] = t_in[i];
  float wsum[1] = {0.f};
  for (int e = tid; e < E; e += kThreads) wsum[0] += __ldg(g.w_edge + e);
  block_sum<1>(wsum, red, phase);  // also publishes x
  const float w_total = fmaxf(wsum[0], 1e-9f);
  const LaplacianOp op{w, deg};

  for (int it = 0; it < iters; ++it) {
    // Closed-form scales, metric edges pinned to 1.
    float sw[1] = {0.f};
    for (int e = tid; e < E; e += kThreads) {
      const int a = g.a(e), b = g.b(e);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 3; ++i) s += (x[3 * b + i] - x[3 * a + i]) * __ldg(g.u + 3 * e + i);
      s = g.metric(e) ? 1.f : fmaxf(s, kDelta);
      scale[e] = s;
      sw[0] += s * __ldg(g.w_edge + e);
    }
    if (normalize_gauge) {  // mean live-edge scale -> 1
      block_sum<1>(sw, red, phase);
      const float c = fmaxf(sw[0] / w_total, 1e-9f);
      for (int e = tid; e < E; e += kThreads) scale[e] = scale[e] / c;
      for (int i = tid; i < 3 * n; i += kThreads) x[i] = x[i] / c;
      __syncthreads();
    }
    // Targets, residual norms and weights (plain least squares for the
    // first third of the sweeps); w * target and w (x_b - x_a) per edge.
    const bool plain = it < iters / 3;
    for (int e = tid; e < E; e += kThreads) {
      const int a = g.a(e), b = g.b(e);
      const float s = scale[e];
      float tg[3], d[3], sq = 0.f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        tg[i] = s * __ldg(g.u + 3 * e + i);
        d[i] = x[3 * b + i] - x[3 * a + i];
        const float res = d[i] - tg[i];
        sq += res * res;
      }
      const float w_rob = plain ? 1.f : fminf(0.25f / fmaxf(sqrtf(sq), 1e-9f), 1.f);
      const float ws_e = (1.f / g.sig(e)) * kNoiseSigma;
      const float we = w_rob * __ldg(g.w_edge + e) * (ws_e * ws_e);
      w[e] = we;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        wt[3 * e + i] = we * tg[i];
        Y[3 * e + i] = we * d[i];
      }
    }
    __syncthreads();
    // Right-hand side, degree and the PCG's first residual from x = t.
    float rz[1] = {0.f};
    for (int v = tid; v < n; v += kThreads) {
      float lb[3], la[3], hb[3], ha[3], db[1], da[1];
      g.gather<3>(v, Y, lb, la);
      g.gather<3>(v, wt, hb, ha);
      g.gather<1>(v, w, db, da);
      const float dg = (da[0] + db[0]) + 1e-6f;
      deg[v] = dg;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float rv = (hb[i] - ha[i]) - ((lb[i] - la[i]) + 1e-6f * x[3 * v + i]);
        const float z = rv / dg;
        r[3 * v + i] = rv;
        p[3 * v + i] = z;
        rz[0] += rv * z;
      }
    }
    block_sum<1>(rz, red, phase);
    pcg(g, op, Y, x, r, p, Ap, rz[0], red, phase);
    subtract_mean(n, x, red, phase);
    __syncthreads();
  }
  for (int i = tid; i < 3 * n; i += kThreads) t_out[i] = x[i];
}

// Closed-form inverse of a symmetric 3x3 (upper triangle in, upper out):
// bundle/ba.py::_inv3x3, adjugate over the determinant, |det| floored at 1e-30.
__device__ void inv3_sym(const float m[6], float out[6]) {
  const float a = m[0], b = m[1], c = m[2], d = m[1], e = m[3], f = m[4], g = m[2], h = m[4], i = m[5];
  const float A = e * i - f * h, B = c * h - b * i, C = b * f - c * e;
  const float D = f * g - d * i, E = a * i - c * g, F = c * d - a * f;
  const float G = d * h - e * g, I = a * e - b * d;
  const float det = a * A + b * D + c * G;
  const float inv_det = 1.f / (fabsf(det) < 1e-30f ? 1e-30f : det);
  out[0] = A * inv_det;
  out[1] = B * inv_det;
  out[2] = C * inv_det;
  out[3] = E * inv_det;
  out[4] = F * inv_det;
  out[5] = I * inv_det;
}

__global__ void __launch_bounds__(kThreads, 1)
gauss_newton_kernel(Graph g, const float* __restrict__ t_in, float* __restrict__ t_out, float* ws, int gn_iters) {
  __shared__ float red[2 * 3 * kWarps];
  int phase = 0;
  const int n = g.n, E = g.E, tid = threadIdx.x;
  float* Y = edge_products_of(ws, E);
  float* t = nodes_of(ws, E);
  float* dx = t + 3 * n;  // the PCG's iterate, from zero
  float* r = t + 6 * n;
  float* p = t + 9 * n;
  float* Ap = t + 12 * n;
  float* damp = t + 15 * n;  // (n, 3) diagonal
  float* minv = t + 18 * n;  // (n, 6)
  float* jtj = ws;  // (E, 6)
  float* jtr = ws + 6 * E;  // (E, 3)
  const HessianOp op{jtj, damp, minv};

  for (int i = tid; i < 3 * n; i += kThreads) t[i] = t_in[i];
  __syncthreads();
  for (int step = 0; step < gn_iters; ++step) {
    // Chordal (or metric) residuals, Huber weights, P, JtJ_e and Jtr_e.
    for (int e = tid; e < E; e += kThreads) {
      const int a = g.a(e), b = g.b(e);
      const float sg = g.sig(e);
      const bool met = g.metric(e);
      float dv[3], u[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        dv[i] = t[3 * b + i] - t[3 * a + i];
        u[i] = __ldg(g.u + 3 * e + i);
      }
      const float dn = fmaxf(sqrtf(dv[0] * dv[0] + dv[1] * dv[1] + dv[2] * dv[2]), 1e-9f);
      float d[3], res[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        d[i] = dv[i] / dn;
        res[i] = met ? (dv[i] - u[i]) / sg : (d[i] - u[i]) / sg;
      }
      const float err = sqrtf(res[0] * res[0] + res[1] * res[1] + res[2] * res[2]);
      const float w_rob = fminf(kHuberK / fmaxf(err, 1e-9f), 1.f) * __ldg(g.w_edge + e);
      float P[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float eye = i == j ? 1.f : 0.f;
          P[i][j] = met ? eye / sg : (eye - d[i] * d[j]) / (dn * sg);
        }
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = i; j < 3; ++j)
          jtj[6 * e + sym_index(i, j)] = (P[0][i] * P[0][j] + P[1][i] * P[1][j] + P[2][i] * P[2][j]) * w_rob;
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) jtr[3 * e + i] = (P[0][i] * res[0] + P[1][i] * res[1] + P[2][i] * res[2]) * w_rob;
    }
    __syncthreads();
    // Per node: Hd, the damping, g, M^-1, and the PCG's start from dx = 0.
    float rz[1] = {0.f};
    for (int v = tid; v < n; v += kThreads) {
      float hb[6], ha[6], gb[3], ga[3];
      g.gather<6>(v, jtj, hb, ha);
      g.gather<3>(v, jtr, gb, ga);
      float m[6];
#pragma unroll
      for (int q = 0; q < 6; ++q) m[q] = ha[q] + hb[q];  // Hd
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int ii = sym_index(i, i);
        const float dmp = 1e-3f * m[ii] + 1e-8f;
        damp[3 * v + i] = dmp;
        m[ii] = m[ii] + dmp;
      }
      float mi[6];
      inv3_sym(m, mi);
#pragma unroll
      for (int q = 0; q < 6; ++q) minv[6 * v + q] = mi[q];
      float rv[3], z[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        rv[i] = -(gb[i] - ga[i]);
        r[3 * v + i] = rv[i];
        dx[3 * v + i] = 0.f;
      }
      op.precond(v, rv, z);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        p[3 * v + i] = z[i];
        rz[0] += rv[i] * z[i];
      }
    }
    block_sum<1>(rz, red, phase);
    pcg(g, op, Y, dx, r, p, Ap, rz[0], red, phase);
    subtract_mean(n, dx, red, phase);
    for (int v = tid; v < n; v += kThreads) {  // the owner of dx[v], as in subtract_mean
#pragma unroll
      for (int i = 0; i < 3; ++i) t[3 * v + i] = t[3 * v + i] + dx[3 * v + i];
    }
    __syncthreads();
  }
  for (int i = tid; i < 3 * n; i += kThreads) t_out[i] = t[i];
}

Graph make_graph(const long long* ea, const long long* eb, const float* u, const float* w_edge,
                 const float* is_metric, const float* sigma, const int* incidence, int n, int E) {
  const int* offsets = incidence;
  return Graph{n, E, ea, eb, u, w_edge, is_metric, sigma, offsets, offsets + n + 1, offsets + 2 * n + 1};
}

}  // namespace

// C interface (loaded with ctypes).

// Floats of the workspace a launch of either phase needs.
extern "C" long long gtsfm_ta_workspace_floats(int n, int E) {
  return static_cast<long long>(kEdgeFloats + 3) * E + static_cast<long long>(kGnNodeFloats) * n;
}

// The phases. Device pointers: ea, eb (E,) int64 node indices below n; u
// (E, 3), w_edge (E,), is_metric and sigma (E,) or null float32; incidence,
// int32, the host's incidence list as offsets (n + 1), split (n) and edge
// (2E) back to back; t_in, t_out (n, 3) float32 (distinct); workspace
// float32 of gtsfm_ta_workspace_floats(n, E). One launch of one block on
// `stream`; allocates nothing, does not synchronise. Returns the
// cudaError_t of the launch (0 = success).

extern "C" int gtsfm_ta_irls_f32(const long long* ea, const long long* eb, const float* u, const float* w_edge,
                                 const float* is_metric, const float* sigma, const int* incidence,
                                 const float* t_in, float* t_out, float* workspace, int n, int E, int iters,
                                 int normalize_gauge, void* stream) {
  if (n <= 0 || E < 0 || iters < 0) return (int)cudaErrorInvalidValue;
  irls_kernel<<<1, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      make_graph(ea, eb, u, w_edge, is_metric, sigma, incidence, n, E), t_in, t_out, workspace, iters,
      normalize_gauge);
  return (int)cudaGetLastError();
}

extern "C" int gtsfm_ta_gauss_newton_f32(const long long* ea, const long long* eb, const float* u,
                                         const float* w_edge, const float* is_metric, const float* sigma,
                                         const int* incidence, const float* t_in, float* t_out, float* workspace,
                                         int n, int E, int gn_iters, void* stream) {
  if (n <= 0 || E < 0 || gn_iters < 0) return (int)cudaErrorInvalidValue;
  gauss_newton_kernel<<<1, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      make_graph(ea, eb, u, w_edge, is_metric, sigma, incidence, n, E), t_in, t_out, workspace, gn_iters);
  return (int)cudaGetLastError();
}
