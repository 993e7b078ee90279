// Hand-written Hopper (sm_90a) kernel: the agents' clipped AdamW step,
// the gradient norm and the update in one launch.
//
// Replaces no Pallas kernel: the reference computes the step in XLA
// (src/repro/train/optimizer.py adamw, vmapped over the agents by
// src/repro/core/agent.py).  It takes over `optimizer.update_lanes`' torch
// ops on the card (kernels/adamw_lanes/ref.py: `batched_linear.sq_norm`,
// the clip, and ~14 elementwise launches for each of the 8 leaves).  For
// each agent g, over its leaves (up to 16, sorted by name):
//   norm  = sqrt(sum over the leaves, in order, of the sum of squares),
//           in `sq_norm_kernel`'s order (csrc/batched_linear.cu): 256
//           columns, column t summing elements t, t + 256, ... of a leaf
//           in order, then the fixed shared-memory tree, leaf by leaf;
//   scale = min(clip * (1 / (norm + 1e-9)), 1), as torch evaluates
//           `clip / (norm + 1e-9)` (a reciprocal, then a product);
//   g'    = g * scale; m = b1 m + (1 - b1) g'; v = b2 v + (1 - b2) g' g';
//   p     = p - lr (m / bc1) / (sqrt(v / bc2) + eps) [+ wd p in the delta],
// each operation rounded once in float32 in `update_lanes`' order, with the
// scalars rounded to float32 as torch rounds a Python scalar, and bc1,
// bc2, lr the (G,) tensors `update_lanes` computes.  So the new
// parameters and moments are the bits of the torch ops.  Built with
// -fmad=false.
//
// What bounds it on this card: bytes.  An agent reads g, m, v, p and
// writes p, m, v: 28 bytes an element, ~0.9 MB for the paper's network,
// ~12 us at G = 45 at 3.35 TB/s.  The design: one agent is a cluster of 8
// CTAs; CTA c owns columns [32c, 32c + 32) of every leaf (each leaf seen
// as rows of 256), stages its columns of g in shared memory (8 loads a
// thread in flight at once), sums its 32 columns' squares (a warp a
// leaf), and pushes the 32 column sums of every leaf into every CTA's
// table through distributed shared memory; after one cluster barrier
// each CTA runs the same tree on the whole table, so all 8 hold the same
// norm, and updates its own elements (8 a thread, every load first).
// The leaf table is copied into shared memory at the start: looked up in
// the kernel's parameters by a run-time leaf, each element's pointer and
// bounds were dependent constant-bank loads, and the launch took 18.0
// against 12.7 us at G = 1 (NVIDIA H100 80GB HBM3, 700 W).
//
// Limits (the launcher returns cudaErrorInvalidValue beyond them): 1 to
// 16 leaves of at most 1664 rows of 256 elements an agent (a CTA's columns
// within 208 KB of shared memory).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_async.cuh"

namespace {

constexpr int kC = 8;             // CTAs an agent (the cluster)
constexpr int kThreads = 256;     // also sq_norm's columns
constexpr int kCols = kThreads / kC;
constexpr int kMaxLeaves = 16;
constexpr int kMaxRows = 1664;    // 256-element rows of an agent's leaves
constexpr int kBatch = 8;         // elements a thread has in flight

struct Leaf {
  const float *g, *m, *v, *p;
  float *p_out, *m_out, *v_out;
  long long n;                    // elements an agent
  long long row0;                 // first staged row
};

struct Leaves {
  Leaf leaf[kMaxLeaves];
  int L, rows;
};

struct Consts {
  float b1, omb1, b2, omb2, eps, clip, wd;   // omb = 1 - b
};

// Staged element e of CTA c: its leaf l and its index in the agent's row of
// that leaf (>= n past the leaf's end).
__device__ __forceinline__ long long locate(const Leaf* sl,
                                            const unsigned char* leaf_of,
                                            int c, int e, int& l) {
  const int r = e / kCols;
  l = leaf_of[r];
  return (r - sl[l].row0) * kThreads + c * kCols + e % kCols;
}

__global__ void __cluster_dims__(kC, 1, 1) __launch_bounds__(kThreads, 1)
adamw_lanes_kernel(const __grid_constant__ Leaves lv,
                   const __grid_constant__ Consts k, const float* bc1,
                   const float* bc2, const float* lr) {
  extern __shared__ __align__(16) float gs[];   // [row][kCols]
  __shared__ float part[kMaxLeaves][kThreads];
  __shared__ Leaf sl[kMaxLeaves];
  __shared__ unsigned char leaf_of[kMaxRows];
  const int c = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const int L = lv.L, rows = lv.rows, elems = rows * kCols;

  // the leaf table into shared memory (8 bytes a thread), then each staged
  // row's leaf: indexing the kernel's parameters by a run-time leaf costs
  // a dependent constant-bank load each time
  {
    const auto* src = reinterpret_cast<const unsigned long long*>(lv.leaf);
    auto* dst = reinterpret_cast<unsigned long long*>(sl);
    for (int e = tid; e < L * (int)(sizeof(Leaf) / 8); e += kThreads)
      dst[e] = src[e];
  }
  __syncthreads();
  for (int r = tid; r < rows; r += kThreads) {
    int l = 0;
    while (l + 1 < L && r >= sl[l + 1].row0) ++l;
    leaf_of[r] = (unsigned char)l;
  }
  __syncthreads();

  // this CTA's columns of g, kBatch loads a thread in flight at once;
  // zero past a leaf's end (a square that adds nothing)
  for (int e0 = tid; e0 < elems; e0 += kBatch * kThreads) {
    float x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      x[u] = 0.f;
      if (e < elems) {
        int l;
        const long long i = locate(sl, leaf_of, c, e, l);
        if (i < sl[l].n) x[u] = sl[l].g[g * sl[l].n + i];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (e0 + u * kThreads < elems) gs[e0 + u * kThreads] = x[u];
  }
  cluster_arrive_relaxed();
  __syncthreads();

  // column sums of squares, ascending rows, a warp a leaf
  const int warp = tid / 32, lane = tid % 32;
  float sums[kMaxLeaves / (kThreads / 32)];
  for (int l = warp, j = 0; l < L; l += kThreads / 32, ++j) {
    const int end = l + 1 < L ? (int)sl[l + 1].row0 : rows;
    float acc = 0.f;
#pragma unroll 8
    for (int r = (int)sl[l].row0; r < end; ++r) {
      const float x = gs[r * kCols + lane];
      acc = __fadd_rn(acc, __fmul_rn(x, x));
    }
    sums[j] = acc;
  }
  cluster_wait();
  for (int l = warp, j = 0; l < L; l += kThreads / 32, ++j)
    for (int r = 0; r < kC; ++r)
      st_cluster(&part[l][c * kCols + lane], r, sums[j]);
  cluster_arrive();
  cluster_wait();             // every leaf's 256 column sums here

  // sq_norm's tree, every leaf at once
  for (int lg = 7; lg >= 0; --lg) {
    for (int e = tid; e < (L << lg); e += kThreads) {
      const int l = e >> lg, t = e & ((1 << lg) - 1);
      part[l][t] = __fadd_rn(part[l][t], part[l][t + (1 << lg)]);
    }
    __syncthreads();
  }
  static_assert(kThreads == 256, "the tree's first level is 128");
  float total = 0.f;
  for (int l = 0; l < L; ++l) total = __fadd_rn(total, part[l][0]);
  const float norm = __fsqrt_rn(total);
  const bool clip = k.clip > 0.f;
  float scale = 1.f;
  if (clip) {
    const float r = __fmul_rn(__fdiv_rn(1.f, __fadd_rn(norm, 1e-9f)),
                              k.clip);
    scale = r > 1.f ? 1.f : r;
  }

  // the update, kBatch elements a thread: every load first, then the
  // arithmetic and the stores
  const float bc1g = bc1[g], bc2g = bc2[g], lrg = lr[g];
  for (int e0 = tid; e0 < elems; e0 += kBatch * kThreads) {
    int ls[kBatch];
    long long os[kBatch];
    float m0[kBatch], v0[kBatch], p0[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      ls[u] = 0;
      os[u] = -1;
      if (e < elems) {
        const long long i = locate(sl, leaf_of, c, e, ls[u]);
        const Leaf& lf = sl[ls[u]];
        if (i < lf.n) {
          os[u] = g * lf.n + i;
          m0[u] = lf.m[os[u]];
          v0[u] = lf.v[os[u]];
          p0[u] = lf.p[os[u]];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (os[u] < 0) continue;
      const Leaf& lf = sl[ls[u]];
      const long long o = os[u];
      const float gv = gs[e0 + u * kThreads];
      const float gr = clip ? __fmul_rn(gv, scale) : gv;
      const float m = __fadd_rn(__fmul_rn(m0[u], k.b1),
                                __fmul_rn(k.omb1, gr));
      const float v = __fadd_rn(__fmul_rn(v0[u], k.b2),
                                __fmul_rn(__fmul_rn(k.omb2, gr), gr));
      float delta = __fdiv_rn(
          __fdiv_rn(m, bc1g), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2g)),
                                        k.eps));
      if (k.wd != 0.f) delta = __fadd_rn(delta, __fmul_rn(k.wd, p0[u]));
      lf.p_out[o] = __fsub_rn(p0[u], __fmul_rn(lrg, delta));
      lf.m_out[o] = m;
      lf.v_out[o] = v;
    }
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One clipped AdamW step for G agents over L leaves.  ptrs holds 7 x L
// pointers, leaf by leaf in order: g, m, v, p, then the new p, m, v (each
// contiguous (G, n[l]) float32, 16-byte aligned); consts b1, 1 - b1, b2,
// 1 - b2, eps, clip (<= 0: none), weight decay; bc1, bc2, lr (G,).
int adamw_lanes_launch(const void* const* ptrs, const long long* n, int L,
                       int G, const float* consts, const void* bc1,
                       const void* bc2, const void* lr, void* stream) {
  if (L < 1 || L > kMaxLeaves || G < 1 || G > 65535)
    return (int)cudaErrorInvalidValue;
  Leaves lv{};
  lv.L = L;
  long long rows = 0;
  for (int l = 0; l < L; ++l) {
    if (n[l] < 0) return (int)cudaErrorInvalidValue;
    const void* const* q = ptrs + 7 * l;
    auto in = [&](int i) { return static_cast<const float*>(q[i]); };
    auto out = [&](int i) {
      return static_cast<float*>(const_cast<void*>(q[i]));
    };
    lv.leaf[l] = Leaf{in(0), in(1), in(2), in(3), out(4), out(5), out(6),
                      n[l], rows};
    rows += (n[l] + kThreads - 1) / kThreads;
    if (rows > kMaxRows) return (int)cudaErrorInvalidValue;
  }
  lv.rows = (int)rows;
  const Consts k{consts[0], consts[1], consts[2], consts[3], consts[4],
                 consts[5], consts[6]};
  const size_t smem = (size_t)rows * kCols * sizeof(float);
  static size_t smem_set = 0;   // the attribute only grows
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        adamw_lanes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  adamw_lanes_kernel<<<dim3(kC, G), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      lv, k, static_cast<const float*>(bc1), static_cast<const float*>(bc2),
      static_cast<const float*>(lr));
  return (int)cudaGetLastError();
}

}  // extern "C"
