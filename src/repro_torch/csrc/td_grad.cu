// Hand-written Hopper (sm_90a) kernel: the agents' TD step, forward, loss
// and backward of the dueling Q network in one launch.
//
// Replaces no Pallas kernel: the reference computes the TD step's products
// and sums as one XLA program (jax.value_and_grad of
// src/repro/core/dqn.py td_loss, src/repro/core/agent.py:181-200).  It
// takes over the twelve `csrc/batched_linear.cu` launches and the torch ops
// around them of one TD step: for each of G agents, given the replay
// minibatch (s (64, S), a, the targets y, the row weights w) and `ready`,
//   h1 = relu(s W0 + b0), h2 = relu(h1 W1 + b1), V = h2 W_v + b_v,
//   A = h2 W_a + b_a, Q = V + A - mean(A), q_sa = Q[a],
//   err = (y - q_sa) w, loss = sum(err^2) / max(sum(w), 1),
// and the gradient of the loss for all 8 leaves, each times `ready`.  The
// plain version is repro_torch/kernels/td_grad/ref.py (autograd of the
// same forward); the targets y come from the dueling-qnet kernel.
//
// What bounds it on this card: latency.  An agent is ~10 MFLOP at S 106
// (~5 M multiply-adds) and ~280 KB of weights, inputs and gradients, so
// at G = 45 the f32 operations bound is ~7 us and the bytes bound ~4 us;
// on one SM the chain of dependent products alone would take ~20 us.  The
// design spreads one agent over a thread-block cluster and keeps
// everything on chip:
//  - One agent is one cluster of 8 CTAs (256 threads each).  CTA c owns
//    hidden units [16c, 16c + 16) of both layers: their forward
//    pre-activations, their share of the backward's dh, and their columns
//    of dW0 / dW1 (and rows of dW_v / dW_a).  After each layer the CTA
//    pushes its slice of h1, h2 or dpre2 into every CTA's shared memory
//    through distributed shared memory (st.shared::cluster), and a
//    cluster barrier (release / acquire) hands the whole matrix to the
//    next product.  The head (9 outputs per row), the dueling combine and
//    the loss are small: every CTA computes them, the same bits in each.
//  - Every operand arrives by asynchronous copies issued at the start, on
//    three barriers, so layer 1 starts as soon as its inputs have landed
//    while the rest are in flight.  The contiguous ones (s, the bias
//    slices, the CTA's 16 rows of W1 for dh1, W_v, W_a, y, w, a) are bulk
//    copies (cp.async.bulk on mbarriers), one a lane of warp 0.  The CTA's
//    16 columns of W0's and W1's rows, 64 bytes a row, are cp.async copies
//    of 16 bytes, every thread a share, in two groups: one 64-byte bulk
//    copy a row, issued one after the other by warp 0, took 4-5 us more at
//    G = 1 (the whole launch 28.7 against 24.0 us, NVIDIA H100 80GB HBM3).
//    So a CTA stages S x 16 of W0, not S x 128: at S 300 (the 8x8 mesh's
//    298) the whole working set, inputs, weights, activations and
//    gradients, is 225 KB.
//  - Each product is register-tiled FFMA out of shared memory (a thread
//    4 outputs of one row; 4 x 4 of dW1; 8 of one weight row for dW0);
//    rows of h1, h2 and dpre2 are padded to 132 floats so a warp's reads
//    fall in distinct banks.
// No tensor cores: the contract is full float32 with TF32 off, and the
// cost is latency, not throughput.
//
// Order (built with -fmad=false): every output is one thread's sum in
// ascending k, one __fmaf_rn each from 0, the bias added after
// (csrc/batched_linear.cu's order); the row sums of dW and db ascend over
// the 64 rows; the dueling mean sums its 8 actions in order and scales by
// 1/8; the loss sums its rows in order; dh2 = dv * w_v + (da W_a^T), as
// autograd adds the two heads' input gradients.  The split is over output
// units only, so an agent's results do not depend on G.
//
// Limits (the launcher returns cudaErrorInvalidValue beyond them): 64 rows,
// hidden 128 / 128, 8 actions, 1 <= S <= 300, 16-byte aligned pointers
// (checked by the wrapper).  An action outside [0, 8) gives a NaN loss.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_async.cuh"

namespace {

constexpr int kN = 64;          // replay rows
constexpr int kH = 128;         // hidden width, both layers
constexpr int kA = 8;           // actions
constexpr int kO = kA + 1;      // head outputs a row: V, A_0 .. A_7
constexpr int kC = 8;           // CTAs an agent (the cluster)
constexpr int kU = kH / kC;     // hidden units a CTA owns
constexpr int kThreads = 256;
constexpr int kHP = kH + 4;     // padded row of h1, h2, dpre2
constexpr int kMaxS = 300;
constexpr int kMaxSmem = 232448 - 64;     // less the static barriers

static_assert(kThreads == kN * 4 && kU == 16, "thread tiles assume these");

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Shared-memory plan, in floats from the start of the dynamic buffer (every
// region on a 16-byte boundary, at the same offset in every CTA).
struct Plan {
  int S, sx, w0s, w1c, w1r, wa, wv, bias, yv, rw, av, h1, h2, dp2, p1, p2,
      hd, red, total;
  __host__ __device__ explicit Plan(int S_) : S(S_) {
    int o = 0;
    sx = o;   o += round4(kN * S);    // the minibatch s, row-major
    w0s = o;  o += S * kU;            // W0[k][c*16 .. +16]
    w1c = o;  o += kH * kU;           // W1[k][c*16 .. +16]; later W1's rows
                                      // transposed: [j][c*16 .. +16]
    w1r = o;  o += kU * kH;           // W1[c*16 .. +16][j]
    wa = o;   o += kH * kA;
    wv = o;   o += kH;
    bias = o; o += 48;                // b0 slice | b1 slice | b_a | b_v
    yv = o;   o += kN;
    rw = o;   o += kN;
    av = o;   o += kN;                // actions (int32)
    h1 = o;   o += kN * kHP;
    h2 = o;   o += kN * kHP;
    dp2 = o;  o += kN * kHP;          // dpre2, all 128 units
    p1 = o;   o += kN * kU;           // pre1 slice, then dpre1 slice
    p2 = o;   o += kN * kU;           // pre2 slice, then dpre2 slice
    hd = o;   o += round4(kN * kO);   // head sums, then the head gradient
    red = o;  o += kN + 4;            // per-row err^2, the loss denominator
    total = o;
  }
};
constexpr int kB0 = 0, kB1 = 16, kBA = 32, kBV = 40;   // offsets in bias

struct Args {
  const float* s;
  const int* act;
  const float *y, *w, *ready;
  const float *w0, *b0, *w1, *b1, *wv, *bv, *wa, *ba;
  float* loss;
  float *gw0, *gb0, *gw1, *gb1, *gwv, *gbv, *gwa, *gba;
  int S;
};

constexpr int kCopies = 10;   // the bulk copies of an agent's CTA

__host__ __device__ constexpr uint32_t bytes0(int S) {
  return (uint32_t)(kN * S + kU) * 4;
}
constexpr uint32_t kBytes1 = kU * 4;
constexpr uint32_t kBytes2 = (kU * kH + kH * kA + kH + kA + 3 * kN) * 4;

// Bulk copy i of the CTA's contiguous operands, issued by lane i of warp 0:
// s and the b0 slice on bar 0, the b1 slice on bar 1, the rest on bar 2.
__device__ void issue_copy(int i, const Args& p, const Plan& pl, int g, int c,
                           float* sm, uint64_t* bar) {
  const int S = pl.S;
  const size_t gH = (size_t)g * kH;
  switch (i) {
    case 0: bulk_g2s(sm + pl.sx, p.s + (size_t)g * kN * S, kN * S * 4,
                     &bar[0]); break;
    case 1: bulk_g2s(sm + pl.bias + kB0, p.b0 + gH + c * kU, kU * 4, &bar[0]);
            break;
    case 2: bulk_g2s(sm + pl.bias + kB1, p.b1 + gH + c * kU, kU * 4, &bar[1]);
            break;
    case 3: bulk_g2s(sm + pl.w1r, p.w1 + (gH + c * kU) * kH, kU * kH * 4,
                     &bar[2]); break;
    case 4: bulk_g2s(sm + pl.wa, p.wa + gH * kA, kH * kA * 4, &bar[2]); break;
    case 5: bulk_g2s(sm + pl.wv, p.wv + gH, kH * 4, &bar[2]); break;
    case 6: bulk_g2s(sm + pl.bias + kBA, p.ba + (size_t)g * kA, kA * 4,
                     &bar[2]); break;
    case 7: bulk_g2s(sm + pl.yv, p.y + (size_t)g * kN, kN * 4, &bar[2]); break;
    case 8: bulk_g2s(sm + pl.rw, p.w + (size_t)g * kN, kN * 4, &bar[2]); break;
    case 9: bulk_g2s(sm + pl.av, p.act + (size_t)g * kN, kN * 4, &bar[2]);
            break;
  }
}

// 16 bytes from global `src` to shared `dst` (cp.async, in the thread's
// current group).
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// The CTA's 16 columns of K rows of a (K, 128) weight matrix into
// dst[K][16], 16 bytes a thread, then one cp.async group.
__device__ __forceinline__ void copy_columns(float* dst, const float* src,
                                             int K, int c) {
  for (int e = threadIdx.x; e < K * 4; e += kThreads)
    copy16(dst + (e >> 2) * kU + (e & 3) * 4,
           src + (size_t)(e >> 2) * kH + c * kU + (e & 3) * 4);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ float relu(float x) { return x < 0.f ? 0.f : x; }

// 4 outputs of row n: sum_k act[n][k] * wt[k][q*4 .. +4], ascending k.
__device__ __forceinline__ void row_by_slab(const float* act, const float* wt,
                                            int K, float acc[4]) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float x = act[k];
    const float4 w4 = *reinterpret_cast<const float4*>(wt + k * kU);
    acc[0] = __fmaf_rn(x, w4.x, acc[0]);
    acc[1] = __fmaf_rn(x, w4.y, acc[1]);
    acc[2] = __fmaf_rn(x, w4.z, acc[2]);
    acc[3] = __fmaf_rn(x, w4.w, acc[3]);
  }
}

// 8 outputs of weight row k: sum_r act[r * stride + k] * d[r][jh*8 .. +8]
// over the 64 rows in order, times `rdy`, stored to out[0 .. 8).
__device__ __forceinline__ void weight_grad_row(const float* act, int stride,
                                                const float* d, float rdy,
                                                float* out) {
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int r = 0; r < kN; ++r) {
    const float x = act[r * stride];
    const float4 a4 = *reinterpret_cast<const float4*>(d + r * kU);
    const float4 b4 = *reinterpret_cast<const float4*>(d + r * kU + 4);
    acc[0] = __fmaf_rn(x, a4.x, acc[0]);
    acc[1] = __fmaf_rn(x, a4.y, acc[1]);
    acc[2] = __fmaf_rn(x, a4.z, acc[2]);
    acc[3] = __fmaf_rn(x, a4.w, acc[3]);
    acc[4] = __fmaf_rn(x, b4.x, acc[4]);
    acc[5] = __fmaf_rn(x, b4.y, acc[5]);
    acc[6] = __fmaf_rn(x, b4.z, acc[6]);
    acc[7] = __fmaf_rn(x, b4.w, acc[7]);
  }
  reinterpret_cast<float4*>(out)[0] =
      make_float4(__fmul_rn(acc[0], rdy), __fmul_rn(acc[1], rdy),
                  __fmul_rn(acc[2], rdy), __fmul_rn(acc[3], rdy));
  reinterpret_cast<float4*>(out)[1] =
      make_float4(__fmul_rn(acc[4], rdy), __fmul_rn(acc[5], rdy),
                  __fmul_rn(acc[6], rdy), __fmul_rn(acc[7], rdy));
}

// The bias gradient of unit `u` of a slice: sum over the rows in order.
__device__ __forceinline__ float bias_grad(const float* d, int u, float rdy) {
  float acc = 0.f;
#pragma unroll 16
  for (int r = 0; r < kN; ++r) acc = __fadd_rn(acc, d[r * kU + u]);
  return __fmul_rn(acc, rdy);
}

__global__ void __cluster_dims__(kC, 1, 1) __launch_bounds__(kThreads, 1)
td_grad_kernel(const __grid_constant__ Args p) {
  extern __shared__ __align__(128) float sm[];
  __shared__ __align__(8) uint64_t bar[3];
  const Plan pl(p.S);
  const int S = p.S, c = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const int n = tid >> 2, q = tid & 3;   // a row, a quad of units

  if (tid == 0) {
    for (int b = 0; b < 3; ++b) mbar_init(&bar[b], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid == 32) sm[pl.bias + kBV] = p.bv[g];
  const float rdy = p.ready[g];
  __syncthreads();
  if (tid < 32) {
    if (tid == 0) {
      mbar_expect_tx(&bar[0], bytes0(S));
      mbar_expect_tx(&bar[1], kBytes1);
      mbar_expect_tx(&bar[2], kBytes2);
    }
    __syncwarp();
    if (tid < kCopies) issue_copy(tid, p, pl, g, c, sm, bar);
  }
  copy_columns(sm + pl.w0s, p.w0 + (size_t)g * S * kH, S, c);
  copy_columns(sm + pl.w1c, p.w1 + (size_t)g * kH * kH, kH, c);
  cluster_arrive_relaxed();   // started: the others may write here now

  // ---- layer 1: pre1 = s W0 + b0 on this CTA's units; h1 to every CTA ----
  mbar_wait(&bar[0], 0);
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");   // W0's columns
  __syncthreads();
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  row_by_slab(sm + pl.sx + n * S, sm + pl.w0s + q * 4, S, acc);
  const float* b0 = sm + pl.bias + kB0 + q * 4;
  float4 pre = make_float4(__fadd_rn(acc[0], b0[0]), __fadd_rn(acc[1], b0[1]),
                           __fadd_rn(acc[2], b0[2]), __fadd_rn(acc[3], b0[3]));
  *reinterpret_cast<float4*>(sm + pl.p1 + n * kU + q * 4) = pre;
  float4 h = make_float4(relu(pre.x), relu(pre.y), relu(pre.z), relu(pre.w));
  cluster_wait();
  for (int r = 0; r < kC; ++r)
    st_cluster4(sm + pl.h1 + n * kHP + c * kU + q * 4, r, h);
  cluster_arrive();
  mbar_wait(&bar[1], 0);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");   // W1's columns
  __syncthreads();
  cluster_wait();             // h1 whole in every CTA

  // ---- layer 2 ----
  acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
  row_by_slab(sm + pl.h1 + n * kHP, sm + pl.w1c + q * 4, kH, acc);
  const float* b1 = sm + pl.bias + kB1 + q * 4;
  pre = make_float4(__fadd_rn(acc[0], b1[0]), __fadd_rn(acc[1], b1[1]),
                    __fadd_rn(acc[2], b1[2]), __fadd_rn(acc[3], b1[3]));
  *reinterpret_cast<float4*>(sm + pl.p2 + n * kU + q * 4) = pre;
  h = make_float4(relu(pre.x), relu(pre.y), relu(pre.z), relu(pre.w));
  for (int r = 0; r < kC; ++r)
    st_cluster4(sm + pl.h2 + n * kHP + c * kU + q * 4, r, h);
  cluster_arrive();
  mbar_wait(&bar[2], 0);
  cluster_wait();             // h2 whole in every CTA

  // ---- head sums [V | A] (without biases) for every row, in every CTA:
  // two threads a row, one V and A_0..3, the other A_4..7 ----
  if (tid < kN * 2) {
    const int hn = tid >> 1, half = tid & 1;
    const float* hr = sm + pl.h2 + hn * kHP;
    const float* wa = sm + pl.wa + half * 4;
    float sv = 0.f, s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int k = 0; k < kH; ++k) {
      const float x = hr[k];
      const float4 w4 = *reinterpret_cast<const float4*>(wa + k * kA);
      s4[0] = __fmaf_rn(x, w4.x, s4[0]);
      s4[1] = __fmaf_rn(x, w4.y, s4[1]);
      s4[2] = __fmaf_rn(x, w4.z, s4[2]);
      s4[3] = __fmaf_rn(x, w4.w, s4[3]);
      if (half == 0) sv = __fmaf_rn(x, sm[pl.wv + k], sv);
    }
    float* out = sm + pl.hd + hn * kO;
    if (half == 0) out[0] = sv;
    for (int i = 0; i < 4; ++i) out[1 + half * 4 + i] = s4[i];
  }
  __syncthreads();

  // ---- dueling combine, TD error, loss ----
  const int* av = reinterpret_cast<const int*>(sm + pl.av);
  float err = 0.f;
  if (tid < kN) {
    const float* hr = sm + pl.hd + tid * kO;
    const float* bias = sm + pl.bias;
    const float v = __fadd_rn(hr[0], bias[kBV]);
    float a[kA], sum = 0.f;
    for (int j = 0; j < kA; ++j) {
      a[j] = __fadd_rn(hr[1 + j], bias[kBA + j]);
      sum = __fadd_rn(sum, a[j]);
    }
    const float mean = __fmul_rn(sum, 1.f / kA);
    const int act = av[tid];
    float q_sa = __int_as_float(0x7fc00000);
    for (int j = 0; j < kA; ++j)
      if (j == act) q_sa = __fsub_rn(__fadd_rn(v, a[j]), mean);
    err = __fmul_rn(__fsub_rn(sm[pl.yv + tid], q_sa), sm[pl.rw + tid]);
    sm[pl.red + tid] = __fmul_rn(err, err);
  }
  __syncthreads();
  if (tid == 0) {
    float ls = 0.f, wsum = 0.f;
#pragma unroll 16
    for (int r = 0; r < kN; ++r) {
      ls = __fadd_rn(ls, sm[pl.red + r]);
      wsum = __fadd_rn(wsum, sm[pl.rw + r]);
    }
    const float den = wsum < 1.f ? 1.f : wsum;
    sm[pl.red + kN] = den;
    if (c == 0) p.loss[g] = __fdiv_rn(ls, den);
  }
  __syncthreads();
  // head gradient, in place of the head sums: dV = dq_sa, dA_j = dq_j -
  // dq_sa / 8, as autograd takes it through the gather and the mean
  if (tid < kN) {
    const float den = sm[pl.red + kN];
    const float gerr = __fmul_rn(__fdiv_rn(1.f, den), __fmul_rn(2.f, err));
    const float dq = -__fmul_rn(gerr, sm[pl.rw + tid]);
    const float dmean = __fdiv_rn(-dq, (float)kA);
    const int act = av[tid];
    float* hr = sm + pl.hd + tid * kO;
    hr[0] = dq;
    for (int j = 0; j < kA; ++j) hr[1 + j] = j == act ? __fadd_rn(dq, dmean)
                                                      : dmean;
  }
  __syncthreads();

  // ---- head backward: dW_v, dW_a rows of this CTA's units; db on CTA 0 ----
  if (tid < kU * kO) {
    const int kk = tid / kO, o = tid % kO, k = c * kU + kk;
    float s1 = 0.f;
#pragma unroll 16
    for (int r = 0; r < kN; ++r)
      s1 = __fmaf_rn(sm[pl.h2 + r * kHP + k], sm[pl.hd + r * kO + o], s1);
    s1 = __fmul_rn(s1, rdy);
    if (o == 0) p.gwv[(size_t)g * kH + k] = s1;
    else p.gwa[((size_t)g * kH + k) * kA + o - 1] = s1;
  } else if (c == 0 && tid < kU * kO + kO) {
    const int o = tid - kU * kO;
    float s1 = 0.f;
#pragma unroll 16
    for (int r = 0; r < kN; ++r) s1 = __fadd_rn(s1, sm[pl.hd + r * kO + o]);
    s1 = __fmul_rn(s1, rdy);
    if (o == 0) p.gbv[g] = s1;
    else p.gba[(size_t)g * kA + o - 1] = s1;
  }
  // dh2 = dV w_v + dA W_a^T on this CTA's units, masked by pre2 >= 0 into
  // dpre2 (in place of pre2), and pushed to every CTA
  {
    const float* hr = sm + pl.hd + n * kO;
    float d[4];
    for (int i = 0; i < 4; ++i) {
      const int k = c * kU + q * 4 + i;
      float sa = 0.f;
      for (int j = 0; j < kA; ++j)
        sa = __fmaf_rn(hr[1 + j], sm[pl.wa + k * kA + j], sa);
      const float dh = __fadd_rn(__fmul_rn(hr[0], sm[pl.wv + k]), sa);
      d[i] = sm[pl.p2 + n * kU + q * 4 + i] >= 0.f ? dh : 0.f;
    }
    const float4 d4 = make_float4(d[0], d[1], d[2], d[3]);
    *reinterpret_cast<float4*>(sm + pl.p2 + n * kU + q * 4) = d4;
    for (int r = 0; r < kC; ++r)
      st_cluster4(sm + pl.dp2 + n * kHP + c * kU + q * 4, r, d4);
  }
  cluster_arrive();

  // ---- while the others' dpre2 arrives: dW1 and db1 of this CTA's units,
  // and W1's rows transposed (into W1's columns, read for the last time by
  // layer 2) ----
  __syncthreads();
  if (tid < kThreads / 2) {
    // dW1[k0 .. k0 + 4][j0 .. j0 + 4]: per row one float4 of h1 and one of
    // dpre2, 16 sums in ascending rows
    const int k0 = (tid >> 2) * 4, j0 = (tid & 3) * 4;
    float d[4][4] = {};
#pragma unroll 4
    for (int r = 0; r < kN; ++r) {
      const float4 x4 = *reinterpret_cast<const float4*>(
          sm + pl.h1 + r * kHP + k0);
      const float4 e4 = *reinterpret_cast<const float4*>(
          sm + pl.p2 + r * kU + j0);
      const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
      const float es[4] = {e4.x, e4.y, e4.z, e4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) d[i][j] = __fmaf_rn(xs[i], es[j], d[i][j]);
    }
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(p.gw1 + ((size_t)g * kH + k0 + i) * kH +
                                 c * kU + j0) =
          make_float4(__fmul_rn(d[i][0], rdy), __fmul_rn(d[i][1], rdy),
                      __fmul_rn(d[i][2], rdy), __fmul_rn(d[i][3], rdy));
  } else {
    const int t = tid - kThreads / 2;
    if (t < kU)
      p.gb1[(size_t)g * kH + c * kU + t] = bias_grad(sm + pl.p2, t, rdy);
    for (int e = t; e < kU * kH; e += kThreads / 2)
      sm[pl.w1c + (e % kH) * kU + e / kH] = sm[pl.w1r + e];
  }
  __syncthreads();
  cluster_wait();             // dpre2 whole in every CTA

  // ---- dh1 = dpre2 W1^T on this CTA's units, masked by pre1 >= 0 ----
  acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
  row_by_slab(sm + pl.dp2 + n * kHP, sm + pl.w1c + q * 4, kH, acc);
  {
    float* p1 = sm + pl.p1 + n * kU + q * 4;
    const float4 d4 = make_float4(p1[0] >= 0.f ? acc[0] : 0.f,
                                  p1[1] >= 0.f ? acc[1] : 0.f,
                                  p1[2] >= 0.f ? acc[2] : 0.f,
                                  p1[3] >= 0.f ? acc[3] : 0.f);
    *reinterpret_cast<float4*>(p1) = d4;
  }
  __syncthreads();

  // ---- dW0 and db0 of this CTA's units ----
  for (int k0 = 0; k0 < S; k0 += kThreads / 2) {
    const int k = k0 + (tid >> 1), jh = tid & 1;
    if (k < S)
      weight_grad_row(sm + pl.sx + k, S, sm + pl.p1 + jh * 8, rdy,
                      p.gw0 + ((size_t)g * S + k) * kH + c * kU + jh * 8);
  }
  if (tid < kU)
    p.gb0[(size_t)g * kH + c * kU + tid] = bias_grad(sm + pl.p1, tid, rdy);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One TD step's loss and gradients for G agents.  s (G, 64, S), act (G, 64)
// int32, y, w (G, 64), ready (G,); w0 (G, S, 128), b0 (G, 128), w1 (G, 128,
// 128), b1 (G, 128), wv (G, 128, 1), bv (G, 1), wa (G, 128, 8), ba (G, 8);
// out: loss (G,) and the gradients in the leaves' shapes.  All contiguous
// float32 (act int32), 16-byte aligned.
int td_grad_launch(const void* s, const void* act, const void* y,
                   const void* w, const void* ready, const void* w0,
                   const void* b0, const void* w1, const void* b1,
                   const void* wv, const void* bv, const void* wa,
                   const void* ba, void* loss, void* gw0, void* gb0,
                   void* gw1, void* gb1, void* gwv, void* gbv, void* gwa,
                   void* gba, int G, int S, void* stream) {
  if (G < 1 || G > 65535 || S < 1 || S > kMaxS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)Plan(S).total * sizeof(float);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static size_t smem_set = 0;   // the attribute only grows
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        td_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  auto f = [](const void* t) { return static_cast<const float*>(t); };
  auto o = [](void* t) { return static_cast<float*>(t); };
  const Args args{f(s), static_cast<const int*>(act), f(y), f(w), f(ready),
                  f(w0), f(b0), f(w1), f(b1), f(wv), f(bv), f(wa), f(ba),
                  o(loss), o(gw0), o(gb0), o(gw1), o(gb1), o(gwv), o(gbv),
                  o(gwa), o(gba), S};
  td_grad_kernel<<<dim3(kC, G), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}

}  // extern "C"
