// Hand-written Hopper (sm_90a) kernel: fused dueling-DQN inference.
//
// Replaces the Pallas kernel `dueling_qnet_fused`
// (src/repro/kernels/dueling_qnet/kernel.py:43): relu(x W0 + b0) ->
// relu(. W1 + b1) -> V (H2 -> 1) and A (H2 -> A), Q = V + A - mean(A).
// The plain torch version is repro_torch/kernels/dueling_qnet/ref.py.
//
// What bounds it on this card: latency.  At the production shape (state
// 106, hidden 128/128, 8 actions) the weights are ~123 KB and the work
// 2 * 31 K multiply-adds per row, so the bytes bound (~40 ns) and the f32
// operations bound (< 0.1 us at 64 rows) are far below one launch.  What
// the time is made of is the chain of dependent steps inside one block:
// fetching the weights, then the multiply-adds that one SM's 128 f32 lanes
// issue in order.  The design shortens both:
//  - Weights arrive by bulk asynchronous copies (`cp.async.bulk`
//    global -> shared, completing on an mbarrier) in K-slabs of up to 32 KB
//    through a three-stage ring: the first three issued at once by lanes of
//    warp 0 while the inputs load, each later one by one thread as a stage
//    frees up, from a slab table the launcher lays out.  The first
//    slab's multiply-adds start while the later slabs are still in flight,
//    and widths beyond one block's shared memory still stream through.
//    The head's W_a and W_v travel as one slab.
//  - Each layer is a register-tiled f32 FFMA product out of shared memory:
//    warp g takes every 16th K row, a lane the tile's 4 rows x 4 units of a
//    128-unit pass (two passes at once where a layer is wider than 128),
//    so a warp reads 32 distinct float4s of weights and one broadcast
//    float4 of transposed activations per k: shared-memory bandwidth, not
//    the FFMAs, is what a tile with fewer rows per lane runs out of.  The
//    16 warps' partial sums are added once per layer.  h1 and h2 stay in
//    shared memory; the dueling combine is done with warp shuffles.
//  - One block per (agent, 4-row tile), so the multiply-adds of a batch
//    spread over its rows' SMs: 16 blocks for the 64-row TD batch, 1 for
//    the act call, each block's chain 4 rows long instead of 64.  Every
//    block stages the whole weights (from L2 after the first).
// No TF32: the bar is 1e-4 against a full-f32 plain version and the f32
// operations bound is ~60 ns, so tensor cores would buy nothing.  Built
// without -fmad=false: an FMA rounds once, and the bar is a tolerance.
//
// Rows that are not a multiple of 16 bytes: a bulk copy moves 16-byte
// multiples from 16-byte-aligned addresses.  When a hidden width is not a
// multiple of 4 floats, (H2 * A) is not, or a weight pointer is not 16-byte
// aligned, the launcher says so and the block's threads copy each slab
// themselves with plain loads instead, into the same layout padded to a
// multiple of 4 floats with zeros.  The production shape never takes that
// branch.  The input rows (any S) are always read by the threads, since
// they are transposed on the way into shared memory.
//
// Limits (the launcher returns cudaErrorInvalidValue beyond them): a weight
// row of at most 8192 floats, W_a and W_v together within one 32 KB stage,
// at most 64 slabs, and the whole layout within 227 KB of shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_async.cuh"

namespace {

constexpr int kRows = 4;             // rows per block
constexpr int kThreads = 512;        // 16 warps, one k-group each
constexpr int kGroups = kThreads / 32;
constexpr int kPass = 128;           // units of one pass (a lane: 4)
constexpr int kStages = 3;
constexpr int kStageFloats = 8192;   // 32 KB per stage
constexpr int kMaxSmem = 232448 - 1024;   // less the static barriers

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Shared-memory plan, in floats from the start of the dynamic buffer;
// every region starts on a 16-byte boundary.
struct Plan {
  int S, H1, H2, A;
  int units;   // units per group: one pass of 128, or two where wider
  int xT, h1T, h2T, red, head, b0, b1, bh, total;
  __host__ __device__ Plan(int S_, int H1_, int H2_, int A_)
      : S(S_), H1(H1_), H2(H2_), A(A_) {
    units = H1 > kPass || H2 > kPass ? 2 * kPass : kPass;
    xT = kStages * kStageFloats;
    h1T = xT + S * kRows;
    h2T = h1T + H1 * kRows;
    red = h2T + H2 * kRows;
    head = red + kGroups * kRows * units;        // k-groups' partial sums
    b0 = head + round4(kRows * (A + 1));          // [V | A] per row
    b1 = b0 + round4(H1);
    bh = b1 + round4(H2);                     // bv then ba
    total = bh + round4(A + 1);
  }
  __host__ __device__ int rows_per_slab(int K, int H) const {
    const int per = kStageFloats / round4(H);
    return K < per ? K : per;
  }
  __host__ __device__ int head_wv() const { return round4(H2 * A); }
};

struct Weights {
  const float *w0, *w1, *wv, *wa;   // this agent's
};

// The slab sequence, laid out by the launcher (so the issuing thread does
// no arithmetic on shapes): layer 0 (W0: S rows of H1), layer 1 (W1: H1
// rows of H2), each as groups of up to 256 units x K-slabs of full rows,
// then the head (W_a then W_v) as one slab.  The consumer loops walk the
// same sequence.
constexpr int kMaxSlabs = 64;
struct SlabTable {
  int n;
  unsigned char layer[kMaxSlabs];   // 0, 1, or 2 for the head
  short k0[kMaxSlabs], rows[kMaxSlabs];
};

SlabTable slab_table(const Plan& pl) {
  SlabTable t{};
  for (int layer = 0; layer < 2; ++layer) {
    const int K = layer ? pl.H1 : pl.S, H = layer ? pl.H2 : pl.H1;
    const int per = pl.rows_per_slab(K, H);
    for (int u0 = 0; u0 < H; u0 += pl.units)
      for (int k0 = 0; k0 < K; k0 += per, ++t.n) {
        if (t.n == kMaxSlabs) return SlabTable{};
        t.layer[t.n] = (unsigned char)layer;
        t.k0[t.n] = (short)k0;
        t.rows[t.n] = (short)(K - k0 < per ? K - k0 : per);
      }
  }
  if (t.n == kMaxSlabs) return SlabTable{};
  t.layer[t.n++] = 2;
  return t;
}

struct Slab {
  const float* src;   // rows [k0, k0 + rows) of a (K, H) matrix
  int rows, H, head;
};

__device__ __forceinline__ Slab slab_at(int i, const SlabTable& t,
                                        const Plan& pl, const Weights& w) {
  const int layer = t.layer[i];
  if (layer == 2) return Slab{w.wa, pl.H2, pl.A, 1};
  const int H = layer ? pl.H2 : pl.H1;
  return Slab{(layer ? w.w1 : w.w0) + (size_t)t.k0[i] * H, t.rows[i], H, 0};
}

// One elected thread: slab i into its stage by bulk copies.
__device__ void issue(int i, const SlabTable& t, const Plan& pl,
                      const Weights& w, float* ring, uint64_t* full) {
  const Slab s = slab_at(i, t, pl, w);
  float* dst = ring + (i % kStages) * kStageFloats;
  uint64_t* bar = full + i % kStages;
  if (s.head) {
    const uint32_t ba = pl.H2 * pl.A * 4, bv = pl.H2 * 4;
    mbar_expect_tx(bar, ba + bv);
    bulk_g2s(dst, w.wa, ba, bar);
    bulk_g2s(dst + pl.head_wv(), w.wv, bv, bar);
  } else {
    const uint32_t bytes = (uint32_t)s.rows * s.H * 4;
    mbar_expect_tx(bar, bytes);
    bulk_g2s(dst, s.src, bytes, bar);
  }
}

// Every thread: slab i into its stage by plain loads, rows padded to a
// multiple of 4 floats with zeros (the unaligned-width path).
__device__ void fill(int i, const SlabTable& t, const Plan& pl,
                     const Weights& w, float* ring) {
  const Slab s = slab_at(i, t, pl, w);
  float* dst = ring + (i % kStages) * kStageFloats;
  if (s.head) {
    for (int e = threadIdx.x; e < pl.H2 * pl.A; e += kThreads) dst[e] = w.wa[e];
    for (int e = threadIdx.x; e < pl.H2; e += kThreads)
      dst[pl.head_wv() + e] = w.wv[e];
    return;
  }
  const int Hp = round4(s.H);
  for (int e = threadIdx.x; e < s.rows * Hp; e += kThreads) {
    const int r = e / Hp, u = e % Hp;
    dst[e] = u < s.H ? s.src[(size_t)r * s.H + u] : 0.f;
  }
}

// NP: passes of 128 units a thread keeps in flight (Plan::units / 128).
template <int NP>
__global__ void __launch_bounds__(kThreads)
dueling_qnet_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                    const float* __restrict__ b0, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ wv,
                    const float* __restrict__ bv, const float* __restrict__ wa,
                    const float* __restrict__ ba, float* __restrict__ q, int N,
                    int S, int H1, int H2, int A, int bulk,
                    const __grid_constant__ SlabTable tab) {
  extern __shared__ __align__(128) float sm[];
  __shared__ __align__(8) uint64_t full[kStages];
  const Plan pl(S, H1, H2, A);
  const int g = blockIdx.y, tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows, rows = min(kRows, N - row0);
  const Weights w{w0 + (size_t)g * S * H1, w1 + (size_t)g * H1 * H2,
                  wv + (size_t)g * H2, wa + (size_t)g * H2 * A};
  float* ring = sm;
  const int total = tab.n;

  // every load from device memory the prologue needs, issued first: the
  // tile's inputs (transposed on the way in: xT[k][r], zero past the last
  // row) and the biases; while they are in flight, warp 0 starts the first
  // slabs' bulk copies, one lane each
  x += ((size_t)g * N + row0) * S;
  for (int base = 0; base < kRows * S; base += kThreads) {
    const int e = base + tid;
    const float v = e < rows * S ? x[e] : 0.f;
    float bias[3] = {0.f, 0.f, 0.f};
    if (base == 0) {
      if (tid < H1) bias[0] = b0[(size_t)g * H1 + tid];
      if (tid < H2) bias[1] = b1[(size_t)g * H2 + tid];
      if (tid <= A) bias[2] = tid == 0 ? bv[g] : ba[(size_t)g * A + tid - 1];
      if (bulk && tid < 32) {
        if (tid == 0) {
          for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
          asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        }
        __syncwarp();
        if (tid < min(kStages, total)) issue(tid, tab, pl, w, ring, full);
      }
    }
    if (e < kRows * S) sm[pl.xT + (e % S) * kRows + e / S] = v;
    if (base == 0) {
      if (tid < H1) sm[pl.b0 + tid] = bias[0];
      if (tid < H2) sm[pl.b1 + tid] = bias[1];
      if (tid <= A) sm[pl.bh + tid] = bias[2];
    }
  }
  for (int e = kThreads + tid; e < H1; e += kThreads)
    sm[pl.b0 + e] = b0[(size_t)g * H1 + e];
  for (int e = kThreads + tid; e < H2; e += kThreads)
    sm[pl.b1 + e] = b1[(size_t)g * H2 + e];
  for (int e = kThreads + tid; e <= A; e += kThreads)
    sm[pl.bh + e] = ba[(size_t)g * A + e - 1];
  __syncthreads();

  // thread tile: warp kg is k-group kg (k = kg mod 16), the tile's 4 rows x
  // units lane*4..+3 (+128 per pass), so a warp's weight reads are 32
  // distinct float4s and its activation read one broadcast float4
  const int kg = tid / 32, lane = tid % 32;
  int i = 0;
  auto acquire = [&](int n) {
    if (bulk) {
      mbar_wait(&full[n % kStages], (n / kStages) & 1);
    } else {
      fill(n, tab, pl, w, ring);
      __syncthreads();
    }
  };
  auto release = [&](int n) {
    __syncthreads();   // every thread is done reading stage n % kStages
    if (bulk && tid == 0 && n + kStages < total)
      issue(n + kStages, tab, pl, w, ring, full);
  };

  for (int layer = 0; layer < 2; ++layer) {
    const int K = layer ? H1 : S, H = layer ? H2 : H1, Hp = round4(H);
    const float* actT = sm + (layer ? pl.h1T : pl.xT);
    float* outT = sm + (layer ? pl.h2T : pl.h1T);
    const float* bias = sm + (layer ? pl.b1 : pl.b0);
    const int per = pl.rows_per_slab(K, H);
    for (int u0 = 0; u0 < H; u0 += NP * kPass) {
      float acc[NP][4][4];
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[p][r][j] = 0.f;
      for (int k0 = 0; k0 < K; k0 += per, ++i) {
        acquire(i);
        // units past H read whatever follows in shared memory (still inside
        // the allocation: the ring is followed by the activations); their
        // sums are never stored
        const float* wk = ring + (i % kStages) * kStageFloats + kg * Hp +
                          u0 + lane * 4;
        const float* ak = actT + (k0 + kg) * kRows;
        const int nr = min(per, K - k0);
#pragma unroll 2
        for (int k = kg; k < nr; k += kGroups) {
          const float4 a4 = *reinterpret_cast<const float4*>(ak);
          const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const float4 w4 = *reinterpret_cast<const float4*>(wk + p * kPass);
            const float wv4[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[p][r][j] = fmaf(av[r], wv4[j], acc[p][r][j]);
          }
          wk += kGroups * Hp;
          ak += kGroups * kRows;
        }
        release(i);
      }
      // every k-group's partial sums to red[kg][r][unit]; then thread o
      // sums the 16 groups of one (row, unit), adds the bias and the relu,
      // and stores the layer's output as outT[u][r]
      const int RU = NP * kPass;
      float* red = sm + pl.red;
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          *reinterpret_cast<float4*>(red + (kg * 4 + r) * RU + p * kPass +
                                     lane * 4) =
              make_float4(acc[p][r][0], acc[p][r][1], acc[p][r][2],
                          acc[p][r][3]);
      __syncthreads();
      for (int o = tid; o < 4 * RU; o += kThreads) {
        const int r = o / RU, uu = o % RU, u = u0 + uu;
        float s = 0.f;
#pragma unroll
        for (int g2 = 0; g2 < kGroups; ++g2) s += red[(g2 * 4 + r) * RU + uu];
        if (u < H) outT[u * kRows + r] = fmaxf(s + bias[u], 0.f);
      }
      __syncthreads();
    }
  }

  // ---- head: [V | A] = h2 [W_v | W_a] + [b_v | b_a]; 8 lanes per (output,
  // row), each summing k = lane, lane + 8, .., reduced by shuffles ----
  acquire(i);
  {
    const float* ws = ring + (i % kStages) * kStageFloats;
    const float* h2T = sm + pl.h2T;
    const int grp = tid / 8, sub = tid % 8, n_out = kRows * (A + 1);
    for (int base = 0; base < n_out; base += kThreads / 8) {
      const int o = base + grp, j = o / kRows, r = o % kRows;
      float s = 0.f;
      if (o < n_out) {
#pragma unroll 4
        for (int k = sub; k < H2; k += 8)
          s = fmaf(h2T[k * kRows + r],
                   j == 0 ? ws[pl.head_wv() + k] : ws[k * A + j - 1], s);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (o < n_out && sub == 0) sm[pl.head + r * (A + 1) + j] = s + sm[pl.bh + j];
    }
  }
  release(i);
  // dueling combine: warp r takes row r, lane j output j
  {
    const int r = tid / 32, ln = tid % 32;
    if (r < rows) {
      const float* hr = sm + pl.head + r * (A + 1);
      float asum = 0.f;
      for (int j = 1 + ln; j <= A; j += 32) asum += hr[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        asum += __shfl_xor_sync(0xffffffffu, asum, off);
      const float mean = asum / (float)A;
      float* qr = q + ((size_t)g * N + row0 + r) * A;
      for (int j = 1 + ln; j <= A; j += 32) qr[j - 1] = hr[0] + hr[j] - mean;
    }
  }
}

template <int NP>
int launch(const void* x, const void* w0, const void* b0, const void* w1,
           const void* b1, const void* wv, const void* bv, const void* wa,
           const void* ba, void* q, int G, int N, int S, int H1, int H2,
           int A, int bulk, const SlabTable& tab, size_t smem, void* stream) {
  static size_t smem_set = 0;   // per instantiation; the attribute only grows
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        dueling_qnet_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  dim3 grid((N + kRows - 1) / kRows, G);
  dueling_qnet_kernel<NP><<<grid, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w0),
      static_cast<const float*>(b0), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(wv),
      static_cast<const float*>(bv), static_cast<const float*>(wa),
      static_cast<const float*>(ba), static_cast<float*>(q), N, S, H1, H2, A,
      bulk, tab);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (G, N, S), w0 (G, S, H1), b0 (G, H1), w1 (G, H1, H2), b1 (G, H2),
// wv (G, H2, 1), bv (G, 1), wa (G, H2, A), ba (G, A) -> q (G, N, A).
int dueling_qnet_launch(const void* x, const void* w0, const void* b0,
                        const void* w1, const void* b1, const void* wv,
                        const void* bv, const void* wa, const void* ba,
                        void* q, int G, int N, int S, int H1, int H2, int A,
                        void* stream) {
  const Plan pl(S, H1, H2, A);
  const size_t smem = (size_t)pl.total * sizeof(float);
  if (round4(H1) > kStageFloats || round4(H2) > kStageFloats ||
      pl.head_wv() + H2 > kStageFloats || smem > (size_t)kMaxSmem || A < 1)
    return (int)cudaErrorInvalidValue;
  auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int bulk = H1 % 4 == 0 && H2 % 4 == 0 && (H2 * A) % 4 == 0 &&
                   aligned(w0) && aligned(w1) && aligned(wv) && aligned(wa);
  const SlabTable tab = slab_table(pl);
  if (tab.n == 0) return (int)cudaErrorInvalidValue;
  return pl.units == kPass
             ? launch<1>(x, w0, b0, w1, b1, wv, bv, wa, ba, q, G, N, S, H1, H2,
                         A, bulk, tab, smem, stream)
             : launch<2>(x, w0, b0, w1, b1, wv, bv, wa, ba, q, G, N, S, H1, H2,
                         A, bulk, tab, smem, stream);
}

}  // extern "C"
