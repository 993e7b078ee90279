// Hand-written Hopper (sm_90a) kernels for the AIMM epoch core.
//
// fused_epoch replaces the Pallas kernel `fused_epoch_call`
// (src/repro/kernels/epoch_fused/kernel.py:42, whose body runs
// ref.shared_stage + ref.route_stage_onehot); tom_scores replaces
// `tom_scores_call` (kernel.py:158, body ref.tom_stage_loop).  The plain
// torch versions are repro_torch/kernels/epoch_fused/ref.py.
//
// What bounds them on this card: latency.  One epoch of one lane reads a
// 128-op window, a page table of P <= 4096 entries and the 25 KB route
// table, and does a few thousand integer and float operations: the bytes
// bound at 3.35 TB/s is tens of nanoseconds, far below one launch.  What is
// left is the chain of steps one block takes in order, each waiting on
// device memory or on other threads.  So fused_epoch runs one thread block
// per lane (B lanes fill B SMs in one launch, as the batched engine will
// need) and its design keeps that chain short:
//  - the route and hop tables, and the lane's stamp and EMA rows, arrive by
//    bulk asynchronous copies (`cp.async.bulk` global -> shared on one
//    mbarrier), issued first by one thread; meanwhile the threads load the
//    window, the scalars and the route stage's six gathers (eff_table and
//    compute_remap at dest, src1, src2: one op a thread), all issued
//    together, so the block waits on device memory about twice;
//  - the lane's P-sized rows (row-buffer stamps, access EMA, touch counts)
//    are worked on in shared memory where they fit (48 KB for all three at
//    P = 4096) and written out once with 16-byte stores; where the window's
//    valid flags are 0/1, as the engine makes them, every sum is an integer
//    count kept with integer atomics (shared memory has no float atomic
//    add), and each page's EMA takes its +1.0s one at a time from the
//    page's first access;
//  - the PEI threshold's radix select picks each pass's digit with a
//    warp-wide suffix scan of the 256 counts, not a serial walk by one
//    thread;
//  - link loads: a histogram of the 3W flows' flits over the C*C = 256 cube
//    pairs, then loads[l] = sum_pair hist[pair] * routes[pair, l] per link
//    by warp partial sums, the one-hot product the TPU kernel computes,
//    instead of one contended atomic per (flow, link);
//  - the per-cube counts (ops, accesses, distinct, MC queue; C, M <= 32)
//    are counted per warp in registers from ballots of the key bits (lane k
//    counts key k), one atomic per key and warp at the end, where the
//    window's valid flags are 0/1 as the engine makes them; any other valid
//    value takes plain atomics.
//
// The TOM candidate scores depend only on the window and the static
// candidate table, so they ride in the shared stage's launch: with kTom,
// fused_epoch_kernel also scores the candidates (SharedParts' tom_scores),
// and a TOM epoch is one launch.  tom_scores_kernel is the same scorer
// alone, for the reference's own call shape.  Both run tom_warp, one warp
// per candidate over the whole window: all its candidate gathers of a round
// issued together, integer counts in registers where the valid flags are
// 0/1 (per-cube op counts from ballots, lane c counting cube c), sums and
// the max over cubes by warp reductions; no shared-memory atomics (the
// warps of a block would all add into the same few counters) and no
// barrier.
// What bounds the scorer is its 3K gathers per op, 2304 scattered 4-byte
// reads at K = 6, W = 128, which one SM's load unit takes a cache line at a
// time.  So the standalone kernel runs a one-warp block per (lane,
// candidate), K SMs for one lane, each reading the window's ops straight
// from device memory; and the fold lands the candidate table in shared
// memory by one more bulk copy, issued with the others (96 KB at P = 4096,
// where it fits beside the rows), and scores after the stamp race, when
// the copy has long arrived; where the table does not fit, it gathers from
// device memory at the same point.
//
// Exactness (the reference's contract, kernels/epoch_fused/ref.py): every
// value summed is an exact small integer in f32 (0/1 validity, winner flags,
// route incidence times packet_flits, their counts below 2^24), or a +1.0
// onto an EMA, so any order of the sums gives the same bits.  The EMA is
// decayed first (x * 0.9f) and then receives one +1.0 per valid access,
// never a pre-summed count (x+1+1 != x+2 in f32).  Built with -fmad=false so
// no a*b+c is contracted into an FMA.  The PEI threshold is the r-th largest
// access EMA (the reference's top_k order statistic, duplicates counted),
// found by a 4-pass radix select on the float bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLdbId = 1;   // repro.nmp.baselines.TECHNIQUES.index("ldb")
constexpr int kPeiId = 2;   // TECHNIQUES.index("pei")
constexpr int kTomR = 4;    // 32-op chunks a TOM warp gathers per round

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// The TOM scorer's inputs and output (ref.tom_stage).
struct TomArgs {
  const int* cands;   // (K, P) candidate page -> cube tables
  float* out;         // (B, K) scores
  int K, C;
  float inv_c, recip; // float32 1/C and 1/(1 - 1/C) (tom_score_constants)
};

// Shared words of the TOM scorer: a row of C per-cube sums for each warp
// (used where they cannot stay in registers: C > 32 or valid flags that are
// not all 0/1).
__host__ __device__ constexpr int tom_words(int C) {
  return kWarps * round4(C);
}

struct FusedArgs {
  // window, (B, W)
  const int* dest;
  const int* src1;
  const int* src2;
  const float* valid;
  // shared stage
  const float* epochs;          // (B,)
  const int* rb_stamp_in;       // (B, P+1)
  int* rb_stamp;                // (B, P+1) out
  unsigned char* rb_winner;     // (B, 3W) out (shared stage) / in (route only)
  const float* page_ema_in;     // (B, P)
  float* page_ema;              // (B, P) out
  const int* n_pages;           // (B,)
  const int* pei_idx;           // (B,)
  unsigned char* pei_hot1;      // (B, W) out / in
  unsigned char* pei_hot2;      // (B, W) out / in
  float* touch_cnt;             // (B, P) out
  // route stage
  const int* eff_table;         // (B, P)
  const int* compute_remap;     // (B, P)
  const int* technique;         // (B,)
  const unsigned char* is_aimm; // (B,)
  const float* pending;         // (B, L)
  const float* routes_flat;     // (C*C, L)
  const float* hops_flat;       // (C*C,)
  const int* nearest_mc;        // (C,)
  int* ccube;                   // (B, W) out
  float* loads;                 // (B, L) out
  float* hops_op;               // (B, W) out
  float* ops_c;                 // (B, C) out
  float* acc_c;                 // (B, C) out
  float* distinct_c;            // (B, C) out
  float* mcq;                   // (B, M) out
  int W, P, C, L, M, pei_k;
  int run_shared, run_route, pei, aimm, bulk_routes;
  float packet_flits;
  TomArgs tom;                  // read only by the kTom instantiations
  int tom_smem;                 // the candidate table lands in shared memory
};

// Dynamic shared-memory plan in 4-byte words; every region starts on 16
// bytes.  The route table comes first so one bulk copy lands it.  With
// `rows` set, the lane's P-sized working rows (stamps, EMA, touch counts)
// live here too, each with 3 words of slack so that it can start at the
// same offset within 16 bytes as its row in device memory.
struct Plan {
  int routes, hops, hist, lpart, ops, acc, dist, mcq, nmc, win, st, ema,
      touch, cnt, tom, tcands, bytes, total;
  __host__ __device__ Plan(int W, int C, int L, int M, int P, int run_route,
                           int run_shared, int pei, int aimm, int rows,
                           int tom_w, int tcands_w) {
    const int CC = run_route ? C * C : 0;
    const int ns = run_shared && rows ? round4(P + 1) + 4 : 0;
    routes = 0;
    hops = routes + round4(CC * L);
    hist = hops + round4(CC);
    lpart = hist + round4(CC);
    ops = lpart + round4(kWarps * L);
    acc = ops + round4(C);
    dist = acc + round4(C);
    mcq = dist + round4(C);
    nmc = mcq + round4(M);
    win = nmc + round4(C);             // dest, src1, src2, valid
    st = win + 4 * round4(W);
    ema = st + ns;
    touch = ema + (pei ? ns : 0);
    cnt = touch + (aimm ? ns : 0);     // EMA counts where there is no touch
    tom = cnt + (pei && !aimm ? ns : 0);    // TOM rows (tom_words)
    tcands = tom + tom_w;              // TOM candidate table (K * P)
    bytes = tcands + tcands_w;         // winner (3W), hot1, hot2 (W),
                                       // first (3W)
    total = bytes + round4((8 * W + 3) / 4);
  }
};

// The static shared memory of fused_epoch_kernel: the radix select's
// histogram and state, and the bulk copies' two barriers.
constexpr int kStaticSmem = 256 * 4 + 8 + 16;
constexpr int kMaxSmem = 232448 - kStaticSmem - 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (tries == (1u << 28)) __trap();
  }
}

__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// dst[i] = f(src[i]) for i < n over the block's threads (src may be null,
// then f takes nothing).  Where dst and src share their offset within 16
// bytes, the body moves 16 bytes a thread (up to 4 in flight), with a
// scalar head up to dst's 16-byte boundary and a scalar tail.
template <class T, class V, class F>
__device__ __forceinline__ void map_row(T* dst, const T* src, int n, F f) {
  static_assert(sizeof(V) == 4 * sizeof(T), "V holds four T");
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  const bool vec = !src || ((d ^ reinterpret_cast<uintptr_t>(src)) & 15) == 0;
  const int head = vec ? min(n, (int)(((16 - (d & 15)) & 15) >> 2)) : n;
  for (int i = threadIdx.x; i < head; i += blockDim.x)
    dst[i] = f(src ? src[i] : T());
  const int n4 = (n - head) >> 2;
  V* d4 = reinterpret_cast<V*>(dst + head);
  const V* s4 = reinterpret_cast<const V*>(src + head);
#pragma unroll 4
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    V v = src ? s4[i] : V{};
    v.x = f(v.x); v.y = f(v.y); v.z = f(v.z); v.w = f(v.w);
    d4[i] = v;
  }
  for (int i = head + 4 * n4 + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = f(src ? src[i] : T());
}

// `base` (shared) moved forward to the offset within 16 bytes that `row`
// (device memory) has, so map_row between the two moves 16 bytes a thread.
template <class T>
__device__ __forceinline__ T* same_phase(float* base, const T* row) {
  return reinterpret_cast<T*>(base) +
         ((reinterpret_cast<uintptr_t>(row) & 15) >> 2);
}

// The 16-byte body of a row of n 4-byte elements: the first `head`
// elements up to the row's first 16-byte boundary, then `bytes` (a
// multiple of 16, for one bulk copy), then fewer than 4 left over.
struct RowBody {
  int head = 0;
  uint32_t bytes = 0;
  RowBody() = default;
  __device__ RowBody(const void* row, int n) {
    head = min(n, (int)(((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15)
                        >> 2));
    bytes = (uint32_t)((n - head) >> 2) * 16;
  }
};

// The elements of row[0..n) outside its RowBody, copied to dst by threads
// t0 .. t0 + 7 (at most 3 before the body, 3 after).
template <class T>
__device__ __forceinline__ void row_ends(T* dst, const T* row, int n,
                                         int t0) {
  const RowBody rb(row, n);
  const int t = threadIdx.x - t0, tail0 = rb.head + (int)rb.bytes / 4;
  if (t >= 0 && t < rb.head) dst[t] = row[t];
  if (t >= 4 && t < 8 && tail0 + t - 4 < n) dst[tail0 + t - 4] = row[tail0 + t - 4];
}

// Order-preserving map of float bits onto unsigned ints.
__device__ __forceinline__ uint32_t float_key(float f) {
  uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t k) {
  uint32_t u = (k & 0x80000000u) ? (k & 0x7fffffffu) : ~k;
  return __uint_as_float(u);
}

// The r-th largest of vals[0..n) (r is 1-based, duplicates counted), by
// most-significant-digit radix select: 4 passes of 8 bits.  Each pass
// counts the candidates that still match the chosen prefix into a 256-bin
// shared histogram (the hardware merges a warp's increments of one bin
// into one), then warp 0 finds the digit whose suffix count first reaches
// the rank with a warp-wide suffix scan (8 digits a lane).  Starts and ends
// with a barrier.
__device__ float select_rth_largest(const float* vals, int n, int r,
                                    unsigned* hist, unsigned* state) {
  const int tid = threadIdx.x, lane = tid & 31;
  uint32_t prefix = 0, mask = 0;
  unsigned rem = (unsigned)r;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += kThreads) hist[i] = 0;
    __syncthreads();
#pragma unroll 4
    for (int i = tid; i < n; i += kThreads) {
      const uint32_t k = float_key(vals[i]);
      if ((k & mask) == prefix) atomicAdd(&hist[(k >> shift) & 0xFFu], 1u);
    }
    __syncthreads();
    if (tid < 32) {
      // lane owns digits 8*lane .. 8*lane+7; suffix counts from the top
      unsigned c[8], own = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) own += (c[k] = hist[8 * lane + k]);
      unsigned suf = own;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned t = __shfl_down_sync(kFull, suf, off);
        if (lane + off < 32) suf += t;
      }
      // the digit d with count(> d) < rem <= count(>= d), as a walk from
      // digit 255 down finds it; digit 0 with the rest if rem exceeds all
      unsigned run = suf - own, found = 0, d = 0, next = 0;
#pragma unroll
      for (int k = 7; k >= 0; --k) {
        if (!found && rem > run && rem <= run + c[k]) {
          found = 1;
          d = 8 * lane + k;
          next = rem - run;
        }
        run += c[k];
      }
      const unsigned who = __ballot_sync(kFull, found);
      if (who) {
        d = __shfl_sync(kFull, d, __ffs(who) - 1);
        next = __shfl_sync(kFull, next, __ffs(who) - 1);
      } else {
        const unsigned total = __shfl_sync(kFull, suf, 0);
        d = 0;
        next = rem - (total - __shfl_sync(kFull, c[0], 0));
      }
      if (lane == 0) {
        state[0] = prefix | (d << shift);
        state[1] = next;
      }
    }
    __syncthreads();
    prefix = state[0];
    rem = state[1];
    mask |= 0xFFu << shift;
  }
  return key_float(prefix);
}

// The count of key `lane` among the warp's lanes that are active with a
// nonzero val (every lane of the warp calls it; at most 32 keys): from
// ballots of the key bits, lane k builds the mask of lanes whose key is k.
__device__ __forceinline__ unsigned count_key(int n_keys, bool act, int key,
                                              float val) {
  const int lane = threadIdx.x & 31;
  unsigned m = __ballot_sync(kFull, act && val != 0.f);
  for (int bit = 0; (1 << bit) < n_keys; ++bit) {
    const unsigned kb = __ballot_sync(kFull, (key >> bit) & 1);
    m &= ((lane >> bit) & 1) ? kb : ~kb;
  }
  return __popc(m);
}

__device__ __forceinline__ const int* pick(int which, const int* a,
                                           const int* b, const int* c) {
  return which == 0 ? a : (which == 1 ? b : c);
}

// ---------------- TOM candidate scores (ref.tom_stage) ----------------
// Warp-level: one warp scores candidate k over the whole window.  Its lanes
// take the ops 32 at a time, kTomR chunks a round, reading each op by
// op(w, dest, src1, src2, valid) and issuing the round's 3 * kTomR gathers
// of candidate cubes from `cands` (device or shared memory) together.
// binary (valid flags 0/1, given by `binary_of` after the first round's
// gathers are issued, from that round's flags): the co-location
// half-counts 2*co = (x == d) + (y == d) and the valid count are integer
// counts in registers, summed by warp reductions, and with C <= 32 lane c
// counts the ops on cube c from ballots of the cube bits, so the max over
// cubes is one warp reduction: no shared memory, no atomics, exact in any
// order.  Otherwise the per-cube sums go to the warp's row `s_row` (C words
// in shared memory) by atomics, integer or float.  The score then follows
// the reference's float32 expression step by step (the division by the
// constant (1 - 1/C) as a multiply by its float32 reciprocal, as XLA
// compiles it); lane 0 writes it.
template <class Op, class Binary>
__device__ __forceinline__ void tom_warp(const TomArgs& ta, int k,
                                         const int* cands, int W, int P,
                                         float* s_row, int b, Op op,
                                         Binary binary_of) {
  const int lane = threadIdx.x & 31, C = ta.C;
  const int* cand = cands + (size_t)k * P;
  unsigned* row = reinterpret_cast<unsigned*>(s_row);
  for (int c = lane; c < C; c += 32) row[c] = 0u;
  __syncwarp();
  bool binary = true, regs = true;
  unsigned n_cube = 0, n_co2 = 0, n_v = 0;
  float f_co = 0.f, f_v = 0.f;
  for (int w0 = 0; w0 < W; w0 += 32 * kTomR) {
    int d[kTomR], x[kTomR], y[kTomR];
    float v[kTomR];
#pragma unroll
    for (int r = 0; r < kTomR; ++r) {
      const int w = w0 + 32 * r + lane;
      d[r] = x[r] = y[r] = 0;
      v[r] = 0.f;
      if (w < W) op(w, d[r], x[r], y[r], v[r]);
    }
#pragma unroll
    for (int r = 0; r < kTomR; ++r) {
      if (w0 + 32 * r >= W) break;   // warp-uniform
      d[r] = cand[d[r]];
      x[r] = cand[x[r]];
      y[r] = cand[y[r]];
    }
    if (w0 == 0) {
      binary = binary_of(v);
      regs = binary && C <= 32;
    }
#pragma unroll
    for (int r = 0; r < kTomR; ++r) {
      if (w0 + 32 * r >= W) break;   // warp-uniform
      const bool on = v[r] != 0.f;   // 0 past the window's end
      if (binary) {
        n_co2 += on ? (x[r] == d[r]) + (y[r] == d[r]) : 0u;
        n_v += on;
        if (regs) n_cube += count_key(C, on, d[r], 1.f);
        else if (on) atomicAdd(row + d[r], 1u);
      } else {
        f_co += ((x[r] == d[r] ? 1.f : 0.f) + (y[r] == d[r] ? 1.f : 0.f))
                * 0.5f * v[r];
        f_v += v[r];
        if (on) atomicAdd(s_row + d[r], v[r]);
      }
    }
  }
  __syncwarp();
  float mx, co_sum, vsum;
  if (binary) {
    unsigned m = regs && lane < C ? n_cube : 0u;
    for (int c = lane; !regs && c < C; c += 32) m = max(m, row[c]);
    mx = (float)__reduce_max_sync(kFull, m);
    co_sum = (float)__reduce_add_sync(kFull, n_co2) * 0.5f;
    vsum = (float)__reduce_add_sync(kFull, n_v);
  } else {
    float m = __int_as_float(0xff800000);   // -inf
    for (int c = lane; c < C; c += 32) m = fmaxf(m, s_row[c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
      f_co += __shfl_xor_sync(kFull, f_co, off);
      f_v += __shfl_xor_sync(kFull, f_v, off);
    }
    mx = m;
    co_sum = f_co;
    vsum = f_v;
  }
  if (lane == 0) {
    const float total = fmaxf(vsum, 1.f);
    const float co_frac = co_sum / total;
    float imb = (mx / total - ta.inv_c) * ta.recip;
    imb = fminf(fmaxf(imb, 0.f), 1.f);
    ta.out[(size_t)b * ta.K + k] = co_frac - 0.5f * imb;
  }
  __syncwarp();   // the row is free for the warp's next candidate
}

// kSharedRows: the lane's P-sized working rows live in shared memory (where
// they fit), else the output rows in device memory are worked on directly.
//
// Where every valid flag of the window is 0 or 1 (`binary`, as the engine
// makes them), the sums are kept as integer counts with integer atomics
// (shared memory has no float atomic add: it would be a compare-and-swap
// loop) and turned into floats once: touch counts, the per-pair flow counts
// (times packet_flits), the per-cube counts.  The EMA receives its +1.0s
// one at a time from the thread whose access won its page's stamp race.
// Any other window adds its float values with float atomics.  Both give
// the reference's bits under its contract.
//
// kTom: the shared stage also scores the TOM candidates (a.tom), a warp
// per candidate after the stamp race, from the candidate table that a bulk
// copy on a barrier of its own landed in shared memory where a.tom_smem,
// else from device memory.
template <bool kSharedRows, bool kTom>
__global__ void __launch_bounds__(kThreads)
fused_epoch_kernel(FusedArgs a) {
  extern __shared__ __align__(128) float smem[];
  __shared__ unsigned s_rhist[256];
  __shared__ unsigned s_sel[2];
  __shared__ __align__(8) uint64_t s_bar;
  __shared__ __align__(8) uint64_t s_bar_tom;

  const int b = blockIdx.x, tid = threadIdx.x, nt = kThreads;
  const int lane = tid & 31, warp = tid >> 5;
  const int W = a.W, P = a.P, C = a.C, L = a.L, M = a.M, W3 = 3 * W;
  const int CC = C * C;
  const bool bulk_tom = kTom && a.tom_smem;
  const Plan pl(W, C, L, M, P, a.run_route, a.run_shared, a.pei, a.aimm,
                kSharedRows, kTom ? tom_words(a.tom.C) : 0,
                bulk_tom ? round4(a.tom.K * P) : 0);
  float* s_routes = smem + pl.routes;
  float* s_hops = smem + pl.hops;
  float* s_hist = smem + pl.hist;
  float* s_lpart = smem + pl.lpart;
  float* s_ops = smem + pl.ops;
  float* s_acc = smem + pl.acc;
  float* s_dist = smem + pl.dist;
  float* s_mcq = smem + pl.mcq;
  int* s_nmc = reinterpret_cast<int*>(smem + pl.nmc);
  float* s_tom = smem + pl.tom;
  int* s_tcands = reinterpret_cast<int*>(smem + pl.tcands);
  unsigned char* s_win = reinterpret_cast<unsigned char*>(smem + pl.bytes);
  unsigned char* s_hot1 = s_win + W3;
  unsigned char* s_hot2 = s_hot1 + W;
  unsigned char* s_first = s_hot2 + W;   // (3W) first counted access
  int* s_dest = reinterpret_cast<int*>(smem + pl.win);
  int* s_src1 = s_dest + W;
  int* s_src2 = s_src1 + W;
  float* s_valid = reinterpret_cast<float*>(s_src2 + W);
  const int* eff = a.eff_table + (size_t)b * P;
  const int* remap = a.aimm ? a.compute_remap + (size_t)b * P : nullptr;
  auto as_count = [](float* p) { return reinterpret_cast<unsigned*>(p); };

  const bool bulk_rows = kSharedRows && a.run_shared;
  const bool bulk_route = a.run_route && a.bulk_routes;
  const int* st_in =
      a.run_shared ? a.rb_stamp_in + (size_t)b * (P + 1) : nullptr;
  const float* ema_in =
      a.run_shared && a.pei ? a.page_ema_in + (size_t)b * P : nullptr;
  int* s_st = same_phase(smem + pl.st, st_in);
  float* s_ema = same_phase(smem + pl.ema, ema_in);
  // Everything the block reads from device memory is issued at once:
  // first the lane's scalars and window (one op a thread; a window wider
  // than 256 loads the rest below), then, while those are in flight, the
  // bulk copies on one barrier by warp 0 (one lane each): the route and hop
  // tables, and the 16-byte bodies of the lane's stamp and EMA rows where
  // those are worked on in shared memory (placed at their device rows'
  // offsets within 16 bytes; threads copy the few elements around them).
  const float epoch = a.run_shared ? a.epochs[b] : 0.f;
  const int hot_m = a.run_shared && a.pei ? a.n_pages[b] - a.pei_idx[b] : 0;
  const int tech = a.run_route ? a.technique[b] : 0;
  const bool lane_aimm = a.run_route && a.aimm && a.is_aimm[b];
  const bool pre = a.run_route && W <= nt;
  const float pend = a.run_route && tid < L ? a.pending[(size_t)b * L + tid]
                                            : 0.f;
  int pdp = 0, pp1 = 0, pp2 = 0, pdc = 0, pc1 = 0, pc2 = 0;
  int pr0 = -1, pr1 = -1, pr2 = -1;
  float pv = 0.f;
  if (tid < W) {
    const size_t o = (size_t)b * W + tid;
    pdp = a.dest[o]; pp1 = a.src1[o]; pp2 = a.src2[o]; pv = a.valid[o];
  }
  const uint32_t tom_bytes = bulk_tom ? a.tom.K * P * 4 : 0;
  if ((bulk_rows || bulk_route || bulk_tom) && tid < 32) {
    const RowBody sb = bulk_rows ? RowBody(st_in, P + 1) : RowBody();
    const RowBody eb = bulk_rows && a.pei ? RowBody(ema_in, P) : RowBody();
    if (tid == 0) {
      auto expect = [](uint64_t* bar, uint32_t bytes) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                     :: "r"(smem_u32(bar)));
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
            :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
      };
      if (bulk_rows || bulk_route)
        expect(&s_bar, (bulk_route ? CC * L * 4 + CC * 4 : 0) + sb.bytes +
                           eb.bytes);
      if (bulk_tom) expect(&s_bar_tom, tom_bytes);
    }
    __syncwarp();
    if (tid == 0 && bulk_route)
      bulk_g2s(s_routes, a.routes_flat, CC * L * 4, &s_bar);
    if (tid == 1 && bulk_route) bulk_g2s(s_hops, a.hops_flat, CC * 4, &s_bar);
    if (tid == 2 && sb.bytes)
      bulk_g2s(s_st + sb.head, st_in + sb.head, sb.bytes, &s_bar);
    if (tid == 3 && eb.bytes)
      bulk_g2s(s_ema + eb.head, ema_in + eb.head, eb.bytes, &s_bar);
    if (tid == 4 && bulk_tom)
      bulk_g2s(s_tcands, a.tom.cands, tom_bytes, &s_bar_tom);
  }
  if (bulk_rows) {
    row_ends(s_st, st_in, P + 1, 0);
    if (a.pei) row_ends(s_ema, ema_in, P, 8);
  }
  bool my_binary = true;
  for (int w = tid; w < W; w += nt) {
    int d = pdp, s1 = pp1, s2 = pp2;
    float v = pv;
    if (w >= nt) {
      const size_t o = (size_t)b * W + w;
      d = a.dest[o]; s1 = a.src1[o]; s2 = a.src2[o]; v = a.valid[o];
    }
    s_dest[w] = d;
    s_src1[w] = s1;
    s_src2[w] = s2;
    s_valid[w] = v;
    my_binary = my_binary && (v == 0.f || v == 1.f);
  }
  if (pre && tid < W) {
    pdc = eff[pdp]; pc1 = eff[pp1]; pc2 = eff[pp2];
    if (remap) { pr0 = remap[pdp]; pr1 = remap[pp1]; pr2 = remap[pp2]; }
  }
  if (a.run_route) {
    for (int i = tid; i < CC; i += nt) s_hist[i] = 0.f;
    for (int i = tid; i < C; i += nt) {
      s_ops[i] = s_acc[i] = s_dist[i] = 0.f;
      s_nmc[i] = a.nearest_mc[i];
    }
    for (int i = tid; i < M; i += nt) s_mcq[i] = 0.f;
    if (!a.run_shared) {
      for (int j = tid; j < W3; j += nt)
        s_win[j] = a.rb_winner[(size_t)b * W3 + j];
      if (a.pei)
        for (int w = tid; w < W; w += nt) {
          s_hot1[w] = a.pei_hot1[(size_t)b * W + w];
          s_hot2[w] = a.pei_hot2[(size_t)b * W + w];
        }
    }
  }
  const bool binary = __syncthreads_and(my_binary);
  if (bulk_rows || bulk_route) mbar_wait(&s_bar, 0);

  // ---------------- shared stage (ref.shared_stage) ----------------
  if (a.run_shared) {
    // working rows: in shared memory where they fit (the stamp and EMA
    // rows landed there above), else the output rows
    int* st_out = a.rb_stamp + (size_t)b * (P + 1);
    float* ema_out = a.pei ? a.page_ema + (size_t)b * P : nullptr;
    float* touch_out = a.aimm ? a.touch_cnt + (size_t)b * P : nullptr;
    int* st = kSharedRows ? s_st : st_out;
    float* ema = !a.pei ? nullptr : kSharedRows ? s_ema : ema_out;
    float* touch = !a.aimm ? nullptr
        : kSharedRows ? same_phase(smem + pl.touch, touch_out) : touch_out;
    // counted (binary, and the rows in shared memory where there is an
    // EMA): each page's count of valid accesses, the +1.0s its EMA
    // receives, kept in the touch row where there is one (0 reads as 0.0f
    // too), else in a row of its own; the first access to count a page
    // applies them
    const bool counted = binary && (kSharedRows || !a.pei);
    unsigned* cnt = a.aimm ? as_count(touch)
                           : reinterpret_cast<unsigned*>(smem + pl.cnt);
    auto same = [](auto v) { return v; };
    auto zero = [](auto) { return 0; };
    if (!kSharedRows) {
      map_row<int, int4>(st, st_in, P + 1, same);
      if (a.pei) map_row<float, float4>(ema, ema_in, P, same);
    }
    if (a.aimm) map_row<float, float4>(touch, nullptr, P, zero);
    __syncthreads();
    if (a.pei) {
      // threshold = top_k(ema, pei_k)[clip(m - 1, 0, pei_k - 1)] and the
      // hot flags, from the PRE-update EMA; then the decay x * 0.9f
      const int r = min(max(hot_m - 1, 0), a.pei_k - 1) + 1;
      const float t =
          fmaxf(select_rth_largest(ema, P, r, s_rhist, s_sel), 1e-6f);
      for (int w = tid; w < W; w += nt) {
        const unsigned char h1 = ema[s_src1[w]] >= t;
        const unsigned char h2 = ema[s_src2[w]] >= t;
        s_hot1[w] = h1;
        s_hot2[w] = h2;
        a.pei_hot1[(size_t)b * W + w] = h1;
        a.pei_hot2[(size_t)b * W + w] = h2;
      }
      __syncthreads();
      map_row<float, float4>(ema, ema, P,
                             [](float v) { return __fmul_rn(0.9f, v); });
      if (counted && !a.aimm) map_row<unsigned, uint4>(cnt, nullptr, P, zero);
      __syncthreads();
    }

    // stamp race, EMA +valid and touch counts over the 3W accesses
    const int tag_base = ((int)epoch + 1) * W3;
    for (int j = tid; j < W3; j += nt) {
      const int w = j % W;
      const int page = pick(j / W, s_dest, s_src1, s_src2)[w];
      const float v = s_valid[w];
      const bool ok = v > 0.f;
      atomicMax(&st[ok ? page : P], ok ? tag_base + j : 0);
      if (counted) {
        s_first[j] = ok && (a.aimm || a.pei) && atomicAdd(cnt + page, 1u) == 0;
      } else {
        if (a.pei) atomicAdd(&ema[page], v);
        if (a.aimm) atomicAdd(&touch[page], v);
      }
    }
    if (kTom) {   // a warp per candidate, over the window in shared memory
      auto op = [&](int w, int& d, int& x, int& y, float& v) {
        d = s_dest[w]; x = s_src1[w]; y = s_src2[w]; v = s_valid[w];
      };
      auto window_binary = [&](const float (&)[kTomR]) { return binary; };
      float* s_row = s_tom + warp * round4(a.tom.C);
      if (bulk_tom && warp < a.tom.K) mbar_wait(&s_bar_tom, 0);
      for (int k = warp; k < a.tom.K; k += kWarps) {
        if (bulk_tom)
          tom_warp(a.tom, k, s_tcands, W, P, s_row, b, op, window_binary);
        else
          tom_warp(a.tom, k, a.tom.cands, W, P, s_row, b, op, window_binary);
      }
    }
    __syncthreads();
    // winner read-back: an access is its page's first touch of the epoch
    // iff its stamp won the race; the page's first counted access applies
    // its count
    for (int j = tid; j < W3; j += nt) {
      const int w = j % W;
      const int page = pick(j / W, s_dest, s_src1, s_src2)[w];
      const bool ok = s_valid[w] > 0.f;
      const unsigned char win = ok && st[page] == tag_base + j;
      s_win[j] = win;
      a.rb_winner[(size_t)b * W3 + j] = win;
      if (counted && s_first[j]) {
        const unsigned n = cnt[page];
        if (a.pei) {
          float e = ema[page];
          for (unsigned c = 0; c < n; ++c) e = __fadd_rn(e, 1.f);
          ema[page] = e;
        }
        if (a.aimm) touch[page] = (float)n;
      }
    }
    if (kSharedRows) {
      __syncthreads();
      map_row<int, int4>(st_out, st, P + 1, same);
      if (a.pei) map_row<float, float4>(ema_out, ema, P, same);
      if (a.aimm) map_row<float, float4>(touch_out, touch, P, same);
    }
  }

  // -------- schedule / route / count stage (ref.route_stage) --------
  if (!a.run_route) return;
  if (!a.bulk_routes) {
    for (int i = tid; i < CC * L; i += nt) s_routes[i] = a.routes_flat[i];
    for (int i = tid; i < CC; i += nt) s_hops[i] = a.hops_flat[i];
  }
  __syncthreads();

  const float flits = a.packet_flits;
  // warps take 32 ops at a time; every lane of a warp runs each round.
  // binary: lane k of each warp counts key k in registers (C, M <= 32)
  const bool regs = binary && C <= 32 && M <= 32;
  unsigned n_ops = 0, n_acc = 0, n_dist = 0, n_mcq = 0;
  for (int w0 = warp * 32; w0 < W; w0 += nt) {
    const int w = w0 + lane;
    const bool act = w < W;
    int dp = pdp, p1 = pp1, p2 = pp2, dc = pdc, c1 = pc1, c2 = pc2;
    int r0 = pr0, r1 = pr1, r2 = pr2;
    float v = pv;
    if (!pre) {   // the six gathers, issued together
      dp = act ? s_dest[w] : 0;
      p1 = act ? s_src1[w] : 0;
      p2 = act ? s_src2[w] : 0;
      v = act ? s_valid[w] : 0.f;
      dc = eff[dp]; c1 = eff[p1]; c2 = eff[p2];
      if (remap) { r0 = remap[dp]; r1 = remap[p1]; r2 = remap[p2]; }
    }
    int cc;
    if (a.pei) {   // baselines.schedule_by_id
      const bool h1 = act && s_hot1[w], h2 = act && s_hot2[w];
      int pc = h1 ? c2 : c1;
      if (h1 && h2) pc = c1;
      if (!(h1 || h2)) pc = dc;
      cc = tech == kPeiId ? pc : (tech == kLdbId ? c1 : dc);
    } else {
      cc = tech == kLdbId ? c1 : dc;
    }
    if (a.aimm) {  // compute-remap table: -1 none, 0..C-1 cube, C = source
      const int cr = r0 >= 0 ? r0 : (r1 >= 0 ? r1 : r2);
      const int acc = cr == C ? c1 : (cr >= 0 ? cr : cc);
      if (lane_aimm) cc = acc;
    }
    const int pair[3] = {c1 * C + cc, c2 * C + cc, cc * C + dc};
    const float wd = act && s_win[w] ? 1.f : 0.f;
    const float w1 = act && s_win[W + w] ? 1.f : 0.f;
    const float w2 = act && s_win[2 * W + w] ? 1.f : 0.f;
    if (act) {
      a.ccube[(size_t)b * W + w] = cc;
      a.hops_op[(size_t)b * W + w] =
          (s_hops[pair[0]] + s_hops[pair[1]]) + s_hops[pair[2]];
      // the flows by cube pair (C*C bins: few collide)
      if (v != 0.f)
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          if (binary) atomicAdd(as_count(s_hist) + pair[f], 1u);
          else atomicAdd(&s_hist[pair[f]], v * flits);
        }
    }
    if (regs) {
      n_ops += count_key(C, act, cc, v);
      n_acc += count_key(C, act, dc, v) + count_key(C, act, c1, v)
             + count_key(C, act, c2, v);
      n_dist += count_key(C, act, dc, wd) + count_key(C, act, c1, w1)
              + count_key(C, act, c2, w2);
      n_mcq += count_key(M, act, s_nmc[dc], v);
    } else if (act) {
      const int keys[8] = {cc, dc, c1, c2, dc, c1, c2, s_nmc[dc]};
      float* arrs[8] = {s_ops, s_acc, s_acc, s_acc, s_dist, s_dist, s_dist,
                        s_mcq};
      const float vals[8] = {v, v, v, v, wd, w1, w2, v};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (vals[k] == 0.f) continue;
        if (binary) atomicAdd(as_count(arrs[k]) + keys[k], 1u);
        else atomicAdd(arrs[k] + keys[k], vals[k]);
      }
    }
  }
  // the warp's counts of key `lane`, one atomic each
  if (regs) {
    if (lane < C) {
      if (n_ops) atomicAdd(as_count(s_ops) + lane, n_ops);
      if (n_acc) atomicAdd(as_count(s_acc) + lane, n_acc);
      if (n_dist) atomicAdd(as_count(s_dist) + lane, n_dist);
    }
    if (lane < M && n_mcq) atomicAdd(as_count(s_mcq) + lane, n_mcq);
  }
  __syncthreads();
  // counts to floats
  auto value = [&](float* arr, int i) {
    return binary ? (float)as_count(arr)[i] : arr[i];
  };
  // link loads = hist (C*C) . routes (C*C, L): warp `warp` sums its share of
  // the pairs for every link (lane = link), skipping empty pairs
  const int per = (CC + kWarps - 1) / kWarps;
  for (int l = lane; l < L; l += 32) {
    float s = 0.f;
    for (int p = warp * per; p < min(CC, (warp + 1) * per); ++p) {
      const float h = binary ? value(s_hist, p) * flits : s_hist[p];
      if (h != 0.f) s += h * s_routes[p * L + l];
    }
    s_lpart[warp * L + l] = s;
  }
  __syncthreads();
  for (int l = tid; l < L; l += nt) {
    float s = 0.f;
    for (int k = 0; k < kWarps; ++k) s += s_lpart[k * L + l];
    a.loads[(size_t)b * L + l] =
        s + (l == tid ? pend : a.pending[(size_t)b * L + l]);
  }
  for (int c = tid; c < C; c += nt) {
    a.ops_c[(size_t)b * C + c] = value(s_ops, c);
    a.acc_c[(size_t)b * C + c] = value(s_acc, c);
    a.distinct_c[(size_t)b * C + c] = value(s_dist, c);
  }
  for (int m = tid; m < M; m += nt) a.mcq[(size_t)b * M + m] = value(s_mcq, m);
}

// The TOM scorer alone (ops.tom_scores): a one-warp block per (lane,
// candidate), so the K candidates' gathers go through K SMs' load units, not
// one.  The warp reads the window's ops straight from device memory, so its
// gathers follow the window's loads with nothing in between, and decides
// from the window's valid flags by a warp vote whether its sums are integer
// counts.
__global__ void __launch_bounds__(32)
tom_scores_kernel(const int* dest, const int* src1, const int* src2,
                  const float* valid, TomArgs ta, int W, int P) {
  extern __shared__ __align__(16) float s_row[];   // the warp's row (C)
  const int b = blockIdx.x, lane = threadIdx.x;
  const size_t row0 = (size_t)b * W;
  auto op = [&](int w, int& d, int& x, int& y, float& v) {
    d = dest[row0 + w]; x = src1[row0 + w]; y = src2[row0 + w];
    v = valid[row0 + w];
  };
  auto is01 = [](float v) { return v == 0.f || v == 1.f; };
  auto window_binary = [&](const float (&v)[kTomR]) {
    bool ok = true;
#pragma unroll
    for (int r = 0; r < kTomR; ++r) ok = ok && is01(v[r]);
    for (int w = 32 * kTomR + lane; w < W; w += 32)
      ok = ok && is01(valid[row0 + w]);
    return __all_sync(kFull, ok) != 0;
  };
  tom_warp(ta, blockIdx.y, ta.cands, W, P, s_row, b, op, window_binary);
}

// Sets the kernel's dynamic shared-memory limit to `smem` where that is
// above what it was set to (the attribute only grows).
template <class Kernel>
int reserve_smem(Kernel kernel, size_t smem, size_t& smem_set) {
  if (smem <= smem_set) return 0;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  smem_set = smem;
  return 0;
}

template <bool kSharedRows, bool kTom>
int launch(const FusedArgs& a, int B, size_t smem, void* stream) {
  static size_t smem_set = 48 * 1024 - kStaticSmem;
  const int e = reserve_smem(fused_epoch_kernel<kSharedRows, kTom>, smem,
                             smem_set);
  if (e) return e;
  fused_epoch_kernel<kSharedRows, kTom><<<B, kThreads, smem,
                                          static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The fused launch with or without the TOM fold (tom.cands null).
int fused_launch(FusedArgs& a, int B, void* stream) {
  // one bulk copy of the route and hop tables where both are 16-byte
  // multiples on 16-byte addresses; else the threads copy them
  auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int C = a.C, L = a.L, W = a.W, M = a.M, P = a.P;
  a.bulk_routes = a.run_route && (C * C * L) % 4 == 0 && (C * C) % 4 == 0 &&
                  aligned(a.routes_flat) && aligned(a.hops_flat);
  const bool tom = a.tom.cands != nullptr;
  if (tom && (!a.run_shared || a.tom.K < 1 || a.tom.C < 1))
    return (int)cudaErrorInvalidValue;
  const int tw = tom ? tom_words(a.tom.C) : 0;
  auto words = [&](int rows, int tc) {
    return Plan(W, C, L, M, P, a.run_route, a.run_shared, a.pei, a.aimm,
                rows, tw, tc).total;
  };
  // the lane's P-sized working rows in shared memory where they fit; then
  // the TOM candidate table where it fits too (one bulk copy: 16-byte
  // multiple on a 16-byte address, below the barrier's 2^20-byte count)
  const bool rows = words(1, 0) <= kMaxSmem / 4;
  const int tc = round4(a.tom.K * P);
  a.tom_smem = tom && (a.tom.K * P) % 4 == 0 && aligned(a.tom.cands) &&
               (size_t)a.tom.K * P * 4 < (1u << 20) &&
               words(rows, tc) <= kMaxSmem / 4;
  const size_t smem = (size_t)words(rows, a.tom_smem ? tc : 0) * 4;
  if (tom)
    return rows ? launch<true, true>(a, B, smem, stream)
                : launch<false, true>(a, B, smem, stream);
  return rows ? launch<true, false>(a, B, smem, stream)
              : launch<false, false>(a, B, smem, stream);
}

FusedArgs fused_args(
    const void* dest, const void* src1, const void* src2, const void* valid,
    const void* epochs, const void* rb_stamp_in, void* rb_stamp,
    void* rb_winner, const void* page_ema_in, void* page_ema,
    const void* n_pages, const void* pei_idx, void* pei_hot1, void* pei_hot2,
    void* touch_cnt, const void* eff_table, const void* compute_remap,
    const void* technique, const void* is_aimm, const void* pending,
    const void* routes_flat, const void* hops_flat, const void* nearest_mc,
    void* ccube, void* loads, void* hops_op, void* ops_c, void* acc_c,
    void* distinct_c, void* mcq, int W, int P, int C, int L, int M,
    int pei_k, int run_shared, int run_route, int pei, int aimm,
    float packet_flits) {
  FusedArgs a;
  a.dest = static_cast<const int*>(dest);
  a.src1 = static_cast<const int*>(src1);
  a.src2 = static_cast<const int*>(src2);
  a.valid = static_cast<const float*>(valid);
  a.epochs = static_cast<const float*>(epochs);
  a.rb_stamp_in = static_cast<const int*>(rb_stamp_in);
  a.rb_stamp = static_cast<int*>(rb_stamp);
  a.rb_winner = static_cast<unsigned char*>(rb_winner);
  a.page_ema_in = static_cast<const float*>(page_ema_in);
  a.page_ema = static_cast<float*>(page_ema);
  a.n_pages = static_cast<const int*>(n_pages);
  a.pei_idx = static_cast<const int*>(pei_idx);
  a.pei_hot1 = static_cast<unsigned char*>(pei_hot1);
  a.pei_hot2 = static_cast<unsigned char*>(pei_hot2);
  a.touch_cnt = static_cast<float*>(touch_cnt);
  a.eff_table = static_cast<const int*>(eff_table);
  a.compute_remap = static_cast<const int*>(compute_remap);
  a.technique = static_cast<const int*>(technique);
  a.is_aimm = static_cast<const unsigned char*>(is_aimm);
  a.pending = static_cast<const float*>(pending);
  a.routes_flat = static_cast<const float*>(routes_flat);
  a.hops_flat = static_cast<const float*>(hops_flat);
  a.nearest_mc = static_cast<const int*>(nearest_mc);
  a.ccube = static_cast<int*>(ccube);
  a.loads = static_cast<float*>(loads);
  a.hops_op = static_cast<float*>(hops_op);
  a.ops_c = static_cast<float*>(ops_c);
  a.acc_c = static_cast<float*>(acc_c);
  a.distinct_c = static_cast<float*>(distinct_c);
  a.mcq = static_cast<float*>(mcq);
  a.W = W; a.P = P; a.C = C; a.L = L; a.M = M; a.pei_k = pei_k;
  a.run_shared = run_shared; a.run_route = run_route;
  a.pei = pei; a.aimm = aimm; a.packet_flits = packet_flits;
  a.tom = TomArgs{nullptr, nullptr, 0, 0, 0.f, 0.f};
  a.tom_smem = 0;
  return a;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#define FUSED_PARAMS                                                        \
    const void *dest, const void *src1, const void *src2, const void *valid, \
    const void *epochs, const void *rb_stamp_in, void *rb_stamp,             \
    void *rb_winner, const void *page_ema_in, void *page_ema,                \
    const void *n_pages, const void *pei_idx, void *pei_hot1,                \
    void *pei_hot2, void *touch_cnt, const void *eff_table,                  \
    const void *compute_remap, const void *technique, const void *is_aimm,   \
    const void *pending, const void *routes_flat, const void *hops_flat,     \
    const void *nearest_mc, void *ccube, void *loads, void *hops_op,         \
    void *ops_c, void *acc_c, void *distinct_c, void *mcq, int B, int W,     \
    int P, int C, int L, int M, int pei_k, int run_shared, int run_route,    \
    int pei, int aimm, float packet_flits
#define FUSED_ARGS                                                          \
    dest, src1, src2, valid, epochs, rb_stamp_in, rb_stamp, rb_winner,       \
    page_ema_in, page_ema, n_pages, pei_idx, pei_hot1, pei_hot2, touch_cnt,  \
    eff_table, compute_remap, technique, is_aimm, pending, routes_flat,      \
    hops_flat, nearest_mc, ccube, loads, hops_op, ops_c, acc_c, distinct_c,  \
    mcq, W, P, C, L, M, pei_k, run_shared, run_route, pei, aimm,             \
    packet_flits

int fused_epoch_launch(FUSED_PARAMS, void* stream) {
  FusedArgs a = fused_args(FUSED_ARGS);
  return fused_launch(a, B, stream);
}

// fused_epoch_launch with the TOM fold: tom_out (B, K) receives the scores
// of the K candidate tables tom_cands (K, P) over C cubes (run_shared only).
int fused_epoch_tom_launch(FUSED_PARAMS, const void* tom_cands, void* tom_out,
                           int K, int tom_c, float inv_c, float recip,
                           void* stream) {
  FusedArgs a = fused_args(FUSED_ARGS);
  a.tom = TomArgs{static_cast<const int*>(tom_cands),
                  static_cast<float*>(tom_out), K, tom_c, inv_c, recip};
  return fused_launch(a, B, stream);
}

int tom_scores_launch(const void* dest, const void* src1, const void* src2,
                      const void* valid, const void* cands, void* out, int B,
                      int W, int P, int K, int C, float inv_c, float recip,
                      void* stream) {
  static size_t smem_set = 48 * 1024;
  const size_t smem = (size_t)round4(C) * 4;
  const int e = reserve_smem(tom_scores_kernel, smem, smem_set);
  if (e) return e;
  const TomArgs ta{static_cast<const int*>(cands), static_cast<float*>(out),
                   K, C, inv_c, recip};
  tom_scores_kernel<<<dim3(B, K), 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(dest), static_cast<const int*>(src1),
      static_cast<const int*>(src2), static_cast<const float*>(valid), ta, W,
      P);
  return (int)cudaGetLastError();
}

}  // extern "C"
