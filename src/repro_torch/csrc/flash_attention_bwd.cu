// Backward of blocked GQA flash attention for sm_90a: causal with or
// without a window, and non-causal with a key length of its own.
//
// Replaces no Pallas kernel: the reference trains through XLA's autodiff
// of src/repro/models/attention.py `attend` / `attend_chunked` under
// `jax.value_and_grad` (src/repro/train/train_step.py), and has no backward
// kernel of its own.  The port's forward is the flash kernel
// (flash_attention.cu), a ctypes launch with no autograd, so on the card
// its gradient is this source.  Given q (B, S, H, hd), k, v (B, S_kv, K,
// hd), the forward's output o, its row log-sum-exp lse (B, H, S) f32
// (`flash_attention_lse_launch`) and dO:
//   D  = rowsum(dO o)
//   P  = exp(scale q k^T - lse), 0 where key j is hidden from query i
//        (recomputed)
//   dP = dO v^T,  dS = P (dP - D)
//   dV = P^T dO,  dK = scale dS^T q,  dQ = scale dS k
// each gradient written once in the inputs' type.  The mask: causal hides
// j > i (S_kv == S), a window > 0 (causal only) also hides j <= i - window,
// and keys at or past S_kv and queries at or past S take no part.  Non-
// causal attention (the encoder's, S_kv == S, and cross attention, S_kv !=
// S either way) hides nothing but the ragged ends.  Every head dim the
// forward takes: hd 16, 32, 64, 128 or 256.
//
// Bound on this card: five products over the visible (query, key) pairs,
// 2.5x the forward's FLOP, bound by operations at the bf16 tensor-core rate;
// at minitron-8b's shape (B 1, S 4096, H 32, K 8, hd 128, causal) 2.5 x
// 1.374e11 FLOP, 0.347 ms, against ~0.14 GB of q, k, v, o, dO, lse in and
// dq, dk, dv out (0.04 ms).  Three designs, chosen by dtype and head dim as
// the forward's `kernel_for` chooses (a shape rule, not a fallback):
//
// bf16: wgmma fed by TMA (`flash_bwd_dkdv_kernel` or, at hd 256,
// `flash_bwd_dkdv_split_kernel`, and `flash_bwd_dq_kernel`, after
// `flash_bwd_prep_kernel`).  The forward's building blocks (hopper_wgmma.cuh):
// TMA copies of 64-column panels with the 128-byte swizzle into full / empty
// mbarrier rings (rows past S or S_kv arrive as zeros), SS wgmma on those
// panels, and the bf16 re-pack of f32 accumulators into register A operands
// for RS wgmma.  Three launches:
//   * prep: D = rowsum(dO o) and lse log2(e), one warp a row, into rows
//     padded to a multiple of 128 (zeros past S), so the other two kernels
//     copy a tile's rows of them with one bulk copy.
//   * dK / dV: one block per (batch, kv head, key tile of 128; 64 at hd
//     256); at hd 64 and 128 two warpgroups of 64 keys each keep the K and V
//     tile resident and their dK, dV in f32 registers over the whole GQA
//     group, while the Q and dO tiles and their lse / D rows of every query
//     head of the group stream through a three-stage ring: causal from the
//     key tile's diagonal to S, or with a window only to the last query
//     that sees one of its keys (min(S, k0 + keys - 1 + window)); non-
//     causal every query tile.  Per query step, K-major products: S^T = K
//     Q^T and dP^T = V dO^T (SS), P^T = exp2(S^T scale log2(e) - lse
//     log2(e)), masked where a step meets the diagonal, the window's edge or
//     a ragged end, dS^T = P^T (dP^T - D), then dV += P^T dO and dK += dS^T
//     Q (RS: P^T and dS^T re-packed to bf16 in registers, dO and Q the
//     N-major B operands: the same swizzled tiles read transposed).  A
//     warpgroup none of whose keys a step's queries see skips its products.
//     dK is scaled and both are written once in bf16.
//   * dQ: one block per (batch, head, 128-row query tile), causal without a
//     window heaviest (the most key tiles) first; two consumer warpgroups
//     keep their 64 Q and dO rows and the rows' lse and D resident, and a
//     producer warp (at hd 256 thread 0, in band) streams the K and V tiles
//     (64 keys; 32 at hd 256) the block's rows see, from the window's first
//     key (causal: up to the diagonal; non-causal: to S_kv), through a
//     two-stage ring (three at hd 256).  S = Q K^T and dP = dO V^T (SS), dS
//     in registers, dQ += dS K (RS, K the N-major B operand).
// The two passes do seven products (S and dP twice), ~1.4x the five-product
// bound.  P and dS are rounded to bf16 for their products (S and dP
// accumulate in f32 from bf16 operands), as the forward rounds P;
// `GRAD_BARS` in ref.py holds the result, and tests/test_torch_backward.py
// emulates this arithmetic against it for every variant.
// Registers: ptxas gives every thread of a block one count, which the
// block's threads must fit into the 64K registers at launch: 168 for three
// warpgroups, or for two and a warp, whatever `setmaxnreg` asks later (a
// producer warpgroup at 24 and consumers at 240, 40 / 232 or 56 / 224 left
// the same 136-byte spill; chip runs, PR 21).  At hd 128 a dK / dV thread
// holds dK and dV (128 floats) beside S^T, dP^T and their bf16 packs:
// ~250 registers with 64-query steps, 198 with 32-query steps.  So the dK /
// dV block is the two warpgroups alone, with no producer warp (thread 0
// issues each step's copies two steps ahead), and ptxas may give it up to
// 255 registers a thread; its steps are 32 query rows at hd 128 and 256,
// 64 at hd 64.  The dQ block needs 166 at hd 128 and keeps its producer
// warp; at hd 256 its consumers spilled 136 bytes at 168, so it drops the
// warp too and takes 198, no spill.
// hd 256 (gemma3): a warpgroup's 64 x 256 f32 accumulator is 128 registers
// a thread, so one warpgroup cannot hold both dK and dV of its keys.  In
// `flash_bwd_dkdv_split_kernel` both warpgroups take the same 64 keys:
// warpgroup 0 forms S^T and P^T and holds dV += P^T dO, warpgroup 1 forms
// dP^T, reads P^T (f32, 8 KB a step, in its own accumulator layout, so
// each thread reads what its twin wrote) and holds dK += dS^T Q; two named
// barriers pass the buffer between them (one buffer: warpgroup 0 forms the
// next S^T while warpgroup 1 reads).  Each warpgroup does two of the four
// products of a step: 179 registers, no spill.  Shared memory at hd 256
// (227 KB a block): dK / dV holds K and V (64 keys, 32 KB each), a three-
// stage ring of 32-row Q and dO steps (3 x 32 KB), the P^T buffer and the
// lse / D rows: ~169 KB.  dQ holds Q and dO of its 128 rows (64 KB each)
// and a three-stage ring of 32-key K and V tiles (3 x 32 KB, wgmma N =
// 32): 225 KB with the rows' lse and D, inside the 227; 64-key tiles would
// need 256 KB for two stages.  dQ's RS product at hd 256 is two m64n128
// wgmmas a k-step, as the forward's P V is.
// Causal balance: both grids are triangles of work, launched heaviest first
// (dK / dV: the first key tiles have the most query steps, and block y 0
// runs first; dQ: block y 0 takes the last query tile), so the light blocks
// fill the tail.  A window or non-causal attention gives every block about
// the same work.
// Deterministic: no float atomics.  Every gradient element is owned by
// one warpgroup, which adds the query (or key) tiles in a fixed order.
//
// bf16 at hd 16 and 32 (the smoke configs' widths): mma.sync m16n8k16 with
// ldmatrix fragments and a cp.async ring (mma_sync.cuh), the forward's
// `flash_bf16_kernel` design; a 64-column TMA panel would be
// mostly padding at these widths, and hd 16 is a single k16 step.  The
// same prep pass, then `flash_bwd_mma_dkdv_kernel` per (batch, query head,
// 64 keys), four warps of 16 keys holding K, V as A fragments and dK, dV in
// f32 registers while the head's Q / dO rows stream through in steps of
// 64 (with GQA, float32 partials of each query head, which
// `flash_bwd_gqa_sum_kernel` adds over the group in head order), and
// `flash_bwd_mma_dq_kernel` per (batch, head, 64 query rows), four warps of
// 16 rows holding Q, dO, lse, D and dQ while 64-key K / V tiles stream
// through; the element mask runs in a branch of its own, on the tiles
// that need it only (inline, its predicates were most of a step's
// instructions, SASS of the loop).  The arithmetic is the wgmma kernels'
// (P and dS rounded to bf16 for their products, S and dP in f32 from bf16
// operands), so the same emulation holds it.  Bound: at these widths the
// products are few (10 hd FLOP a visible pair: 0.043 ms at hd 16, 0.087
// at hd 32 at minitron-8b's shape cut to that width, 2.685e8 pairs) and
// the exponentials are the limit at hd 16: one exp2 a pair at the SFU's 16
// a clock per SM (compute capability 9.0) on 132 SMs at the card's 1.98
// GHz maximum SM clock, 4.18e12 a second, 0.064 ms; the two passes compute
// P twice, so this design's own floor is ~0.128 ms there.
// f32: CUDA-core FMAs (`flash_bwd_f32_dkdv_kernel`, `flash_bwd_f32_dq_kernel`,
// after `flash_bwd_d_kernel`), the first design of this source: 32 x 32
// shared-memory tiles, the same two passes and the same mask, every product
// in f32 (the f32 bar is 2e-5, which TF32 would not meet); at hd 256 its
// tiles take 140 KB of dynamic shared memory, at hd 16 a thread's columns
// are one (t % 16).  No training path on the card runs f32 attention.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"
#include "mma_sync.cuh"

namespace {

// The launch's shape and mask: queries S (lse / D rows padded to S_pad),
// keys S_kv, query heads H over K kv heads; causal (S_kv == S) with an
// optional window (> 0), or non-causal.
struct BwdShape {
  int S, S_kv, S_pad, H, K, causal, window;
};

// Key `key` is seen by query `row`.
__device__ __forceinline__ bool seen(int row, int key, const BwdShape& sh) {
  return row < sh.S && key < sh.S_kv && (!sh.causal || key <= row) &&
         (sh.window == 0 || key > row - sh.window);
}

// The first query that sees a key at or after k0, and one past the last
// query that sees a key at or before k_last (causal: queries k0 .., a
// window ends them at k_last + window).
__device__ __forceinline__ int first_query(int k0, const BwdShape& sh) {
  return sh.causal ? k0 : 0;
}
__device__ __forceinline__ int query_end(int k_last, const BwdShape& sh) {
  return sh.causal && sh.window ? min(sh.S, k_last + sh.window) : sh.S;
}

// The first key a query at or after q0 sees, and one past the last key a
// query at or before q_last sees.
__device__ __forceinline__ int first_key(int q0, const BwdShape& sh) {
  return sh.causal && sh.window ? max(0, q0 - sh.window + 1) : 0;
}
__device__ __forceinline__ int key_end(int q_last, const BwdShape& sh) {
  return sh.causal ? min(sh.S_kv, q_last + 1) : sh.S_kv;
}

// Some key of [k0, k1] is seen by some query of [q0, q1] (all in range).
__device__ __forceinline__ bool any_seen(int q0, int q1, int k0, int k1,
                                         const BwdShape& sh) {
  return (!sh.causal || k0 <= q1) && (sh.window == 0 || k1 > q0 - sh.window);
}

// Some pair of [q0, q0 + nq) x [k0, k0 + nk) is hidden, or out of range:
// the tile needs the element mask.
__device__ __forceinline__ bool needs_mask(int q0, int nq, int k0, int nk,
                                           const BwdShape& sh) {
  return q0 + nq > sh.S || k0 + nk > sh.S_kv ||
         (sh.causal && k0 + nk - 1 > q0) ||
         (sh.window > 0 && k0 <= q0 + nq - 1 - sh.window);
}

// Zero the entries of a 64-row wgmma accumulator tile (N columns) whose
// (row, column) pair is hidden: rows row0 + 16 w + g (+ 8 for e >= 2),
// columns col0 + 8 j + 2 t + (e & 1) in x[4 j + e].  `kT_` (the dK / dV
// tiles) swaps them: rows are keys and columns queries.  A branch of its
// own, taken only by tiles that need the mask (`needs_mask`), so the
// others pay nothing for it.
template <int N, bool kT_>
__device__ __forceinline__ void mask_tile(float (&x)[N / 2], int row0,
                                          int col0, const BwdShape& sh) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x / 32) % 4;
  const int r = row0 + 16 * w + (lane >> 2), c = col0 + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int row = r + ((i & 2) ? 8 : 0), col = c + 8 * (i >> 2) + (i & 1);
    if (kT_ ? !seen(col, row, sh) : !seen(row, col, sh)) x[i] = 0.f;
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kT = 32;          // query rows and keys per tile
constexpr int kThreads = 256;
constexpr int kLT = kT + 1;     // padded row of a P / dS tile

// Rows r0 .. r0 + kT - 1 of one head of a (.., rows, heads, HD) tensor
// (`src` already at its batch and head, rows `stride` apart) into shared
// memory as f32 rows of HD + 1; rows at or past `n` are zeros.
template <int HD>
__device__ __forceinline__ void load_f32_rows(float* dst,
                                              const float* __restrict__ src,
                                              size_t stride, int r0, int n) {
  for (int i = threadIdx.x; i < kT * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    dst[r * (HD + 1) + c] =
        r0 + r < n ? src[(size_t)(r0 + r) * stride + c] : 0.f;
  }
}

// D = rowsum(dO o) for every (batch, row, head): one warp a row, the lanes'
// partial sums added in a fixed butterfly.  D is (B, H, S).
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_d_kernel(const float* __restrict__ o, const float* __restrict__ dO,
                   float* __restrict__ D, int B, int S, int H) {
  const long long rowid =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (rowid >= (long long)B * S * H) return;   // whole warps leave together
  const float* ob = o + (size_t)rowid * HD;
  const float* gb = dO + (size_t)rowid * HD;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < HD; c += 32) acc = fmaf(ob[c], gb[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = (int)(rowid % H);
    const long long bs = rowid / H;
    const int s = (int)(bs % S), b = (int)(bs / S);
    D[((size_t)b * H + h) * S + s] = acc;
  }
}

// P and dS of one tile of kT query rows (q0 ..) and kT keys (k0 ..) from
// the staged q, dO, k, v (f32 rows of HD + 1) and the rows' lse and D.
// Thread t computes rows 2 (t / 16) and + 1, keys t % 16 and + 16.
template <int HD>
__device__ __forceinline__ void p_ds_tile(
    const float* __restrict__ sQ, const float* __restrict__ sdO,
    const float* __restrict__ sK, const float* __restrict__ sV,
    const float* __restrict__ sLse, const float* __restrict__ sD,
    float* __restrict__ sP, float* __restrict__ sdS, int q0, int k0,
    const BwdShape& sh, float scale) {
  constexpr int LD = HD + 1;
  const int i0 = 2 * (threadIdx.x / 16), j0 = threadIdx.x % 16;
  float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
  float p00 = 0.f, p01 = 0.f, p10 = 0.f, p11 = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    const float qa = sQ[i0 * LD + d], qb = sQ[(i0 + 1) * LD + d];
    const float ga = sdO[i0 * LD + d], gb = sdO[(i0 + 1) * LD + d];
    const float ka = sK[j0 * LD + d], kb = sK[(j0 + 16) * LD + d];
    const float va = sV[j0 * LD + d], vb = sV[(j0 + 16) * LD + d];
    s00 = fmaf(qa, ka, s00);
    s01 = fmaf(qa, kb, s01);
    s10 = fmaf(qb, ka, s10);
    s11 = fmaf(qb, kb, s11);
    p00 = fmaf(ga, va, p00);
    p01 = fmaf(ga, vb, p01);
    p10 = fmaf(gb, va, p10);
    p11 = fmaf(gb, vb, p11);
  }
  const float s[2][2] = {{s00, s01}, {s10, s11}};
  const float dp[2][2] = {{p00, p01}, {p10, p11}};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int r = i0 + a, c = j0 + 16 * b;
      float p = 0.f, ds = 0.f;
      if (seen(q0 + r, k0 + c, sh)) {
        p = expf(s[a][b] * scale - sLse[r]);
        ds = p * (dp[a][b] - sD[r]);
      }
      sP[r * kLT + c] = p;
      sdS[r * kLT + c] = ds;
    }
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (4 * (size_t)kT * (HD + 1) + 2 * (size_t)kT * kLT + 2 * kT);
}

// dK, dV of kT keys of one kv head.  Thread t accumulates keys t / 16 and
// + 16, columns t % 16 + 16 m.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_f32_dkdv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dO,
                          const float* __restrict__ lse,
                          const float* __restrict__ D, float* __restrict__ dk,
                          float* __restrict__ dv, BwdShape sh, float scale) {
  constexpr int LD = HD + 1, CT = HD / 16;
  extern __shared__ float bwd_smem[];
  float* sK = bwd_smem;
  float* sV = sK + kT * LD;
  float* sQ = sV + kT * LD;
  float* sdO = sQ + kT * LD;
  float* sP = sdO + kT * LD;
  float* sdS = sP + kT * kLT;
  float* sLse = sdS + kT * kLT;
  float* sD = sLse + kT;

  const int S = sh.S, H = sh.H, K = sh.K;
  const int b = blockIdx.x / K, kh = blockIdx.x % K, rep = H / K;
  const int k0 = blockIdx.y * kT;
  const size_t qrow = (size_t)H * HD, krow = (size_t)K * HD;
  const size_t kvoff = (size_t)b * sh.S_kv * krow + (size_t)kh * HD;
  load_f32_rows<HD>(sK, k + kvoff, krow, k0, sh.S_kv);
  load_f32_rows<HD>(sV, v + kvoff, krow, k0, sh.S_kv);

  const int t = threadIdx.x, kr = t / 16, cc = t % 16;
  float adk[2][CT], adv[2][CT];
#pragma unroll
  for (int m = 0; m < CT; ++m) adk[0][m] = adk[1][m] = adv[0][m] = adv[1][m] = 0.f;

  // the query tiles that see a key of the tile (equal tile sizes: causal
  // starts at q0 = k0)
  const int q_begin = first_query(k0, sh) / kT * kT;
  const int q_end = query_end(min(k0 + kT, sh.S_kv) - 1, sh);
  for (int hh = 0; hh < rep; ++hh) {
    const int h = kh * rep + hh;
    const size_t qoff = (size_t)b * S * qrow + (size_t)h * HD;
    const float* lb = lse + ((size_t)b * H + h) * S;
    const float* db = D + ((size_t)b * H + h) * S;
    for (int q0 = q_begin; q0 < q_end; q0 += kT) {
      __syncthreads();   // the previous tile's reads are done
      load_f32_rows<HD>(sQ, q + qoff, qrow, q0, S);
      load_f32_rows<HD>(sdO, dO + qoff, qrow, q0, S);
      if (t < kT) {
        sLse[t] = q0 + t < S ? lb[q0 + t] : 0.f;
        sD[t] = q0 + t < S ? db[q0 + t] : 0.f;
      }
      __syncthreads();
      p_ds_tile<HD>(sQ, sdO, sK, sV, sLse, sD, sP, sdS, q0, k0, sh, scale);
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < kT; ++i) {
        const float p0 = sP[i * kLT + kr], p1 = sP[i * kLT + kr + 16];
        const float d0 = sdS[i * kLT + kr], d1 = sdS[i * kLT + kr + 16];
#pragma unroll
        for (int m = 0; m < CT; ++m) {
          const float g = sdO[i * LD + cc + 16 * m];
          const float x = sQ[i * LD + cc + 16 * m];
          adv[0][m] = fmaf(p0, g, adv[0][m]);
          adv[1][m] = fmaf(p1, g, adv[1][m]);
          adk[0][m] = fmaf(d0, x, adk[0][m]);
          adk[1][m] = fmaf(d1, x, adk[1][m]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kr + 16 * r;
    if (key >= sh.S_kv) continue;
    float* dkb = dk + kvoff + (size_t)key * krow;
    float* dvb = dv + kvoff + (size_t)key * krow;
#pragma unroll
    for (int m = 0; m < CT; ++m) {
      dkb[cc + 16 * m] = adk[r][m] * scale;
      dvb[cc + 16 * m] = adv[r][m];
    }
  }
}

// dQ of kT query rows of one head.  Thread t accumulates rows t / 16 and
// + 16, columns t % 16 + 16 m.  Causal: the heaviest query tiles (the most
// key tiles) start first.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_f32_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dO,
                        const float* __restrict__ lse,
                        const float* __restrict__ D, float* __restrict__ dq,
                        BwdShape sh, float scale) {
  constexpr int LD = HD + 1, CT = HD / 16;
  extern __shared__ float bwd_smem[];
  float* sK = bwd_smem;
  float* sV = sK + kT * LD;
  float* sQ = sV + kT * LD;
  float* sdO = sQ + kT * LD;
  float* sP = sdO + kT * LD;
  float* sdS = sP + kT * kLT;
  float* sLse = sdS + kT * kLT;
  float* sD = sLse + kT;

  const int S = sh.S, H = sh.H, K = sh.K;
  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h / (H / K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kT;
  const size_t qrow = (size_t)H * HD, krow = (size_t)K * HD;
  const size_t qoff = (size_t)b * S * qrow + (size_t)h * HD;
  const size_t kvoff = (size_t)b * sh.S_kv * krow + (size_t)kh * HD;
  const int t = threadIdx.x, qr = t / 16, cc = t % 16;
  load_f32_rows<HD>(sQ, q + qoff, qrow, q0, S);
  load_f32_rows<HD>(sdO, dO + qoff, qrow, q0, S);
  if (t < kT) {
    const size_t row = ((size_t)b * H + h) * S + q0 + t;
    sLse[t] = q0 + t < S ? lse[row] : 0.f;
    sD[t] = q0 + t < S ? D[row] : 0.f;
  }
  float adq[2][CT];
#pragma unroll
  for (int m = 0; m < CT; ++m) adq[0][m] = adq[1][m] = 0.f;

  // the key tiles the tile's rows see
  const int k_end = key_end(min(q0 + kT, S) - 1, sh);
  for (int k0 = first_key(q0, sh) / kT * kT; k0 < k_end; k0 += kT) {
    __syncthreads();   // the previous tile's reads are done
    load_f32_rows<HD>(sK, k + kvoff, krow, k0, sh.S_kv);
    load_f32_rows<HD>(sV, v + kvoff, krow, k0, sh.S_kv);
    __syncthreads();
    p_ds_tile<HD>(sQ, sdO, sK, sV, sLse, sD, sP, sdS, q0, k0, sh, scale);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kT; ++j) {
      const float d0 = sdS[qr * kLT + j], d1 = sdS[(qr + 16) * kLT + j];
#pragma unroll
      for (int m = 0; m < CT; ++m) {
        const float x = sK[j * LD + cc + 16 * m];
        adq[0][m] = fmaf(d0, x, adq[0][m]);
        adq[1][m] = fmaf(d1, x, adq[1][m]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + qr + 16 * r;
    if (row >= S) continue;
    float* dqb = dq + qoff + (size_t)row * qrow;
#pragma unroll
    for (int m = 0; m < CT; ++m) dqb[cc + 16 * m] = adq[r][m] * scale;
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int kBT = 64;                  // rows of a warpgroup's tile
constexpr int kBStages = 2;              // dQ's K / V ring depth
constexpr int kDkvStages = 3;            // dK / dV's Q / dO ring depth
constexpr int kBConsumers = 256;         // two consumer warpgroups
constexpr int kDqThreads = kBConsumers + 32;   // + one producer warp
constexpr int kBoxBytes = kBT * kPanel * 2;    // one 64-row panel: 8 KB

// Query rows of a dK / dV step: 64, or 32 at hd 128 and 256, where a
// consumer thread's dK and dV (128 floats) beside S^T, dP^T and their bf16
// packs of 64-query tiles needed ~250 registers (ptxas without a cap);
// with 32 it takes 198.
__host__ __device__ constexpr int dkv_bq(int hd) { return hd > 64 ? 32 : 64; }
// Keys of a dK / dV block: two warpgroups' 64 each, or at hd 256 one set
// of 64 that both warpgroups share (the split kernel).
__host__ __device__ constexpr int dkv_keys(int hd) {
  return hd > 128 ? kBT : 2 * kBT;
}
// Keys of a dQ K / V tile: 64, or 32 at hd 256 (shared memory).
__host__ __device__ constexpr int dq_bkv(int hd) { return hd > 128 ? 32 : 64; }
// The dQ block has a producer warp at hd 64 and 128 (166 registers a
// thread, within the 168 of a 288-thread block); at hd 256 a consumer
// thread needs more (the 168 spilled 136 bytes), so thread 0 issues the
// copies in band, as in the dK / dV blocks, and the ring has three stages.
__host__ __device__ constexpr bool dq_producer(int hd) { return hd <= 128; }
__host__ __device__ constexpr int dq_threads(int hd) {
  return dq_producer(hd) ? kDqThreads : kBConsumers;
}
__host__ __device__ constexpr int dq_stages(int hd) {
  return dq_producer(hd) ? kBStages : 3;
}
constexpr int kPadRows = 128;            // lse / D rows padded to this
constexpr float kLog2e = 1.4426950408889634f;
// named barriers of the split kernel (0 is __syncthreads)
constexpr int kPFull = 1, kPEmpty = 2;

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(kBConsumers) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(kBConsumers)
               : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing on `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Rows `row0` .. + R n - 1 of one head into n consecutive R-row boxes of
// each 64-column panel (`panels[p]` holds R n rows; `map`'s boxes are R
// rows).
template <int NP, int N, int R = kBT>
__device__ __forceinline__ void load_rows(__nv_bfloat16 (*panels)[N * R * kPanel],
                                          const CUtensorMap* map,
                                          uint64_t* bar, int head, int row0,
                                          int b) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int r = 0; r < N; ++r)
      tma_load(panels[p] + r * R * kPanel, map, bar, p * kPanel, head,
               row0 + r * R, b);
}

// d (64 x 32, f32) += A (64 x 16, bf16, shared, K-major) . B (16 x 32, bf16,
// shared, K-major); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// The descriptor of `p` as a value the compiler must build where it is
// used: descriptors of the k-steps are this plus an offset, so the compiler
// holds two registers for them, not two per k-step (hoisted out of the tile
// loop, those cost the consumers the registers they need).
__device__ __forceinline__ uint64_t desc_at(const void* p, uint32_t lbo) {
  uint64_t d = sw128_desc(p, lbo);
  asm volatile("" : "+l"(d));
  return d;
}

// A descriptor moved on by `bytes` (a multiple of 16 inside the tile): the
// start address is its low field, in units of 16 bytes.
__device__ __forceinline__ uint64_t desc_plus(uint64_t d, uint32_t bytes) {
  return d + (bytes >> 4);
}

// d (64 x HD) += A (64 x R, registers) . B (R x HD, shared, N-major): B the
// R rows of a tile's panels; k-step kk is B's rows 16 kk .. + 15.  hd 256
// takes two m64n128 products a k-step, columns 0-127 (panels 0, 1) into
// d[0..63] and 128-255 (panels 2, 3) into d[64..127]: the accumulator
// layout of one m64n256 product, as the forward's P V.
template <int HD, int R>
__device__ __forceinline__ void rs_tile(float (&d)[HD / 2],
                                        const uint32_t (&a)[R / 16][4],
                                        const __nv_bfloat16* b) {
  // k-step kk: 16 rows (of 128 bytes) on; lbo: the next 64-column panel
  constexpr uint32_t lbo = R * kPanel * 2;
  const uint64_t db = desc_at(b, lbo);
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk) {
    if constexpr (HD == 64) {
      wgmma_rs_n64(d, a[kk], desc_plus(db, kk * 16 * kPanel * 2));
    } else if constexpr (HD == 128) {
      wgmma_rs_n128(d, a[kk], desc_plus(db, kk * 16 * kPanel * 2));
    } else {
      static_assert(HD == 256, "wgmma flash backward: hd 64, 128 or 256");
      wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&d[0]), a[kk],
                    desc_plus(db, kk * 16 * kPanel * 2));
      wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&d[64]), a[kk],
                    desc_plus(db, (2 * R + kk * 16) * kPanel * 2));
    }
  }
}

// d (64 x N) = A . B^T over the head dim: A the 64 rows at `a` of panels
// `sa` elements apart, B the N rows at `b` of panels `sb` apart; both
// K-major (k-step kk: 32 bytes into panel kk / 4).
template <int HD, int N>
__device__ __forceinline__ void ss_tile(float (&d)[N / 2],
                                        const __nv_bfloat16* a, int sa,
                                        const __nv_bfloat16* b, int sb) {
  const uint64_t da = desc_at(a, 16), db = desc_at(b, 16);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint64_t ka = desc_plus(da, ((kk / 4) * sa + (kk % 4) * 16) * 2);
    const uint64_t kb = desc_plus(db, ((kk / 4) * sb + (kk % 4) * 16) * 2);
    if constexpr (N == 64)
      wgmma_ss_n64(d, ka, kb, kk > 0);
    else
      wgmma_ss_n32(d, ka, kb, kk > 0);
  }
}

// A 64 x N tile's accumulators (row 16 w + g (+ 8), column 8 j + 2 t +
// (e & 1) in d[4 j + e], see flash_attention.cu) as the bf16 A operand of
// N / 16 k-steps of 16 columns.
template <int N>
__device__ __forceinline__ void pack_tile(uint32_t (&a)[N / 16][4],
                                          const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(d[8 * kk], d[8 * kk + 1]);
    a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// A warpgroup's 64 x HD accumulator to rows row0 + 16 w + g (+ 8) of a
// (.., rows, heads, HD) bf16 tensor (`out` at its batch and head), scaled;
// rows at or past `n` are not written.
template <int HD>
__device__ __forceinline__ void store_rows(const float (&d)[HD / 2],
                                           __nv_bfloat16* out, size_t stride,
                                           int row0, int n, float scale) {
  const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
  const int r0 = row0 + 16 * w + (lane >> 2), r1 = r0 + 8, t = lane & 3;
#pragma unroll
  for (int c8 = 0; c8 < HD / 8; ++c8) {
    const int c = c8 * 8 + 2 * t;
    if (r0 < n)
      *reinterpret_cast<uint32_t*>(out + r0 * stride + c) =
          pack_bf16(d[4 * c8] * scale, d[4 * c8 + 1] * scale);
    if (r1 < n)
      *reinterpret_cast<uint32_t*>(out + r1 * stride + c) =
          pack_bf16(d[4 * c8 + 2] * scale, d[4 * c8 + 3] * scale);
  }
}

// D = rowsum(dO o) and lse log2(e) of every (batch, head, row), into rows
// of S_pad (zeros from S on): Dp and Lp are (B, H, S_pad).  One warp a
// row of the (B, S_pad, H) order, the lanes' partial sums added in a fixed
// butterfly.
template <int HD>
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const __nv_bfloat16* __restrict__ o,
                      const __nv_bfloat16* __restrict__ dO,
                      const float* __restrict__ lse, float* __restrict__ Dp,
                      float* __restrict__ Lp, int B, int S, int S_pad,
                      int H) {
  // columns per lane: 2 (hd 16, 32 and 64: lanes past hd / 2 add 0), 4
  // or 8
  constexpr int PER = HD > 64 ? HD / 32 : 2;
  const long long rowid = ((long long)blockIdx.x * 256 + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (rowid >= (long long)B * S_pad * H) return;   // whole warps leave
  const int h = (int)(rowid % H);
  const long long bs = rowid / H;
  const int s = (int)(bs % S_pad), b = (int)(bs / S_pad);
  float acc = 0.f, l2 = 0.f;
  if (s < S) {
    const size_t off = (((size_t)b * S + s) * H + h) * HD + PER * lane;
    if (PER * lane < HD) {
#pragma unroll
      for (int i = 0; i < PER; i += 2) {
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(o + off + i));
        const float2 y = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dO + off + i));
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
      }
    }
    l2 = lse[((size_t)b * H + h) * S + s] * kLog2e;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const size_t at = ((size_t)b * H + h) * S_pad + s;
    Dp[at] = acc;
    Lp[at] = l2;
  }
}

template <int HD>
struct DkvSmem {
  static constexpr int NP = HD / kPanel, BQ = dkv_bq(HD);
  static constexpr int KEYS = dkv_keys(HD);
  static constexpr bool kSplit = KEYS == kBT;
  __nv_bfloat16 k[NP][KEYS * kPanel];               // the keys, resident
  __nv_bfloat16 v[NP][KEYS * kPanel];
  __nv_bfloat16 q[kDkvStages][NP][BQ * kPanel];     // BQ query rows
  __nv_bfloat16 dO[kDkvStages][NP][BQ * kPanel];
  float lse[kDkvStages][BQ], dd[kDkvStages][BQ];    // the rows' lse, D
  // the split kernel's P^T of a step, [accumulator][thread of the
  // warpgroup]
  float p[kSplit ? BQ / 2 : 1][128];
  uint64_t kv_full, full[kDkvStages], empty[kDkvStages];
};

template <int HD>
struct DqSmem {
  static constexpr int NP = HD / kPanel, BKV = dq_bkv(HD);
  static constexpr int NST = dq_stages(HD);
  __nv_bfloat16 q[NP][2 * kBT * kPanel];            // 128 query rows
  __nv_bfloat16 dO[NP][2 * kBT * kPanel];
  __nv_bfloat16 k[NST][NP][BKV * kPanel];           // BKV keys
  __nv_bfloat16 v[NST][NP][BKV * kPanel];
  float lse[2 * kBT], dd[2 * kBT];
  uint64_t q_full, full[NST], empty[NST];
};

template <typename Smem>
__device__ __forceinline__ Smem& aligned_smem() {
  extern __shared__ unsigned char bwd_wg_smem[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  return *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(bwd_wg_smem) + 1023) & ~uintptr_t(1023));
}

template <int NSTAGES>
__device__ __forceinline__ void init_ring(uint64_t* first, uint64_t* full,
                                          uint64_t* empty) {
  if (threadIdx.x == 0) {
    mbar_init(first, 1);
    for (int s = 0; s < NSTAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kBConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The query steps of a dK / dV block over keys k0 .. k0 + keys - 1 (its
// last real key k_last): tiles qt0 .. qt0 + per_head - 1 of BQ rows of each
// head of the group.  Step `it` is tile qt0 + it % per_head of the group's
// head it / per_head, in ring slot it % kDkvStages; thread 0 issues its
// copies.
template <int HD>
struct DkvSteps {
  static constexpr int NP = HD / kPanel, BQ = dkv_bq(HD);
  int qt0, per_head, n_it;

  __device__ DkvSteps(int k0, int k_last, int rep, const BwdShape& sh) {
    qt0 = first_query(k0, sh) / BQ;
    per_head = (query_end(k_last, sh) + BQ - 1) / BQ - qt0;
    n_it = rep * per_head;
  }
  __device__ int q0(int it) const { return (qt0 + it % per_head) * BQ; }
  __device__ void issue(DkvSmem<HD>& sm, int it, const CUtensorMap* tm_q,
                        const CUtensorMap* tm_do, const float* Lp,
                        const float* Dp, int b, int kh, int rep,
                        const BwdShape& sh) const {
    const int s = it % kDkvStages, h = kh * rep + it / per_head;
    const int row0 = q0(it);
    const size_t rows = ((size_t)b * sh.H + h) * sh.S_pad + row0;
    mbar_expect_tx(&sm.full[s], 2 * NP * BQ * kPanel * 2 + 2 * BQ * 4);
    load_rows<NP, 1, BQ>(sm.q[s], tm_q, &sm.full[s], h, row0, b);
    load_rows<NP, 1, BQ>(sm.dO[s], tm_do, &sm.full[s], h, row0, b);
    bulk_load(sm.lse[s], Lp + rows, BQ * 4, &sm.full[s]);
    bulk_load(sm.dd[s], Dp + rows, BQ * 4, &sm.full[s]);
  }
};

// Thread 0 before step `it`: refill the slot of step it - 1 once both
// warpgroups are done with it (the first kDkvStages steps were issued
// before the loop).
template <int HD>
__device__ __forceinline__ void dkv_refill(DkvSmem<HD>& sm,
                                           const DkvSteps<HD>& st, int it,
                                           const CUtensorMap* tm_q,
                                           const CUtensorMap* tm_do,
                                           const float* Lp, const float* Dp,
                                           int b, int kh, int rep,
                                           const BwdShape& sh) {
  const int refill = it - 1 + kDkvStages;
  if (threadIdx.x == 0 && it > 0 && refill < st.n_it) {
    mbar_wait(&sm.empty[(it - 1) % kDkvStages],
              ((it - 1) / kDkvStages) & 1);
    st.issue(sm, refill, tm_q, tm_do, Lp, Dp, b, kh, rep, sh);
  }
}

// dK, dV of 128 keys of one kv head, hd 64 or 128 (see the header).  Lp,
// Dp (B, H, S_pad); tm_q and tm_do have boxes of dkv_bq(HD) rows.  No
// producer warp: thread 0 issues the copies, kDkvStages - 1 tiles ahead of
// its own warpgroup, so the block is two warpgroups and ptxas may give each
// thread the 198 registers the consumers take at hd 128 (a third warpgroup
// or warp caps every thread at 168, whatever setmaxnreg asks at run time:
// the same 136-byte spill at 24 / 240, 40 / 232 and 56 / 224 registers,
// chip runs).
template <int HD>
__global__ void __launch_bounds__(kBConsumers, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const float* __restrict__ Lp,
                      const float* __restrict__ Dp,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, BwdShape sh,
                      float scale) {
  constexpr int NP = HD / kPanel, BQ = dkv_bq(HD);
  static_assert(dkv_keys(HD) == 2 * kBT, "hd 256 takes the split kernel");
  DkvSmem<HD>& sm = aligned_smem<DkvSmem<HD>>();
  const int b = blockIdx.x / sh.K, kh = blockIdx.x % sh.K;
  const int rep = sh.H / sh.K;
  const int k0 = blockIdx.y * 2 * kBT;     // heaviest (k0 = 0) first
  const DkvSteps<HD> st(k0, min(k0 + 2 * kBT, sh.S_kv) - 1, rep, sh);
  init_ring<kDkvStages>(&sm.kv_full, sm.full, sm.empty);
  if (threadIdx.x == 0) {
    mbar_expect_tx(&sm.kv_full, 2 * NP * 2 * kBoxBytes);
    load_rows<NP, 2>(sm.k, &tm_k, &sm.kv_full, kh, k0, b);
    load_rows<NP, 2>(sm.v, &tm_v, &sm.kv_full, kh, k0, b);
    for (int it = 0; it < min(kDkvStages, st.n_it); ++it)
      st.issue(sm, it, &tm_q, &tm_do, Lp, Dp, b, kh, rep, sh);
  }

  // ---- warpgroup wg owns keys kw0 .. kw0 + 63 ----
  const int wg = threadIdx.x / 128, t = threadIdx.x & 3;
  const int kw0 = k0 + wg * kBT;
  const int kw_last = min(kw0 + kBT, sh.S_kv) - 1;
  const float scale_log2 = scale * kLog2e;
  const __nv_bfloat16* kA = sm.k[0] + wg * kBT * kPanel;
  const __nv_bfloat16* vA = sm.v[0] + wg * kBT * kPanel;
  float adk[HD / 2], adv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) adk[i] = adv[i] = 0.f;
  mbar_wait(&sm.kv_full, 0);
  for (int it = 0; it < st.n_it; ++it) {
    dkv_refill<HD>(sm, st, it, &tm_q, &tm_do, Lp, Dp, b, kh, rep, sh);
    const int s = it % kDkvStages;
    mbar_wait(&sm.full[s], (it / kDkvStages) & 1);
    const int q0 = st.q0(it);
    // some query of the step sees a key of this warpgroup
    if (kw0 <= kw_last &&
        any_seen(q0, min(q0 + BQ, sh.S) - 1, kw0, kw_last, sh)) {
      float sT[BQ / 2], dpt[BQ / 2];
      wgmma_fence();
      ss_tile<HD, BQ>(sT, kA, 2 * kBT * kPanel, sm.q[s][0], BQ * kPanel);
      ss_tile<HD, BQ>(dpt, vA, 2 * kBT * kPanel, sm.dO[s][0], BQ * kPanel);
      wgmma_commit();
      wgmma_wait0();
      reg_fence(sT);
      reg_fence(dpt);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const int c = 8 * j + 2 * t;          // query columns c, c + 1
        const float2 l = *reinterpret_cast<const float2*>(&sm.lse[s][c]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sT[4 * j + e] = exp2_approx(fmaf(sT[4 * j + e], scale_log2,
                                           -((e & 1) ? l.y : l.x)));
      }
      if (needs_mask(q0, BQ, kw0, kBT, sh))
        mask_tile<BQ, true>(sT, kw0, q0, sh);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 dd = *reinterpret_cast<const float2*>(&sm.dd[s][c]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * j + e] = sT[4 * j + e] *
                           (dpt[4 * j + e] - ((e & 1) ? dd.y : dd.x));
      }
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
      pack_tile<BQ>(pa, sT);
      pack_tile<BQ>(da, dpt);
      wgmma_fence();
      rs_tile<HD, BQ>(adv, pa, sm.dO[s][0]);
      rs_tile<HD, BQ>(adk, da, sm.q[s][0]);
      wgmma_commit();
      wgmma_wait0();
      reg_fence(adv);
      reg_fence(adk);
      reg_fence(pa);   // the operands stay live until their products end
      reg_fence(da);
    }
    mbar_arrive(&sm.empty[s]);   // this thread is done with the stage
  }
  const size_t krow = (size_t)sh.K * HD;
  const size_t off = (size_t)b * sh.S_kv * krow + (size_t)kh * HD;
  store_rows<HD>(adk, dk + off, krow, kw0, sh.S_kv, scale);
  store_rows<HD>(adv, dv + off, krow, kw0, sh.S_kv, 1.f);
}

// dK, dV of 64 keys of one kv head at hd 256 (see the header): both
// warpgroups take the same keys; warpgroup 0 forms S^T = K Q^T and P^T,
// hands P^T to warpgroup 1 through shared memory and accumulates dV += P^T
// dO; warpgroup 1 forms dP^T = V dO^T and dS^T = P^T (dP^T - D) and
// accumulates dK += dS^T Q.  Thread 0 issues the copies, as above.
template <int HD>
__global__ void __launch_bounds__(kBConsumers, 1)
flash_bwd_dkdv_split_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do,
                            const float* __restrict__ Lp,
                            const float* __restrict__ Dp,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, BwdShape sh,
                            float scale) {
  constexpr int NP = HD / kPanel, BQ = dkv_bq(HD);
  static_assert(dkv_keys(HD) == kBT, "the split kernel takes hd 256");
  DkvSmem<HD>& sm = aligned_smem<DkvSmem<HD>>();
  const int b = blockIdx.x / sh.K, kh = blockIdx.x % sh.K;
  const int rep = sh.H / sh.K;
  const int k0 = blockIdx.y * kBT;         // heaviest (k0 = 0) first
  const int k_last = min(k0 + kBT, sh.S_kv) - 1;
  const DkvSteps<HD> st(k0, k_last, rep, sh);
  init_ring<kDkvStages>(&sm.kv_full, sm.full, sm.empty);
  if (threadIdx.x == 0) {
    mbar_expect_tx(&sm.kv_full, 2 * NP * kBoxBytes);
    load_rows<NP, 1>(sm.k, &tm_k, &sm.kv_full, kh, k0, b);
    load_rows<NP, 1>(sm.v, &tm_v, &sm.kv_full, kh, k0, b);
    for (int it = 0; it < min(kDkvStages, st.n_it); ++it)
      st.issue(sm, it, &tm_q, &tm_do, Lp, Dp, b, kh, rep, sh);
  }

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int t = threadIdx.x & 3;
  const float scale_log2 = scale * kLog2e;
  // warpgroup 0: dV; warpgroup 1: dK
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  int done = 0;                            // steps with products so far
  mbar_wait(&sm.kv_full, 0);
  for (int it = 0; it < st.n_it; ++it) {
    dkv_refill<HD>(sm, st, it, &tm_q, &tm_do, Lp, Dp, b, kh, rep, sh);
    const int s = it % kDkvStages;
    mbar_wait(&sm.full[s], (it / kDkvStages) & 1);
    const int q0 = st.q0(it);
    if (any_seen(q0, min(q0 + BQ, sh.S) - 1, k0, k_last, sh)) {
      float x[BQ / 2];                     // S^T, then P^T; or dP^T, dS^T
      wgmma_fence();
      if (wg == 0)
        ss_tile<HD, BQ>(x, sm.k[0], kBT * kPanel, sm.q[s][0], BQ * kPanel);
      else
        ss_tile<HD, BQ>(x, sm.v[0], kBT * kPanel, sm.dO[s][0], BQ * kPanel);
      wgmma_commit();
      wgmma_wait0();
      reg_fence(x);
      uint32_t xa[BQ / 16][4];
      if (wg == 0) {
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const int c = 8 * j + 2 * t;
          const float2 l = *reinterpret_cast<const float2*>(&sm.lse[s][c]);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[4 * j + e] = exp2_approx(fmaf(x[4 * j + e], scale_log2,
                                            -((e & 1) ? l.y : l.x)));
        }
        if (needs_mask(q0, BQ, k0, kBT, sh))
          mask_tile<BQ, true>(x, k0, q0, sh);
        if (done > 0) named_sync(kPEmpty);   // warpgroup 1 read the last
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) sm.p[i][tid] = x[i];
        named_arrive(kPFull);
      } else {
        named_sync(kPFull);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const int c = 8 * j + 2 * t;
          const float2 dd = *reinterpret_cast<const float2*>(&sm.dd[s][c]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            x[i] = sm.p[i][tid] * (x[i] - ((e & 1) ? dd.y : dd.x));
          }
        }
        named_arrive(kPEmpty);
      }
      pack_tile<BQ>(xa, x);
      wgmma_fence();
      rs_tile<HD, BQ>(acc, xa, wg == 0 ? sm.dO[s][0] : sm.q[s][0]);
      wgmma_commit();
      wgmma_wait0();
      reg_fence(acc);
      reg_fence(xa);   // the operand stays live until its product ends
      ++done;
    }
    mbar_arrive(&sm.empty[s]);   // this thread is done with the stage
  }
  // warpgroup 1's last arrival on kPEmpty, taken so both barriers end even
  if (wg == 0 && done > 0) named_sync(kPEmpty);
  const size_t krow = (size_t)sh.K * HD;
  const size_t off = (size_t)b * sh.S_kv * krow + (size_t)kh * HD;
  if (wg == 0)
    store_rows<HD>(acc, dv + off, krow, k0, sh.S_kv, 1.f);
  else
    store_rows<HD>(acc, dk + off, krow, k0, sh.S_kv, scale);
}

// dQ of 128 query rows of one head (see the header): two consumer
// warpgroups, and at hd 64 and 128 one producer warp (166 registers a
// thread at hd 128, within the 168 a block of 288 threads gets); at hd 256
// thread 0 issues the copies (`dq_producer`).
template <int HD>
__global__ void __launch_bounds__(dq_threads(HD), 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ Lp,
                    const float* __restrict__ Dp,
                    __nv_bfloat16* __restrict__ dq, BwdShape sh,
                    float scale) {
  constexpr int NP = HD / kPanel, BKV = dq_bkv(HD), NST = dq_stages(HD);
  DqSmem<HD>& sm = aligned_smem<DqSmem<HD>>();
  const int b = blockIdx.x / sh.H, h = blockIdx.x % sh.H;
  const int kh = h / (sh.H / sh.K);
  // causal without a window: the last query tiles have the most key tiles;
  // start them first, all heads' at once (blockIdx.x runs fastest)
  const bool heavy_last = sh.causal && !sh.window;
  const int q0 =
      (heavy_last ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * 2 * kBT;
  const int j0 = first_key(q0, sh) / BKV;
  const int n_kt = (key_end(min(sh.S, q0 + 2 * kBT) - 1, sh) + BKV - 1) /
                   BKV;
  const int n_it = n_kt - j0;
  init_ring<NST>(&sm.q_full, sm.full, sm.empty);
  // the block's Q, dO, lse and D rows
  auto issue_q = [&] {
    const size_t rows = ((size_t)b * sh.H + h) * sh.S_pad + q0;
    mbar_expect_tx(&sm.q_full, 2 * NP * 2 * kBoxBytes + 2 * 2 * kBT * 4);
    load_rows<NP, 2>(sm.q, &tm_q, &sm.q_full, h, q0, b);
    load_rows<NP, 2>(sm.dO, &tm_do, &sm.q_full, h, q0, b);
    bulk_load(sm.lse, Lp + rows, 2 * kBT * 4, &sm.q_full);
    bulk_load(sm.dd, Dp + rows, 2 * kBT * 4, &sm.q_full);
  };
  // step `it`: K / V tile j0 + it into ring slot it % NST
  auto issue_kv = [&](int it) {
    const int s = it % NST, kv0 = (j0 + it) * BKV;
    mbar_expect_tx(&sm.full[s], 2 * NP * BKV * kPanel * 2);
    load_rows<NP, 1, BKV>(sm.k[s], &tm_k, &sm.full[s], kh, kv0, b);
    load_rows<NP, 1, BKV>(sm.v[s], &tm_v, &sm.full[s], kh, kv0, b);
  };
  if constexpr (dq_producer(HD)) {
    if (threadIdx.x >= kBConsumers) {
      // ---- producer warp: one lane issues every copy ----
      if (threadIdx.x != kBConsumers) return;
      issue_q();
      for (int it = 0; it < n_it; ++it) {
        if (it >= NST) mbar_wait(&sm.empty[it % NST], (it / NST - 1) & 1);
        issue_kv(it);
      }
      return;
    }
  } else if (threadIdx.x == 0) {
    issue_q();
    for (int it = 0; it < min(NST, n_it); ++it) issue_kv(it);
  }

  const int wg = threadIdx.x / 128, w = (threadIdx.x / 32) % 4;
  const int g = (threadIdx.x & 31) >> 2;
  const int qw0 = q0 + wg * kBT;
  const int qw_last = min(qw0 + kBT, sh.S) - 1;
  const int lr0 = wg * kBT + 16 * w + g;   // rows lr0, lr0 + 8 of the block
  const float scale_log2 = scale * kLog2e;
  const __nv_bfloat16* qA = sm.q[0] + wg * kBT * kPanel;
  const __nv_bfloat16* dA = sm.dO[0] + wg * kBT * kPanel;
  float adq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) adq[i] = 0.f;
  mbar_wait(&sm.q_full, 0);
  const float l0 = sm.lse[lr0], l1 = sm.lse[lr0 + 8];
  const float d0 = sm.dd[lr0], d1 = sm.dd[lr0 + 8];
  for (int it = 0; it < n_it; ++it) {
    if constexpr (!dq_producer(HD)) {
      // thread 0: refill the slot of step it - 1 once both warpgroups
      // are done with it
      const int refill = it - 1 + NST;
      if (threadIdx.x == 0 && it > 0 && refill < n_it) {
        mbar_wait(&sm.empty[(it - 1) % NST], ((it - 1) / NST) & 1);
        issue_kv(refill);
      }
    }
    const int s = it % NST;
    mbar_wait(&sm.full[s], (it / NST) & 1);
    const int kv0 = (j0 + it) * BKV;
    // some key of the tile is seen by some row of this warpgroup
    if (qw0 <= qw_last &&
        any_seen(qw0, qw_last, kv0, min(kv0 + BKV, sh.S_kv) - 1, sh)) {
      float sc[BKV / 2], dp[BKV / 2];
      wgmma_fence();
      ss_tile<HD, BKV>(sc, qA, 2 * kBT * kPanel, sm.k[s][0], BKV * kPanel);
      ss_tile<HD, BKV>(dp, dA, 2 * kBT * kPanel, sm.v[s][0], BKV * kPanel);
      wgmma_commit();
      wgmma_wait0();
      reg_fence(sc);
      reg_fence(dp);
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i)
        sc[i] = exp2_approx(fmaf(sc[i], scale_log2, -((i & 2) ? l1 : l0)));
      if (needs_mask(qw0, kBT, kv0, BKV, sh))
        mask_tile<BKV, false>(sc, qw0, kv0, sh);
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i)
        sc[i] = sc[i] * (dp[i] - ((i & 2) ? d1 : d0));
      uint32_t da[BKV / 16][4];
      pack_tile<BKV>(da, sc);
      wgmma_fence();
      rs_tile<HD, BKV>(adq, da, sm.k[s][0]);
      wgmma_commit();
      wgmma_wait0();
      reg_fence(adq);
      reg_fence(da);
    }
    mbar_arrive(&sm.empty[s]);
  }
  const size_t qrow = (size_t)sh.H * HD;
  store_rows<HD>(adq, dq + (size_t)b * sh.S * qrow + (size_t)h * HD, qrow,
                 qw0, sh.S, scale);
}

// ---------------------------------------------------------------------------
// bf16, hd 16 and 32: mma.sync
// ---------------------------------------------------------------------------

constexpr int kMRows = 64;       // keys of a dK / dV block, rows of a dQ
                                 // block: four warps of 16
constexpr int kMStep = 64;       // query rows of a dK / dV step, keys of a
                                 // dQ step
constexpr int kMThreads = 128;
constexpr int kMStages = 3;      // cp.async ring: one barrier a step
// Blocks an SM should hold: at hd 16 ptxas then keeps a thread at 128
// registers (four blocks, 16 warps an SM: ~7% faster at minitron-8b's
// shape, on an H100 80GB HBM3 at 700 W, in turns); at hd 32 that cap ran
// slower.
__host__ __device__ constexpr int mma_min_blocks(int hd) {
  return hd <= 16 ? 4 : 1;
}

// Rows r0 and r1 = r0 + 8 of one head of a (.., rows, heads, HD) bf16
// tensor (`src` at its batch and head, rows `stride` apart) as the A
// fragments of the HD / 16 k-steps over the head dim; rows at or past `n`
// are zeros.
template <int HD>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[HD / 16][4],
                                            const __nv_bfloat16* src,
                                            size_t stride, int r0, int n) {
  const int t = threadIdx.x & 3, r1 = r0 + 8;
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc) {
    const int c = kc * 16 + 2 * t;
    const uint32_t* p0 =
        reinterpret_cast<const uint32_t*>(src + (size_t)r0 * stride + c);
    const uint32_t* p1 =
        reinterpret_cast<const uint32_t*>(src + (size_t)r1 * stride + c);
    a[kc][0] = r0 < n ? p0[0] : 0u;
    a[kc][1] = r1 < n ? p1[0] : 0u;
    a[kc][2] = r0 < n ? p0[4] : 0u;
    a[kc][3] = r1 < n ? p1[4] : 0u;
  }
}

// kMStep rows (r0 ..) of one head into a shared tile of rows of HD + 8
// (conflict-free ldmatrix), by cp.async; rows at or past `n` are zeros.
template <int HD>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          size_t stride, int r0, int n) {
  constexpr int LD = HD + 8, VEC = HD / 8;   // 16-byte vectors a row
  for (int i = threadIdx.x; i < kMStep * VEC; i += kMThreads) {
    const int r = i / VEC, c = (i % VEC) * 8;
    const bool in = r0 + r < n;     // rows past n: zeros, read nothing
    cp_async16(dst + r * LD + c, src + (size_t)(in ? r0 + r : 0) * stride + c,
               in);
  }
}

// d (16 x kMStep, 8 column tiles) = A (16 x HD, fragments) . B^T, B the
// kMStep rows of a shared tile (rows of HD + 8): the scores of a warp's 16
// rows against a step's rows.
template <int HD>
__device__ __forceinline__ void mma_abt(float (&d)[kMStep / 8][4],
                                        const uint32_t (&a)[HD / 16][4],
                                        const __nv_bfloat16* b) {
  constexpr int LD = HD + 8;
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int nt = 0; nt < kMStep / 8; ++nt)
    d[nt][0] = d[nt][1] = d[nt][2] = d[nt][3] = 0.f;
#pragma unroll
  for (int nt = 0; nt < kMStep / 8; nt += 2) {
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      uint32_t f[4];
      ldmatrix_x4(f, b + ((nt + (mi >> 1)) * 8 + mr) * LD + kc * 16 +
                         (mi & 1) * 8);
      mma_bf16(d[nt], a[kc], f[0], f[1]);
      mma_bf16(d[nt + 1], a[kc], f[2], f[3]);
    }
  }
}

// acc (16 x HD) += X (16 x kMStep, f32 accumulators, rounded to bf16) . B,
// B the kMStep rows of a shared tile (rows of HD + 8), read transposed.
template <int HD>
__device__ __forceinline__ void mma_xb(float (&acc)[HD / 8][4],
                                       const float (&x)[kMStep / 8][4],
                                       const __nv_bfloat16* b) {
  constexpr int LD = HD + 8;
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int j = 0; j < kMStep / 16; ++j) {
    const uint32_t xa[4] = {pack_bf16(x[2 * j][0], x[2 * j][1]),
                            pack_bf16(x[2 * j][2], x[2 * j][3]),
                            pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]),
                            pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3])};
#pragma unroll
    for (int n = 0; n < HD / 8; n += 2) {
      uint32_t f[4];
      ldmatrix_x4_trans(f, b + (j * 16 + (mi & 1) * 8 + mr) * LD +
                               (n + (mi >> 1)) * 8);
      mma_bf16(acc[n], xa, f[0], f[1]);
      mma_bf16(acc[n + 1], xa, f[2], f[3]);
    }
  }
}

// A warp's 16 x HD accumulator to rows r0 = row0 + g and r0 + 8 of a (..,
// rows, heads, HD) tensor (`out` at its batch and head), scaled: bf16, or
// float32 (the dK / dV partials of one query head); rows at or past `n` are
// not written.
template <int HD, typename T>
__device__ __forceinline__ void store_warp_rows(const float (&d)[HD / 8][4],
                                                T* out, size_t stride,
                                                int row0, int n, float scale) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int r0 = row0 + (lane >> 2), r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int c = j * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0;
      const float x = d[j][2 * half] * scale, y = d[j][2 * half + 1] * scale;
      if (r >= n) continue;
      if constexpr (sizeof(T) == 2)
        *reinterpret_cast<uint32_t*>(out + (size_t)r * stride + c) =
            pack_bf16(x, y);
      else
        *reinterpret_cast<float2*>(out + (size_t)r * stride + c) =
            make_float2(x, y);
    }
  }
}

// dK, dV of kMRows keys of one kv head from one query head h, hd 16 or 32
// (see the header).  Lp, Dp (B, H, S_pad).  Warp w owns keys kw0 = k0 +
// 16 w .. + 15: their K and V rows as A fragments, dK and dV in f32
// registers.  The Q and dO rows of head h, kMStep at a time, and their lse
// / D, are copied by cp.async into a three-stage ring (step it + 1 lands
// while it is computed).  With one query head a kv head (H == K) dK and
// dV are written in bf16; else as float32 partials of head h (`pk`, `pv`:
// (B, S_kv, H, HD)), which `flash_bwd_gqa_sum_kernel` adds over the group
// in head order: a block per query head keeps each block's chain of steps
// as short as the forward's, where one block over the whole group ran H /
// K times as many steps in a row (1.00 -> 0.80 ms at minitron-8b's shape
// cut to hd 16, on an H100 80GB HBM3 at 700 W, in turns).  Per step,
// key-major: S^T = K Q^T and dP^T = V dO^T, P^T = exp2(S^T scale log2(e) -
// lse log2(e)), masked where the step meets the diagonal, the window's
// edge or a ragged end, dS^T = P^T (dP^T - D), dV += P^T dO and dK += dS^T
// Q (P^T and dS^T re-packed to bf16, dO and Q read transposed by
// ldmatrix).  A warp none of whose keys a step's queries see skips its
// products.
template <int HD>
__global__ void __launch_bounds__(kMThreads, mma_min_blocks(HD))
flash_bwd_mma_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dO,
                          const float* __restrict__ Lp,
                          const float* __restrict__ Dp,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv,
                          float* __restrict__ pk, float* __restrict__ pv,
                          BwdShape sh, float scale) {
  constexpr int LD = HD + 8, NT = HD / 8;
  __shared__ __align__(16) __nv_bfloat16 sq[kMStages][kMStep * LD];
  __shared__ __align__(16) __nv_bfloat16 sdo[kMStages][kMStep * LD];
  __shared__ __align__(16) float slse[kMStages][kMStep];
  __shared__ __align__(16) float sdd[kMStages][kMStep];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / sh.H, h = blockIdx.x % sh.H;
  const int kh = h / (sh.H / sh.K);
  const int k0 = blockIdx.y * kMRows;      // heaviest (k0 = 0) first
  const int kw0 = k0 + 16 * warp, kw_last = min(kw0 + 16, sh.S_kv) - 1;
  const size_t qrow = (size_t)sh.H * HD, krow = (size_t)sh.K * HD;
  const size_t kvoff = (size_t)b * sh.S_kv * krow + (size_t)kh * HD;
  uint32_t kf[HD / 16][4], vf[HD / 16][4];
  load_a_rows<HD>(kf, k + kvoff, krow, kw0 + g, sh.S_kv);
  load_a_rows<HD>(vf, v + kvoff, krow, kw0 + g, sh.S_kv);
  float adk[NT][4], adv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

  // steps: query tiles qt0 .. qt0 + n_it - 1 of head h
  const int qt0 = first_query(k0, sh) / kMStep;
  const int n_it =
      (query_end(min(k0 + kMRows, sh.S_kv) - 1, sh) + kMStep - 1) / kMStep -
      qt0;
  auto issue = [&](int it) {
    const int st = it % kMStages, q0 = (qt0 + it) * kMStep;
    const size_t qoff = (size_t)b * sh.S * qrow + (size_t)h * HD;
    copy_rows<HD>(sq[st], q + qoff, qrow, q0, sh.S);
    copy_rows<HD>(sdo[st], dO + qoff, qrow, q0, sh.S);
    // the rows' lse and D, four a copy (rows padded to S_pad: in range)
    if (threadIdx.x < kMStep / 2) {
      const int half = threadIdx.x / (kMStep / 4);
      const int j = threadIdx.x % (kMStep / 4);
      const size_t rows = ((size_t)b * sh.H + h) * sh.S_pad + q0 + 4 * j;
      cp_async16(half ? &sdd[st][4 * j] : &slse[st][4 * j],
                 (half ? Dp : Lp) + rows, true);
    }
    cp_async_commit();
  };
  const float scale_log2 = scale * kLog2e;
  if (n_it > 0) issue(0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % kMStages;
    if (it + 1 < n_it) {
      issue(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // step `it` has landed for every thread.  One barrier a step: the copy
    // of it + 1, issued above before it, fills the stage step it - 2 read,
    // and every warp had finished step it - 2 to pass step it - 1's barrier
    __syncthreads();
    const int q0 = (qt0 + it) * kMStep;
    if (kw0 <= kw_last &&
        any_seen(q0, min(q0 + kMStep, sh.S) - 1, kw0, kw_last, sh)) {
      float pt[kMStep / 8][4], dst[kMStep / 8][4];
      mma_abt<HD>(pt, kf, sq[st]);
      mma_abt<HD>(dst, vf, sdo[st]);
      // the step's queries 8 nt + 2 t, + 1 are columns e & 1
#pragma unroll
      for (int nt = 0; nt < kMStep / 8; ++nt) {
        const float2 l =
            *reinterpret_cast<const float2*>(&slse[st][nt * 8 + 2 * t]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pt[nt][e] = exp2_approx(fmaf(pt[nt][e], scale_log2,
                                       -((e & 1) ? l.y : l.x)));
      }
      // the element mask in a branch of its own, on the tiles that need it
      // only (inline, its predicates were most of a step's instructions);
      // the block's four warps hold a 64-row tile in mask_tile's layout
      if (needs_mask(q0, kMStep, kw0, 16, sh))
        mask_tile<kMStep, true>(
            *reinterpret_cast<float(*)[kMStep / 2]>(&pt[0][0]), k0, q0, sh);
#pragma unroll
      for (int nt = 0; nt < kMStep / 8; ++nt) {
        const float2 dd =
            *reinterpret_cast<const float2*>(&sdd[st][nt * 8 + 2 * t]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dst[nt][e] = pt[nt][e] * (dst[nt][e] - ((e & 1) ? dd.y : dd.x));
      }
      mma_xb<HD>(adv, pt, sdo[st]);
      mma_xb<HD>(adk, dst, sq[st]);
    }
  }
  if (sh.H == sh.K) {
    store_warp_rows<HD>(adk, dk + kvoff, krow, kw0, sh.S_kv, scale);
    store_warp_rows<HD>(adv, dv + kvoff, krow, kw0, sh.S_kv, 1.f);
  } else {
    const size_t prow = (size_t)sh.H * HD;
    const size_t poff = (size_t)b * sh.S_kv * prow + (size_t)h * HD;
    store_warp_rows<HD>(adk, pk + poff, prow, kw0, sh.S_kv, 1.f);
    store_warp_rows<HD>(adv, pv + poff, prow, kw0, sh.S_kv, 1.f);
  }
}

// dK, dV of every (batch, key, kv head) from the per-query-head partials
// (B, S_kv, H, HD) f32: the group's H / K heads added in head order, dK
// scaled, both written in bf16.  One thread a pair of columns.
template <int HD>
__global__ void __launch_bounds__(256)
flash_bwd_gqa_sum_kernel(const float* __restrict__ pk,
                         const float* __restrict__ pv,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, long long pairs,
                         int K, int rep, float scale) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= pairs) return;
  // i runs over (b, key, kh, column pair); the partials' (b, key) rows
  // hold H = K rep heads
  const int c = 2 * (int)(i % (HD / 2));
  const long long row = i / (HD / 2);           // (b, key, kh)
  const size_t src = ((size_t)(row / K) * K * rep + (size_t)(row % K) * rep) *
                         HD + c;
  float2 sk = make_float2(0.f, 0.f), sv = sk;
  for (int hh = 0; hh < rep; ++hh) {
    const float2 a = *reinterpret_cast<const float2*>(pk + src + hh * HD);
    const float2 e = *reinterpret_cast<const float2*>(pv + src + hh * HD);
    sk.x += a.x;
    sk.y += a.y;
    sv.x += e.x;
    sv.y += e.y;
  }
  const size_t dst = (size_t)row * HD + c;
  *reinterpret_cast<uint32_t*>(dk + dst) =
      pack_bf16(sk.x * scale, sk.y * scale);
  *reinterpret_cast<uint32_t*>(dv + dst) = pack_bf16(sv.x, sv.y);
}

// dQ of kMRows query rows of one head, hd 16 or 32 (see the header): warp
// w owns rows q0 + 16 w .. + 15, their Q and dO rows as A fragments, their
// lse and D in registers and dQ in f32 registers; the K and V tiles of
// kMStep keys that the block's rows see stream through a three-stage
// cp.async ring.  S = Q K^T and dP = dO V^T, P and dS as above, dQ += dS K
// (K read transposed).  Causal without a window: the heaviest query tiles
// (the most key tiles) start first.
template <int HD>
__global__ void __launch_bounds__(kMThreads, mma_min_blocks(HD))
flash_bwd_mma_dq_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dO,
                        const float* __restrict__ Lp,
                        const float* __restrict__ Dp,
                        __nv_bfloat16* __restrict__ dq, BwdShape sh,
                        float scale) {
  constexpr int LD = HD + 8, NT = HD / 8;
  __shared__ __align__(16) __nv_bfloat16 sk[kMStages][kMStep * LD];
  __shared__ __align__(16) __nv_bfloat16 sv[kMStages][kMStep * LD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int b = blockIdx.x / sh.H, h = blockIdx.x % sh.H;
  const int kh = h / (sh.H / sh.K);
  const bool heavy_last = sh.causal && !sh.window;
  const int q0 =
      (heavy_last ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kMRows;
  const int qw0 = q0 + 16 * warp, qw_last = min(qw0 + 16, sh.S) - 1;
  const size_t qrow = (size_t)sh.H * HD, krow = (size_t)sh.K * HD;
  const size_t qoff = (size_t)b * sh.S * qrow + (size_t)h * HD;
  const size_t kvoff = (size_t)b * sh.S_kv * krow + (size_t)kh * HD;
  uint32_t qf[HD / 16][4], df[HD / 16][4];
  load_a_rows<HD>(qf, q + qoff, qrow, qw0 + g, sh.S);
  load_a_rows<HD>(df, dO + qoff, qrow, qw0 + g, sh.S);
  // rows qw0 + g and + 8 (padded to S_pad: in range, zeros past S)
  const size_t lrow = ((size_t)b * sh.H + h) * sh.S_pad + qw0 + g;
  const float l0 = Lp[lrow], l1 = Lp[lrow + 8];
  const float d0 = Dp[lrow], d1 = Dp[lrow + 8];
  float adq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    adq[n][0] = adq[n][1] = adq[n][2] = adq[n][3] = 0.f;

  const int j0 = first_key(q0, sh) / kMStep;
  const int n_it =
      (key_end(min(q0 + kMRows, sh.S) - 1, sh) + kMStep - 1) / kMStep - j0;
  auto issue = [&](int it) {
    const int st = it % kMStages, kv0 = (j0 + it) * kMStep;
    copy_rows<HD>(sk[st], k + kvoff, krow, kv0, sh.S_kv);
    copy_rows<HD>(sv[st], v + kvoff, krow, kv0, sh.S_kv);
    cp_async_commit();
  };
  const float scale_log2 = scale * kLog2e;
  if (n_it > 0) issue(0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % kMStages;
    if (it + 1 < n_it) {
      issue(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile `it` has landed; stage reuse as above
    const int kv0 = (j0 + it) * kMStep;
    if (qw0 <= qw_last &&
        any_seen(qw0, qw_last, kv0, min(kv0 + kMStep, sh.S_kv) - 1, sh)) {
      float p[kMStep / 8][4], ds[kMStep / 8][4];
      mma_abt<HD>(p, qf, sk[st]);
      mma_abt<HD>(ds, df, sv[st]);
      // rows qw0 + g and + 8 are e < 2 and e >= 2
#pragma unroll
      for (int nt = 0; nt < kMStep / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[nt][e] = exp2_approx(fmaf(p[nt][e], scale_log2,
                                      -((e & 2) ? l1 : l0)));
      if (needs_mask(qw0, 16, kv0, kMStep, sh))   // as in the dK / dV pass
        mask_tile<kMStep, false>(
            *reinterpret_cast<float(*)[kMStep / 2]>(&p[0][0]), q0, kv0, sh);
#pragma unroll
      for (int nt = 0; nt < kMStep / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[nt][e] = p[nt][e] * (ds[nt][e] - ((e & 2) ? d1 : d0));
      mma_xb<HD>(adq, ds, sk[st]);
    }
  }
  store_warp_rows<HD>(adq, dq + qoff, qrow, qw0, sh.S, scale);
}

template <int HD>
int launch_bwd_mma(const void* q, const void* k, const void* v,
                   const void* o, const void* dO, const void* lse, void* D,
                   void* dq, void* dk, void* dv, int B, BwdShape sh,
                   float scale, cudaStream_t stream) {
  const int H = sh.H, K = sh.K;
  float* Dp = static_cast<float*>(D);
  float* Lp = Dp + (size_t)B * H * sh.S_pad;
  const __nv_bfloat16* tq = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* tk = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* tv = static_cast<const __nv_bfloat16*>(v);
  const __nv_bfloat16* tdo = static_cast<const __nv_bfloat16*>(dO);
  const long long rows = (long long)B * sh.S_pad * H;
  flash_bwd_prep_kernel<HD><<<(int)((rows * 32 + 255) / 256), 256, 0,
                              stream>>>(
      static_cast<const __nv_bfloat16*>(o), tdo,
      static_cast<const float*>(lse), Dp, Lp, B, sh.S, sh.S_pad, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the dK / dV partials of each query head, after the lse / D rows
  float* pk = Lp + (size_t)B * H * sh.S_pad;
  float* pv = pk + (size_t)B * sh.S_kv * H * HD;
  flash_bwd_mma_dkdv_kernel<HD><<<dim3(B * H, (sh.S_kv + kMRows - 1) /
                                                  kMRows),
                                  kMThreads, 0, stream>>>(
      tq, tk, tv, tdo, Lp, Dp, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), pk, pv, sh, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (H != K) {
    const long long pairs = (long long)B * sh.S_kv * K * (HD / 2);
    flash_bwd_gqa_sum_kernel<HD><<<(int)((pairs + 255) / 256), 256, 0,
                                   stream>>>(
        pk, pv, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), pairs, K, H / K, scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  flash_bwd_mma_dq_kernel<HD><<<dim3(B * H, (sh.S + kMRows - 1) / kMRows),
                                kMThreads, 0, stream>>>(
      tq, tk, tv, tdo, Lp, Dp, static_cast<__nv_bfloat16*>(dq), sh, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bwd_wgmma(const void* q, const void* k, const void* v,
                     const void* o, const void* dO, const void* lse, void* D,
                     void* dq, void* dk, void* dv, int B, BwdShape sh,
                     float scale, cudaStream_t stream) {
  constexpr bool kSplit = DkvSmem<HD>::kSplit;
  constexpr int KEYS = dkv_keys(HD);
  constexpr size_t dkv_smem = sizeof(DkvSmem<HD>) + 1024;   // + alignment
  constexpr size_t dq_smem = sizeof(DqSmem<HD>) + 1024;
  static_assert(dkv_smem <= 232448 && dq_smem <= 232448,
                "flash backward: over the 227 KB a block may have");
  // hd 256: the split kernel (only the one taken is instantiated)
  const auto dkv_kernel = [] {
    if constexpr (kSplit)
      return &flash_bwd_dkdv_split_kernel<HD>;
    else
      return &flash_bwd_dkdv_kernel<HD>;
  }();
  // once per instantiation, outside any CUDA-graph capture that follows
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dkv_smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dq_smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int S = sh.S, S_kv = sh.S_kv, H = sh.H, K = sh.K;
  float* Dp = static_cast<float*>(D);
  float* Lp = Dp + (size_t)B * H * sh.S_pad;
  // boxes: 64 rows (Q, dO of dQ's block; K, V of dK / dV's), the dK / dV
  // step's query rows, dQ's K / V tile
  CUtensorMap tq, tk, tv, tdo, tq_s, tdo_s, tk_q, tv_q;
  cudaError_t e = head_map(&tq, q, B, S, H, HD, kBT);
  if (e == cudaSuccess) e = head_map(&tk, k, B, S_kv, K, HD, kBT);
  if (e == cudaSuccess) e = head_map(&tv, v, B, S_kv, K, HD, kBT);
  if (e == cudaSuccess) e = head_map(&tdo, dO, B, S, H, HD, kBT);
  if (e == cudaSuccess) e = head_map(&tq_s, q, B, S, H, HD, dkv_bq(HD));
  if (e == cudaSuccess) e = head_map(&tdo_s, dO, B, S, H, HD, dkv_bq(HD));
  if (e == cudaSuccess) e = head_map(&tk_q, k, B, S_kv, K, HD, dq_bkv(HD));
  if (e == cudaSuccess) e = head_map(&tv_q, v, B, S_kv, K, HD, dq_bkv(HD));
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)B * sh.S_pad * H;
  flash_bwd_prep_kernel<HD><<<(int)((rows * 32 + 255) / 256), 256, 0,
                              stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dO), static_cast<const float*>(lse),
      Dp, Lp, B, S, sh.S_pad, H);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dkv_kernel<<<dim3(B * K, (S_kv + KEYS - 1) / KEYS), kBConsumers, dkv_smem,
               stream>>>(tq_s, tk, tv, tdo_s, Lp, Dp,
                         static_cast<__nv_bfloat16*>(dk),
                         static_cast<__nv_bfloat16*>(dv), sh, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  flash_bwd_dq_kernel<HD><<<dim3(B * H, (S + 2 * kBT - 1) / (2 * kBT)),
                            dq_threads(HD), dq_smem, stream>>>(
      tq, tk_q, tv_q, tdo, Lp, Dp, static_cast<__nv_bfloat16*>(dq), sh,
      scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bwd_f32(const void* q, const void* k, const void* v,
                   const void* o, const void* dO, const void* lse, void* D,
                   void* dq, void* dk, void* dv, int B, BwdShape sh,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  // once per instantiation, outside any CUDA-graph capture that follows
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_f32_dkdv_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_f32_dq_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dO);
  const float* tl = static_cast<const float*>(lse);
  float* tD = static_cast<float*>(D);
  const long long rows = (long long)B * sh.S * sh.H;
  const int d_blocks = (int)((rows * 32 + kThreads - 1) / kThreads);
  flash_bwd_d_kernel<HD><<<d_blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(o), tdo, tD, B, sh.S, sh.H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_f32_dkdv_kernel<HD><<<dim3(B * sh.K, (sh.S_kv + kT - 1) / kT),
                                  kThreads, smem, stream>>>(
      tq, tk, tv, tdo, tl, tD, static_cast<float*>(dk),
      static_cast<float*>(dv), sh, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  flash_bwd_f32_dq_kernel<HD><<<dim3(B * sh.H, (sh.S + kT - 1) / kT),
                                kThreads, smem, stream>>>(
      tq, tk, tv, tdo, tl, tD, static_cast<float*>(dq), sh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, o, dO, dq (B, S, H, hd); k, v, dk, dv (B, S_kv, K, hd); lse (B, H, S)
// f32 from flash_attention_lse_launch; D f32 scratch of 2 B H S_pad floats,
// S_pad = S rounded up to a multiple of 128 (the f32 kernels use the first
// B H S), and for bf16 at hd 16 and 32 with H != K 2 B S_kv H hd floats
// more (the dK / dV partials of each query head).  Contiguous, 16-byte
// aligned, all bf16 (bf16 != 0) or all f32.  hd 16, 32, 64, 128 or 256,
// H % K == 0; causal (S_kv == S) with window 0 or > 0, or non-causal
// (window 0) at any S_kv >= 1.  Returns a cudaError_t
// (cudaErrorInvalidValue outside those).
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dO,
                               const void* lse, void* D, void* dq, void* dk,
                               void* dv, int B, int S, int S_kv, int H, int K,
                               int hd, float scale, int causal, int window,
                               int bf16, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (K < 1 || H % K != 0 || S_kv < 1 || window < 0 ||
      (window > 0 && !causal) || (causal && S_kv != S))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  const BwdShape sh{S, S_kv, (S + kPadRows - 1) / kPadRows * kPadRows, H, K,
                    causal ? 1 : 0, window};
#define REPRO_BWD_ARGS q, k, v, o, dO, lse, D, dq, dk, dv, B, sh, scale, \
                       stream
  switch ((bf16 ? 1000 : 0) + hd) {
    case 16: return launch_bwd_f32<16>(REPRO_BWD_ARGS);
    case 32: return launch_bwd_f32<32>(REPRO_BWD_ARGS);
    case 64: return launch_bwd_f32<64>(REPRO_BWD_ARGS);
    case 128: return launch_bwd_f32<128>(REPRO_BWD_ARGS);
    case 256: return launch_bwd_f32<256>(REPRO_BWD_ARGS);
    case 1016: return launch_bwd_mma<16>(REPRO_BWD_ARGS);
    case 1032: return launch_bwd_mma<32>(REPRO_BWD_ARGS);
    case 1064: return launch_bwd_wgmma<64>(REPRO_BWD_ARGS);
    case 1128: return launch_bwd_wgmma<128>(REPRO_BWD_ARGS);
    case 1256: return launch_bwd_wgmma<256>(REPRO_BWD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_BWD_ARGS
}

}  // extern "C"
