// Blocked causal / non-causal GQA flash attention for sm_90a, with an
// optional causal window.
//
// Replaces src/repro/kernels/flash_attention/kernel.py:80 `flash_attention`
// (`_flash_kernel`, :31): softmax(q k^T * scale, masked) v with an online
// softmax (running max m, running sum l, f32 accumulator acc), skipping the
// KV tiles above the diagonal.  q, o: (B, S, H, hd); k, v: (B, S_kv, K, hd)
// with H % K == 0; S_kv == S when causal, any S_kv >= 1 without (the
// encoder's bidirectional and the decoder's cross attention,
// src/repro/models/attention.py:180-225, which the reference computes
// outside Pallas: queries S, keys S_kv).  The KV head of query head h is h / (H / K), so the expanded
// K/V of the reference's wrapper is never materialised.  `window` > 0 also
// hides key j from query i when j <= i - window (the reference model's
// sliding-window and local mixers, src/repro/models/attention.py:72-80,
// which it computes outside Pallas); a block then starts its KV loop at the
// first tile holding a key inside the window of its first query row, so the
// work grows linearly in S.
//
// Bound on this card: at the main-path shape (B 1, S 4096, H 32, hd 128,
// bf16) the causal half of the two products is ~1.4e11 FLOP against ~84 MB
// of q/k/v/o, so it is bound by operations (the bf16 tensor-core rate), not
// bytes.  Three kernels, chosen by the wrapper (ops.py) from dtype and head
// dim alone:
//   * bf16, hd 64, 128 and 256 (the models' widths): `flash_wgmma_kernel`,
//     Hopper's route to the full tensor-core rate.  One block per
//     (batch*head, 128-row query tile): two consumer warpgroups of 64 rows
//     and one producer warp.  The producer loads the Q tile once and
//     streams K/V tiles (128 keys; 64 at hd 256, see below) into a
//     two-stage ring with TMA (full / empty
//     mbarrier per stage), so no consumer thread spends instructions or
//     registers on addresses; each staged tile serves 128 query rows.
//     S = Q K^T runs as wgmma m64n128k16 with both operands in shared
//     memory (K-major, TMA's 128-byte swizzle); P V as wgmma with P in
//     registers (the bf16 re-pack of the f32 score accumulators, never in
//     shared memory) and V the N-major shared operand.  Within a
//     warpgroup the products and the softmax take turns; the other
//     warpgroup's products fill the gap.  (Issuing S_j together with
//     P_{j-1} V_{j-1}, with or without named-barrier turns between the
//     warpgroups, needs ~230 registers a thread; at the 168 that ptxas
//     grants this block it spilled and serialised the wgmmas, and ran
//     slower.)  P is rounded to bf16 for that product (the reference keeps
//     it in f32; the bar against the plain version is `BARS` in ref.py).
//     The softmax runs in log2 units.  For scale > 0 the row max is taken
//     over the raw scores and scaled once, so p = exp2(x * scale * log2(e)
//     - m) is one FMA and one ex2 (this source compiles without
//     -fmad=false); for scale <= 0 a second instantiation scales each
//     score first, as the other two kernels do, so every scale is taken.
//     hd 256 (gemma3): a 128 x 256 Q tile is 64 KB and two stages of
//     128-key K and V tiles another 256 KB, over the 227 KB a block may
//     have, so the K/V tiles shrink to 64 keys (Q 64 KB + 2 x (K 32 KB +
//     V 32 KB) = 192 KB).  The output accumulator is 128 floats a thread,
//     the score tile 32 and its bf16 re-pack 16, inside the 224 registers
//     a thread of this 288-thread block can have; P V runs as two
//     m64n128k16 wgmmas per k-step, one per 128-column half of V.  Simple
//     and right first: the time against its bound is in PERF.md.
//   * bf16, hd 16 and 32: `flash_bf16_kernel`, 64-row query tiles of four
//     warps, mma.sync m16n8k16 with ldmatrix fragments, K/V double-buffered
//     with cp.async (the first tensor-core design; a 64-column TMA panel
//     would be mostly padding at these widths).
//   * f32: CUDA-core FMAs (no TF32: the f32 bar is 2e-5), 4 x 4 register
//     tiles, P through shared memory.
// Kept from the reference in all three: the finite -1e30 mask value and
// start of the running max, the finaliser's max(l, 1e-30), and the causal
// skip rule (a KV tile runs iff its first key <= the tile's last query
// row), heaviest query tiles first when there is no window (with one,
// every tile does the same work and the order buys nothing).  With a
// window a masked score is -inf instead, so its p is exactly 0 even in the
// leading tiles that the window hides entirely from a row (a finite mask
// would give p = 1 there); the tile max still starts at -1e30, so the
// running max stays finite.  In all three kernels the window is a
// compile-time flag, a separate instantiation, so the window-free path
// carries none of its tests: run-time window tests cost the mma.sync and
// f32 kernels 4-6% at minitron-8b's shape, and -inf on the window-free path
// cost the wgmma kernel ~3.5%, in turns against the kernels without a
// window (flash_in_turns.py).  Keys at or past S_kv are masked (TMA fills
// rows past S_kv with zeros), so a ragged S or S_kv needs no padding here:
// query tiles run to S, key tiles to S_kv.
//
// Training (`flash_attention_lse_launch`): the wgmma and f32 kernels also
// store each row's log-sum-exp m + log l (natural units, (B, H, S) f32),
// from which the backward kernels (flash_attention_bwd.cu) recompute P.
// The store is a compile-time flag (kLse), a separate instantiation as the
// window is, so prefill, which passes no LSE, runs the code it ran before.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMaskValue = -1e30f;   // start of every running / tile max

// A masked score: exp2 of it is exactly 0 whatever the running max.
__device__ __forceinline__ float masked_score() {
  return __int_as_float(0xff800000u);   // -inf
}

// The value a masked score takes: -inf with a window, which can hide every
// key of a row's first tiles; else the reference's finite -1e30, whose p is
// 0 once the row has met a visible key, which it does in its first tile.
template <bool kWindow>
__device__ __forceinline__ float mask_value() {
  return kWindow ? masked_score() : kMaskValue;
}

// First key tile a block of query rows q0.. reads: with a window, the tile
// of key q0 - window + 1 (the oldest key its first row sees), else tile 0.
template <bool kWindow>
__device__ __forceinline__ int first_kv_tile(int q0, int window, int bkv) {
  return kWindow ? max(0, q0 - window + 1) / bkv : 0;
}

constexpr int kBQ = 64;        // query rows per block (mma.sync and f32)
constexpr int kThreads = 128;  // four warps

// ---------------------------------------------------------------------------
// bf16, hd 16 and 32: tensor cores (mma.sync)
// ---------------------------------------------------------------------------

constexpr int kBKV16 = 64;     // keys per tile

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one bf16x2 register: `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 and receives, of matrix i in r[i], the pair
// (row l / 4, columns 2 (l % 4), +1) -- with .trans, the pair (rows 2 (l % 4),
// +1, column l / 4) of the stored matrix.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// 16-byte global -> shared copy that bypasses the registers; src_size 0
// (valid false) fills the 16 bytes with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Fragment layout of m16n8k16 (PTX ISA, "Matrix Fragments for mma.m16n8k16"),
// with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                     a3 (g+8, 2t+8..)
//   B (16 x 8, col):  b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C (16 x 8):       c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)
template <int HD, bool kWindow>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int S, int Skv, int H,
                  int K, float scale, int causal, int window) {
  constexpr int KC = HD / 16;   // k-steps of q.k^T over the head dim
  constexpr int NT = HD / 8;    // 8-wide column tiles of the output
  constexpr int LD = HD + 8;    // padded smem row: conflict-free fragments
  constexpr int VEC = HD / 8;   // 16-byte vectors per row
  // two stages of K and V tiles: tile j + 1 is copied while j is computed
  extern __shared__ __align__(16) unsigned char flash_smem[];
  __nv_bfloat16* kbuf = reinterpret_cast<__nv_bfloat16*>(flash_smem);
  __nv_bfloat16* vbuf = kbuf + 2 * kBKV16 * LD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kh = h / (H / K);
  // causal: the last query tiles have the most KV tiles; start them first,
  // all heads' at once (blockIdx.x runs fastest)
  const bool heavy_last = causal && !kWindow;
  const int q0 = (heavy_last ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kBQ;
  const size_t qrow = (size_t)H * HD, krow = (size_t)K * HD;
  const __nv_bfloat16* qb = q + (size_t)b * S * qrow + (size_t)h * HD;
  const __nv_bfloat16* kb = k + (size_t)b * Skv * krow + (size_t)kh * HD;
  const __nv_bfloat16* vb = v + (size_t)b * Skv * krow + (size_t)kh * HD;
  __nv_bfloat16* ob = o + (size_t)b * S * qrow + (size_t)h * HD;

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int c = kc * 16 + 2 * t;
    const bool in0 = r0 < S, in1 = r1 < S;
    qf[kc][0] = in0 ? *reinterpret_cast<const uint32_t*>(qb + r0 * qrow + c) : 0u;
    qf[kc][1] = in1 ? *reinterpret_cast<const uint32_t*>(qb + r1 * qrow + c) : 0u;
    qf[kc][2] = in0 ? *reinterpret_cast<const uint32_t*>(qb + r0 * qrow + c + 8) : 0u;
    qf[kc][3] = in1 ? *reinterpret_cast<const uint32_t*>(qb + r1 * qrow + c + 8) : 0u;
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // running max in log2 units: exp(x * scale) = exp2(x * scale * log2(e))
  const float scale_log2 = scale * 1.4426950408889634f;
  float m0 = kMaskValue, m1 = kMaskValue, l0 = 0.f, l1 = 0.f;
  const float mask_v = mask_value<kWindow>();

  // causal skip: tile j runs iff j * kBKV16 <= the block's last query row
  // (causal has S_kv == S)
  int kv_end = Skv;
  if (causal) kv_end = min(S, q0 + kBQ);
  const int n_tiles = (kv_end + kBKV16 - 1) / kBKV16;
  const int tile0 = first_kv_tile<kWindow>(q0, window, kBKV16);
  auto load_tile = [&](int tile) {
    const int kv0 = tile * kBKV16;
    __nv_bfloat16* kd = kbuf + (tile & 1) * kBKV16 * LD;
    __nv_bfloat16* vd = vbuf + (tile & 1) * kBKV16 * LD;
    for (int i = threadIdx.x; i < kBKV16 * VEC; i += kThreads) {
      const int r = i / VEC, c = (i % VEC) * 8;
      const bool in = kv0 + r < Skv;  // rows past S_kv: zeros, read nothing
      const size_t off = (size_t)(in ? kv0 + r : 0) * krow + c;
      cp_async16(kd + r * LD + c, kb + off, in);
      cp_async16(vd + r * LD + c, vb + off, in);
    }
    cp_async_commit();
  };
  load_tile(tile0);
  for (int tile = tile0; tile < n_tiles; ++tile) {
    const int kv0 = tile * kBKV16;
    if (tile + 1 < n_tiles) {
      load_tile(tile + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `tile` has landed for every thread
    const __nv_bfloat16* ks = kbuf + (tile & 1) * kBKV16 * LD;
    const __nv_bfloat16* vs = vbuf + (tile & 1) * kBKV16 * LD;

    // scores: (16 rows) x (64 keys) as 8 column tiles of 8; K fragments by
    // ldmatrix, two column tiles x one k-step per call
    float s[kBKV16 / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBKV16 / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
    for (int nt = 0; nt < kBKV16 / 8; nt += 2) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t kf[4];
        ldmatrix_x4(kf, ks + ((nt + (mi >> 1)) * 8 + mr) * LD + kc * 16 +
                            (mi & 1) * 8);
        mma_bf16(s[nt], qf[kc], kf[0], kf[1]);
        mma_bf16(s[nt + 1], qf[kc], kf[2], kf[3]);
      }
    }
    // scale into log2 units, mask, row max over the tile
    const bool masked = kv0 + kBKV16 > Skv ||
                        (causal && kv0 + kBKV16 - 1 > q0) ||
                        (kWindow && kv0 <= q0 + kBQ - 1 - window);
    float mx0 = kMaskValue, mx1 = kMaskValue;
#pragma unroll
    for (int nt = 0; nt < kBKV16 / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (masked) {
          const int row = e < 2 ? r0 : r1;
          const int col = kv0 + nt * 8 + 2 * t + (e & 1);
          if (col >= Skv || (causal && col > row) ||
              (kWindow && col <= row - window))
            x = mask_v;
        }
        s[nt][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = exp2_approx(m0 - mn0), corr1 = exp2_approx(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBKV16 / 8; ++nt) {
      s[nt][0] = exp2_approx(s[nt][0] - mn0);
      s[nt][1] = exp2_approx(s[nt][1] - mn0);
      s[nt][2] = exp2_approx(s[nt][2] - mn1);
      s[nt][3] = exp2_approx(s[nt][3] - mn1);
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
    // each thread keeps a partial row sum; the quad is summed at the end
    l0 = l0 * corr0 + ps0;
    l1 = l1 * corr1 + ps1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= corr0;
      acc[n][1] *= corr0;
      acc[n][2] *= corr1;
      acc[n][3] *= corr1;
    }
    // acc += P V: the score tiles 2j and 2j+1 form the A fragment of k-step
    // j; V fragments by ldmatrix.trans, one k-step x two column tiles per call
#pragma unroll
    for (int j = 0; j < kBKV16 / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vs + (j * 16 + (mi & 1) * 8 + mr) * LD +
                                  (n + (mi >> 1)) * 8);
        mma_bf16(acc[n], pa, vf[0], vf[1]);
        mma_bf16(acc[n + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is overwritten by the load of tile + 2
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(ob + r0 * qrow + c) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(ob + r1 * qrow + c) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// bf16, hd 64, 128 and 256: wgmma fed by TMA (warp-specialised)
// ---------------------------------------------------------------------------

constexpr int kWgBQ = 128;       // query rows per block: two warpgroups of 64
constexpr int kWgStages = 2;     // K/V ring depth
constexpr int kWgConsumers = 256;
constexpr int kWgThreads = kWgConsumers + 32;   // + one producer warp
constexpr int kPanel = 64;       // bf16 columns per 128-byte swizzled row
constexpr int kPanelBytes = kWgBQ * kPanel * 2; // one 128-row panel: 16 KB

// Keys per K/V tile: 128, or 64 at hd 256, where two stages of 128-key K
// and V tiles beside the 64 KB Q tile would not fit in shared memory.
__host__ __device__ constexpr int wg_bkv(int hd) { return hd > 128 ? 64 : 128; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Spin until the barrier's phase of parity `parity` has completed.  A wait
// that never ends (a lost TMA load, a miscounted arrival) traps after ~2^28
// tries instead of hanging the card.
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

// One TMA box of the 4-D map (hd, heads, S, B) into shared memory; rows
// past S arrive as zeros and still count their bytes on the barrier.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile (the layout
// TMA's CU_TENSOR_MAP_SWIZZLE_128B writes): start address, leading byte
// offset (K-major: unused; N-major: the next 64-column panel), stride byte
// offset 1024 (the next 8 rows), swizzle mode 1 (128 B).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from touching registers of an asynchronous wgmma
// across its wait (or before the fence of the next one).
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// d (64 x 128, f32) += A (64 x 16, bf16, shared, K-major) . B (16 x 128, bf16,
// shared, K-major); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, bf16, shared, K-major) . B (16 x 64, bf16,
// shared, K-major); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128, f32) += A (64 x 16, bf16, registers) . B (16 x 128, bf16,
// shared, N-major: the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16, registers) . B (16 x 64, bf16,
// shared, N-major: the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int HD>
struct WgSmem {
  static constexpr int BKV = wg_bkv(HD);
  // each tile: HD / 64 panels of [rows][64 columns], 128-byte swizzled
  __nv_bfloat16 q[HD / kPanel][kWgBQ * kPanel];
  __nv_bfloat16 k[kWgStages][HD / kPanel][BKV * kPanel];
  __nv_bfloat16 v[kWgStages][HD / kPanel][BKV * kPanel];
  uint64_t q_full, full[kWgStages], empty[kWgStages];
};

// S (64 x BKV keys) = Q K^T: k-steps of 16 over the head dim, k-step kk 32
// bytes into panel kk / 4 (inside the swizzle atom).
template <int HD>
__device__ __forceinline__ void qk_tile(
    float (&s)[wg_bkv(HD) / 2], const __nv_bfloat16 (*q)[kWgBQ * kPanel],
    const __nv_bfloat16 (*k)[wg_bkv(HD) * kPanel], int wg) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint64_t da =
        sw128_desc(q[kk / 4] + wg * 64 * kPanel + (kk % 4) * 16, 16);
    const uint64_t db = sw128_desc(k[kk / 4] + (kk % 4) * 16, 16);
    if constexpr (wg_bkv(HD) == 128)
      wgmma_ss_n128(s, da, db, kk > 0);
    else
      wgmma_ss_n64(s, da, db, kk > 0);
  }
}

// acc += P V: k-step kk is keys 16 kk .. + 15, 16 rows of 128 bytes into
// each panel; the next 64-column panel of V is one panel (BKV rows) on.
// hd 256 takes two m64n128 products a k-step: columns 0-127 into acc[0..63]
// and 128-255 (panels 2, 3) into acc[64..127], which is the accumulator
// layout of one m64n256 product.
template <int HD>
__device__ __forceinline__ void pv_tile(
    float (&acc)[HD / 2], const uint32_t (&pa)[wg_bkv(HD) / 16][4],
    const __nv_bfloat16 (*v)[wg_bkv(HD) * kPanel]) {
  constexpr int BKV = wg_bkv(HD);
  constexpr uint32_t lbo = BKV * kPanel * 2;
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    if constexpr (HD == 64) {
      wgmma_rs_n64(acc, pa[kk], sw128_desc(v[0] + kk * 16 * kPanel, lbo));
    } else if constexpr (HD == 128) {
      wgmma_rs_n128(acc, pa[kk], sw128_desc(v[0] + kk * 16 * kPanel, lbo));
    } else {
      static_assert(HD == 256, "wgmma flash: hd 64, 128 or 256");
      wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&acc[0]), pa[kk],
                    sw128_desc(v[0] + kk * 16 * kPanel, lbo));
      wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&acc[64]), pa[kk],
                    sw128_desc(v[2] + kk * 16 * kPanel, lbo));
    }
  }
}

// The online softmax of one score tile: mask (only tiles that reach the
// diagonal, the window's edge or the ragged end), update m and l, rescale
// acc, and re-pack P as bf16 A fragments (column tiles 2 kk, 2 kk + 1 are
// k-step kk).  kRawMax (scale > 0, the models' case): x -> x * scale_log2 is
// monotone, so the row max is taken over the raw scores (a masked score is
// mask_x = -1e30 / scale_log2) and scaled once, and p = exp2(x * scale_log2
// - m) is one FMA and one ex2.  Otherwise (scale <= 0) each score is scaled
// before the mask and the max (mask_x = -1e30), one multiply more per
// score.  kWindow: the launch has a window, a separate instantiation, so
// the window-free path carries none of its tests; there a masked score is
// -inf (its p exactly 0), since a window can hide every key of a row's
// first tiles, where the finite mask_x would give p = 1.  Without a window
// every row meets a visible key (key 0) in its first tile, and the finite
// mask_x's p is 0 from then on, as before the window existed.
template <int HD, bool kRawMax, bool kWindow>
__device__ __forceinline__ void softmax_tile(
    float (&s)[wg_bkv(HD) / 2], float (&acc)[HD / 2],
    uint32_t (&pa)[wg_bkv(HD) / 16][4], float& m0, float& m1, float& l0,
    float& l1, int kv0, int Skv, int causal, int window, int wg_row0, int r0,
    int r1, int t, float scale_log2, float mask_x) {
  constexpr int BKV = wg_bkv(HD);
  constexpr int NS = BKV / 2;               // score accumulators per thread
  const bool masked = kv0 + BKV > Skv ||
                      (causal && kv0 + BKV - 1 > wg_row0) ||
                      (kWindow && kv0 <= wg_row0 + 63 - window);
  float mx0 = kMaskValue, mx1 = kMaskValue;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    float x = kRawMax ? s[i] : s[i] * scale_log2;
    if (masked) {
      const int row = (i & 2) ? r1 : r0;
      const int col = kv0 + (i >> 2) * 8 + 2 * t + (i & 1);
      if (col >= Skv || (causal && col > row) ||
          (kWindow && col <= row - window))
        x = kWindow ? masked_score() : mask_x;
    }
    s[i] = x;
    if (i & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, kRawMax ? mx0 * scale_log2 : mx0);
  const float mn1 = fmaxf(m1, kRawMax ? mx1 * scale_log2 : mx1);
  const float corr0 = exp2_approx(m0 - mn0), corr1 = exp2_approx(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const float mn = (i & 2) ? mn1 : mn0;
    const float p = exp2_approx(kRawMax ? s[i] * scale_log2 - mn : s[i] - mn);
    s[i] = p;
    if (i & 2) ps1 += p; else ps0 += p;
  }
  // each thread keeps a partial row sum; the quad is summed at the end
  l0 = l0 * corr0 + ps0;
  l1 = l1 * corr1 + ps1;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] *= (i & 2) ? corr1 : corr0;
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// Accumulator layout of wgmma m64nN (per warpgroup), with w = warp in the
// warpgroup, g = lane / 4, t = lane % 4: d[4 j + e] holds row 16 w + g
// (+ 8 for e >= 2), column 8 j + 2 t + (e & 1).  The register A operand of
// m64nNk16 has mma.sync m16n8k16's A layout per warp, so the scores' column
// tiles 2 kk and 2 kk + 1 are the A fragment of the P.V k-step kk.
// This is the consumer warpgroups' side of `flash_wgmma_kernel`: it reads
// K/V tiles tile0 .. n_tiles - 1, the i-th of them from stage i % 2.
template <int HD, bool kRawMax, bool kWindow, bool kLse>
__device__ __forceinline__ void flash_consume(WgSmem<HD>& sm,
                                              __nv_bfloat16* __restrict__ o,
                                              float* __restrict__ lse,
                                              int S, int Skv, int H, int b,
                                              int h, int q0, int tile0,
                                              int n_tiles, float scale,
                                              int causal, int window,
                                              int wg) {
  constexpr int BKV = wg_bkv(HD);
  constexpr int NO = HD / 2;                // output accumulators per thread
  const int w = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + wg * 64 + w * 16 + g, r1 = r0 + 8;
  const int wg_row0 = q0 + wg * 64;
  const float scale_log2 = scale * 1.4426950408889634f;
  const float mask_x = kRawMax ? kMaskValue / scale_log2 : kMaskValue;

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  // running max in log2 units: exp(x * scale) = exp2(x * scale * log2(e))
  float m0 = kMaskValue, m1 = kMaskValue, l0 = 0.f, l1 = 0.f;

  // Per K/V tile: S = Q K^T, wait; the online softmax; P V, wait; release
  // the stage.  The two warpgroups run this loop independently, so one's
  // softmax tends to overlap the other's products.
  mbar_wait(&sm.q_full, 0);
  for (int j = tile0; j < n_tiles; ++j) {
    const int it = j - tile0, s_ = it % kWgStages;
    mbar_wait(&sm.full[s_], (it / kWgStages) & 1);
    float s[BKV / 2];
    wgmma_fence();
    qk_tile<HD>(s, sm.q, sm.k[s_], wg);
    wgmma_commit();
    wgmma_wait0();
    reg_fence(s);
    uint32_t pa[BKV / 16][4];
    softmax_tile<HD, kRawMax, kWindow>(s, acc, pa, m0, m1, l0, l1, j * BKV,
                                       Skv, causal, window, wg_row0, r0, r1,
                                       t, scale_log2, mask_x);
    wgmma_fence();
    pv_tile<HD>(acc, pa, sm.v[s_]);
    wgmma_commit();
    wgmma_wait0();
    reg_fence(acc);
    reg_fence(pa);   // P stays live until its product has read it
    mbar_arrive(&sm.empty[s_]);   // this thread is done with the stage
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  if constexpr (kLse) {
    // the row's log-sum-exp of the scaled scores, natural units (m is in
    // log2 units): what the backward recomputes P from
    if (t == 0) {
      float* lb = lse + ((size_t)b * H + h) * S;
      if (r0 < S) lb[r0] = m0 * 0.6931471805599453f + logf(l0);
      if (r1 < S) lb[r1] = m1 * 0.6931471805599453f + logf(l1);
    }
  }
  const size_t qrow = (size_t)H * HD;
  __nv_bfloat16* ob = o + (size_t)b * S * qrow + (size_t)h * HD;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(ob + r0 * qrow + c) =
          pack_bf16(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(ob + r1 * qrow + c) =
          pack_bf16(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
  }
}

template <int HD, bool kRawMax, bool kWindow, bool kLse>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ o, int S, int Skv, int H,
                   int K, float scale, int causal, int window,
                   float* __restrict__ lse) {
  constexpr int NP = HD / kPanel;           // 64-column panels per row
  constexpr int BKV = wg_bkv(HD);
  constexpr uint32_t kv_bytes = 2u * NP * BKV * kPanel * 2;   // K + V tile
  extern __shared__ unsigned char wg_smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  WgSmem<HD>& sm = *reinterpret_cast<WgSmem<HD>*>(
      (reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~uintptr_t(1023));

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kh = h / (H / K);
  // causal: the last query tiles have the most KV tiles; start them first,
  // all heads' at once (blockIdx.x runs fastest)
  const bool heavy_last = causal && !kWindow;
  const int q0 = (heavy_last ? gridDim.y - 1 - blockIdx.y : blockIdx.y) *
                 kWgBQ;
  const int kv_end = causal ? min(S, q0 + kWgBQ) : Skv;
  const int n_tiles = (kv_end + BKV - 1) / BKV;
  const int tile0 = first_kv_tile<kWindow>(q0, window, BKV);

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kWgConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int role = threadIdx.x / 128;   // 0, 1: consumers; 2: producer
  if (role == kWgConsumers / 128) {
    // ---- producer: one lane issues every TMA load ----
    if (threadIdx.x == kWgConsumers) {
      mbar_expect_tx(&sm.q_full, NP * kPanelBytes);
      for (int p = 0; p < NP; ++p)
        tma_load(sm.q[p], &tm_q, &sm.q_full, p * kPanel, h, q0, b);
      for (int j = tile0; j < n_tiles; ++j) {
        const int it = j - tile0;
        const int s = it % kWgStages, round = it / kWgStages;
        if (round > 0) mbar_wait(&sm.empty[s], (round - 1) & 1);
        mbar_expect_tx(&sm.full[s], kv_bytes);
        for (int p = 0; p < NP; ++p) {
          tma_load(sm.k[s][p], &tm_k, &sm.full[s], p * kPanel, kh, j * BKV, b);
          tma_load(sm.v[s][p], &tm_v, &sm.full[s], p * kPanel, kh, j * BKV, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 ----
    flash_consume<HD, kRawMax, kWindow, kLse>(sm, o, lse, S, Skv, H, b, h,
                                              q0, tile0, n_tiles, scale,
                                              causal, window, role);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBKV32 = 32;     // keys per tile
// Thread (ty, tx) = (tid / 8, tid % 8) owns query rows ty + 16 i (i < 4);
// for the scores, keys tx + 8 j (j < 4); for the output, columns tx + 8 c.

template <int HD, bool kWindow, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int Skv, int H, int K, float scale, int causal, int window,
                 float* __restrict__ lse) {
  constexpr int LDQ = HD + 1;
  constexpr int OC = HD / 8;    // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                     // (kBQ, LDQ)
  float* ks = qs + kBQ * LDQ;           // (kBKV32, LDQ)
  float* vs = ks + kBKV32 * LDQ;        // (kBKV32, HD)
  float* ps = vs + kBKV32 * HD;         // (kBQ, kBKV32 + 1)

  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kh = h / (H / K);
  // causal: the last query tiles have the most KV tiles; start them first,
  // all heads' at once (blockIdx.x runs fastest)
  const bool heavy_last = causal && !kWindow;
  const int q0 = (heavy_last ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kBQ;
  const size_t qrow = (size_t)H * HD, krow = (size_t)K * HD;
  const float* qb = q + (size_t)b * S * qrow + (size_t)h * HD;
  const float* kb = k + (size_t)b * Skv * krow + (size_t)kh * HD;
  const float* vb = v + (size_t)b * Skv * krow + (size_t)kh * HD;
  float* ob = o + (size_t)b * S * qrow + (size_t)h * HD;

  for (int i = threadIdx.x; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    qs[r * LDQ + c] = q0 + r < S ? qb[(size_t)(q0 + r) * qrow + c] : 0.f;
  }
  float acc[4][OC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  int kv_end = Skv;                  // causal has S_kv == S
  if (causal) kv_end = min(S, q0 + kBQ);
  const float mask_v = mask_value<kWindow>();
  for (int kv0 = first_kv_tile<kWindow>(q0, window, kBKV32) * kBKV32;
       kv0 < kv_end; kv0 += kBKV32) {
    __syncthreads();
    for (int i = threadIdx.x; i < kBKV32 * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      const bool in = kv0 + r < Skv;
      ks[r * LDQ + c] = in ? kb[(size_t)(kv0 + r) * krow + c] : 0.f;
      vs[r * HD + c] = in ? vb[(size_t)(kv0 + r) * krow + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = ks[(tx + 8 * j) * LDQ + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kMaskValue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kv0 + tx + 8 * j;
        float x = s[i][j] * scale;
        if (col >= Skv || (causal && col > row) ||
            (kWindow && col <= row - window))
          x = mask_v;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // the 8 threads of a row are 8 consecutive lanes
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float corr = expf(m[i] - mn);
      m[i] = mn;
      float ps_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        ps[(ty + 16 * i) * (kBKV32 + 1) + tx + 8 * j] = p;
        ps_sum += p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        ps_sum += __shfl_xor_sync(0xffffffffu, ps_sum, off);
      l[i] = l[i] * corr + ps_sum;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
    for (int j = 0; j < kBKV32; ++j) {
      float p[4], vv[OC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * (kBKV32 + 1) + j];
#pragma unroll
      for (int c = 0; c < OC; ++c) vv[c] = vs[j * HD + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < OC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    if constexpr (kLse) {   // the row's log-sum-exp, for the backward
      if (tx == 0) lse[((size_t)b * H + h) * S + row] = m[i] + logf(l[i]);
    }
#pragma unroll
    for (int c = 0; c < OC; ++c)
      ob[(size_t)row * qrow + tx + 8 * c] = acc[i][c] * inv;
  }
}

template <int HD, bool kWindow, bool kLse = false>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int S, int Skv, int H, int K, float scale, int causal,
               int window, cudaStream_t stream, float* lse) {
  const size_t smem = sizeof(float) * ((size_t)(kBQ + kBKV32) * (HD + 1) +
                                       (size_t)kBKV32 * HD +
                                       (size_t)kBQ * (kBKV32 + 1));
  // once per instantiation, outside any CUDA-graph capture that follows
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_f32_kernel<HD, kWindow, kLse>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_f32_kernel<HD, kWindow, kLse><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Skv, H, K,
      scale, causal, window, lse);
  return (int)cudaGetLastError();
}

template <int HD, bool kWindow>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int S, int Skv, int H, int K, float scale, int causal,
                int window, cudaStream_t stream, float*) {
  constexpr size_t smem = 4 * (size_t)kBKV16 * (HD + 8) * sizeof(uint16_t);
  // once per instantiation, outside any CUDA-graph capture that follows
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bf16_kernel<HD, kWindow>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_bf16_kernel<HD, kWindow><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      Skv, H, K, scale, causal, window);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime,
// so the library links against nothing but cudart.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 4-D map (hd, heads, S, B) of a (B, S, heads, hd) bf16 tensor, boxes of
// 64 columns x 1 head x `rows` rows, 128-byte swizzle, zeros out of bounds.
cudaError_t head_map(CUtensorMap* map, const void* base, int B, int S,
                     int heads, int hd, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {kPanel, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(base), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD, bool kRawMax, bool kWindow, bool kLse = false>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int S, int Skv, int H, int K, float scale, int causal,
                 int window, cudaStream_t stream, float* lse) {
  constexpr size_t smem = sizeof(WgSmem<HD>) + 1024;   // + alignment slack
  // once per instantiation, outside any CUDA-graph capture that follows
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma_kernel<HD, kRawMax, kWindow, kLse>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  CUtensorMap tq, tk, tv;
  cudaError_t e = head_map(&tq, q, B, S, H, HD, kWgBQ);
  if (e == cudaSuccess) e = head_map(&tk, k, B, Skv, K, HD, wg_bkv(HD));
  if (e == cudaSuccess) e = head_map(&tv, v, B, Skv, K, HD, wg_bkv(HD));
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (S + kWgBQ - 1) / kWgBQ);
  flash_wgmma_kernel<HD, kRawMax, kWindow, kLse><<<grid, kWgThreads, smem,
                                                    stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, Skv, H, K, scale,
      causal, window, lse);
  return (int)cudaGetLastError();
}

// The wgmma instantiation a launch takes: the raw-max softmax for scale >
// 0, the window's tests only with a window.
template <int HD>
int launch_wgmma_any(const void* q, const void* k, const void* v, void* o,
                     int B, int S, int Skv, int H, int K, float scale,
                     int causal, int window, cudaStream_t stream,
                     float* lse) {
#define REPRO_WG_ARGS q, k, v, o, B, S, Skv, H, K, scale, causal, window, \
                      stream, lse
  if (scale > 0.f)
    return window > 0 ? launch_wgmma<HD, true, true>(REPRO_WG_ARGS)
                      : launch_wgmma<HD, true, false>(REPRO_WG_ARGS);
  return window > 0 ? launch_wgmma<HD, false, true>(REPRO_WG_ARGS)
                    : launch_wgmma<HD, false, false>(REPRO_WG_ARGS);
#undef REPRO_WG_ARGS
}

using Launcher = int (*)(const void*, const void*, const void*, void*, int,
                        int, int, int, int, float, int, int, cudaStream_t,
                        float*);

// The instantiation a launch of the mma.sync or f32 kernel takes: the
// window's tests only with a window.
template <Launcher kPlain, Launcher kWindowed>
int launch_windowed(const void* q, const void* k, const void* v, void* o,
                    int B, int S, int Skv, int H, int K, float scale,
                    int causal, int window, cudaStream_t stream,
                    float* lse) {
  return (window > 0 ? kWindowed : kPlain)(q, k, v, o, B, S, Skv, H, K,
                                           scale, causal, window, stream,
                                           lse);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, o (B, S, H, hd); k, v (B, S_kv, K, hd); contiguous, 16-byte aligned.
// kernel: 0 f32 (CUDA cores; hd 16-256), 1 bf16 mma.sync (hd 16, 32), 2 bf16
// wgmma + TMA (hd 64, 128, 256).  window 0: none; else (causal only) key j
// is hidden from query i when j <= i - window.  Returns a cudaError_t
// (cudaErrorInvalidValue for a kernel / hd pair outside those, a negative
// window, a window without causal, S_kv < 1, or causal with S_kv != S).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int S, int S_kv, int H, int K,
                           int hd, float scale, int causal, int window,
                           int kernel, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (window < 0 || (window > 0 && !causal) || S_kv < 1 ||
      (causal && S_kv != S))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
#define REPRO_FLASH_ARGS q, k, v, o, B, S, S_kv, H, K, scale, causal, window, \
                         stream, nullptr
  switch (kernel * 1000 + hd) {
    case 16: return launch_windowed<launch_f32<16, false>,
                                    launch_f32<16, true>>(REPRO_FLASH_ARGS);
    case 32: return launch_windowed<launch_f32<32, false>,
                                    launch_f32<32, true>>(REPRO_FLASH_ARGS);
    case 64: return launch_windowed<launch_f32<64, false>,
                                    launch_f32<64, true>>(REPRO_FLASH_ARGS);
    case 128: return launch_windowed<launch_f32<128, false>,
                                     launch_f32<128, true>>(REPRO_FLASH_ARGS);
    case 256: return launch_windowed<launch_f32<256, false>,
                                     launch_f32<256, true>>(REPRO_FLASH_ARGS);
    case 1016: return launch_windowed<launch_bf16<16, false>,
                                      launch_bf16<16, true>>(REPRO_FLASH_ARGS);
    case 1032: return launch_windowed<launch_bf16<32, false>,
                                      launch_bf16<32, true>>(REPRO_FLASH_ARGS);
    case 2064: return launch_wgmma_any<64>(REPRO_FLASH_ARGS);
    case 2128: return launch_wgmma_any<128>(REPRO_FLASH_ARGS);
    case 2256: return launch_wgmma_any<256>(REPRO_FLASH_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_ARGS
}

// The training forward: as flash_attention_launch, and also the row
// log-sum-exp lse (B, H, S) float32 of the scaled scores, which the
// backward (flash_attention_bwd.cu) recomputes P from.  Causal, no window,
// S_kv == S, scale > 0; kernel 0 (f32) or 2 (wgmma), hd 64 or 128: the
// variants the backward takes.  A separate instantiation (kLse), so the
// prefill path above runs the code it ran before the store existed.
int flash_attention_lse_launch(const void* q, const void* k, const void* v,
                               void* o, void* lse, int B, int S, int H,
                               int K, int hd, float scale, int kernel,
                               void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!(scale > 0.f) || lse == nullptr) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  float* l = static_cast<float*>(lse);
#define REPRO_LSE_ARGS q, k, v, o, B, S, S, H, K, scale, 1, 0, stream, l
  switch (kernel * 1000 + hd) {
    case 64: return launch_f32<64, false, true>(REPRO_LSE_ARGS);
    case 128: return launch_f32<128, false, true>(REPRO_LSE_ARGS);
    case 2064: return launch_wgmma<64, true, false, true>(REPRO_LSE_ARGS);
    case 2128: return launch_wgmma<128, true, false, true>(REPRO_LSE_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_LSE_ARGS
}

}  // extern "C"
