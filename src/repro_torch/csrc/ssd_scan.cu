// Mamba2 SSD chunked scan for sm_90a.
//
// Replaces src/repro/kernels/ssd_scan/kernel.py:74 `ssd_scan` (`_ssd_kernel`,
// :29).  x (B, L, H, P), b and c (B, L, N), dt (B, L, H), a (H,) -> y (B, L,
// H, P), all float32.  For each chunk of Q steps, in order:
//   seg   = cumsum(dt * a) within the chunk
//   y_i   = sum_{j <= i} (C_i . B_j) exp(clip(seg_i - seg_j)) dt_j x_j   (intra)
//         + exp(clip(seg_i)) C_i . R                                     (inter)
//   R    <- exp(clip(seg_end)) R + sum_j exp(clip(seg_end - seg_j)) dt_j B_j x_j^T
// with every exponent clipped to [-60, 0] as the reference does: without the
// clip, exp(seg_i - seg_j) for j > i overflows to inf before the causal mask
// multiplies it by 0, and inf * 0 is NaN.
//
// Bound on this card: at the main-path shape (B 1, L 4096, H 32, P 64, N 128,
// Q 256) the products are ~6.3 GFLOP (the causal halves of C.B^T and of the
// intra term; no inter term for the first chunk, whose entering state is 0,
// and no state update after the last) against ~71 MB.  On f32 CUDA cores
// that is bound by operations (0.094 ms); the products here run on the
// tensor cores as a 3xTF32 split, three TF32 products per f32 one (0.038 ms
// at 495 TFLOP/s), still above the bytes' 0.021 ms.
//
// Products: every one (C.B^T, the weighted intra product W.X, the inter
// product (e_i C_i).R, the chunk state (w B)^T.X) is a 3xTF32 split on the
// tensor cores: each f32 operand a is staged in shared memory once as
// a_hi = tf32(a) and a_lo = tf32(a - a_hi) (round to nearest even,
// `tf32_rne`), and a_hi.b_hi + (a_hi.b_lo + a_lo.b_hi) accumulates in f32.
// The dropped a_lo.b_lo and the TF32 rounding of a_lo leave f32-level
// error: the bar against the plain version stays 1e-4.  The tensor cores'
// own accumulation truncates, so each 64-deep k-tile's products go into
// fresh partials that are added to the result in f32 once per k-tile; one
// accumulator over the whole k range read 9.92e-5 against that bar on the
// card, the per-k-tile partials 3.05e-5 (chip_smoke.py, mamba2-370m's
// shape).  tests/test_torch_ssd.py emulates the operands' rounding (at the
// main shape, L cut to 1024, state carried across chunks: 3xTF32 5.5e-6,
// plain TF32 2.2e-3 fails) but sums in float32 in einsum's order: it
// cannot see the accumulation order, and only the card checks hold that
// part of the design.  The products are
// wgmma m64n64k8 .tf32 (TF32 operands must both be K-major, and here both
// can be), one consumer warpgroup per 64 x 64 output tile.  Staging, not the
// products, bounds the kernels: twelve producer warps copy each 64-deep
// k-tile's raw operands in with cp.async (two k-tiles ahead), apply the
// decay weights, split and store them in the 128-byte swizzle that wgmma
// reads; the two halves hand a ring of split k-tiles back and forth with
// named barriers.
//
// Design.  The TPU kernel walks the chunk axis as a sequential grid axis with
// R in VMEM.  Only R's recurrence is sequential, and it is cheap (N x P
// multiply-adds per chunk); everything else is independent across chunks,
// and C_i . B_j is the same for every head (one group).  So one launch of
// the wrapper runs these kernels in its stream:
//   0. ssd_seg_kernel, one thread per (chunk, head, batch): seg and seg_end
//      into scratch, in the reference's order (see there);
//      ssd_cb_kernel, one block per (64 x 64 tile at or below the diagonal,
//      chunk, batch): C_i . B_j of the chunk into scratch, once for all heads;
//   1. ssd_state_kernel, one block per (64 state rows, chunk but the last,
//      head, batch): the chunk's own state S_c = (w B)^T X, w_j =
//      exp(clip(seg_end - seg_j)) dt_j;
//   2. ssd_recur_kernel walks the chunks in order for each (head, batch)
//      (a few blocks each, one slice of R's N x P elements per block) and
//      replaces each S_c by R_c, the state entering chunk c
//      (R_0 = 0, R_{c+1} = exp(clip(seg_end_c)) R_c + S_c);
//   3. ssd_y_kernel, one block per (64-row tile, chunk, head, batch): the
//      intra term (the decay weights of each 64 x 64 source tile applied
//      from the shared C.B^T while it is staged) and the inter term as more
//      k-tiles of the same accumulators, A = e_i C_i and B = R_c; y is
//      written once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;           // row / column / k tile within a chunk
constexpr int kConsumers = 128;  // one warpgroup: wgmma on a 64 x 64 tile
constexpr int kProducers = 384;  // twelve warps: load and split the k-tiles
constexpr int kThreads = kConsumers + kProducers;
constexpr int kStages = 2;       // split k-tiles in flight
constexpr int kMaxN = 128;       // d_state
constexpr int kMaxP = 64;        // head_dim
constexpr int kPanel = kT * 32;  // floats of a 64-row x 32-k panel (8 KB)
constexpr int kPart = 2 * kPanel;   // a 64 x 64 operand's hi or lo part
constexpr int kStage = 4 * kPart;   // A hi, A lo, B hi, B lo (64 KB)
constexpr int kQuads =           // quads of an operand per producer thread
    (kT * kT / 4 + kProducers - 1) / kProducers;

// exp(z) with z clipped to [-60, 0]; the fast exponential (ex2.approx of
// z log2(e)), a few ulp off on this range, well inside the 1e-4 bar.
__device__ __forceinline__ float clip_exp(float z) {
  return __expf(fminf(fmaxf(z, -60.f), 0.f));
}

// float32 -> TF32 (10-bit mantissa), to nearest, ties to even.
__device__ __forceinline__ float tf32_rne(float x) {
  uint32_t u = __float_as_uint(x);
  u += 0xFFFu + ((u >> 13) & 1u);
  return __uint_as_float(u & 0xFFFFE000u);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// An operand part (64 rows x 64 k, the rows being A's M or B's N) is two
// K-major panels of 32 k, each row 128 bytes, in the 128-byte swizzle that
// wgmma reads: 16-byte chunk c of row m sits at chunk c ^ (m % 8).
__device__ __forceinline__ int sw_off(int m, int k) {
  return (k >> 5) * kPanel + m * 32 + ((((k >> 2) & 7) ^ (m & 7)) << 2) +
         (k & 3);
}

// wgmma shared-memory descriptor of a K-major, 128-byte-swizzled panel:
// start address, leading byte offset (unused), stride byte offset 1024 (the
// next 8 rows), swizzle mode 1 (128 B).
__device__ __forceinline__ uint64_t sw128_desc(const float* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// Split the quad (k .. k + 3) of row m into an operand's hi and lo parts:
// a_hi = tf32(a), a_lo = tf32(a - a_hi).
__device__ __forceinline__ void put_quad(float* hi, int m, int k, float4 v) {
  const float4 h = make_float4(tf32_rne(v.x), tf32_rne(v.y), tf32_rne(v.z),
                               tf32_rne(v.w));
  const int o = sw_off(m, k);
  *reinterpret_cast<float4*>(hi + o) = h;
  *reinterpret_cast<float4*>(hi + kPart + o) =
      make_float4(tf32_rne(v.x - h.x), tf32_rne(v.y - h.y),
                  tf32_rne(v.z - h.z), tf32_rne(v.w - h.w));
}

// Quad q of this producer thread: row m, k .. k + 3, if the thread has a
// q-th quad (1024 quads over the producers).  Along k: 16
// consecutive threads take one row (for data whose k runs along memory
// rows); along m: 64 consecutive threads take one quad of k for all rows
// (for data whose m runs along memory rows).  Either way the swizzled
// 16-byte stores of a quarter-warp land in distinct banks.
template <bool kAlongK>
__device__ __forceinline__ bool quad_at(int q, int& m, int& k) {
  const int e = (int)threadIdx.x - kConsumers + q * kProducers;
  m = kAlongK ? e >> 4 : e & 63;
  k = (kAlongK ? e & 15 : e >> 6) << 2;
  return e < kT * kT / 4;
}

// d (64 x 64, f32) += A (64 x 8, tf32) . B (8 x 64, tf32), both from shared
// memory, K-major; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
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
// Keeps the compiler from touching an asynchronous wgmma's accumulators
// before its wait.
__device__ __forceinline__ void reg_fence(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// Named barriers 1 .. 2 kStages hand the ring's slots between producers and
// consumers: slot s is full (1 + s) or empty (1 + kStages + s).
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(kThreads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "n"(kThreads) : "memory");
}

// 4-byte global -> shared copy that bypasses the registers; `valid` false
// writes a zero and reads nothing.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Producer warps' named barrier (after they load their Q-sized arrays).
constexpr int kProducerBar = 1 + 2 * kStages;
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync %0, %1;\n" :: "n"(kProducerBar), "n"(kProducers)
               : "memory");
}

// The product kernels are warp-specialised: a block computes one 64 x 64
// output tile from n_k k-tiles, its producer warps staging k-tiles into a
// ring of kStages slots (produce), its consumer warpgroup multiplying them
// (consume).
//
// produce: the producers copy k-tile t + 2 into a raw staging buffer with
// cp.async (each thread its own quads, so it needs no barrier to read them
// back) while they split k-tile t from raw into its ring slot.
//   src_a(t, m, k, valid) / src_b: the global address of element (row m,
//   k) of k-tile t's A / B and whether it exists (else it is zero);
//   scale_a(t, m, k, v): A's quad (m, k .. k + 3) as it is multiplied.
// kAK / kBK: whether A / B quads run along k (else along m, see quad_at).
template <bool kAK, bool kBK, typename SrcA, typename SrcB, typename ScaleA>
__device__ __forceinline__ void produce(float* ring, float* raw, int n_k,
                                        SrcA src_a, SrcB src_b,
                                        ScaleA scale_a) {
  const int p = threadIdx.x - kConsumers;
  // raw stage (t & 1): A quads, then B quads, quad q of this thread at
  // (q * kProducers + p) * 4
  auto issue = [&](int t) {
    float* r = raw + (t & 1) * 2 * kT * kT;
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      int m, k;
      bool ok;
      if (!quad_at<kAK>(q, m, k)) continue;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* src = src_a(t, m, k + u, ok);
        cp_async4(r + (q * kProducers + p) * 4 + u, src, ok);
      }
      quad_at<kBK>(q, m, k);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* src = src_b(t, m, k + u, ok);
        cp_async4(r + kT * kT + (q * kProducers + p) * 4 + u, src, ok);
      }
    }
  };
  issue(0);
  cp_async_commit();
  if (n_k > 1) issue(1);
  cp_async_commit();
  for (int t = 0; t < n_k; ++t) {
    const int s = t % kStages;
    float* slot = ring + s * kStage;
    const float* r = raw + (t & 1) * 2 * kT * kT;
    cp_async_wait1();   // this thread's copies of k-tile t have landed
    if (t >= kStages) bar_sync(1 + kStages + s);   // its slot's last use done
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      int m, k;
      if (!quad_at<kAK>(q, m, k)) continue;
      put_quad(slot, m, k,
               scale_a(t, m, k, *reinterpret_cast<const float4*>(
                                    r + (q * kProducers + p) * 4)));
      quad_at<kBK>(q, m, k);
      put_quad(slot + 2 * kPart, m, k,
               *reinterpret_cast<const float4*>(
                   r + kT * kT + (q * kProducers + p) * 4));
    }
    // generic-proxy stores, read next by wgmma through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_arrive(1 + s);
    if (t + 2 < n_k) issue(t + 2);   // into the raw stage just read
    cp_async_commit();
  }
}

// consume: the consumer warpgroup runs the three products of each k-tile as
// wgmma (A hi.B hi into one partial, A hi.B lo and A lo.B hi into another:
// the tensor cores' own accumulation truncates, so no partial runs over
// more than a k-tile) and adds the partials to acc in f32.  acc is the
// wgmma accumulator layout: with w = warp, g = lane / 4, t = lane % 4,
// acc[4 j + e] holds row 16 w + g (+ 8 for e >= 2), column 8 j + 2 t +
// (e & 1).
__device__ __forceinline__ void consume(float (&acc)[32], const float* ring,
                                        int n_k) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int t = 0; t < n_k; ++t) {
    const int s = t % kStages;
    const float* slot = ring + s * kStage;
    bar_sync(1 + s);
    float hh[32], cross[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kT / 8; ++kk) {
      const int off = (kk >> 2) * kPanel + (kk & 3) * 8;   // 32 B a k-step
      const uint64_t ah = sw128_desc(slot + off);
      const uint64_t al = sw128_desc(slot + kPart + off);
      const uint64_t bh = sw128_desc(slot + 2 * kPart + off);
      const uint64_t bl = sw128_desc(slot + 3 * kPart + off);
      wgmma_tf32(hh, ah, bh, kk > 0);
      wgmma_tf32(cross, ah, bl, kk > 0);
      wgmma_tf32(cross, al, bh, 1);
    }
    wgmma_commit();
    wgmma_wait0();
    reg_fence(hh);
    reg_fence(cross);
    if (t + kStages < n_k) bar_arrive(1 + kStages + s);   // slot is reused
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += hh[i] + cross[i];
  }
}

// Store the consumer warpgroup's 64 x 64 tile, clipped to rows x cols.
__device__ __forceinline__ void store_tile(const float (&acc)[32], float* out,
                                           size_t ld, int rows, int cols) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * w + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = r0 + ((i >> 1) & 1) * 8, c = c0 + (i >> 2) * 8 + (i & 1);
    if (r < rows && c < cols) out[(size_t)r * ld + c] = acc[i];
  }
}

// The dynamic shared memory, its ring aligned to 1024 bytes (the swizzle
// repeats every 8 rows of 128 bytes).
__device__ __forceinline__ float* smem_ring() {
  extern __shared__ unsigned char ssd_smem_raw[];
  return reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(ssd_smem_raw) + 1023) & ~uintptr_t(1023));
}

// By the producers: sDt[i] = dt and sSeg[i] = seg of row i of the chunk
// (from ssd_seg_kernel), zeros from Q to q_pad.  Ends synchronised among
// the producers.
__device__ __forceinline__ void load_seg(const float* __restrict__ db,
                                         const float* __restrict__ sgb, int H,
                                         int Q, int q_pad, float* sDt,
                                         float* sSeg) {
  for (int i = threadIdx.x - kConsumers; i < q_pad; i += kProducers) {
    sDt[i] = i < Q ? db[(size_t)i * H] : 0.f;
    sSeg[i] = i < Q ? sgb[(size_t)i * H] : 0.f;
  }
  producer_sync();
}

struct Args {
  const float* x;     // (B, L, H, P)
  const float* b;     // (B, L, N)
  const float* c;     // (B, L, N)
  const float* dt;    // (B, L, H)
  const float* a;     // (H,)
  float* y;           // (B, L, H, P)
  float* st;          // (B, nc, H, N, P) scratch: S_c, then R_c
  float* se;          // (B, nc, H) scratch: seg_end of each chunk
  float* sg;          // (B, L, H) scratch: seg, the in-chunk cumsum
  float* cbt;         // (B, nc, Q, Q) scratch: C_i . B_j within each chunk
  int L, H, P, N, Q;
};

// ---- 0a. seg = cumsum(dt * a) within each chunk, in order -----------------
// One thread per (chunk, head, batch), adding in the reference's order with
// the product rounded first: seg_i - seg_j of two rows far down a fast-
// decaying chunk is the difference of two large sums, and any other order
// moves it by their last bits, which exp() turns into relative error of y
// (a block-wide scan broke the 1e-4 bar at |seg| ~ 1e3).
__global__ void __launch_bounds__(64) ssd_seg_kernel(Args g) {
  const int c = blockIdx.x, h = blockIdx.y * 64 + threadIdx.x, b = blockIdx.z;
  if (h >= g.H) return;
  const int nc = g.L / g.Q;
  const size_t off = ((size_t)b * g.L + (size_t)c * g.Q) * g.H + h;
  const float A = g.a[h];
  float run = 0.f;
  for (int i0 = 0; i0 < g.Q; i0 += 64) {   // 64 loads in flight, then adds
    float d[64];
#pragma unroll
    for (int k = 0; k < 64; ++k)
      d[k] = i0 + k < g.Q ? __ldg(g.dt + off + (size_t)(i0 + k) * g.H) : 0.f;
#pragma unroll
    for (int k = 0; k < 64; ++k) {
      if (i0 + k >= g.Q) break;
      run = __fadd_rn(run, __fmul_rn(d[k], A));
      g.sg[off + (size_t)(i0 + k) * g.H] = run;
    }
  }
  g.se[((size_t)b * nc + c) * g.H + h] = run;
}

// ---- 0b. C_i . B_j of each chunk, once for all heads ----------------------
// One block per (64 x 64 tile at or below the diagonal, chunk, batch): A =
// C rows i, B = B rows j, k = the state in k-tiles of 64.
__global__ void __launch_bounds__(kThreads, 1) ssd_cb_kernel(Args g) {
  const int N = g.N, Q = g.Q;
  const int n_tiles = (Q + kT - 1) / kT;
  const int it = blockIdx.x / n_tiles, jt = blockIdx.x % n_tiles;
  if (jt > it) return;
  float* ring = smem_ring();
  const int c = blockIdx.y, b = blockIdx.z;
  const int nc = g.L / Q, l0 = c * Q, i0 = it * kT, j0 = jt * kT;
  const int n_k = (N + kT - 1) / kT;
  if (threadIdx.x >= kConsumers) {
    const float* cb = g.c + ((size_t)b * g.L + l0) * N;
    const float* bb = g.b + ((size_t)b * g.L + l0) * N;
    auto src_a = [&](int tk, int m, int k, bool& ok) {
      const int n = tk * kT + k;
      ok = i0 + m < Q && n < N;
      return cb + (ok ? (size_t)(i0 + m) * N + n : 0);
    };
    auto src_b = [&](int tk, int m, int k, bool& ok) {
      const int n = tk * kT + k;
      ok = j0 + m < Q && n < N;
      return bb + (ok ? (size_t)(j0 + m) * N + n : 0);
    };
    auto same = [](int, int, int, float4 v) { return v; };
    produce<true, true>(ring, ring + kStages * kStage, n_k, src_a, src_b,
                        same);
    return;
  }
  float acc[32];
  consume(acc, ring, n_k);
  store_tile(acc, g.cbt + ((size_t)b * nc + c) * Q * Q + (size_t)i0 * Q + j0,
             Q, Q - i0, Q - j0);
}

// ---- 1. the chunk's own state S_c = (w B)^T X ------------------------------
// One block per (64 state rows, chunk but the last, head, batch): A = rows
// n, k = j, the value w_j B_j[n]; B = rows p, k = j, the value x_j[p].
__global__ void __launch_bounds__(kThreads, 1) ssd_state_kernel(Args g) {
  float* ring = smem_ring();
  const int N = g.N, P = g.P, Q = g.Q, H = g.H;
  const int n_halves = (N + kT - 1) / kT;
  const int c = blockIdx.x / n_halves, n0 = (blockIdx.x % n_halves) * kT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = g.L / Q, l0 = c * Q, n_k = (Q + kT - 1) / kT;
  const size_t xrow = (size_t)H * P;
  if (threadIdx.x >= kConsumers) {
    const float* xb = g.x + ((size_t)b * g.L + l0) * xrow + (size_t)h * P;
    const float* bb = g.b + ((size_t)b * g.L + l0) * N;
    // the producers' Q-sized arrays, padded with zeros to a whole k-tile
    // so that quads read them as float4: seg, dt, and w_j =
    // exp(clip(seg_end - seg_j)) dt_j
    const int q_pad = n_k * kT;
    float* sSeg = ring + kStages * kStage + 4 * kT * kT;
    float* sDt = sSeg + q_pad;
    float* sW = sDt + q_pad;
    load_seg(g.dt + ((size_t)b * g.L + l0) * H + h,
             g.sg + ((size_t)b * g.L + l0) * H + h, H, Q, q_pad, sDt, sSeg);
    const float seg_end = sSeg[Q - 1];
    for (int i = threadIdx.x - kConsumers; i < q_pad; i += kProducers)
      sW[i] = i < Q ? clip_exp(seg_end - sSeg[i]) * sDt[i] : 0.f;
    producer_sync();
    auto src_a = [&](int tk, int m, int k, bool& ok) {
      const int j = tk * kT + k;
      ok = j < Q && n0 + m < N;
      return bb + (ok ? (size_t)j * N + n0 + m : 0);
    };
    auto src_b = [&](int tk, int m, int k, bool& ok) {
      const int j = tk * kT + k;
      ok = j < Q && m < P;
      return xb + (ok ? (size_t)j * xrow + m : 0);
    };
    auto scale_a = [&](int tk, int, int k, float4 v) {
      const float4 w = *reinterpret_cast<const float4*>(sW + tk * kT + k);
      return make_float4(v.x * w.x, v.y * w.y, v.z * w.z, v.w * w.w);
    };
    produce<false, false>(ring, ring + kStages * kStage, n_k, src_a, src_b,
                          scale_a);
    return;
  }
  float acc[32];
  consume(acc, ring, n_k);
  const size_t slot = ((size_t)b * nc + c) * H + h;
  store_tile(acc, g.st + slot * N * P + (size_t)n0 * P, P, N - n0, P);
}

// ---- 2. the recurrence, in chunk order: S_c -> R_c in place ---------------
// Each thread carries kStatePer elements of R in registers, so the loads of
// one chunk step are independent and overlap (one chain of dependent loads
// per element was latency-bound: 0.34 ms at the main-path shape).  The last
// chunk has no S_c (nothing reads the state after it): its slot only
// receives R.
constexpr int kStatePer = 8;
constexpr int kRecurThreads = 256;

__global__ void __launch_bounds__(kRecurThreads) ssd_recur_kernel(Args g) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = g.L / g.Q, NP = g.N * g.P;
  const int e0 = blockIdx.x * kStatePer * kRecurThreads + threadIdx.x;
  float R[kStatePer];
#pragma unroll
  for (int k = 0; k < kStatePer; ++k) R[k] = 0.f;
  for (int c = 0; c < nc; ++c) {
    const size_t slot = ((size_t)b * nc + c) * g.H + h;
    float* p = g.st + slot * NP;
    const bool more = c + 1 < nc;
    const float dec = more ? clip_exp(g.se[slot]) : 0.f;
    float s[kStatePer];
#pragma unroll
    for (int k = 0; k < kStatePer; ++k) {
      const int e = e0 + k * kRecurThreads;
      s[k] = more && e < NP ? p[e] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kStatePer; ++k) {
      const int e = e0 + k * kRecurThreads;
      if (e < NP) p[e] = R[k];
      R[k] = R[k] * dec + s[k];
    }
  }
}

// ---- 3. y = intra + inter, written once ------------------------------------
// One block per (64-row tile, chunk, head, batch), the heaviest row tiles
// (the most source tiles below the diagonal) first.  The k-tiles: for each
// source tile j <= i, A = the weights W = C.B^T * decay * dt_j (masked) and
// B = x_j (rows p); then, for chunks >= 1, A = exp(clip(seg_i)) C_i and B =
// R_c (rows p), 64 state rows at a time (the inter term as more k-tiles of
// the same accumulators).
__global__ void __launch_bounds__(kThreads, 1) ssd_y_kernel(Args g) {
  float* ring = smem_ring();
  const int N = g.N, P = g.P, Q = g.Q, H = g.H;
  const int n_tiles = (Q + kT - 1) / kT;
  const int it = n_tiles - 1 - blockIdx.x % n_tiles, c = blockIdx.x / n_tiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = g.L / Q, l0 = c * Q, i0 = it * kT;
  const int n_intra = it + 1;
  const int n_k = n_intra + (c > 0 ? (N + kT - 1) / kT : 0);
  const size_t xrow = (size_t)H * P;
  if (threadIdx.x >= kConsumers) {
    const float* xb = g.x + ((size_t)b * g.L + l0) * xrow + (size_t)h * P;
    const float* cb = g.c + ((size_t)b * g.L + l0) * N;
    const float* cbt = g.cbt + ((size_t)b * nc + c) * Q * Q;
    const float* rb = g.st + (((size_t)b * nc + c) * H + h) * N * P;
    const int q_pad = n_tiles * kT;   // see ssd_state_kernel
    float* sSeg = ring + kStages * kStage + 4 * kT * kT;
    float* sDt = sSeg + q_pad;
    load_seg(g.dt + ((size_t)b * g.L + l0) * H + h,
             g.sg + ((size_t)b * g.L + l0) * H + h, H, Q, q_pad, sDt, sSeg);
    auto src_a = [&](int tk, int m, int k, bool& ok) {
      const int i = i0 + m;
      if (tk < n_intra) {
        const int j = tk * kT + k;
        ok = i < Q && j <= i;
        return cbt + (ok ? (size_t)i * Q + j : 0);
      }
      const int n = (tk - n_intra) * kT + k;
      ok = i < Q && n < N;
      return cb + (ok ? (size_t)i * N + n : 0);
    };
    auto src_b = [&](int tk, int m, int k, bool& ok) {
      if (tk < n_intra) {
        const int j = tk * kT + k;
        ok = j < Q && m < P;
        return xb + (ok ? (size_t)j * xrow + m : 0);
      }
      const int n = (tk - n_intra) * kT + k;
      ok = n < N && m < P;
      return rb + (ok ? (size_t)n * P + m : 0);
    };
    auto scale_a = [&](int tk, int m, int k, float4 v) {
      const float si = sSeg[min(i0 + m, Q - 1)];
      if (tk < n_intra) {
        const int j = tk * kT + k;
        const float4 sj = *reinterpret_cast<const float4*>(sSeg + j);
        const float4 dj = *reinterpret_cast<const float4*>(sDt + j);
        return make_float4(v.x * clip_exp(si - sj.x) * dj.x,
                           v.y * clip_exp(si - sj.y) * dj.y,
                           v.z * clip_exp(si - sj.z) * dj.z,
                           v.w * clip_exp(si - sj.w) * dj.w);
      }
      const float e = clip_exp(si);
      return make_float4(v.x * e, v.y * e, v.z * e, v.w * e);
    };
    produce<true, false>(ring, ring + kStages * kStage, n_k, src_a, src_b,
                         scale_a);
    return;
  }
  float acc[32];
  consume(acc, ring, n_k);
  store_tile(acc, g.y + ((size_t)b * g.L + l0 + i0) * xrow + (size_t)h * P,
             xrow, Q - i0, P);
}

// dynamic shared memory: the ring, two raw stages of A and B, `arrays`
// padded Q-sized arrays, alignment slack
size_t smem_bytes(int Q, int arrays) {
  const size_t q_pad = (size_t)(Q + kT - 1) / kT * kT;
  return sizeof(float) * (kStages * kStage + 4 * kT * kT + arrays * q_pad) +
         1024;
}

// The opt-in maximum of dynamic shared memory, less the kernel's static
// shared memory.
template <typename Kernel>
cudaError_t allow_max_dynamic_smem(Kernel kernel, int optin) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - (int)attr.sharedSizeBytes);
  return e;
}

cudaError_t allow_max_smem() {
  // once, outside any CUDA-graph capture that follows
  static bool configured = false;
  if (configured) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess) e = allow_max_dynamic_smem(ssd_cb_kernel, optin);
  if (e == cudaSuccess) e = allow_max_dynamic_smem(ssd_state_kernel, optin);
  if (e == cudaSuccess) e = allow_max_dynamic_smem(ssd_y_kernel, optin);
  if (e == cudaSuccess) configured = true;
  return e;
}

}  // namespace

extern "C" {



const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, L, H, P), b and c (B, L, N), dt (B, L, H), a (H,) -> y (B, L, H, P);
// scratch st (B, L / Q, H, N, P), se (B, L / Q, H), sg (B, L, H) and cbt
// (B, L / Q, Q, Q), allocated by the caller.  float32, contiguous.  Needs L % Q == 0,
// P <= 64, N <= 128.
// Returns a cudaError_t (cudaErrorInvalidValue for shapes outside those).
int ssd_scan_launch(const void* x, const void* b, const void* c,
                    const void* dt, const void* a, void* y, void* st,
                    void* se, void* sg, void* cbt, int B, int L, int H,
                    int P, int N, int Q, void* stream_ptr) {
  if (Q <= 0 || L % Q != 0 || P < 1 || P > kMaxP || N < 1 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || L == 0 || H == 0) return 0;
  cudaError_t e = allow_max_smem();
  if (e != cudaSuccess) return (int)e;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Args g{static_cast<const float*>(x), static_cast<const float*>(b),
               static_cast<const float*>(c), static_cast<const float*>(dt),
               static_cast<const float*>(a), static_cast<float*>(y),
               static_cast<float*>(st), static_cast<float*>(se),
               static_cast<float*>(sg), static_cast<float*>(cbt), L, H, P, N,
               Q};
  const int nc = L / Q, n_tiles = (Q + kT - 1) / kT;
  ssd_seg_kernel<<<dim3(nc, (H + 63) / 64, B), 64, 0, stream>>>(g);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_cb_kernel<<<dim3(n_tiles * n_tiles, nc, B), kThreads, smem_bytes(Q, 0),
                  stream>>>(g);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (nc > 1) {
    ssd_state_kernel<<<dim3((nc - 1) * ((N + kT - 1) / kT), H, B), kThreads,
                       smem_bytes(Q, 3), stream>>>(g);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    const int per_block = kStatePer * kRecurThreads;
    ssd_recur_kernel<<<dim3((N * P + per_block - 1) / per_block, H, B),
                       kRecurThreads, 0, stream>>>(g);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  ssd_y_kernel<<<dim3(nc * n_tiles, H, B), kThreads, smem_bytes(Q, 2),
                 stream>>>(g);
  return (int)cudaGetLastError();
}

}  // extern "C"
