// Blocked causal / non-causal GQA flash attention for sm_90a.
//
// Replaces src/repro/kernels/flash_attention/kernel.py:80 `flash_attention`
// (`_flash_kernel`, :31): softmax(q k^T * scale, masked) v with an online
// softmax (running max m, running sum l, f32 accumulator acc), skipping the
// KV tiles above the diagonal.  q, o: (B, S, H, hd); k, v: (B, S, K, hd) with
// H % K == 0.  The KV head of query head h is h / (H / K), so the expanded
// K/V of the reference's wrapper is never materialised.
//
// Bound on this card: at the main-path shape (B 1, S 4096, H 32, hd 128,
// bf16) the causal half of the two products is ~1.4e11 FLOP against ~84 MB
// of q/k/v/o, so it is bound by operations (tensor-core rate), not bytes.
// Design: one block per (batch*head, query tile of 64 rows); the K and V
// tiles (64 rows) are staged through shared memory and reused by the
// block's four warps; the online-softmax state lives in registers.
//   * bf16: each warp owns 16 query rows and runs both products on the
//     tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate), its K
//     and V fragments read by ldmatrix (.trans for V).  The scores'
//     accumulator fragment is re-packed in registers as the A operand of
//     the P.V product, so P never touches shared memory.  P is rounded to
//     bf16 for that product (the reference keeps it in f32; the bar against
//     the plain version is the reference's bf16 tolerance).  The softmax
//     runs in log2 units (scale * log2(e) folded in, ex2.approx), and only
//     tiles that reach the diagonal or the ragged end are masked.
//   * f32: CUDA-core FMAs (no TF32: the f32 bar is 2e-5), 4 x 4 register
//     tiles, P through shared memory.
// Kept from the reference: the finite -1e30 mask value (never -inf, so a
// fully masked tile gives finite p that the next tile's correction wipes),
// the finaliser's max(l, 1e-30), and the causal skip rule (a KV tile runs
// iff its first key <= the tile's last query row).  Keys at or past S are
// masked too, so a ragged S needs no padding here.
// K/V tiles are double-buffered with cp.async (tile j + 1 in flight while j
// is computed).  Not yet used: wgmma, TMA, a producer warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMaskValue = -1e30f;
constexpr int kBQ = 64;        // query rows per block
constexpr int kThreads = 128;  // four warps

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync)
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
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int S, int H, int K,
                  float scale, int causal) {
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
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kBQ;
  const size_t qrow = (size_t)H * HD, krow = (size_t)K * HD;
  const __nv_bfloat16* qb = q + (size_t)b * S * qrow + (size_t)h * HD;
  const __nv_bfloat16* kb = k + (size_t)b * S * krow + (size_t)kh * HD;
  const __nv_bfloat16* vb = v + (size_t)b * S * krow + (size_t)kh * HD;
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

  // causal skip: tile j runs iff j * kBKV16 <= the block's last query row
  int kv_end = S;
  if (causal) kv_end = min(S, q0 + kBQ);
  const int n_tiles = (kv_end + kBKV16 - 1) / kBKV16;
  auto load_tile = [&](int tile) {
    const int kv0 = tile * kBKV16;
    __nv_bfloat16* kd = kbuf + (tile & 1) * kBKV16 * LD;
    __nv_bfloat16* vd = vbuf + (tile & 1) * kBKV16 * LD;
    for (int i = threadIdx.x; i < kBKV16 * VEC; i += kThreads) {
      const int r = i / VEC, c = (i % VEC) * 8;
      const bool in = kv0 + r < S;  // rows past S: zeros, read nothing
      const size_t off = (size_t)(in ? kv0 + r : 0) * krow + c;
      cp_async16(kd + r * LD + c, kb + off, in);
      cp_async16(vd + r * LD + c, vb + off, in);
    }
    cp_async_commit();
  };
  load_tile(0);
  for (int tile = 0; tile < n_tiles; ++tile) {
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
    const bool masked = kv0 + kBKV16 > S || (causal && kv0 + kBKV16 - 1 > q0);
    float mx0 = kMaskValue, mx1 = kMaskValue;
#pragma unroll
    for (int nt = 0; nt < kBKV16 / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (masked) {
          const int row = e < 2 ? r0 : r1;
          const int col = kv0 + nt * 8 + 2 * t + (e & 1);
          if (col >= S || (causal && col > row)) x = kMaskValue;
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
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBKV32 = 32;     // keys per tile
// Thread (ty, tx) = (tid / 8, tid % 8) owns query rows ty + 16 i (i < 4);
// for the scores, keys tx + 8 j (j < 4); for the output, columns tx + 8 c.

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int H, int K, float scale, int causal) {
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
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kBQ;
  const size_t qrow = (size_t)H * HD, krow = (size_t)K * HD;
  const float* qb = q + (size_t)b * S * qrow + (size_t)h * HD;
  const float* kb = k + (size_t)b * S * krow + (size_t)kh * HD;
  const float* vb = v + (size_t)b * S * krow + (size_t)kh * HD;
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

  int kv_end = S;
  if (causal) kv_end = min(S, q0 + kBQ);
  for (int kv0 = 0; kv0 < kv_end; kv0 += kBKV32) {
    __syncthreads();
    for (int i = threadIdx.x; i < kBKV32 * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      const bool in = kv0 + r < S;
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
        if (col >= S || (causal && col > row)) x = kMaskValue;
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
#pragma unroll
    for (int c = 0; c < OC; ++c)
      ob[(size_t)row * qrow + tx + 8 * c] = acc[i][c] * inv;
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int K, float scale, int causal,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)(kBQ + kBKV32) * (HD + 1) +
                                       (size_t)kBKV32 * HD +
                                       (size_t)kBQ * (kBKV32 + 1));
  // once per instantiation, outside any CUDA-graph capture that follows
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_f32_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, K, scale,
      causal);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int S, int H, int K, float scale, int causal,
                cudaStream_t stream) {
  constexpr size_t smem = 4 * (size_t)kBKV16 * (HD + 8) * sizeof(uint16_t);
  // once per instantiation, outside any CUDA-graph capture that follows
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_bf16_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      H, K, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, o (B, S, H, hd); k, v (B, S, K, hd); contiguous, 16-byte aligned.
// is_bf16: 1 for bfloat16 tensors, 0 for float32.  hd in {16, 32, 64, 128}.
// Returns a cudaError_t (cudaErrorInvalidValue for an unsupported hd).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int S, int H, int K, int hd,
                           float scale, int causal, int is_bf16,
                           void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B == 0 || S == 0) return 0;
#define REPRO_FLASH_CASE(D)                                                  \
  case D:                                                                    \
    return is_bf16 ? launch_bf16<D>(q, k, v, o, B, S, H, K, scale, causal,   \
                                    stream)                                  \
                   : launch_f32<D>(q, k, v, o, B, S, H, K, scale, causal,    \
                                   stream);
  switch (hd) {
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_CASE
}

}  // extern "C"
