// Backward of blocked causal GQA flash attention for sm_90a.
//
// Replaces no Pallas kernel: the reference trains through XLA's autodiff
// of src/repro/models/attention.py `attend` / `attend_chunked` under
// `jax.value_and_grad` (src/repro/train/train_step.py), and has no backward
// kernel of its own.  The port's forward is the flash kernel
// (flash_attention.cu), a ctypes launch with no autograd, so on the card
// its gradient is this source.  Given q (B, S, H, hd), k, v (B, S, K, hd),
// the forward's output o, its row log-sum-exp lse (B, H, S) f32
// (`flash_attention_lse_launch`) and dO:
//   D  = rowsum(dO o)                                  flash_bwd_d_kernel
//   P  = exp(scale q k^T - lse), 0 above the diagonal  (recomputed, f32)
//   dP = dO v^T,  dS = P (dP - D)
//   dV = P^T dO,  dK = scale dS^T q,  dQ = scale dS k
// every product accumulated in f32, each gradient written once in the
// inputs' type (bf16 or f32).  Causal, no window, S_kv == S, hd 64 or 128:
// the wrapper (ops.py) raises NotImplementedError for any other variant.
//
// Deterministic: no float atomics, and every sum runs in a fixed order.
// flash_bwd_dkdv_kernel: one block per (batch, kv head, 32-key tile); it
// loops over the GQA group's H / K query heads and, for each, the query
// tiles from the key tile's own down to S, so dK and dV of its keys are
// complete in its registers.  flash_bwd_dq_kernel: one block per (batch,
// head, 32-row query tile), looping over the key tiles up to its
// diagonal.  Each block recomputes P and dS of its (query, key) tiles.
//
// Bound on this card: at minitron-8b's shape (B 1, S 4096, H 32, K 8, hd
// 128) the work is 2.5x the forward's 1.374e11 FLOP (dV, dP, dK, dQ and
// the recomputed scores over the causal half), bound by operations at the
// bf16 tensor-core rate (0.347 ms).  This first kernel runs them as f32
// FMAs on the CUDA cores (67 TFLOP/s: 5.1 ms at best), from 32 x 32
// shared-memory tiles with 2 x 2 register tiles for the scores and 2 x
// hd/16 for the gradients: simple and right first; its time against the
// bound is in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 32;          // query rows and keys per tile
constexpr int kThreads = 256;
constexpr int kLT = kT + 1;     // padded row of a P / dS tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Rows r0 .. r0 + kT - 1 of one head of a (.., S, heads, HD) tensor (`src`
// already at its batch and head, rows `stride` apart) into shared memory as
// f32 rows of HD + 1; rows at or past S are zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          size_t stride, int r0, int S) {
  for (int i = threadIdx.x; i < kT * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    dst[r * (HD + 1) + c] =
        r0 + r < S ? to_f(src[(size_t)(r0 + r) * stride + c]) : 0.f;
  }
}

// D = rowsum(dO o) for every (batch, row, head): one warp a row, the lanes'
// partial sums added in a fixed butterfly.  D is (B, H, S).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_d_kernel(const T* __restrict__ o, const T* __restrict__ dO,
                   float* __restrict__ D, int B, int S, int H) {
  const long long rowid =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (rowid >= (long long)B * S * H) return;   // whole warps leave together
  const T* ob = o + (size_t)rowid * HD;
  const T* gb = dO + (size_t)rowid * HD;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < HD; c += 32) acc = fmaf(to_f(ob[c]), to_f(gb[c]), acc);
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
    float* __restrict__ sP, float* __restrict__ sdS, int q0, int k0, int S,
    float scale) {
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
      const int row = q0 + r, col = k0 + c;
      float p = 0.f, ds = 0.f;
      if (row < S && col <= row) {
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
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dO,
                      const float* __restrict__ lse,
                      const float* __restrict__ D, T* __restrict__ dk,
                      T* __restrict__ dv, int S, int H, int K, float scale) {
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

  const int b = blockIdx.x / K, kh = blockIdx.x % K, rep = H / K;
  const int k0 = blockIdx.y * kT;
  const size_t qrow = (size_t)H * HD, krow = (size_t)K * HD;
  const size_t kvoff = (size_t)b * S * krow + (size_t)kh * HD;
  load_rows<T, HD>(sK, k + kvoff, krow, k0, S);
  load_rows<T, HD>(sV, v + kvoff, krow, k0, S);

  const int t = threadIdx.x, kr = t / 16, cc = t % 16;
  float adk[2][CT], adv[2][CT];
#pragma unroll
  for (int m = 0; m < CT; ++m) adk[0][m] = adk[1][m] = adv[0][m] = adv[1][m] = 0.f;

  for (int hh = 0; hh < rep; ++hh) {
    const int h = kh * rep + hh;
    const size_t qoff = (size_t)b * S * qrow + (size_t)h * HD;
    const float* lb = lse + ((size_t)b * H + h) * S;
    const float* db = D + ((size_t)b * H + h) * S;
    // query tiles at and below the diagonal: q0 >= k0 (equal tile sizes)
    for (int q0 = k0; q0 < S; q0 += kT) {
      __syncthreads();   // the previous tile's reads are done
      load_rows<T, HD>(sQ, q + qoff, qrow, q0, S);
      load_rows<T, HD>(sdO, dO + qoff, qrow, q0, S);
      if (t < kT) {
        sLse[t] = q0 + t < S ? lb[q0 + t] : 0.f;
        sD[t] = q0 + t < S ? db[q0 + t] : 0.f;
      }
      __syncthreads();
      p_ds_tile<HD>(sQ, sdO, sK, sV, sLse, sD, sP, sdS, q0, k0, S, scale);
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
    if (key >= S) continue;
    T* dkb = dk + kvoff + (size_t)key * krow;
    T* dvb = dv + kvoff + (size_t)key * krow;
#pragma unroll
    for (int m = 0; m < CT; ++m) {
      dkb[cc + 16 * m] = from_f<T>(adk[r][m] * scale);
      dvb[cc + 16 * m] = from_f<T>(adv[r][m]);
    }
  }
}

// dQ of kT query rows of one head.  Thread t accumulates rows t / 16 and
// + 16, columns t % 16 + 16 m.  The heaviest query tiles (the most key
// tiles) start first.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ D, T* __restrict__ dq, int S,
                    int H, int K, float scale) {
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

  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h / (H / K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kT;
  const size_t qrow = (size_t)H * HD, krow = (size_t)K * HD;
  const size_t qoff = (size_t)b * S * qrow + (size_t)h * HD;
  const size_t kvoff = (size_t)b * S * krow + (size_t)kh * HD;
  const int t = threadIdx.x, qr = t / 16, cc = t % 16;
  load_rows<T, HD>(sQ, q + qoff, qrow, q0, S);
  load_rows<T, HD>(sdO, dO + qoff, qrow, q0, S);
  if (t < kT) {
    const size_t row = ((size_t)b * H + h) * S + q0 + t;
    sLse[t] = q0 + t < S ? lse[row] : 0.f;
    sD[t] = q0 + t < S ? D[row] : 0.f;
  }
  float adq[2][CT];
#pragma unroll
  for (int m = 0; m < CT; ++m) adq[0][m] = adq[1][m] = 0.f;

  for (int k0 = 0; k0 <= q0; k0 += kT) {   // key tiles up to the diagonal
    __syncthreads();   // the previous tile's reads are done
    load_rows<T, HD>(sK, k + kvoff, krow, k0, S);
    load_rows<T, HD>(sV, v + kvoff, krow, k0, S);
    __syncthreads();
    p_ds_tile<HD>(sQ, sdO, sK, sV, sLse, sD, sP, sdS, q0, k0, S, scale);
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
    T* dqb = dq + qoff + (size_t)row * qrow;
#pragma unroll
    for (int m = 0; m < CT; ++m) dqb[cc + 16 * m] = from_f<T>(adq[r][m] * scale);
  }
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dO, const void* lse, void* D, void* dq, void* dk,
               void* dv, int B, int S, int H, int K, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  // once per instantiation, outside any CUDA-graph capture that follows
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dO);
  const float* tl = static_cast<const float*>(lse);
  float* tD = static_cast<float*>(D);
  const long long rows = (long long)B * S * H;
  const int d_blocks = (int)((rows * 32 + kThreads - 1) / kThreads);
  flash_bwd_d_kernel<T, HD><<<d_blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(o), tdo, tD, B, S, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (S + kT - 1) / kT;
  flash_bwd_dkdv_kernel<T, HD><<<dim3(B * K, n_tiles), kThreads, smem,
                                 stream>>>(tq, tk, tv, tdo, tl, tD,
                                           static_cast<T*>(dk),
                                           static_cast<T*>(dv), S, H, K,
                                           scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  flash_bwd_dq_kernel<T, HD><<<dim3(B * H, n_tiles), kThreads, smem,
                               stream>>>(tq, tk, tv, tdo, tl, tD,
                                         static_cast<T*>(dq), S, H, K,
                                         scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, o, dO, dq (B, S, H, hd); k, v, dk, dv (B, S, K, hd); lse (B, H, S) f32
// from flash_attention_lse_launch; D (B, H, S) f32 scratch.  Contiguous,
// all bf16 (bf16 != 0) or all f32.  Causal, S_kv == S, hd 64 or 128, H % K
// == 0.  Returns a cudaError_t (cudaErrorInvalidValue outside those).
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dO,
                               const void* lse, void* D, void* dq, void* dk,
                               void* dv, int B, int S, int H, int K, int hd,
                               float scale, int bf16, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (K < 1 || H % K != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
#define REPRO_BWD_ARGS q, k, v, o, dO, lse, D, dq, dk, dv, B, S, H, K, scale, \
                       stream
  switch ((bf16 ? 1000 : 0) + hd) {
    case 64: return launch_bwd<float, 64>(REPRO_BWD_ARGS);
    case 128: return launch_bwd<float, 128>(REPRO_BWD_ARGS);
    case 1064: return launch_bwd<__nv_bfloat16, 64>(REPRO_BWD_ARGS);
    case 1128: return launch_bwd<__nv_bfloat16, 128>(REPRO_BWD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_BWD_ARGS
}

}  // extern "C"
