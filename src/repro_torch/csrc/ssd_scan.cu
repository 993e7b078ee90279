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
// and no state update after the last) against ~71 MB, bound by f32
// operations (no TF32: the bar against the plain version is 1e-4).
//
// Design.  The TPU kernel walks the chunk axis as a sequential grid axis with
// R in VMEM.  Only R's recurrence is sequential, and it is cheap (N x P
// multiply-adds per chunk); the intra term, each chunk's own state
// contribution S_c and the inter term are independent across chunks, and
// C_i . B_j is the same for every head (one group).  So one launch of the
// wrapper runs four kernels in its stream:
//   0. ssd_cb_kernel, one block per (64 x 64 tile at or below the diagonal,
//      chunk, batch): C_i . B_j of the chunk into scratch, once for all heads;
//   1. ssd_intra_kernel, one block per (chunk, head, batch): the intra term
//      (the shared C.B^T tile weighted by this head's decay and dt) into y,
//      S_c and seg_end of the chunk into scratch;
//   2. ssd_state_kernel walks the chunks in order for each (head, batch)
//      (a few blocks each, one slice of R's N x P elements per block) and
//      replaces each S_c by R_c, the state entering chunk c
//      (R_0 = 0, R_{c+1} = exp(clip(seg_end_c)) R_c + S_c);
//   3. ssd_inter_kernel, one block per (chunk >= 1, head, batch): y_i +=
//      exp(clip(seg_i)) C_i . R_c.
// At the main-path shape that is 512 blocks for the heavy kernels, where one
// block per (batch, head) walking every chunk would give 32, a quarter of
// the SMs.  The TPU wrapper's VMEM head-group split does not carry
// over: per-block work is cut into 64 x 64 tiles sized for shared memory (C
// and B row tiles of 64 x N, an x tile, the weighted C.B^T tile, R) and for
// registers (a 4 x 4 micro-tile per thread for y, 8 x 4 for a state).  The
// shared C.B^T (4 MB at the main-path shape) and B are re-read by every
// head's blocks through L2.  CUDA-core FMAs.

#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;          // row / column tile within a chunk
constexpr int kThreads = 256;   // 16 x 16 threads, a 4 x 4 micro-tile each
constexpr int kMaxN = 128;      // d_state
constexpr int kMaxP = 64;       // head_dim

__device__ __forceinline__ float clip_exp(float z) {
  return expf(fminf(fmaxf(z, -60.f), 0.f));
}

// dst[r * ld + c] = src[r * stride + c] for r < rows (zeros past it), c < cols
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* __restrict__ src,
                                          size_t stride, int rows, int cols) {
  for (int i = threadIdx.x; i < kT * cols; i += kThreads) {
    const int r = i / cols, c = i % cols;
    dst[r * ld + c] = r < rows ? src[(size_t)r * stride + c] : 0.f;
  }
}

// sDt[i] = dt of row i of the chunk; sSeg = its in-order cumsum of dt * A
// (one thread, in order, as the reference's cumsum).  Ends synchronised.
__device__ __forceinline__ void chunk_seg(const float* __restrict__ db,
                                          int H, int Q, float A, float* sDt,
                                          float* sSeg) {
  for (int i = threadIdx.x; i < Q; i += kThreads) sDt[i] = db[(size_t)i * H];
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = 0.f;
    for (int i = 0; i < Q; ++i) {
      run += sDt[i] * A;
      sSeg[i] = run;
    }
  }
  __syncthreads();
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
  float* cbt;         // (B, nc, Q, Q) scratch: C_i . B_j within each chunk
  int L, H, P, N, Q;
};

// ---- 0. C_i . B_j of each chunk, once for all heads -----------------------
// One block per (64 x 64 tile at or below the diagonal, chunk, batch).
__global__ void __launch_bounds__(kThreads) ssd_cb_kernel(Args g) {
  extern __shared__ float sm[];
  const int N = g.N, Q = g.Q;
  const int n_tiles = (Q + kT - 1) / kT;
  const int it = blockIdx.x / n_tiles, jt = blockIdx.x % n_tiles;
  if (jt > it) return;
  const int LDN = N + 1;              // padded rows: conflict-free columns
  float* sC = sm;                     // (kT, LDN)
  float* sB = sC + kT * LDN;          // (kT, LDN)
  const int c = blockIdx.y, b = blockIdx.z;
  const int nc = g.L / Q, l0 = c * Q, i0 = it * kT, j0 = jt * kT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  load_tile(sC, LDN, g.c + ((size_t)b * g.L + l0 + i0) * N, N,
            min(kT, Q - i0), N);
  load_tile(sB, LDN, g.b + ((size_t)b * g.L + l0 + j0) * N, N,
            min(kT, Q - j0), N);
  __syncthreads();
  float at[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) at[i][j] = 0.f;
  for (int n = 0; n < N; ++n) {
    float cv[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) cv[i] = sC[(ty + 16 * i) * LDN + n];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = sB[(tx + 16 * j) * LDN + n];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) at[i][j] = fmaf(cv[i], bv[j], at[i][j]);
  }
  float* out = g.cbt + ((size_t)b * nc + c) * Q * Q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = i0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gj = j0 + tx + 16 * j;
      if (gi < Q && gj < Q) out[(size_t)gi * Q + gj] = at[i][j];
    }
  }
}

// ---- 1. intra term and the chunk's own state ----------------------------
__global__ void __launch_bounds__(kThreads) ssd_intra_kernel(Args g) {
  extern __shared__ float sm[];
  const int N = g.N, P = g.P, Q = g.Q, H = g.H;
  const int LDN = N + 1;              // padded rows: conflict-free columns
  float* sB = sm;                     // (kT, LDN) B rows of the source tile
  float* sX = sB + kT * LDN;          // (kT, P)
  float* sAtt = sX + kT * P;          // (kT, kT + 1) masked, weighted C.B^T
  float* sSeg = sAtt + kT * (kT + 1); // (Q)
  float* sDt = sSeg + Q;              // (Q)
  float* sW = sDt + Q;                // (Q) exp(clip(seg_end - seg_j)) dt_j

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = g.L / Q, l0 = c * Q;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t xrow = (size_t)H * P;
  const float* xb = g.x + ((size_t)b * g.L + l0) * xrow + (size_t)h * P;
  float* yb = g.y + ((size_t)b * g.L + l0) * xrow + (size_t)h * P;
  const float* bb = g.b + ((size_t)b * g.L + l0) * N;
  const float* cbt = g.cbt + ((size_t)b * nc + c) * Q * Q;
  const size_t slot = ((size_t)b * nc + c) * H + h;

  // this thread's columns p = tx + 16 j, clamped for reads (writes check p < P)
  int cj[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) cj[j] = min(tx + 16 * j, P - 1);

  chunk_seg(g.dt + ((size_t)b * g.L + l0) * H + h, H, Q, g.a[h], sDt, sSeg);
  const float seg_end = sSeg[Q - 1];
  for (int i = threadIdx.x; i < Q; i += kThreads)
    sW[i] = clip_exp(seg_end - sSeg[i]) * sDt[i];
  const int n_tiles = (Q + kT - 1) / kT;

  // ---- y_intra for each 64-row tile of the chunk ----
  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = it * kT;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kT;
      const int rows = min(kT, Q - j0);
      __syncthreads();  // the last tile's sX / sAtt reads are done
      load_tile(sX, P, xb + (size_t)j0 * xrow, xrow, rows, P);
      // this head's weights on the shared C.B^T tile
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gi = i0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gj = j0 + tx + 16 * j;
          float val = 0.f;
          if (gi >= gj && gi < Q && gj < Q)
            val = cbt[(size_t)gi * Q + gj] * clip_exp(sSeg[gi] - sSeg[gj]) *
                  sDt[gj];
          sAtt[(ty + 16 * i) * (kT + 1) + tx + 16 * j] = val;
        }
      }
      __syncthreads();
      for (int jj = 0; jj < kT; ++jj) {
        float av[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = sAtt[(ty + 16 * i) * (kT + 1) + jj];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = sX[jj * P + cj[j]];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], xv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = i0 + ty + 16 * i;
      if (row >= Q) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (tx + 16 * j < P) yb[(size_t)row * xrow + tx + 16 * j] = acc[i][j];
    }
  }

  // ---- S_c = sum_j w_j B_j x_j^T; thread owns rows n = ty + 16 i ----
  float r[kMaxN / 16][4];
#pragma unroll
  for (int i = 0; i < kMaxN / 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) r[i][j] = 0.f;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int j0 = jt * kT;
    const int rows = min(kT, Q - j0);
    __syncthreads();
    load_tile(sB, LDN, bb + (size_t)j0 * N, N, rows, N);
    load_tile(sX, P, xb + (size_t)j0 * xrow, xrow, rows, P);
    __syncthreads();
    for (int jj = 0; jj < rows; ++jj) {
      const float w = sW[j0 + jj];
      float xv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = sX[jj * P + cj[j]];
#pragma unroll
      for (int i = 0; i < kMaxN / 16; ++i) {
        const float bw = sB[jj * LDN + min(ty + 16 * i, N - 1)] * w;
#pragma unroll
        for (int j = 0; j < 4; ++j) r[i][j] = fmaf(bw, xv[j], r[i][j]);
      }
    }
  }
  float* stb = g.st + slot * N * P;
#pragma unroll
  for (int i = 0; i < kMaxN / 16; ++i) {
    const int n = ty + 16 * i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (tx + 16 * j < P) stb[n * P + tx + 16 * j] = r[i][j];
  }
  if (threadIdx.x == 0) g.se[slot] = seg_end;
}

// ---- 2. the recurrence, in chunk order: S_c -> R_c in place ---------------
// Each thread carries kStatePer elements of R in registers, so the loads of
// one chunk step are independent and overlap (one chain of dependent loads
// per element was latency-bound: 0.34 ms at the main-path shape).
constexpr int kStatePer = 8;

__global__ void __launch_bounds__(kThreads) ssd_state_kernel(Args g) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = g.L / g.Q, NP = g.N * g.P;
  const int e0 = blockIdx.x * kStatePer * kThreads + threadIdx.x;
  float R[kStatePer];
#pragma unroll
  for (int k = 0; k < kStatePer; ++k) R[k] = 0.f;
  for (int c = 0; c < nc; ++c) {
    const size_t slot = ((size_t)b * nc + c) * g.H + h;
    float* p = g.st + slot * NP;
    const float dec = clip_exp(g.se[slot]);
    float s[kStatePer];
#pragma unroll
    for (int k = 0; k < kStatePer; ++k) {
      const int e = e0 + k * kThreads;
      s[k] = e < NP ? p[e] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kStatePer; ++k) {
      const int e = e0 + k * kThreads;
      if (e < NP) p[e] = R[k];
      R[k] = R[k] * dec + s[k];
    }
  }
}

// ---- 3. inter term: y_i += exp(clip(seg_i)) C_i . R_c, chunks c >= 1 ------
__global__ void __launch_bounds__(kThreads) ssd_inter_kernel(Args g) {
  extern __shared__ float sm[];
  const int N = g.N, P = g.P, Q = g.Q, H = g.H;
  const int LDN = N + 1;
  float* sR = sm;                     // (N, P) state entering the chunk
  float* sC = sR + N * P;             // (kT, LDN)
  float* sSeg = sC + kT * LDN;        // (Q)
  float* sDt = sSeg + Q;              // (Q)

  const int c = blockIdx.x + 1, h = blockIdx.y, b = blockIdx.z;
  const int nc = g.L / Q, l0 = c * Q;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t xrow = (size_t)H * P;
  float* yb = g.y + ((size_t)b * g.L + l0) * xrow + (size_t)h * P;
  const float* cb = g.c + ((size_t)b * g.L + l0) * N;
  const float* stb = g.st + (((size_t)b * nc + c) * H + h) * N * P;

  int cj[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) cj[j] = min(tx + 16 * j, P - 1);
  for (int i = threadIdx.x; i < N * P; i += kThreads) sR[i] = stb[i];
  chunk_seg(g.dt + ((size_t)b * g.L + l0) * H + h, H, Q, g.a[h], sDt, sSeg);

  const int n_tiles = (Q + kT - 1) / kT;
  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = it * kT;
    if (it > 0) __syncthreads();  // the last tile's sC reads are done
    load_tile(sC, LDN, cb + (size_t)i0 * N, N, min(kT, Q - i0), N);
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[4], rv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = sC[(ty + 16 * i) * LDN + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) rv[j] = sR[n * P + cj[j]];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], rv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = i0 + ty + 16 * i;
      if (row >= Q) continue;
      const float e = clip_exp(sSeg[row]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (tx + 16 * j < P) yb[(size_t)row * xrow + tx + 16 * j] += acc[i][j] * e;
    }
  }
}

cudaError_t allow_max_smem() {
  // once, outside any CUDA-graph capture that follows: allow the opt-in max
  static bool configured = false;
  if (configured) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_cb_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_intra_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_inter_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (e == cudaSuccess) configured = true;
  return e;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, L, H, P), b and c (B, L, N), dt (B, L, H), a (H,) -> y (B, L, H, P);
// scratch st (B, L / Q, H, N, P), se (B, L / Q, H) and cbt (B, L / Q, Q,
// Q), allocated by the caller.  float32, contiguous.  Needs L % Q == 0, P <= 64, N <= 128.
// Returns a cudaError_t (cudaErrorInvalidValue for shapes outside those).
int ssd_scan_launch(const void* x, const void* b, const void* c,
                    const void* dt, const void* a, void* y, void* st,
                    void* se, void* cbt, int B, int L, int H, int P, int N,
                    int Q, void* stream_ptr) {
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
               static_cast<float*>(cbt), L, H, P, N, Q};
  const int nc = L / Q, n_tiles = (Q + kT - 1) / kT;
  const size_t smem_cb = sizeof(float) * 2 * (size_t)kT * (N + 1);
  ssd_cb_kernel<<<dim3(n_tiles * n_tiles, nc, B), kThreads, smem_cb,
                  stream>>>(g);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const size_t smem_intra =
      sizeof(float) * ((size_t)kT * (N + 1) + (size_t)kT * P +
                       (size_t)kT * (kT + 1) + 3 * (size_t)Q);
  ssd_intra_kernel<<<dim3(nc, H, B), kThreads, smem_intra, stream>>>(g);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int per_block = kStatePer * kThreads;
  ssd_state_kernel<<<dim3((N * P + per_block - 1) / per_block, H, B),
                     kThreads, 0, stream>>>(g);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (nc > 1) {
    const size_t smem_inter =
        sizeof(float) * ((size_t)N * P + (size_t)kT * (N + 1) + 2 * (size_t)Q);
    ssd_inter_kernel<<<dim3(nc - 1, H, B), kThreads, smem_inter, stream>>>(g);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
