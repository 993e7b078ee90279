// Hand-written Hopper (sm_90a) kernel: fused dueling-DQN inference.
//
// Replaces the Pallas kernel `dueling_qnet_fused`
// (src/repro/kernels/dueling_qnet/kernel.py:43): relu(x W0 + b0) ->
// relu(. W1 + b1) -> V (H2 -> 1) and A (H2 -> A), Q = V + A - mean(A).
// The plain torch version is repro_torch/kernels/dueling_qnet/ref.py.
//
// What bounds it on this card: the weights.  At the production shape
// (state 106, hidden 128/128, 8 actions) they are about 123 KB, the
// activations of a 64-row TD batch a few KB, and the work 2 * 31 K
// multiply-adds per row: at B = 1 (act) and B = 64 (TD targets) the bytes
// bound is ~40 ns and the f32 operations bound under 0.1 us, both far below
// one launch.  Design: one block per (agent, 16-row tile), with a leading
// agent axis so a batch of agents is one launch.  The tile's inputs and
// both hidden layers stay in shared memory (no device-memory round trip
// between layers); each thread owns one hidden unit and keeps the tile's
// 16 partial sums in registers, reading its weight column through the
// read-only cache (__ldg), coalesced across the threads of a warp.  All
// f32; the bar against the plain version is a tolerance (1e-4), so the
// summation order may differ from torch.matmul's.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = 128;

// out[r, j] = relu(sum_i in[r, i] * w[i, j] + bias[j]) for the tile's rows.
__device__ void dense_relu(const float* in, int K, const float* __restrict__ w,
                           const float* __restrict__ bias, int H, float* out,
                           int rows) {
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    float acc[kTile];
#pragma unroll
    for (int r = 0; r < kTile; ++r) acc[r] = 0.f;
    for (int i = 0; i < K; ++i) {
      const float wij = __ldg(w + (size_t)i * H + j);
#pragma unroll
      for (int r = 0; r < kTile; ++r) acc[r] += in[r * K + i] * wij;
    }
    const float bj = __ldg(bias + j);
    for (int r = 0; r < rows; ++r) out[r * H + j] = fmaxf(acc[r] + bj, 0.f);
  }
}

__global__ void __launch_bounds__(kThreads)
dueling_qnet_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                    const float* __restrict__ b0, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ wv,
                    const float* __restrict__ bv, const float* __restrict__ wa,
                    const float* __restrict__ ba, float* __restrict__ q, int N,
                    int S, int H1, int H2, int A) {
  extern __shared__ float sm[];
  const int g = blockIdx.y;                     // agent
  const int row0 = blockIdx.x * kTile;
  const int rows = min(kTile, N - row0);
  float* xs = sm;                               // (kTile, S)
  float* h1 = xs + kTile * S;                   // (kTile, H1)
  float* h2 = h1 + kTile * H1;                  // (kTile, H2)
  float* head = h2 + kTile * H2;                // (kTile, A + 1): V then A

  x += ((size_t)g * N + row0) * S;
  w0 += (size_t)g * S * H1;
  b0 += (size_t)g * H1;
  w1 += (size_t)g * H1 * H2;
  b1 += (size_t)g * H2;
  wv += (size_t)g * H2;
  bv += g;
  wa += (size_t)g * H2 * A;
  ba += (size_t)g * A;
  q += ((size_t)g * N + row0) * A;

  for (int i = threadIdx.x; i < kTile * S; i += blockDim.x)
    xs[i] = i < rows * S ? x[i] : 0.f;
  for (int i = threadIdx.x; i < kTile * H1; i += blockDim.x) h1[i] = 0.f;
  for (int i = threadIdx.x; i < kTile * H2; i += blockDim.x) h2[i] = 0.f;
  __syncthreads();
  dense_relu(xs, S, w0, b0, H1, h1, rows);
  __syncthreads();
  dense_relu(h1, H1, w1, b1, H2, h2, rows);
  __syncthreads();

  const int A1 = A + 1;
  for (int idx = threadIdx.x; idx < rows * A1; idx += blockDim.x) {
    const int r = idx / A1, j = idx % A1;
    const float* w = j == 0 ? wv : wa + (j - 1);
    const int stride = j == 0 ? 1 : A;
    float acc = 0.f;
    for (int i = 0; i < H2; ++i)
      acc += h2[r * H2 + i] * __ldg(w + (size_t)i * stride);
    head[r * A1 + j] = acc + (j == 0 ? __ldg(bv) : __ldg(ba + j - 1));
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * A; idx += blockDim.x) {
    const int r = idx / A, j = idx % A;
    float mean = 0.f;
    for (int jj = 0; jj < A; ++jj) mean += head[r * A1 + 1 + jj];
    mean /= (float)A;
    q[(size_t)r * A + j] = head[r * A1] + head[r * A1 + 1 + j] - mean;
  }
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
  const size_t smem = (size_t)kTile * (S + H1 + H2 + A + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        dueling_qnet_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((N + kTile - 1) / kTile, G);
  dueling_qnet_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w0),
      static_cast<const float*>(b0), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(wv),
      static_cast<const float*>(bv), static_cast<const float*>(wa),
      static_cast<const float*>(ba), static_cast<float*>(q), N, S, H1, H2, A);
  return (int)cudaGetLastError();
}

}  // extern "C"
