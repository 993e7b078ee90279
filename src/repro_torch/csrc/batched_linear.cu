// Hand-written Hopper (sm_90a) kernels: the batched products and sums of
// the agents' TD step, with an accumulation order that does not depend on
// how many agents share the launch.
//
// Replaces no Pallas kernel: the reference leaves the TD step's products
// to XLA (jax.value_and_grad of src/repro/core/dqn.py td_loss).  The port
// runs one TD step for G agents at once, G = 1 for a serial episode and
// G = L·S for a grid's cells.  cuBLAS picks its batched-GEMM algorithm
// from the batch count, and torch's reductions their split from the
// number of outputs, so agent g's gradients come out in other float bits
// at G = 45 than at G = 1; Adam normalises those differences in
// near-zero gradients into full steps, and after a few hundred TD steps
// the grid's agents and the serial ones act differently.  These kernels
// give each output a fixed order instead:
//   bgemm    C[g] = op(A[g]) @ op(B[g]), plus bias[g] broadcast over the
//            rows where given (the forward layer in one launch), and where
//            asked the column sums of op(B[g]) as one more row of A made
//            of ones (the weight and bias gradients in one launch):
//            32 x 32 output tiles per block, 32-deep k tiles staged
//            through shared memory from any strides (the global loads
//            run along whichever axis of A and of B is contiguous), each
//            thread 2 x 2 outputs whose K products are added in ascending
//            k, one FMA each, from 0; the bias is added after the sum;
//   sq_norm  (G,) = the square root of the sum over up to 16 leaves, in
//            their order, of each leaf's sum of squares per agent: one
//            block per agent, each thread a fixed stride of the row in
//            order, then a fixed shared-memory tree.
// So agent g's results are the same bits for every G.  A ones-row FMA
// 1 * b + acc rounds once, as the plain add b + acc does.
//
// What bounds them on this card: launch latency.  The products are
// 64 x 106 x 128 per agent (~1.7 MFLOP), the norm at most 13568 values a
// leaf; at 45 agents that is tens of microseconds of f32 FMA at most.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;       // output tile edge and k-tile depth
constexpr int kThreads = 256;   // 16 x 16 threads, 2 x 2 outputs each
constexpr int kMaxLeaves = 16;

__global__ void __launch_bounds__(kThreads)
bgemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ bias, float* __restrict__ c,
             float* __restrict__ colsum, int M, int N, int K, long long a_g,
             long long a_m, long long a_k, long long b_g, long long b_k,
             long long b_n) {
  __shared__ float as[kTile][kTile + 1];   // [m][k]
  __shared__ float bs[kTile][kTile + 1];   // [k][n]
  const int g = blockIdx.z;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* ag = a + g * a_g;
  const float* bg = b + g * b_g;
  // which tile axis neighbouring threads load: the contiguous one
  const bool a_m_fast = a_m == 1 && a_k != 1;
  const bool b_k_fast = b_k == 1 && b_n != 1;
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  for (int k0 = 0; k0 < K; k0 += kTile) {
    const int kn = min(kTile, K - k0);
    for (int l = threadIdx.x; l < kTile * kTile; l += kThreads) {
      const int slow = l / kTile, fast = l % kTile;
      const int m = a_m_fast ? fast : slow, ka = a_m_fast ? slow : fast;
      const int gm = m0 + m, gka = k0 + ka;
      float v = 0.0f;
      if (gka < K) {
        if (gm < M) v = ag[gm * a_m + gka * a_k];
        else if (gm == M && colsum) v = 1.0f;
      }
      as[m][ka] = v;
      const int kb = b_k_fast ? fast : slow, n = b_k_fast ? slow : fast;
      const int gkb = k0 + kb, gn = n0 + n;
      bs[kb][n] = gkb < K && gn < N ? bg[gkb * b_k + gn * b_n] : 0.0f;
    }
    __syncthreads();
    for (int kk = 0; kk < kn; ++kk) {
      const float a0 = as[ty][kk], a1 = as[ty + 16][kk];
      const float b0 = bs[kk][tx], b1 = bs[kk][tx + 16];
      acc[0][0] = __fmaf_rn(a0, b0, acc[0][0]);
      acc[0][1] = __fmaf_rn(a0, b1, acc[0][1]);
      acc[1][0] = __fmaf_rn(a1, b0, acc[1][0]);
      acc[1][1] = __fmaf_rn(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }
  for (int i = 0; i < 2; ++i) {
    const int gm = m0 + ty + 16 * i;
    for (int j = 0; j < 2; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      if (gm < M) {
        const long long o = ((long long)g * M + gm) * N + gn;
        c[o] = bias ? __fadd_rn(acc[i][j], bias[(long long)g * N + gn])
                    : acc[i][j];
      } else if (gm == M && colsum) {
        colsum[(long long)g * N + gn] = acc[i][j];
      }
    }
  }
}

struct Leaves {
  const float* ptr[kMaxLeaves];
  long long n[kMaxLeaves];   // elements per agent
};

__global__ void __launch_bounds__(kThreads)
sq_norm_kernel(Leaves leaves, int L, float* __restrict__ out) {
  __shared__ float part[kThreads];
  const int g = blockIdx.x;
  float total = 0.0f;
  for (int l = 0; l < L; ++l) {
    const long long n = leaves.n[l];
    const float* row = leaves.ptr[l] + g * n;
    float acc = 0.0f;
    for (long long i = threadIdx.x; i < n; i += kThreads)
      acc = __fadd_rn(acc, __fmul_rn(row[i], row[i]));
    part[threadIdx.x] = acc;
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
      if (threadIdx.x < s)
        part[threadIdx.x] = __fadd_rn(part[threadIdx.x],
                                      part[threadIdx.x + s]);
      __syncthreads();
    }
    if (threadIdx.x == 0) total = __fadd_rn(total, part[0]);
    __syncthreads();
  }
  if (threadIdx.x == 0) out[g] = __fsqrt_rn(total);
}

unsigned tiles(long long n) { return (unsigned)((n + kTile - 1) / kTile); }

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// c (G, M, N) contiguous = op(a) @ op(b) [+ bias (G, N) on every row],
// with a's (g, m, k) and b's (g, k, n) element strides given (a transpose
// is a swap of strides); colsum (G, N), where not null, = the sums of
// op(b) over k.  bias and colsum contiguous or null.
int bgemm_launch(const void* a, const void* b, const void* bias, void* c,
                 void* colsum, int G, int M, int N, int K, long long a_g,
                 long long a_m, long long a_k, long long b_g, long long b_k,
                 long long b_n, void* stream) {
  if (G < 1 || G > 65535 || M < 1 || N < 1 || K < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(tiles(N), tiles((long long)M + (colsum ? 1 : 0)), G);
  bgemm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(bias), static_cast<float*>(c),
      static_cast<float*>(colsum), M, N, K, a_g, a_m, a_k, b_g, b_k, b_n);
  return (int)cudaGetLastError();
}

// out (G,) = sqrt(sum over leaves l in order of sum(leaf_l[g]^2)); leaf l
// is contiguous (G, n[l]) float32.
int sq_norm_launch(const void* const* ptrs, const long long* n, int L, int G,
                   void* out, void* stream) {
  if (L < 1 || L > kMaxLeaves || G < 1) return (int)cudaErrorInvalidValue;
  Leaves leaves{};
  for (int l = 0; l < L; ++l) {
    if (n[l] < 0) return (int)cudaErrorInvalidValue;
    leaves.ptr[l] = static_cast<const float*>(ptrs[l]);
    leaves.n[l] = n[l];
  }
  sq_norm_kernel<<<G, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      leaves, L, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
