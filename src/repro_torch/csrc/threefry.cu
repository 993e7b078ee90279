// Hand-written Hopper (sm_90a) kernel: threefry2x32 random streams, the
// draws of `jax.random` that the AIMM engine makes, bit for bit.
//
// Replaces no Pallas kernel: on the TPU these draws are XLA's own threefry
// lowering (jax/_src/prng.py `_threefry2x32_lowering`), fused into the
// jitted epoch.  The port runs the epoch eagerly, and one hash written in
// torch ops is ~150 launches (20 rounds of add, rotate and xor in int64
// under a 32-bit mask), so every `jax.random` call of the engine is ONE
// launch of this kernel instead: a fused elementwise hash over counters,
// with the conversion the call needs in the same launch.
// The plain torch version is repro_torch/kernels/threefry/ref.py.
//
// Modes (one thread per output element; each key draws `n` elements):
//   split    (b, j) -> the two hash words of counter (0, j): key j
//   bits     (b, i) -> w0 ^ w1 of counter (i >> 32, i)
//   uniform  (b, i) -> float32 from the top 23 bits, scaled to [lo, hi)
//   randint  (b, i) -> jax's two-draw randint: the key split in two
//               (counters (0,0), (0,1)), a 32-bit draw from each half,
//               (hi_bits mod span) * (2^32 mod span) + (lo_bits mod span),
//               mod span; span per key (the replay's fill) or one for all
//   choice   (b)    -> cumsum of the key's weight row in float32, in order,
//               r = sum * (1 - uniform), first index with cumsum >= r
//
// What bounds it on this card: bytes and launch latency.  A hash is ~90
// 32-bit integer instructions (funnel-shift rotates), far under a byte of
// memory traffic per instruction, and the engine's calls draw 1-64 values
// for 1-135 keys, so a call costs one launch.  The float steps use the
// _rn intrinsics, never contracted into an FMA, so they round as jax's
// separate multiply and add do; the source is also built with
// -fmad=false like every exact kernel of the port.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Mode { kSplit = 0, kBits = 1, kUniform = 2, kRandint = 3, kChoice = 4 };

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r); \
  x1 ^= x0;

// Threefry-2x32, 20 rounds: five groups of four, a key injection after each.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
}

__device__ __forceinline__ uint32_t bits32(uint32_t k0, uint32_t k1,
                                           long long i) {
  uint32_t x0 = (uint32_t)((unsigned long long)i >> 32);
  uint32_t x1 = (uint32_t)i;
  threefry(k0, k1, x0, x1);
  return x0 ^ x1;
}

__device__ __forceinline__ float to_unit(uint32_t b) {
  return __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
}

__global__ void threefry_kernel(const long long* __restrict__ keys, int B,
                                int n, int mode, void* __restrict__ out,
                                float lo, float span, const int* __restrict__
                                hi_tab, int hi, int lo_int,
                                const float* __restrict__ p, int D) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * n) return;
  const int b = (int)(t / n);
  const long long i = t - (long long)b * n;
  const uint32_t k0 = (uint32_t)keys[2 * b];
  const uint32_t k1 = (uint32_t)keys[2 * b + 1];
  switch (mode) {
    case kSplit: {
      uint32_t x0 = 0u, x1 = (uint32_t)i;
      threefry(k0, k1, x0, x1);
      long long* o = static_cast<long long*>(out) + 2 * t;
      o[0] = (long long)x0;
      o[1] = (long long)x1;
      break;
    }
    case kBits:
      static_cast<long long*>(out)[t] = (long long)bits32(k0, k1, i);
      break;
    case kUniform: {
      const float f = __fadd_rn(__fmul_rn(to_unit(bits32(k0, k1, i)), span),
                                lo);
      static_cast<float*>(out)[t] = fmaxf(lo, f);
      break;
    }
    case kRandint: {
      uint32_t a0 = 0u, a1 = 0u, c0 = 0u, c1 = 1u;
      threefry(k0, k1, a0, a1);
      threefry(k0, k1, c0, c1);
      const uint32_t hb = bits32(a0, a1, i), lb = bits32(c0, c1, i);
      const int top = hi_tab ? hi_tab[b] : hi;
      const uint32_t sp =
          top <= lo_int ? 1u : (uint32_t)top - (uint32_t)lo_int;
      uint32_t mult = 65536u % sp;
      mult = (mult * mult) % sp;
      const uint32_t off = ((hb % sp) * mult + lb % sp) % sp;
      static_cast<int*>(out)[t] = (int)((uint32_t)lo_int + off);
      break;
    }
    case kChoice: {
      const float u = to_unit(bits32(k0, k1, 0));
      const float* row = p + (long long)b * D;
      float total = 0.0f;
      for (int d = 0; d < D; ++d) total = __fadd_rn(total, row[d]);
      const float r = __fmul_rn(total, __fsub_rn(1.0f, u));
      float cum = 0.0f;
      int idx = 0;
      for (int d = 0; d < D; ++d) {
        cum = __fadd_rn(cum, row[d]);
        idx += cum < r ? 1 : 0;
      }
      static_cast<long long*>(out)[t] = (long long)idx;
      break;
    }
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// keys (B, 2) int64 key words; each key draws n elements into out:
// split (B, n, 2) int64, bits (B, n) int64, uniform (B, n) float32 in
// [lo, lo + span), randint (B, n) int32 in [lo_int, hi_tab[b] or hi),
// choice (B,) int64 from p (B, D) float32 (n must be 1).
int threefry_launch(const void* keys, int B, int n, int mode, void* out,
                    float lo, float span, const void* hi_tab, int hi,
                    int lo_int, const void* p, int D, void* stream) {
  if (mode < kSplit || mode > kChoice || n < 1 || B < 1 ||
      (mode == kChoice && (n != 1 || D < 1)))
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * n;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  threefry_kernel<<<(unsigned)blocks, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), B, n, mode, out, lo, span,
      static_cast<const int*>(hi_tab), hi, lo_int,
      static_cast<const float*>(p), D);
  return (int)cudaGetLastError();
}

}  // extern "C"
