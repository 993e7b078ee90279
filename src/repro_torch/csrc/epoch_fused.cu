// Hand-written Hopper (sm_90a) kernels for the AIMM epoch core.
//
// fused_epoch replaces the Pallas kernel `fused_epoch_call`
// (src/repro/kernels/epoch_fused/kernel.py:42, whose body runs
// ref.shared_stage + ref.route_stage_onehot); tom_scores replaces
// `tom_scores_call` (kernel.py:158, body ref.tom_stage_loop).  The plain
// torch versions are repro_torch/kernels/epoch_fused/ref.py.
//
// What bounds them on this card: very little work per lane.  One epoch of
// one lane reads a 128-op window, a page table of P <= 4096 entries and the
// 25 KB route table, and does a few thousand integer and float operations:
// the bytes bound at 3.35 TB/s is tens of nanoseconds, far below one launch.
// So the design spends nothing on bandwidth tricks: one thread block per
// lane (B lanes fill B SMs in one launch, as the batched engine will need),
// every scatter of the cost model is an atomic on shared memory (or on the
// lane's own global row for the P-sized tables), and the route table sits in
// shared memory.  Speed at B = 1 is the launch overhead.
//
// Exactness (the reference's contract, kernels/epoch_fused/ref.py): every
// value summed by an atomic is an exact small integer in f32 (0/1 validity,
// winner flags, route incidence times packet_flits), or a +1.0 onto an EMA,
// so any order of the atomics gives the same bits.  The EMA is decayed
// first (x * 0.9f) and then receives one +1.0 per valid access, never a
// pre-summed count (x+1+1 != x+2 in f32).  Built with -fmad=false so no
// a*b+c is contracted into an FMA.  The PEI threshold is the r-th largest
// access EMA (the reference's top_k order statistic), found by a 4-pass
// radix select on the float bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLdbId = 1;   // repro.nmp.baselines.TECHNIQUES.index("ldb")
constexpr int kPeiId = 2;   // TECHNIQUES.index("pei")

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
  int run_shared, run_route, pei, aimm;
  float packet_flits;
};

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
// most-significant-digit radix select: 4 passes of 8 bits, each a shared
// histogram of the candidates that still match the chosen prefix.
__device__ float select_rth_largest(const float* vals, int n, int r,
                                    unsigned* hist, unsigned* state) {
  uint32_t prefix = 0, mask = 0;
  if (threadIdx.x == 0) state[1] = (unsigned)r;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      uint32_t k = float_key(vals[i]);
      if ((k & mask) == prefix) atomicAdd(&hist[(k >> shift) & 0xFFu], 1u);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned rem = state[1];
      int d = 255;
      for (; d > 0; --d) {
        if (rem <= hist[d]) break;
        rem -= hist[d];
      }
      state[0] = prefix | ((uint32_t)d << shift);
      state[1] = rem;
    }
    __syncthreads();
    prefix = state[0];
    mask |= 0xFFu << shift;
  }
  return key_float(prefix);
}

__device__ __forceinline__ const int* pick(int which, const int* a,
                                           const int* b, const int* c) {
  return which == 0 ? a : (which == 1 ? b : c);
}

__global__ void __launch_bounds__(kThreads)
fused_epoch_kernel(FusedArgs a) {
  extern __shared__ float smem[];
  __shared__ unsigned s_hist[256];
  __shared__ unsigned s_sel[2];

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int W = a.W, P = a.P, C = a.C, L = a.L, M = a.M, W3 = 3 * W;
  const int* dest = a.dest + (size_t)b * W;
  const int* src1 = a.src1 + (size_t)b * W;
  const int* src2 = a.src2 + (size_t)b * W;
  const float* valid = a.valid + (size_t)b * W;

  // dynamic shared layout: route table | hops | loads | ops | acc | distinct
  // | mcq (floats), then winner / hot flags (bytes)
  const int n_routes = a.run_route ? C * C * L : 0;
  const int n_hops = a.run_route ? C * C : 0;
  float* s_routes = smem;
  float* s_hops = s_routes + n_routes;
  float* s_loads = s_hops + n_hops;
  float* s_ops = s_loads + L;
  float* s_acc = s_ops + C;
  float* s_dist = s_acc + C;
  float* s_mcq = s_dist + C;
  unsigned char* s_win = reinterpret_cast<unsigned char*>(s_mcq + M);
  unsigned char* s_hot1 = s_win + W3;
  unsigned char* s_hot2 = s_hot1 + W;

  // ---------------- shared stage (ref.shared_stage) ----------------
  if (a.run_shared) {
    const int* st_in = a.rb_stamp_in + (size_t)b * (P + 1);
    int* st = a.rb_stamp + (size_t)b * (P + 1);
    for (int i = tid; i <= P; i += nt) st[i] = st_in[i];
    const float* ema_in = a.pei ? a.page_ema_in + (size_t)b * P : nullptr;
    float* ema = a.pei ? a.page_ema + (size_t)b * P : nullptr;
    float* touch = a.aimm ? a.touch_cnt + (size_t)b * P : nullptr;
    float thresh = 0.f;
    if (a.pei) {
      // threshold = top_k(ema, pei_k)[clip(m - 1, 0, pei_k - 1)], read from
      // the PRE-update EMA
      const int m = a.n_pages[b] - a.pei_idx[b];
      const int r = min(max(m - 1, 0), a.pei_k - 1) + 1;
      thresh = select_rth_largest(ema_in, P, r, s_hist, s_sel);
      for (int i = tid; i < P; i += nt) ema[i] = __fmul_rn(0.9f, ema_in[i]);
    }
    if (a.aimm)
      for (int i = tid; i < P; i += nt) touch[i] = 0.f;
    __syncthreads();

    // stamp race, EMA +valid and touch counts over the 3W accesses
    const int tag_base = ((int)a.epochs[b] + 1) * W3;
    for (int j = tid; j < W3; j += nt) {
      const int w = j % W;
      const int page = pick(j / W, dest, src1, src2)[w];
      const float v = valid[w];
      const bool ok = v > 0.f;
      atomicMax(&st[ok ? page : P], ok ? tag_base + j : 0);
      if (a.pei) atomicAdd(&ema[page], v);
      if (a.aimm) atomicAdd(&touch[page], v);
    }
    if (a.pei) {
      const float t = fmaxf(thresh, 1e-6f);
      for (int w = tid; w < W; w += nt) {
        const unsigned char h1 = ema_in[src1[w]] >= t;
        const unsigned char h2 = ema_in[src2[w]] >= t;
        s_hot1[w] = h1;
        s_hot2[w] = h2;
        a.pei_hot1[(size_t)b * W + w] = h1;
        a.pei_hot2[(size_t)b * W + w] = h2;
      }
    }
    __syncthreads();
    // winner read-back: an access is its page's first touch of the epoch
    // iff its stamp won the race
    for (int j = tid; j < W3; j += nt) {
      const int w = j % W;
      const int page = pick(j / W, dest, src1, src2)[w];
      const bool ok = valid[w] > 0.f;
      const unsigned char win = ok && st[page] == tag_base + j;
      s_win[j] = win;
      a.rb_winner[(size_t)b * W3 + j] = win;
    }
  }

  // -------- schedule / route / count stage (ref.route_stage) --------
  if (!a.run_route) return;
  for (int i = tid; i < n_routes; i += nt) s_routes[i] = a.routes_flat[i];
  for (int i = tid; i < n_hops; i += nt) s_hops[i] = a.hops_flat[i];
  for (int i = tid; i < L; i += nt) s_loads[i] = 0.f;
  for (int i = tid; i < C; i += nt) s_ops[i] = s_acc[i] = s_dist[i] = 0.f;
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
  __syncthreads();

  const int* eff = a.eff_table + (size_t)b * P;
  const int* remap = a.aimm ? a.compute_remap + (size_t)b * P : nullptr;
  const int tech = a.technique[b];
  const bool lane_aimm = a.aimm && a.is_aimm[b];
  for (int w = tid; w < W; w += nt) {
    const int dp = dest[w], p1 = src1[w], p2 = src2[w];
    const int dc = eff[dp], c1 = eff[p1], c2 = eff[p2];
    int cc;
    if (a.pei) {   // baselines.schedule_by_id
      const bool h1 = s_hot1[w], h2 = s_hot2[w];
      int pc = h1 ? c2 : c1;
      if (h1 && h2) pc = c1;
      if (!(h1 || h2)) pc = dc;
      cc = tech == kPeiId ? pc : (tech == kLdbId ? c1 : dc);
    } else {
      cc = tech == kLdbId ? c1 : dc;
    }
    if (a.aimm) {  // compute-remap table: -1 none, 0..C-1 cube, C = source
      int cr = remap[dp];
      if (cr < 0) cr = remap[p1];
      if (cr < 0) cr = remap[p2];
      const int acc = cr == C ? c1 : (cr >= 0 ? cr : cc);
      if (lane_aimm) cc = acc;
    }
    a.ccube[(size_t)b * W + w] = cc;

    const float v = valid[w];
    const float fw = v * a.packet_flits;
    const int pair[3] = {c1 * C + cc, c2 * C + cc, cc * C + dc};
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      const float* row = s_routes + pair[f] * L;
      for (int l = 0; l < L; ++l) {
        const float rv = row[l];
        if (rv != 0.f) atomicAdd(&s_loads[l], fw * rv);
      }
    }
    a.hops_op[(size_t)b * W + w] =
        (s_hops[pair[0]] + s_hops[pair[1]]) + s_hops[pair[2]];
    atomicAdd(&s_ops[cc], v);
    atomicAdd(&s_acc[dc], v);
    atomicAdd(&s_acc[c1], v);
    atomicAdd(&s_acc[c2], v);
    atomicAdd(&s_dist[dc], s_win[w] ? 1.f : 0.f);
    atomicAdd(&s_dist[c1], s_win[W + w] ? 1.f : 0.f);
    atomicAdd(&s_dist[c2], s_win[2 * W + w] ? 1.f : 0.f);
    atomicAdd(&s_mcq[a.nearest_mc[dc]], v);
  }
  __syncthreads();
  for (int l = tid; l < L; l += nt)
    a.loads[(size_t)b * L + l] = s_loads[l] + a.pending[(size_t)b * L + l];
  for (int c = tid; c < C; c += nt) {
    a.ops_c[(size_t)b * C + c] = s_ops[c];
    a.acc_c[(size_t)b * C + c] = s_acc[c];
    a.distinct_c[(size_t)b * C + c] = s_dist[c];
  }
  for (int m = tid; m < M; m += nt) a.mcq[(size_t)b * M + m] = s_mcq[m];
}

// One block per lane, one warp per TOM candidate mapping.  Every sum is of
// halves or 0/1 values, so the warp reductions are exact in any order; the
// score then follows the reference's float32 expression step by step
// (division by the constant (1 - 1/C) as a multiply by its float32
// reciprocal, as XLA compiles it).
__global__ void tom_scores_kernel(const int* dest, const int* src1,
                                  const int* src2, const float* valid,
                                  const int* cands, float* out, int W, int P,
                                  int K, int C, float inv_c, float recip) {
  extern __shared__ float s_cnt[];  // (K, C) per-cube op counts
  const int b = blockIdx.x;
  const int k = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < K * C; i += blockDim.x) s_cnt[i] = 0.f;
  __syncthreads();
  if (k >= K) return;
  const int* cand = cands + (size_t)k * P;
  float co_sum = 0.f, vsum = 0.f;
  for (int w = lane; w < W; w += 32) {
    const size_t o = (size_t)b * W + w;
    const int d = cand[dest[o]], x = cand[src1[o]], y = cand[src2[o]];
    const float v = valid[o];
    const float co = ((x == d ? 1.f : 0.f) + (y == d ? 1.f : 0.f)) * 0.5f;
    co_sum += co * v;
    vsum += v;
    atomicAdd(&s_cnt[k * C + d], v);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    co_sum += __shfl_xor_sync(0xffffffffu, co_sum, off);
    vsum += __shfl_xor_sync(0xffffffffu, vsum, off);
  }
  __syncwarp();
  if (lane == 0) {
    float mx = s_cnt[k * C];
    for (int c = 1; c < C; ++c) mx = fmaxf(mx, s_cnt[k * C + c]);
    const float total = fmaxf(vsum, 1.f);
    const float co_frac = co_sum / total;
    float imb = (mx / total - inv_c) * recip;
    imb = fminf(fmaxf(imb, 0.f), 1.f);
    out[(size_t)b * K + k] = co_frac - 0.5f * imb;
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int fused_epoch_launch(
    const void* dest, const void* src1, const void* src2, const void* valid,
    const void* epochs, const void* rb_stamp_in, void* rb_stamp,
    void* rb_winner, const void* page_ema_in, void* page_ema,
    const void* n_pages, const void* pei_idx, void* pei_hot1, void* pei_hot2,
    void* touch_cnt, const void* eff_table, const void* compute_remap,
    const void* technique, const void* is_aimm, const void* pending,
    const void* routes_flat, const void* hops_flat, const void* nearest_mc,
    void* ccube, void* loads, void* hops_op, void* ops_c, void* acc_c,
    void* distinct_c, void* mcq, int B, int W, int P, int C, int L, int M,
    int pei_k, int run_shared, int run_route, int pei, int aimm,
    float packet_flits, void* stream) {
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

  const size_t floats = (run_route ? (size_t)C * C * L + (size_t)C * C : 0) +
                        L + 3 * C + M;
  const size_t smem = floats * sizeof(float) + 5 * (size_t)W;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_epoch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_epoch_kernel<<<B, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

int tom_scores_launch(const void* dest, const void* src1, const void* src2,
                      const void* valid, const void* cands, void* out, int B,
                      int W, int P, int K, int C, float inv_c, float recip,
                      void* stream) {
  const size_t smem = (size_t)K * C * sizeof(float);
  tom_scores_kernel<<<B, 32 * K, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(dest), static_cast<const int*>(src1),
      static_cast<const int*>(src2), static_cast<const float*>(valid),
      static_cast<const int*>(cands), static_cast<float*>(out), W, P, K, C,
      inv_c, recip);
  return (int)cudaGetLastError();
}

}  // extern "C"
