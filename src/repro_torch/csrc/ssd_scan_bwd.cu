// Backward of the Mamba2 SSD chunked scan for sm_90a.
//
// Replaces no Pallas kernel: the reference trains through XLA's autodiff
// of src/repro/models/mamba.py:104-127 `chunk_step` under
// `jax.value_and_grad`, and has no backward kernel of its own.  The port's
// forward is ssd_scan.cu, a ctypes launch with no autograd, so on the card
// its gradient is this source.  Notation as in ssd_scan.cu, per batch b,
// head h, chunk c of Q rows i, j, a = A_h:
//   seg_i = cumsum(dt a),  E_ij = exp(clip(seg_i - seg_j)),  e_i =
//   exp(clip(seg_i)),  U_j = exp(clip(seg_end - seg_j)),  w_j = U_j dt_j,
//   g_c = exp(clip(seg_end)),  R_c the state entering chunk c (the forward's
//   `st` scratch after its launch), G_c = dL/dR_c.
// Given dy (B, L, H, P) it computes, in this launch's stream:
//   1. ssd_bwd_t_kernel: T_c = sum_i e_i C_i (x) dy_i, chunks 1 .. nc - 1;
//   2. ssd_bwd_recur_kernel, the reverse inter-chunk recurrence, in chunk
//      order from the last: G_nc = 0, G_c = g_c G_{c+1} + T_c, keeping
//      G_{c+1} for each chunk c (one launch, as the forward's recurrence);
//   3. ssd_bwd_chunk_kernel, one block per (chunk, head, batch): with
//      M_ij = dy_i . x_j and CB_ij = C_i . B_j (the forward's scratch):
//        dx_j   = sum_{i >= j} CB_ij E_ij dt_j dy_i + w_j (B_j G_{c+1})
//        dCB_ij = M_ij E_ij dt_j          (per head, into scratch)
//        ddt_j  = sum_{i >= j} M_ij CB_ij E_ij + dw_j U_j + d(dA)_j a
//      where dw_j = x_j . (B_j G_{c+1}) and de_i = dy_i . (C_i R_c); d(seg)
//      gathers the intra term's dz_ij = M_ij CB_ij E_ij dt_j (i > j: + to
//      row i, - to column j), e_i de_i, -dt_j U_j dw_j (+ their sum to the
//      chunk's last row, which is seg_end) and g_c sum(G_{c+1} R_c) on the
//      last row; d(dA) is the reverse cumsum of d(seg) within the chunk,
//      and d(dA) dt summed over the chunk is this chunk's part of da;
//   4. ssd_bwd_bc_kernel, one block per (32 rows, chunk, batch):
//        dC_i = sum_{j <= i} dCB_ij B_j + sum_h e_i R_c dy_i
//        dB_j = sum_{i >= j} dCB_ij C_i + sum_h w_j G_{c+1} x_j
//      with dCB summed over heads (one B / C pair serves every head, the
//      reference's group 0);
//   5. ssd_bwd_da_kernel: da = the chunks' parts summed over batch and
//      chunks.
// A clipped exponent passes no gradient (torch.clamp's and jnp.clip's rule
// inside the range; the diagonal's exact 0 and the last row's U = 1 are
// one variable on both sides of the difference, so their terms cancel and
// are left out here).  Every sum over heads, rows, chunks or batch runs in
// a fixed order: no atomics, two runs give the same bits.
//
// Bound on this card: at mamba2-370m's shape (B 1, L 4096, H 32, P 64, N
// 128, Q 256) the products are ~25 GFLOP (chip_smoke.py counts them from
// the shapes) against ~0.2 GB of inputs, outputs and saved state, bound by
// operations.  All of it runs as f32 FMAs on the CUDA cores (67 TFLOP/s)
// from 32-row shared-memory tiles: simple and right first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 32;            // rows of a tile
constexpr int kThreads = 256;
constexpr int kMaxN = 128;        // d_state
constexpr int kMaxP = 64;         // head_dim
constexpr int kMaxQ = 256;        // chunk
constexpr int LDA = kMaxN + 1;    // padded row of a B / C tile
constexpr int LDY = kMaxP + 1;    // padded row of an x / dy tile, and of R, G
constexpr int LDT = kT + 1;       // padded row of a 32 x 32 tile

__device__ __forceinline__ float clip_exp(float z) {
  return expf(fminf(fmaxf(z, -60.f), 0.f));
}
// inside the clip range, where the exponent's gradient passes
__device__ __forceinline__ bool clip_in(float z) {
  return z >= -60.f && z <= 0.f;
}

struct Args {
  const float* x;     // (B, L, H, P)
  const float* b;     // (B, L, N)
  const float* c;     // (B, L, N)
  const float* dt;    // (B, L, H)
  const float* a;     // (H,)
  const float* dy;    // (B, L, H, P)
  const float* st;    // (B, nc, H, N, P) R_c (the forward's scratch)
  const float* sg;    // (B, L, H) seg (the forward's scratch)
  const float* se;    // (B, nc, H) seg_end (the forward's scratch)
  const float* cbt;   // (B, nc, Q, Q) C_i . B_j, i >= j (forward scratch)
  float* gst;         // (B, nc, H, N, P) scratch: T_{c+1}, then G_{c+1}
  float* dcb;         // (B, nc, H, Q, Q) scratch: dCB, lower 32-tiles
  float* dap;         // (B, nc, H) scratch: each chunk's part of da
  float* dx;          // (B, L, H, P)
  float* db;          // (B, L, N)
  float* dc;          // (B, L, N)
  float* ddt;         // (B, L, H)
  float* da;          // (H,)
  int B, L, H, P, N, Q;
};

// Rows r0 .. r0 + kT - 1 of head h of a (B, L, H, P) tensor (`src` at the
// chunk's first row) into a tile of rows LDY.
__device__ __forceinline__ void load_head_rows(float* dst,
                                               const float* __restrict__ src,
                                               int r0, int h, int H, int P) {
  for (int e = threadIdx.x; e < kT * P; e += kThreads) {
    const int i = e / P, p = e % P;
    dst[i * LDY + p] = src[((size_t)(r0 + i) * H + h) * P + p];
  }
}

// Rows r0 .. r0 + kT - 1 of a (B, L, N) tensor (`src` at the chunk's first
// row) into a tile of rows LDA.
__device__ __forceinline__ void load_state_rows(float* dst,
                                                const float* __restrict__ src,
                                                int r0, int N) {
  for (int e = threadIdx.x; e < kT * N; e += kThreads) {
    const int i = e / N, n = e % N;
    dst[i * LDA + n] = src[(size_t)(r0 + i) * N + n];
  }
}

// The sum of v over the 8 lanes xor-adjacent to this one (a row's lanes),
// in a fixed butterfly.
__device__ __forceinline__ float sum8(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v;
}

// ---- 1. T_c = sum_i e_i C_i (x) dy_i, chunks 1 .. nc - 1 -> gst[c - 1] ----
// Thread t owns state rows n = t / 16 + 16 k and columns p = t % 16 + 16 m.
__global__ void __launch_bounds__(kThreads) ssd_bwd_t_kernel(Args g) {
  __shared__ float sC[kT * LDA];
  __shared__ float sY[kT * LDY];
  const int c = blockIdx.x + 1, h = blockIdx.y, b = blockIdx.z;
  const int N = g.N, P = g.P, Q = g.Q, H = g.H, nc = g.L / Q;
  const int t = threadIdx.x, n0 = t / 16, p0 = t % 16;
  const size_t l0 = (size_t)b * g.L + (size_t)c * Q;
  float acc[8][4];
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[k][m] = 0.f;
  for (int i0 = 0; i0 < Q; i0 += kT) {
    __syncthreads();
    for (int e = t; e < kT * N; e += kThreads) {
      const int i = e / N, n = e % N;
      const size_t l = l0 + i0 + i;
      sC[i * LDA + n] = g.c[l * N + n] * clip_exp(g.sg[l * H + h]);
    }
    load_head_rows(sY, g.dy + l0 * H * P, i0, h, H, P);
    __syncthreads();
    for (int i = 0; i < kT; ++i) {
      float cv[8], yv[4];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        cv[k] = n0 + 16 * k < N ? sC[i * LDA + n0 + 16 * k] : 0.f;
#pragma unroll
      for (int m = 0; m < 4; ++m)
        yv[m] = p0 + 16 * m < P ? sY[i * LDY + p0 + 16 * m] : 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[k][m] = fmaf(cv[k], yv[m], acc[k][m]);
    }
  }
  float* out = g.gst + (((size_t)b * nc + (c - 1)) * H + h) * N * P;
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int n = n0 + 16 * k, p = p0 + 16 * m;
      if (n < N && p < P) out[(size_t)n * P + p] = acc[k][m];
    }
}

// ---- 2. the reverse recurrence: gst[c] <- G_{c+1}, from the last chunk ----
// gst[c - 1] holds T_c when chunk c is reached; it is read before chunk
// c - 1's step overwrites that slot with G_c.
constexpr int kStatePer = 8;
constexpr int kRecurThreads = 256;

__global__ void __launch_bounds__(kRecurThreads) ssd_bwd_recur_kernel(Args g) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = g.L / g.Q, NP = g.N * g.P;
  const int e0 = blockIdx.x * kStatePer * kRecurThreads + threadIdx.x;
  float G[kStatePer];
#pragma unroll
  for (int k = 0; k < kStatePer; ++k) G[k] = 0.f;   // G_nc
  for (int c = nc - 1; c >= 0; --c) {
    const size_t slot = ((size_t)b * nc + c) * g.H + h;
    float* here = g.gst + slot * NP;
    const float* prev = here - (size_t)g.H * NP;     // slot c - 1: T_c
    const float dec = c >= 1 ? clip_exp(g.se[slot]) : 0.f;
    float tc[kStatePer];
#pragma unroll
    for (int k = 0; k < kStatePer; ++k) {
      const int e = e0 + k * kRecurThreads;
      tc[k] = c >= 1 && e < NP ? prev[e] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kStatePer; ++k) {
      const int e = e0 + k * kRecurThreads;
      if (e < NP) here[e] = G[k];
      G[k] = G[k] * dec + tc[k];
    }
  }
}

// ---- 3. per chunk and head: dx, dCB, ddt and the chunk's part of da -------
size_t chunk_smem_bytes(int Q) {
  return sizeof(float) * (7 * (size_t)Q + 2 * (size_t)kMaxN * LDY +
                          (size_t)kT * LDA + 2 * (size_t)kT * LDY +
                          3 * (size_t)kT * LDT + kThreads);
}

__global__ void __launch_bounds__(kThreads) ssd_bwd_chunk_kernel(Args g) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int N = g.N, P = g.P, Q = g.Q, H = g.H, nc = g.L / Q;
  const bool has_r = c > 0, has_g = c + 1 < nc;
  extern __shared__ float ssd_bwd_smem[];
  float* sSeg = ssd_bwd_smem;     // seg_i
  float* sDt = sSeg + Q;          // dt_i
  float* sDe = sDt + Q;           // de_i = dy_i . (C_i R_c)
  float* sDw = sDe + Q;           // dw_j = x_j . (B_j G_{c+1})
  float* sDdt = sDw + Q;          // sum_i M_ij CB_ij E_ij
  float* sRow = sDdt + Q;         // sum_j dz_ij
  float* sCol = sRow + Q;         // sum_i dz_ij
  float* sR = sCol + Q;           // R_c, N rows of LDY
  float* sG = sR + kMaxN * LDY;   // G_{c+1}
  float* sA = sG + kMaxN * LDY;   // 32 rows of C or B
  float* sY = sA + kT * LDA;      // 32 rows of dy
  float* sX = sY + kT * LDY;      // 32 rows of x
  float* sTt = sX + kT * LDY;     // the tile's M CB E
  float* sDz = sTt + kT * LDT;    // the tile's dz
  float* sAtt = sDz + kT * LDT;   // the tile's CB E dt_j
  float* sRed = sAtt + kT * LDT;  // kThreads partial sums, then du_j

  const int t = threadIdx.x;
  const size_t l0 = (size_t)b * g.L + (size_t)c * Q;
  const size_t slot = ((size_t)b * nc + c) * H + h;
  for (int i = t; i < Q; i += kThreads) {
    sSeg[i] = g.sg[(l0 + i) * H + h];
    sDt[i] = g.dt[(l0 + i) * H + h];
    sDe[i] = sDw[i] = sDdt[i] = sRow[i] = sCol[i] = 0.f;
  }
  const float* Rg = g.st + slot * N * P;
  const float* Gg = g.gst + slot * N * P;
  float part = 0.f;
  for (int e = t; e < N * P; e += kThreads) {
    const int n = e / P, p = e % P;
    const float r = has_r ? Rg[e] : 0.f, gg = has_g ? Gg[e] : 0.f;
    sR[n * LDY + p] = r;
    sG[n * LDY + p] = gg;
    part = fmaf(r, gg, part);
  }
  sRed[t] = part;
  __syncthreads();
  if (t == 0) {   // dg = sum(G_{c+1} R_c), the partials in thread order
    float s = 0.f;
    for (int i = 0; i < kThreads; ++i) s += sRed[i];
    sRed[0] = s;
  }
  __syncthreads();
  const float dg = sRed[0];
  const float seg_end = sSeg[Q - 1];
  const float* xc = g.x + l0 * H * P;
  const float* dyc = g.dy + l0 * H * P;
  // a 32-row tile times a state matrix: thread t owns row t / 8, columns
  // t % 8 + 8 m
  const int row = t / 8, pc = t % 8;

  // de_i = dy_i . (C_i R_c)
  if (has_r) {
    for (int i0 = 0; i0 < Q; i0 += kT) {
      __syncthreads();
      load_state_rows(sA, g.c + l0 * N, i0, N);
      load_head_rows(sY, dyc, i0, h, H, P);
      __syncthreads();
      float cr[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) cr[m] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float cv = sA[row * LDA + n];
#pragma unroll
        for (int m = 0; m < 8; ++m)
          if (pc + 8 * m < P) cr[m] = fmaf(cv, sR[n * LDY + pc + 8 * m], cr[m]);
      }
      float de = 0.f;
#pragma unroll
      for (int m = 0; m < 8; ++m)
        if (pc + 8 * m < P) de = fmaf(cr[m], sY[row * LDY + pc + 8 * m], de);
      de = sum8(de);
      if (pc == 0) sDe[i0 + row] = de;
    }
  }

  float* dcb_h = g.dcb + slot * (size_t)Q * Q;
  const float* cb = g.cbt + ((size_t)b * nc + c) * Q * Q;
  const int ti = 2 * (t / 16), tj = t % 16;   // 32 x 32 tile entries
  for (int j0 = 0; j0 < Q; j0 += kT) {
    __syncthreads();
    load_state_rows(sA, g.b + l0 * N, j0, N);
    load_head_rows(sX, xc, j0, h, H, P);
    __syncthreads();
    // the state term: dx_j = w_j (B_j G), dw_j = x_j . (B_j G)
    float dx[8];
    {
      float bg[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) bg[m] = 0.f;
      if (has_g) {
        for (int n = 0; n < N; ++n) {
          const float bv = sA[row * LDA + n];
#pragma unroll
          for (int m = 0; m < 8; ++m)
            if (pc + 8 * m < P)
              bg[m] = fmaf(bv, sG[n * LDY + pc + 8 * m], bg[m]);
        }
      }
      const int j = j0 + row;
      const float w = clip_exp(seg_end - sSeg[j]) * sDt[j];
      float dw = 0.f;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        dx[m] = w * bg[m];
        if (pc + 8 * m < P) dw = fmaf(sX[row * LDY + pc + 8 * m], bg[m], dw);
      }
      dw = sum8(dw);
      if (pc == 0) sDw[j] = dw;
    }
    // the intra term over the row tiles at and below this column tile
    for (int i0 = j0; i0 < Q; i0 += kT) {
      __syncthreads();
      load_head_rows(sY, dyc, i0, h, H, P);
      __syncthreads();
      float m00 = 0.f, m01 = 0.f, m10 = 0.f, m11 = 0.f;
      for (int p = 0; p < P; ++p) {
        const float ya = sY[ti * LDY + p], yb = sY[(ti + 1) * LDY + p];
        const float xa = sX[tj * LDY + p], xb = sX[(tj + 16) * LDY + p];
        m00 = fmaf(ya, xa, m00);
        m01 = fmaf(ya, xb, m01);
        m10 = fmaf(yb, xa, m10);
        m11 = fmaf(yb, xb, m11);
      }
      const float mm[2][2] = {{m00, m01}, {m10, m11}};
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          const int r = ti + a, q = tj + 16 * bb;
          const int gi = i0 + r, gj = j0 + q;
          float tv = 0.f, dz = 0.f, att = 0.f, dcbv = 0.f;
          if (gi >= gj) {
            const float cbv = cb[(size_t)gi * Q + gj];
            const float z = sSeg[gi] - sSeg[gj];
            const float E = clip_exp(z), dtj = sDt[gj];
            tv = mm[a][bb] * cbv * E;
            dcbv = mm[a][bb] * E * dtj;
            att = cbv * E * dtj;
            if (gi > gj && clip_in(z)) dz = tv * dtj;
          }
          sTt[r * LDT + q] = tv;
          sDz[r * LDT + q] = dz;
          sAtt[r * LDT + q] = att;
          dcb_h[(size_t)gi * Q + gj] = dcbv;
        }
      }
      __syncthreads();
      // fixed-order sums of the tile: columns by threads 0-31, rows by 32-63
      if (t < kT) {
        float st = 0.f, sz = 0.f;
        for (int i = 0; i < kT; ++i) {
          st += sTt[i * LDT + t];
          sz += sDz[i * LDT + t];
        }
        sDdt[j0 + t] += st;
        sCol[j0 + t] += sz;
      } else if (t < 2 * kT) {
        const int r = t - kT;
        float sz = 0.f;
        for (int q = 0; q < kT; ++q) sz += sDz[r * LDT + q];
        sRow[i0 + r] += sz;
      }
      // dx_j += sum_i CB_ij E_ij dt_j dy_i
      for (int i = 0; i < kT; ++i) {
        const float av = sAtt[i * LDT + row];
#pragma unroll
        for (int m = 0; m < 8; ++m)
          if (pc + 8 * m < P) dx[m] = fmaf(av, sY[i * LDY + pc + 8 * m], dx[m]);
      }
    }
    float* dxr = g.dx + ((l0 + j0 + row) * H + h) * P;
#pragma unroll
    for (int m = 0; m < 8; ++m)
      if (pc + 8 * m < P) dxr[pc + 8 * m] = dx[m];
  }
  __syncthreads();

  // d(seg), its reverse cumsum d(dA), then ddt and this chunk's part of da,
  // by one thread in row order
  if (t == 0) {
    const float A = g.a[h];
    float su = 0.f;   // sum_{j < Q-1} du_j: seg_end's share of the w terms
    for (int j = 0; j < Q - 1; ++j) {
      const float u = seg_end - sSeg[j];
      const float du = clip_in(u) ? sDw[j] * sDt[j] * clip_exp(u) : 0.f;
      sRed[j] = du;
      su += du;
    }
    float run = 0.f, dap = 0.f;
    for (int i = Q - 1; i >= 0; --i) {
      float ds = sRow[i] - sCol[i];
      if (has_r && clip_in(sSeg[i])) ds += sDe[i] * clip_exp(sSeg[i]);
      if (i < Q - 1) {
        ds -= sRed[i];
      } else {
        ds += su;
        if (has_g && clip_in(seg_end)) ds += dg * clip_exp(seg_end);
      }
      run += ds;   // d(dA)_i = sum_{k >= i} d(seg)_k
      const float ddt = sDdt[i] + sDw[i] * clip_exp(seg_end - sSeg[i]) +
                        run * A;
      g.ddt[(l0 + i) * H + h] = ddt;
      dap = fmaf(run, sDt[i], dap);
    }
    g.dap[slot] = dap;
  }
}

// ---- 4. dB and dC of 32 rows of a chunk, summed over heads ---------------
size_t bc_smem_bytes() {
  return sizeof(float) * (2 * (size_t)kMaxN * LDY + 2 * (size_t)kT * LDY +
                          (size_t)kT * LDA + (size_t)kT * LDT + 2 * kT);
}

__global__ void __launch_bounds__(kThreads) ssd_bwd_bc_kernel(Args g) {
  const int r0 = blockIdx.x * kT, c = blockIdx.y, b = blockIdx.z;
  const int N = g.N, P = g.P, Q = g.Q, H = g.H, nc = g.L / Q;
  const bool has_r = c > 0, has_g = c + 1 < nc;
  extern __shared__ float ssd_bwd_smem[];
  float* sR = ssd_bwd_smem;
  float* sG = sR + kMaxN * LDY;
  float* sY = sG + kMaxN * LDY;
  float* sX = sY + kT * LDY;
  float* sA = sX + kT * LDY;
  float* sM = sA + kT * LDA;
  float* sE = sM + kT * LDT;
  float* sW = sE + kT;
  const int t = threadIdx.x, row = t / 8, n0 = t % 8;   // n = n0 + 8 k
  const size_t l0 = (size_t)b * g.L + (size_t)c * Q;
  const int NP = N * P;
  float accC[16], accB[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) accC[k] = accB[k] = 0.f;

  // the inter and state terms, head by head in order
  if (has_r || has_g) {
    for (int h = 0; h < H; ++h) {
      const size_t slot = ((size_t)b * nc + c) * H + h;
      __syncthreads();
      for (int e = t; e < NP; e += kThreads) {
        const int n = e / P, p = e % P;
        sR[n * LDY + p] = has_r ? g.st[slot * NP + e] : 0.f;
        sG[n * LDY + p] = has_g ? g.gst[slot * NP + e] : 0.f;
      }
      load_head_rows(sY, g.dy + l0 * H * P, r0, h, H, P);
      load_head_rows(sX, g.x + l0 * H * P, r0, h, H, P);
      if (t < kT) {
        const size_t l = l0 + r0 + t;
        const float seg = g.sg[l * H + h];
        sE[t] = clip_exp(seg);
        sW[t] = clip_exp(g.se[slot] - seg) * g.dt[l * H + h];
      }
      __syncthreads();
      float yr[16], xg[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) yr[k] = xg[k] = 0.f;
      for (int p = 0; p < P; ++p) {
        const float yv = sY[row * LDY + p], xv = sX[row * LDY + p];
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          if (n0 + 8 * k < N) {
            yr[k] = fmaf(yv, sR[(n0 + 8 * k) * LDY + p], yr[k]);
            xg[k] = fmaf(xv, sG[(n0 + 8 * k) * LDY + p], xg[k]);
          }
        }
      }
      const float e = sE[row], w = sW[row];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        accC[k] = fmaf(e, yr[k], accC[k]);
        accB[k] = fmaf(w, xg[k], accB[k]);
      }
    }
  }

  const size_t dcb_c = ((size_t)b * nc + c) * H;   // slot of head 0
  // dC rows r0 ..: sum_{j <= i} dCB_ij B_j, dCB summed over heads in order
  for (int j0 = 0; j0 <= r0; j0 += kT) {
    __syncthreads();
    for (int e = t; e < kT * kT; e += kThreads) {
      const int i = e / kT, j = e % kT;
      float s = 0.f;
      for (int h = 0; h < H; ++h)
        s += g.dcb[((dcb_c + h) * Q + r0 + i) * Q + j0 + j];
      sM[i * LDT + j] = s;
    }
    load_state_rows(sA, g.b + l0 * N, j0, N);
    __syncthreads();
    for (int j = 0; j < kT; ++j) {
      const float mv = sM[row * LDT + j];
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (n0 + 8 * k < N) accC[k] = fmaf(mv, sA[j * LDA + n0 + 8 * k], accC[k]);
    }
  }
  // dB rows r0 ..: sum_{i >= j} dCB_ij C_i
  for (int i0 = r0; i0 < Q; i0 += kT) {
    __syncthreads();
    for (int e = t; e < kT * kT; e += kThreads) {
      const int i = e / kT, j = e % kT;
      float s = 0.f;
      for (int h = 0; h < H; ++h)
        s += g.dcb[((dcb_c + h) * Q + i0 + i) * Q + r0 + j];
      sM[i * LDT + j] = s;
    }
    load_state_rows(sA, g.c + l0 * N, i0, N);
    __syncthreads();
    for (int i = 0; i < kT; ++i) {
      const float mv = sM[i * LDT + row];
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (n0 + 8 * k < N) accB[k] = fmaf(mv, sA[i * LDA + n0 + 8 * k], accB[k]);
    }
  }
  float* dcr = g.dc + (l0 + r0 + row) * N;
  float* dbr = g.db + (l0 + r0 + row) * N;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (n0 + 8 * k < N) {
      dcr[n0 + 8 * k] = accC[k];
      dbr[n0 + 8 * k] = accB[k];
    }
  }
}

// ---- 5. da = the chunks' parts, over batch and chunks in order ------------
__global__ void __launch_bounds__(64) ssd_bwd_da_kernel(Args g) {
  const int h = blockIdx.x * 64 + threadIdx.x;
  if (h >= g.H) return;
  const int nc = g.L / g.Q;
  float s = 0.f;
  for (int b = 0; b < g.B; ++b)
    for (int c = 0; c < nc; ++c) s += g.dap[((size_t)b * nc + c) * g.H + h];
  g.da[h] = s;
}

cudaError_t allow_smem() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)chunk_smem_bytes(kMaxQ));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_bwd_bc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bc_smem_bytes());
  if (e == cudaSuccess) done = true;
  return e;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Inputs x, b, c, dt, a and the forward's scratch st (R_c), sg (seg), se
// (seg_end), cbt (C.B^T) as ssd_scan_launch left them; dy (B, L, H, P).
// Scratch gst (B, L / Q, H, N, P), dcb (B, L / Q, H, Q, Q), dap (B, L / Q,
// H); outputs dx (B, L, H, P), db, dc (B, L, N), ddt (B, L, H), da (H,).
// float32, contiguous.  Needs L % Q == 0, Q % 32 == 0, Q <= 256, P <= 64,
// N <= 128.  Returns a cudaError_t (cudaErrorInvalidValue outside those).
int ssd_scan_bwd_launch(const void* x, const void* b, const void* c,
                        const void* dt, const void* a, const void* dy,
                        const void* st, const void* sg, const void* se,
                        const void* cbt, void* gst, void* dcb, void* dap,
                        void* dx, void* db, void* dc, void* ddt, void* da,
                        int B, int L, int H, int P, int N, int Q,
                        void* stream_ptr) {
  if (Q <= 0 || Q % kT != 0 || Q > kMaxQ || L % Q != 0 || P < 1 ||
      P > kMaxP || N < 1 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || L == 0 || H == 0) return 0;
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Args g{static_cast<const float*>(x), static_cast<const float*>(b),
               static_cast<const float*>(c), static_cast<const float*>(dt),
               static_cast<const float*>(a), static_cast<const float*>(dy),
               static_cast<const float*>(st), static_cast<const float*>(sg),
               static_cast<const float*>(se), static_cast<const float*>(cbt),
               static_cast<float*>(gst), static_cast<float*>(dcb),
               static_cast<float*>(dap), static_cast<float*>(dx),
               static_cast<float*>(db), static_cast<float*>(dc),
               static_cast<float*>(ddt), static_cast<float*>(da), B, L, H, P,
               N, Q};
  const int nc = L / Q;
  if (nc > 1) {
    ssd_bwd_t_kernel<<<dim3(nc - 1, H, B), kThreads, 0, stream>>>(g);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    const int per_block = kStatePer * kRecurThreads;
    ssd_bwd_recur_kernel<<<dim3((N * P + per_block - 1) / per_block, H, B),
                           kRecurThreads, 0, stream>>>(g);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  ssd_bwd_chunk_kernel<<<dim3(nc, H, B), kThreads, chunk_smem_bytes(Q),
                         stream>>>(g);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_bc_kernel<<<dim3(Q / kT, nc, B), kThreads, bc_smem_bytes(),
                      stream>>>(g);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_da_kernel<<<(H + 63) / 64, 64, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // extern "C"
