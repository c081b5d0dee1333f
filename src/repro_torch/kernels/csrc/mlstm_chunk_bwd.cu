// Gradient of one stabilised chunkwise-mLSTM step per (batch*head), for
// Hopper.
//
// The gradient of the TPU kernel src/repro/kernels/mlstm_scan.py:78
// mlstm_chunk_step (whose forward mlstm_chunk.cu ports).  The reference has
// no backward kernel: it trains through XLA's autodiff of
// src/repro/models/xlstm.py:96 mlstm_chunk, the function the forward
// computes.  This kernel computes that gradient, per row bh of B*H:
//   in:  q, k, v (L, hd) fp32 or bf16; i_raw, f_raw (L,); c_in (hd, hd),
//        n_in (hd,), m_in (); the forward's h (L, hd); the upstream dh
//        (L, hd), dc_out (hd, hd), dn_out (hd,), all fp32 but q, k, v;
//   out: dq, dk, dv (L, hd), di, df (L,), dc_in (hd, hd), dn_in (hd,),
//        all fp32 (the wrapper casts dq, dk, dv to q's dtype).
//
// The stabilisers are held constant.  h and the carried state c e^m,
// n e^m do not depend on m_in, M_t or m_out: every stabilised quantity,
// den with its floor exp(-(b_t + M_t)) included, carries the same factor
// e^-(b_t + M_t), and c_out, n_out carry e^-m_out.  So the gradient that
// holds them constant is exact for a loss that reads the last carry
// through c e^m, n e^m (the model's chain of chunks, whose m_in is the
// constant first state or the previous chunk's m_out): dm_out is ignored
// and no dm_in is given (the wrapper marks m_out non-differentiable).
// XLA's autodiff of the reference walks the maximum and cummax branches
// instead; those terms cancel to rounding.  So no max path is
// differentiated here.
//
// The formulas (mlstm_chunk_bwd_plain in kernels/mlstm_scan.py is their
// plain PyTorch version).  The gate scalars are rebuilt as the forward
// builds them: log f, b_t, a_j = i_j - b_j, M_t, D_tj = exp(a_j - M_t)
// (j <= t), inter_t = exp(m_in - M_t), floor_t = exp(-(b_t + M_t)),
// w_j = exp(a_j - M_L), w_in = exp(m_in - M_L).  With S = q k^T, W = S o D,
// qn_t = sum_j W_tj + inter_t q_t.n_in and den_t = max(|qn_t|, floor_t):
//   r_t = dh_t / den_t,  dden_t = -r_t . h_t,
//   dqn_t = sign(qn_t) dden_t  (|qn_t| >= floor_t; else db_t gets
//           -floor_t dden_t),
//   dW_tj = r_t . v_j + dqn_t,  dS = dW o D,
//   dq_t = C_in (inter_t r_t) + inter_t dqn_t n_in + sum_j dS_tj k_j,
//   dk_j = w_j (dC_out v_j + dn_out) + sum_t dS_tj q_t,
//   dv_j = w_j dC_out^T k_j + sum_t W_tj r_t,
//   dC_in = w_in dC_out + sum_t q_t (inter_t r_t)^T,
//   dn_in = w_in dn_out + sum_t inter_t dqn_t q_t,
//   dw_j w_j = k_j . (dk_j's carry term), dw_in w_in = w_in (<C_in, dC_out>
//           + <n_in, dn_out>),
//   da_j = sum_t dW_tj W_tj + dw_j w_j,  di = da,
//   db_t = -da_t (+ the floor term) (+ dw_in w_in + sum_j dw_j w_j at
//           t = L-1),  df_r = (sum_{t >= r} db_t) sigmoid(-f_r).
// exp and log1p are the precise expf/log1pf, as in the forward: the first
// chunk carries m_in = -1e30 and padded steps i = -1e30, f = +30, whose
// exponentials must come out as exact 0.
//
// What bounds it on an H100.  At xlstm-1.3b's train shape (B*H 16, L 256,
// hd 1024): four L hd^2 products (C_in r, q r^T, dC_out v, dC_out^T k) and
// five causal L^2 hd ones (q k^T and dh v^T again, dS k, dS^T q, W^T r),
// 39.7 GFLOP, against 0.285 GB (C_in and dC_out read, dC_in written, q,
// k, v, h, dh read, dq, dk, dv written).  With bf16 q, k, v the work is
// held to the bf16 tensor-core rate, 0.040 ms, so the bytes bound it:
// 0.085 ms at 3.35 TB/s.  fp32 inputs are held to fp32's 67 TFLOP/s,
// 0.59 ms: operations-bound.
//
// C is 4 MB of fp32 a row at hd 1024 and a block has at most 227 KB of
// shared memory, so the hd^2 products cut C into tiles; no sum crosses
// blocks by atomics.  Two routes, chosen by dtype and hd alone:
//
// The bf16 route (q, k, v bf16, hd a multiple of 64: the bf16 training
// step's), five passes, every product on the tensor cores (mma.sync
// m16n8k16, fp32 accumulators, fragments by ldmatrix from rows padded to
// an odd multiple of 16 bytes, so the 8 rows of a phase hit 8 bank
// groups).  q, k, v are exact in bf16.  Each fp32 operand is split once
// into bf16 hi + lo (x - hi is exact in fp32, so ~16 mantissa bits reach
// the fp32 sum): the rows pass writes dS, W, r = dh / den and ri =
// inter r as hi/lo planes; the state and dv passes split their chunks of
// C_in and dC_out on the way into shared memory.  A product of two fp32
// operands (C_in ri, W^T r) takes hi hi + hi lo + lo hi; the lo lo term
// is below 2^-16 of the product and is dropped.  Rows are padded to Lp,
// L rounded up to 16, with zeros (a "first" state, m_in = -1e30, and
// padded steps give exact zeros as on the fp32 route).
//   1. mlstm_bwd_rows_tc_kernel, grid (ceil(L/32), B*H): the gate scalars
//      (block scans), S = q k^T and G = dh v^T for 32 rows over 32-column
//      slices of hd through a 3-stage cp.async ring (dh split on the way
//      in), then W, den, dqn, dS = dW o D and the column sums of dW o W in
//      fp32; writes dS, W (hi/lo, Lp x Lp, zero above the diagonal and
//      past L), r and ri (hi/lo, Lp x hd), the rows' scalars, w_j, w_in.
//   2. mlstm_bwd_state_tc_kernel, grid (hd/64, B*H): the block owns
//      columns e0 .. e0+63 of dq, dk (rows of C_in, dC_out) and streams
//      16-column chunks of C_in, dC_out, ri and v through a 3-stage ring:
//      dq += ri C_in^T (three terms), dk += v dC_out^T (two), <C_in,
//      dC_out>.  Then the carry terms (n_in, w_j, dn_out,
//      dw_j w_j), and dq += dS k, dk += dS^T q from 16-column and 16-row
//      chunks of dS (two terms each; chunks above a warp's diagonal
//      skipped), dn_in summed from the same chunks' rows of q.  Eight
//      warps, each 32 rows t of both accumulators (128 fp32 registers).
//   3. mlstm_bwd_dv_tc_kernel, grid (hd/64, B*H): columns f0 .. f0+63 of
//      dv: k dC_out over 32-row chunks of dC_out (two terms), times w_j,
//      then W^T r over 16-row chunks of W (three terms).
//   4. mlstm_bwd_dcin_tc_kernel, grid ((hd/64)^2, B*H), 4 warps: a 64 x 64
//      tile of dC_in = w_in dC_out + q^T ri over 32-row chunks of q and ri
//      (two terms).
//   5. mlstm_bwd_gates_kernel, as below.
// mma.sync and not wgmma: the fragments, the split and the ring are the
// forward's (mlstm_chunk.cu, mma_sm90.cuh), and the passes are bound by
// shared-memory traffic and latency (the splits, every warp's B
// fragments, one or two blocks an SM), not by the tensor cores' issue
// rate.  Registers (ptxas -v) and shared memory a block at xlstm-1.3b's
// Lp 256: rows 155, 152.7 KB, one block an SM; state 255, 152.6 KB, one
// block; dv 128 (8 bytes spilled), 96.3 KB, two blocks; dcin 96, 41.5 KB;
// gates 32.
//
// The fp32 route (fp32 q, k, v, and hd 8, 16), four passes, every product
// as fp32 FMAs on the CUDA cores (exact-class, the fp32 gradient checks'
// path), tiles of 32 columns (hd 8 and 16: tiles of hd):
//   1. mlstm_bwd_rows_kernel, grid (ceil(L/32), B*H): every block rebuilds
//      the gate scalars (block scans), computes 32 rows of S = q k^T and
//      G = dh v^T over hd chunks, then W, den, r's scale, dqn and the floor
//      term, and writes dS and W (L x L), the rows' scalars, and its 32
//      rows' column sums of dW o W (a partial of da_j, summed in pass 4).
//      Block 0 writes w_j and w_in.
//   2. mlstm_bwd_state_kernel, grid (hd/32, B*H): the block owns rows
//      e0 .. e0+31 of C_in and dC_out and streams them in 32-column
//      chunks beside the same columns of r and v: dq[:, e] += C_in r,
//      dk[:, e] gets dC_out v, dC_in's rows are written, <C_in, dC_out>
//      summed; then the n terms, then dS streamed in 32-column chunks for
//      dq += dS k and dk += dS^T q.  dq and dk are final for the block's
//      columns; dw_j w_j and dw_in partials, one set per tile, go to
//      scratch.
//   3. mlstm_bwd_dv_kernel, grid (hd/32, B*H): the block owns columns f of
//      dv: dv[:, f] = w_j (dC_out^T k)[:, f] over 32-row chunks of dC_out,
//      then W^T r over 32-row chunks of W.  (dC_out is read a second time:
//      dv's contraction runs over the rows that pass 2 cuts into tiles.)
//   4. mlstm_bwd_gates_kernel, grid (B*H): sums every partial in a fixed
//      order (deterministic), then the gate chain: da, di, db, the reverse
//      cumsum for dlog f and df.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"

namespace {

constexpr int NTHREADS = 256;  // also the largest chunk length L
constexpr int MAX_L = 256;
constexpr int TT = 32;         // rows of the L x L part per pass-1 block
constexpr int RPT = MAX_L / 32;  // rows per thread in passes 2 and 3

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// log(sigmoid(x)) in its stable form (the forward's)
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// Inclusive block scan over NTHREADS values in s (sum or max).
template <bool MAX>
__device__ void block_scan(float* s, int tid) {
  for (int off = 1; off < NTHREADS; off <<= 1) {
    const float mine = s[tid];
    const float other = tid >= off ? s[tid - off] : (MAX ? -INFINITY : 0.f);
    __syncthreads();
    s[tid] = MAX ? fmaxf(mine, other) : mine + other;
    __syncthreads();
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Sum of x over the block (NTHREADS threads), returned to every thread;
// red holds NTHREADS / 32 floats.
__device__ float block_sum(float x, float* red, int tid) {
  x = warp_sum(x);
  __syncthreads();                   // red is free
  if (tid % 32 == 0) red[tid / 32] = x;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NTHREADS / 32; ++w) s += red[w];
  return s;
}

// The gate scalars of row bh: Bc = b_t, A = a_j, Mt = M_t (MAX_L each).
__device__ void gate_scalars(const float* __restrict__ i_raw,
                             const float* __restrict__ f_raw, float m0,
                             float* A, float* Bc, float* Mt, int bh, int L,
                             int tid) {
  Bc[tid] = tid < L ? log_sigmoid(f_raw[(size_t)bh * L + tid]) : 0.f;
  __syncthreads();
  block_scan<false>(Bc, tid);
  const float a = tid < L ? i_raw[(size_t)bh * L + tid] - Bc[tid] : -INFINITY;
  A[tid] = a;
  Mt[tid] = a;
  __syncthreads();
  block_scan<true>(Mt, tid);
  Mt[tid] = fmaxf(m0, Mt[tid]);
  __syncthreads();
}

// rows scratch (bh, 5, L): the per-t scalars of pass 1
enum Row { R_DEN = 0, R_INTER, R_CQ, R_DBFLOOR, R_WJ, N_ROWS };

// ---------------------------------------------------------------------
// Pass 1.  Shared memory, in floats: A, Bc, Mt (MAX_L each), Qs, DHs, Hs
// (TT x SE each), Ks, Vs (L x SE each; later the column sums, 8 x L),
// Ns (E), QN, DHH (TT each).
// ---------------------------------------------------------------------
template <typename T, int E>
__global__ void __launch_bounds__(NTHREADS)
mlstm_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const float* __restrict__ i_raw,
                      const float* __restrict__ f_raw,
                      const float* __restrict__ n_in,
                      const float* __restrict__ m_in,
                      const float* __restrict__ h,
                      const float* __restrict__ dh, float* __restrict__ dS,
                      float* __restrict__ Wm, float* __restrict__ rows,
                      float* __restrict__ w_in, float* __restrict__ colpart,
                      int L, int hd) {
  constexpr int SE = E + 1;
  extern __shared__ __align__(16) float smem[];
  float* A = smem;
  float* Bc = A + MAX_L;
  float* Mt = Bc + MAX_L;
  float* Qs = Mt + MAX_L;
  float* DHs = Qs + TT * SE;
  float* Hs = DHs + TT * SE;
  float* Ks = Hs + TT * SE;
  float* Vs = Ks + L * SE;
  float* Ns = Vs + L * SE;
  float* QN = Ns + E;
  float* DHH = QN + TT;
  float* CS = Ks;                // after the stream: column sums, 8 x L

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const float m0 = m_in[bh];
  float* rb = rows + (size_t)bh * N_ROWS * L;

  gate_scalars(i_raw, f_raw, m0, A, Bc, Mt, bh, L, tid);
  const float b_last = Bc[L - 1];
  const float m_l = b_last + Mt[L - 1];
  if (blockIdx.x == 0) {
    if (tid < L) rb[R_WJ * L + tid] = expf(A[tid] + b_last - m_l);
    if (tid == 0) w_in[bh] = expf(m0 - m_l + b_last);
  }

  // S = q k^T and G = dh v^T for rows t0 .. t0+TT-1 and the causal
  // columns j < jmax.  Thread (ty, tx) owns rows ty + 8i, columns tx + 32jj.
  const int jmax = min(L, t0 + TT);
  const int ty = tid / 32, tx = tid % 32;
  const int njj = jmax > tx ? (jmax - tx + 31) / 32 : 0;
  float sacc[4][8], gacc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) sacc[i][jj] = gacc[i][jj] = 0.f;
  float qn = 0.f, dhh = 0.f;
  const size_t rowoff = (size_t)bh * L * hd;

  for (int e0 = 0; e0 < hd; e0 += E) {
    __syncthreads();  // the previous chunk is done with the tiles
    for (int idx = tid; idx < TT * E; idx += NTHREADS) {
      const int r = idx / E, e = idx % E;
      const int t = t0 + r;
      const size_t o = rowoff + (size_t)t * hd + e0 + e;
      const bool in = t < L;
      Qs[r * SE + e] = in ? to_float(q[o]) : 0.f;
      DHs[r * SE + e] = in ? dh[o] : 0.f;
      Hs[r * SE + e] = in ? h[o] : 0.f;
    }
    for (int idx = tid; idx < jmax * E; idx += NTHREADS) {
      const int j = idx / E, e = idx % E;
      const size_t o = rowoff + (size_t)j * hd + e0 + e;
      Ks[j * SE + e] = to_float(k[o]);
      Vs[j * SE + e] = to_float(v[o]);
    }
    if (tid < E) Ns[tid] = n_in[(size_t)bh * hd + e0 + tid];
    __syncthreads();
    if (tid < TT) {
#pragma unroll 8
      for (int e = 0; e < E; ++e) {
        qn = fmaf(Qs[tid * SE + e], Ns[e], qn);
        dhh = fmaf(DHs[tid * SE + e], Hs[tid * SE + e], dhh);
      }
    }
#pragma unroll 2
    for (int e = 0; e < E; ++e) {
      float qa[4], da[4], kk[8], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = Qs[(ty + 8 * i) * SE + e];
        da[i] = DHs[(ty + 8 * i) * SE + e];
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        kk[jj] = jj < njj ? Ks[(tx + 32 * jj) * SE + e] : 0.f;
        vv[jj] = jj < njj ? Vs[(tx + 32 * jj) * SE + e] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          sacc[i][jj] = fmaf(qa[i], kk[jj], sacc[i][jj]);
          gacc[i][jj] = fmaf(da[i], vv[jj], gacc[i][jj]);
        }
    }
  }
  if (tid < TT) {
    QN[tid] = qn;
    DHH[tid] = dhh;
  }
  __syncthreads();  // QN, DHH ready; Ks, Vs free for the column sums

  float cs[8];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) cs[jj] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 8 * i;
    const int t = t0 + r;
    if (t >= L) continue;          // uniform over the warp
    const float m_t = Mt[t];
    float dj[8], wv[8];
    float rowsum = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = tx + 32 * jj;
      dj[jj] = j <= t && jj < njj ? expf(A[j] - m_t) : 0.f;
      wv[jj] = sacc[i][jj] * dj[jj];
      rowsum += wv[jj];
    }
    rowsum = warp_sum(rowsum);
    const float inter = expf(m0 - m_t);
    const float qn_t = rowsum + inter * QN[r];
    const float floor_t = expf(-(Bc[t] + m_t));
    const float den = fmaxf(fabsf(qn_t), floor_t);
    const float dden = -DHH[r] / den;    // -r_t . h_t
    const bool on_abs = fabsf(qn_t) >= floor_t;
    const float sgn = qn_t > 0.f ? 1.f : (qn_t < 0.f ? -1.f : 0.f);
    const float dqn = on_abs ? sgn * dden : 0.f;
    float* dsr = dS + ((size_t)bh * L + t) * L;
    float* wr = Wm + ((size_t)bh * L + t) * L;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = tx + 32 * jj;
      if (j >= L) continue;
      const bool live = j <= t && jj < njj;
      const float dw = live ? gacc[i][jj] / den + dqn : 0.f;
      dsr[j] = dw * dj[jj];
      wr[j] = wv[jj];
      cs[jj] = fmaf(dw, wv[jj], cs[jj]);
    }
    if (tx == 0) {
      rb[R_DEN * L + t] = den;
      rb[R_INTER * L + t] = inter;
      rb[R_CQ * L + t] = inter * dqn;
      rb[R_DBFLOOR * L + t] = on_abs ? 0.f : -floor_t * dden;
    }
  }
  // column sums of dW o W over the block's rows: per warp, then over warps
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int j = tx + 32 * jj;
    if (j < L) CS[ty * L + j] = cs[jj];
  }
  __syncthreads();
  if (tid < L) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += CS[w * L + tid];
    colpart[((size_t)bh * gridDim.x + blockIdx.x) * L + tid] = s;
  }
}

// ---------------------------------------------------------------------
// Pass 2.  Shared memory, in floats: Ri, Vs (L x SR; Ri later dS's
// column chunk), Qs, Ks (L x SE), Cs, Ds (E x SE), RS, CQ, Wj (L each),
// Red (NTHREADS / 32).  SR = E + 4 keeps Ri's rows 16-byte aligned.
// Thread (ty, tx) = (tid / 8, tid % 8) owns rows t (or j) = ty + 32 i and
// columns e = tx + 8 c of the tile.
// ---------------------------------------------------------------------
template <typename T, int E>
__global__ void __launch_bounds__(NTHREADS)
mlstm_bwd_state_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const float* __restrict__ c_in,
                       const float* __restrict__ n_in,
                       const float* __restrict__ dh,
                       const float* __restrict__ dc_out,
                       const float* __restrict__ dn_out,
                       const float* __restrict__ dS,
                       const float* __restrict__ rows,
                       const float* __restrict__ w_in,
                       float* __restrict__ dq, float* __restrict__ dk,
                       float* __restrict__ dc_in, float* __restrict__ dn_in,
                       float* __restrict__ epart, int L, int hd) {
  constexpr int SE = E + 1;
  constexpr int SR = E + 4;
  constexpr int CPE = E / 8;          // tile columns per thread
  constexpr int Q4 = E / 4;           // float4 columns of a tile row
  extern __shared__ __align__(16) float smem[];
  float* Ri = smem;
  float* Vs = Ri + L * SR;
  float* Qs = Vs + L * SR;
  float* Ks = Qs + L * SE;
  float* Cs = Ks + L * SE;
  float* Ds = Cs + E * SE;
  float* RS = Ds + E * SE;
  float* CQ = RS + L;
  float* Wj = CQ + L;
  float* Red = Wj + L;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int e0 = blockIdx.x * E;
  const int ty = tid / 8, tx = tid % 8;
  const int nri = L > ty ? (L - ty + 31) / 32 : 0;
  const size_t rowoff = (size_t)bh * L * hd;
  const float* cb = c_in + (size_t)bh * hd * hd;
  const float* db = dc_out + (size_t)bh * hd * hd;
  float* dcb = dc_in + (size_t)bh * hd * hd;
  const float* rb = rows + (size_t)bh * N_ROWS * L;
  const float win = w_in[bh];

  for (int idx = tid; idx < L * E; idx += NTHREADS) {
    const int t = idx / E, e = idx % E;
    const size_t o = rowoff + (size_t)t * hd + e0 + e;
    Qs[t * SE + e] = to_float(q[o]);
    Ks[t * SE + e] = to_float(k[o]);
  }
  for (int t = tid; t < L; t += NTHREADS) {
    RS[t] = rb[R_INTER * L + t] / rb[R_DEN * L + t];
    CQ[t] = rb[R_CQ * L + t];
    Wj[t] = rb[R_WJ * L + t];
  }

  float xacc[RPT][CPE], yacc[RPT][CPE];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPE; ++c) xacc[i][c] = yacc[i][c] = 0.f;
  float dwin = 0.f;
  // dC_in's tile rows: thread idx < E * Q4 owns row ce, columns cf .. cf+3
  const bool cown = tid < E * Q4;
  const int ce = tid / Q4, cf = (tid % Q4) * 4;

  for (int f0 = 0; f0 < hd; f0 += E) {
    __syncthreads();  // gates loaded; the previous chunk is done
    for (int idx = tid; idx < E * E; idx += NTHREADS) {
      const int e = idx / E, f = idx % E;
      const size_t o = (size_t)(e0 + e) * hd + f0 + f;
      Cs[e * SE + f] = cb[o];
      Ds[e * SE + f] = db[o];
    }
    for (int idx = tid; idx < L * E; idx += NTHREADS) {
      const int t = idx / E, f = idx % E;
      const size_t o = rowoff + (size_t)t * hd + f0 + f;
      Ri[t * SR + f] = dh[o] * RS[t];
      Vs[t * SR + f] = to_float(v[o]);
    }
    __syncthreads();

    // dq_t[e] += sum_f C_in[e, f] ri_t[f]; dk_j[e] += sum_f dC[e, f] v_j[f]
#pragma unroll 2
    for (int f = 0; f < E; ++f) {
      float cc[CPE], dd[CPE];
#pragma unroll
      for (int c = 0; c < CPE; ++c) {
        cc[c] = Cs[(tx + 8 * c) * SE + f];
        dd[c] = Ds[(tx + 8 * c) * SE + f];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        if (i < nri) {
          const float ri = Ri[(ty + 32 * i) * SR + f];
          const float vv = Vs[(ty + 32 * i) * SR + f];
#pragma unroll
          for (int c = 0; c < CPE; ++c) {
            xacc[i][c] = fmaf(cc[c], ri, xacc[i][c]);
            yacc[i][c] = fmaf(dd[c], vv, yacc[i][c]);
          }
        }
      }
    }

    // dC_in[e, f] = w_in dC_out[e, f] + sum_t q_t[e] ri_t[f]
    if (cown) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 4
      for (int t = 0; t < L; ++t) {
        const float qv = Qs[t * SE + ce];
        const float4 r4 = *reinterpret_cast<const float4*>(&Ri[t * SR + cf]);
        s0 = fmaf(qv, r4.x, s0);
        s1 = fmaf(qv, r4.y, s1);
        s2 = fmaf(qv, r4.z, s2);
        s3 = fmaf(qv, r4.w, s3);
      }
      const float* dr = Ds + ce * SE + cf;
      const float* cr = Cs + ce * SE + cf;
      float* out = dcb + (size_t)(e0 + ce) * hd + f0 + cf;
      out[0] = fmaf(win, dr[0], s0);
      out[1] = fmaf(win, dr[1], s1);
      out[2] = fmaf(win, dr[2], s2);
      out[3] = fmaf(win, dr[3], s3);
      dwin = fmaf(cr[0], dr[0], dwin);
      dwin = fmaf(cr[1], dr[1], dwin);
      dwin = fmaf(cr[2], dr[2], dwin);
      dwin = fmaf(cr[3], dr[3], dwin);
    }
  }

  float nin[CPE], dno[CPE];
#pragma unroll
  for (int c = 0; c < CPE; ++c) {
    nin[c] = n_in[(size_t)bh * hd + e0 + tx + 8 * c];
    dno[c] = dn_out[(size_t)bh * hd + e0 + tx + 8 * c];
  }
  if (tid < E) {
    const size_t o = (size_t)bh * hd + e0 + tid;
    float s = 0.f;
    for (int t = 0; t < L; ++t) s = fmaf(CQ[t], Qs[t * SE + tid], s);
    dn_in[o] = fmaf(win, dn_out[o], s);
    dwin = fmaf(n_in[o], dn_out[o], dwin);
  }
  // the n terms of dq, the carry's dk (w_j (dC v_j + dn_out)) and its
  // dw_j w_j = k_j . that, summed over the tile's columns
  float* ep = epart + ((size_t)bh * gridDim.x + blockIdx.x) * (L + 1);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int t = ty + 32 * i;
    float dww = 0.f;
    if (i < nri) {
#pragma unroll
      for (int c = 0; c < CPE; ++c) {
        xacc[i][c] = fmaf(CQ[t], nin[c], xacc[i][c]);
        yacc[i][c] = Wj[t] * (yacc[i][c] + dno[c]);
        dww = fmaf(Ks[t * SE + tx + 8 * c], yacc[i][c], dww);
      }
    }
    // the 8 lanes of a row (tx) are neighbours in the warp
    dww += __shfl_xor_sync(0xffffffffu, dww, 1);
    dww += __shfl_xor_sync(0xffffffffu, dww, 2);
    dww += __shfl_xor_sync(0xffffffffu, dww, 4);
    if (i < nri && tx == 0) ep[t] = dww;
  }
  const float dwin_sum = block_sum(dwin, Red, tid);
  if (tid == 0) ep[L] = dwin_sum;

  // the L x L part: dS streamed in chunks of E columns j (into Ri)
  float* DSc = Ri;
  for (int j0 = 0; j0 < L; j0 += E) {
    const int jn = min(E, L - j0);
    __syncthreads();  // Ri is free
    for (int idx = tid; idx < L * E; idx += NTHREADS) {
      const int t = idx / E, jj = idx % E;
      DSc[t * SR + jj] =
          jj < jn ? dS[((size_t)bh * L + t) * L + j0 + jj] : 0.f;
    }
    __syncthreads();
    // dq_t[e] += sum_j dS_tj k_j[e]
    for (int jj = 0; jj < jn; ++jj) {
      float kk[CPE];
#pragma unroll
      for (int c = 0; c < CPE; ++c) kk[c] = Ks[(j0 + jj) * SE + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        if (i < nri) {
          const float s = DSc[(ty + 32 * i) * SR + jj];
#pragma unroll
          for (int c = 0; c < CPE; ++c) xacc[i][c] = fmaf(s, kk[c], xacc[i][c]);
        }
      }
    }
    // dk_j[e] += sum_{t >= j} dS_tj q_t[e] for the thread's rows j in the
    // chunk
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int j = ty + 32 * i;
      if (i < nri && j >= j0 && j < j0 + jn) {
        for (int t = j; t < L; ++t) {
          const float s = DSc[t * SR + j - j0];
#pragma unroll
          for (int c = 0; c < CPE; ++c)
            yacc[i][c] = fmaf(s, Qs[t * SE + tx + 8 * c], yacc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (i < nri) {
      const size_t o = rowoff + (size_t)(ty + 32 * i) * hd + e0 + tx;
#pragma unroll
      for (int c = 0; c < CPE; ++c) {
        dq[o + 8 * c] = xacc[i][c];
        dk[o + 8 * c] = yacc[i][c];
      }
    }
  }
}

// ---------------------------------------------------------------------
// Pass 3.  Shared memory, in floats: Ks (L x SE), Ds (E x SE), Wc (E x L),
// Rc (E x SE), Wj, Den (L each).  Thread (ty, tx) owns rows j = ty + 32 i
// and columns f = tx + 8 c of the block's tile of dv.
// ---------------------------------------------------------------------
template <typename T, int E>
__global__ void __launch_bounds__(NTHREADS)
mlstm_bwd_dv_kernel(const T* __restrict__ k, const float* __restrict__ dh,
                    const float* __restrict__ dc_out,
                    const float* __restrict__ Wm,
                    const float* __restrict__ rows, float* __restrict__ dv,
                    int L, int hd) {
  constexpr int SE = E + 1;
  constexpr int CPE = E / 8;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Ds = Ks + L * SE;
  float* Wc = Ds + E * SE;
  float* Rc = Wc + E * L;
  float* Wj = Rc + E * SE;
  float* Den = Wj + L;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int f0 = blockIdx.x * E;
  const int ty = tid / 8, tx = tid % 8;
  const int nri = L > ty ? (L - ty + 31) / 32 : 0;
  const size_t rowoff = (size_t)bh * L * hd;
  const float* db = dc_out + (size_t)bh * hd * hd;
  const float* rb = rows + (size_t)bh * N_ROWS * L;
  for (int t = tid; t < L; t += NTHREADS) {
    Wj[t] = rb[R_WJ * L + t];
    Den[t] = rb[R_DEN * L + t];
  }

  float acc[RPT][CPE];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPE; ++c) acc[i][c] = 0.f;

  // dC_out^T k: chunks of E rows e
  for (int e0 = 0; e0 < hd; e0 += E) {
    __syncthreads();
    for (int idx = tid; idx < L * E; idx += NTHREADS) {
      const int j = idx / E, e = idx % E;
      Ks[j * SE + e] = to_float(k[rowoff + (size_t)j * hd + e0 + e]);
    }
    for (int idx = tid; idx < E * E; idx += NTHREADS) {
      const int e = idx / E, f = idx % E;
      Ds[e * SE + f] = db[(size_t)(e0 + e) * hd + f0 + f];
    }
    __syncthreads();
#pragma unroll 2
    for (int e = 0; e < E; ++e) {
      float dd[CPE];
#pragma unroll
      for (int c = 0; c < CPE; ++c) dd[c] = Ds[e * SE + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        if (i < nri) {
          const float kv = Ks[(ty + 32 * i) * SE + e];
#pragma unroll
          for (int c = 0; c < CPE; ++c) acc[i][c] = fmaf(kv, dd[c], acc[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (i < nri) {
#pragma unroll
      for (int c = 0; c < CPE; ++c) acc[i][c] *= Wj[ty + 32 * i];
    }
  }

  // W^T r: chunks of E rows t of W (all its columns j) and of r
  for (int t0 = 0; t0 < L; t0 += E) {
    const int tn = min(E, L - t0);
    __syncthreads();
    for (int idx = tid; idx < E * L; idx += NTHREADS) {
      const int tt = idx / L, j = idx % L;
      Wc[idx] = tt < tn ? Wm[((size_t)bh * L + t0 + tt) * L + j] : 0.f;
    }
    for (int idx = tid; idx < E * E; idx += NTHREADS) {
      const int tt = idx / E, f = idx % E;
      Rc[tt * SE + f] = tt < tn ? dh[rowoff + (size_t)(t0 + tt) * hd + f0 + f]
                                      / Den[t0 + tt]
                                : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < tn; ++tt) {
      float rr[CPE];
#pragma unroll
      for (int c = 0; c < CPE; ++c) rr[c] = Rc[tt * SE + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        if (i < nri) {
          const float w = Wc[tt * L + ty + 32 * i];
#pragma unroll
          for (int c = 0; c < CPE; ++c) acc[i][c] = fmaf(w, rr[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (i < nri) {
      const size_t o = rowoff + (size_t)(ty + 32 * i) * hd + f0 + tx;
#pragma unroll
      for (int c = 0; c < CPE; ++c) dv[o + 8 * c] = acc[i][c];
    }
  }
}

// ---------------------------------------------------------------------
// Pass 4: the partials summed in a fixed order, then the gate chain.
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(NTHREADS)
mlstm_bwd_gates_kernel(const float* __restrict__ f_raw,
                       const float* __restrict__ rows,
                       const float* __restrict__ w_in,
                       const float* __restrict__ colpart,
                       const float* __restrict__ epart, int n_rowblocks,
                       int n_tiles, float* __restrict__ di,
                       float* __restrict__ df, int L) {
  __shared__ float S[NTHREADS];
  __shared__ float Red[NTHREADS / 32];
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const float* rb = rows + (size_t)bh * N_ROWS * L;
  const float* ep = epart + (size_t)bh * n_tiles * (L + 1);
  const bool live = tid < L;

  float cs = 0.f, dww = 0.f;
  if (live) {
    for (int b = 0; b < n_rowblocks; ++b)
      cs += colpart[((size_t)bh * n_rowblocks + b) * L + tid];
    for (int e = 0; e < n_tiles; ++e) dww += ep[(size_t)e * (L + 1) + tid];
  }
  float dwin = 0.f;
  for (int e = 0; e < n_tiles; ++e) dwin += ep[(size_t)e * (L + 1) + L];
  const float dwin_w = dwin * w_in[bh];
  const float sum_dww = block_sum(dww, Red, tid);
  const float da = cs + dww;
  float dbt = 0.f;
  if (live) {
    di[(size_t)bh * L + tid] = da;
    dbt = rb[R_DBFLOOR * L + tid] - da;
    if (tid == L - 1) dbt += dwin_w + sum_dww;
  }
  // dlog f_r = sum_{t >= r} db_t: an inclusive scan of db reversed
  const int rev = L - 1 - tid;
  if (live) S[rev] = dbt;
  if (tid >= L) S[tid] = 0.f;
  __syncthreads();
  block_scan<false>(S, tid);
  if (live) {
    const float f = f_raw[(size_t)bh * L + tid];
    df[(size_t)bh * L + tid] = S[rev] / (1.f + expf(f));   // sigmoid(-f)
  }
}

// ---------------------------------------------------------------------
// The bf16 route: tensor cores
// ---------------------------------------------------------------------

constexpr int TC_STAGES = 3;               // chunks in flight in every ring
constexpr int TE = 64;                     // hd columns a state / dv block owns
constexpr int ROW144 = TE * 2 + 16;        // a 64-column bf16 row, padded

// ldmatrix addresses (bytes in shared memory) of one lane, mi = lane / 8,
// r8 = lane % 8 (fragment layouts in mma_sm90.cuh).  A (16 x 16) from a
// tile stored m rows by k: ldsm_x4.
__device__ __forceinline__ uint32_t a_rows(uint32_t base, int stride, int m0,
                                           int k0, int mi, int r8) {
  return base + (m0 + 8 * (mi & 1) + r8) * stride + (k0 + 8 * (mi >> 1)) * 2;
}
// A from a tile stored k rows by m: ldsm_x4_t.
__device__ __forceinline__ uint32_t a_cols(uint32_t base, int stride, int m0,
                                           int k0, int mi, int r8) {
  return base + (k0 + 8 * (mi >> 1) + r8) * stride + (m0 + 8 * (mi & 1)) * 2;
}
// B of the n8 tiles n0 (r[0], r[1]) and n0 + 8 (r[2], r[3]) from a tile
// stored n rows by k: ldsm_x4.
__device__ __forceinline__ uint32_t b_rows(uint32_t base, int stride, int n0,
                                           int k0, int mi, int r8) {
  return base + (n0 + 8 * (mi >> 1) + r8) * stride + (k0 + 8 * (mi & 1)) * 2;
}
// The same from a tile stored k rows by n: ldsm_x4_t.
__device__ __forceinline__ uint32_t b_cols(uint32_t base, int stride, int n0,
                                           int k0, int mi, int r8) {
  return base + (k0 + 8 * (mi & 1) + r8) * stride + (n0 + 8 * (mi >> 1)) * 2;
}

// two floats split into bf16 hi + lo, each pair packed (x in the low half)
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 hb = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(hb);
  const __nv_bfloat162 lb = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&hb);
  lo = *reinterpret_cast<const uint32_t*>(&lb);
}
__device__ __forceinline__ void split4(float4 x, uint2& hi, uint2& lo) {
  split2(x.x, x.y, hi.x, lo.x);
  split2(x.z, x.w, hi.y, lo.y);
}

__device__ __forceinline__ float2 bf2(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// Pass 1, bf16.  Shared memory: a TC_STAGES ring of (q rows TT, k rows Lp,
// v rows Lp, bf16 in 80-byte rows; dh rows TT, fp32), dh's slice split
// (hi, lo), then the floats A, Bc, Mt (MAX_L each), QN, DHH, Den, Dqn,
// Inter (TT each), RS (TT x 8 warps).
constexpr int RT_EK = 32;                  // hd columns per slice
constexpr int RT_ROW = RT_EK * 2 + 16;     // 80
struct RowsTcLayout {
  __host__ __device__ static int k_off() { return TT * RT_ROW; }
  __host__ __device__ static int v_off(int Lp) { return (TT + Lp) * RT_ROW; }
  __host__ __device__ static int dh_off(int Lp) { return (TT + 2 * Lp) * RT_ROW; }
  __host__ __device__ static int stage(int Lp) { return dh_off(Lp) + TT * RT_EK * 4; }
  __host__ __device__ static int split_off(int Lp) { return TC_STAGES * stage(Lp); }
  __host__ __device__ static int f_off(int Lp) { return split_off(Lp) + 2 * TT * RT_ROW; }
  __host__ __device__ static int bytes(int Lp) {
    return f_off(Lp) + (3 * MAX_L + 5 * TT + TT * 8) * 4;
  }
};

__global__ void __launch_bounds__(NTHREADS, 1)
mlstm_bwd_rows_tc_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const float* __restrict__ i_raw,
                         const float* __restrict__ f_raw,
                         const float* __restrict__ n_in,
                         const float* __restrict__ m_in,
                         const float* __restrict__ h,
                         const float* __restrict__ dh,
                         __nv_bfloat16* __restrict__ sw,
                         __nv_bfloat16* __restrict__ rr,
                         float* __restrict__ rows, float* __restrict__ w_in,
                         float* __restrict__ colpart, int L, int hd) {
  using namespace mma_sm90;
  using Ly = RowsTcLayout;
  extern __shared__ __align__(128) unsigned char rt_smem[];
  const int Lp = (L + 15) / 16 * 16;
  float* A = reinterpret_cast<float*>(rt_smem + Ly::f_off(Lp));
  float* Bc = A + MAX_L;
  float* Mt = Bc + MAX_L;
  float* QN = Mt + MAX_L;
  float* DHH = QN + TT;
  float* Den = DHH + TT;
  float* Dqn = Den + TT;
  float* Inter = Dqn + TT;
  float* RS = Inter + TT;
  const uint32_t base = smem_u32(rt_smem);
  const uint32_t dhh_a = base + Ly::split_off(Lp), dhl_a = dhh_a + TT * RT_ROW;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = lane >> 2, tig = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const int bh = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int jmax = min(L, t0 + TT);
  const int jrows = (jmax + 15) / 16 * 16;
  const float m0 = m_in[bh];
  const size_t rowoff = (size_t)bh * L * hd;
  const __nv_bfloat16* qb = q + rowoff;
  const __nv_bfloat16* kb = k + rowoff;
  const __nv_bfloat16* vb = v + rowoff;
  const float* dhb = dh + rowoff;
  float* rb = rows + (size_t)bh * N_ROWS * L;
  const int nslices = hd / RT_EK;

  // slice c: q rows t0 .. t0+31, k and v rows 0 .. jrows-1 (bf16), dh rows
  // t0 .. t0+31 (fp32), hd columns 32 c ..; rows past L zero-filled
  auto fetch = [&](int c) {
    if (c < nslices) {
      const uint32_t st = base + (c % TC_STAGES) * Ly::stage(Lp);
      const int e0 = c * RT_EK;
      for (int idx = tid; idx < (TT + 2 * jrows) * 4; idx += NTHREADS) {
        const int r = idx >> 2, pc = idx & 3;
        const __nv_bfloat16* src;
        uint32_t dst;
        int t;
        if (r < TT) {
          t = t0 + r;
          src = qb;
          dst = st + r * RT_ROW;
        } else if (r < TT + jrows) {
          t = r - TT;
          src = kb;
          dst = st + Ly::k_off() + t * RT_ROW;
        } else {
          t = r - TT - jrows;
          src = vb;
          dst = st + Ly::v_off(Lp) + t * RT_ROW;
        }
        const bool in = t < L;
        cp_async16(dst + pc * 16, src + (size_t)(in ? t : 0) * hd + e0 + pc * 8,
                   in ? 16 : 0);
      }
      for (int idx = tid; idx < TT * (RT_EK / 4); idx += NTHREADS) {
        const int r = idx / (RT_EK / 4), pc = idx % (RT_EK / 4);
        const int t = t0 + r;
        const bool in = t < L;
        cp_async16(st + Ly::dh_off(Lp) + r * RT_EK * 4 + pc * 16,
                   dhb + (size_t)(in ? t : 0) * hd + e0 + pc * 4, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < TC_STAGES - 1; ++c) fetch(c);

  gate_scalars(i_raw, f_raw, m0, A, Bc, Mt, bh, L, tid);
  const float b_last = Bc[L - 1];
  const float m_l = b_last + Mt[L - 1];
  if (blockIdx.x == 0) {
    if (tid < L) rb[R_WJ * L + tid] = expf(A[tid] + b_last - m_l);
    if (tid == 0) w_in[bh] = expf(m0 - m_l + b_last);
  }
  // q_t . n_in and dh_t . h_t in fp32: 8 lanes a row, 4 columns a load
  {
    const int r = tid / 8, part = tid % 8;
    const int t = t0 + r;
    float qn = 0.f, dhh = 0.f;
    if (t < L) {
      const float* nr = n_in + (size_t)bh * hd;
      const float* hr = h + rowoff + (size_t)t * hd;
      const float* dr = dhb + (size_t)t * hd;
      const __nv_bfloat16* qr = qb + (size_t)t * hd;
      for (int e = 4 * part; e < hd; e += 32) {
        const uint2 q4 = *reinterpret_cast<const uint2*>(qr + e);
        const float4 n4 = *reinterpret_cast<const float4*>(nr + e);
        const float4 d4 = *reinterpret_cast<const float4*>(dr + e);
        const float4 h4 = *reinterpret_cast<const float4*>(hr + e);
        const float2 qa = bf2(q4.x), qc = bf2(q4.y);
        qn = fmaf(qa.x, n4.x, qn);
        qn = fmaf(qa.y, n4.y, qn);
        qn = fmaf(qc.x, n4.z, qn);
        qn = fmaf(qc.y, n4.w, qn);
        dhh = fmaf(d4.x, h4.x, dhh);
        dhh = fmaf(d4.y, h4.y, dhh);
        dhh = fmaf(d4.z, h4.z, dhh);
        dhh = fmaf(d4.w, h4.w, dhh);
      }
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      qn += __shfl_xor_sync(0xffffffffu, qn, off);
      dhh += __shfl_xor_sync(0xffffffffu, dhh, off);
    }
    if (part == 0) {
      QN[r] = qn;
      DHH[r] = dhh;
    }
  }

  // S and G for rows t0 + 16 mt + .., key columns 16 (warp + 8 x) + 8 y + ..
  float sacc[2][2][2][4], gacc[2][2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int y = 0; y < 2; ++y)
#pragma unroll
        for (int c = 0; c < 4; ++c) sacc[mt][x][y][c] = gacc[mt][x][y][c] = 0.f;
  const bool np_on[2] = {16 * warp < jrows, 16 * (warp + 8) < jrows};
  for (int c = 0; c < nslices; ++c) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();          // slice c is in; slice c - 1 is done with
    fetch(c + TC_STAGES - 1);
    const uint32_t st = base + (c % TC_STAGES) * Ly::stage(Lp);
    {
      // dh's slice split: thread -> row tid / 8, columns 4 (tid % 8) ..
      const int r = tid >> 3, c4 = (tid & 7) * 4;
      const float4 x = *reinterpret_cast<const float4*>(
          rt_smem + (c % TC_STAGES) * Ly::stage(Lp) + Ly::dh_off(Lp) +
          r * RT_EK * 4 + c4 * 4);
      uint2 hi, lo;
      split4(x, hi, lo);
      unsigned char* sp = rt_smem + Ly::split_off(Lp) + r * RT_ROW + c4 * 2;
      *reinterpret_cast<uint2*>(sp) = hi;
      *reinterpret_cast<uint2*>(sp + TT * RT_ROW) = lo;
    }
    __syncthreads();
    if (np_on[0]) {
#pragma unroll
      for (int ks = 0; ks < RT_EK / 16; ++ks) {
        uint32_t qa[2][4], dha[2][4], dla[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          ldsm_x4(qa[mt], a_rows(st, RT_ROW, 16 * mt, 16 * ks, mi, r8));
          ldsm_x4(dha[mt], a_rows(dhh_a, RT_ROW, 16 * mt, 16 * ks, mi, r8));
          ldsm_x4(dla[mt], a_rows(dhl_a, RT_ROW, 16 * mt, 16 * ks, mi, r8));
        }
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          if (np_on[x]) {
            const int n0 = 16 * (warp + 8 * x);
            uint32_t bk[4], bv[4];
            ldsm_x4(bk, b_rows(st + Ly::k_off(), RT_ROW, n0, 16 * ks, mi, r8));
            ldsm_x4(bv, b_rows(st + Ly::v_off(Lp), RT_ROW, n0, 16 * ks, mi, r8));
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_bf16(sacc[mt][x][0], qa[mt], bk[0], bk[1]);
              mma_bf16(sacc[mt][x][1], qa[mt], bk[2], bk[3]);
              mma_bf16(gacc[mt][x][0], dha[mt], bv[0], bv[1]);
              mma_bf16(gacc[mt][x][0], dla[mt], bv[0], bv[1]);
              mma_bf16(gacc[mt][x][1], dha[mt], bv[2], bv[3]);
              mma_bf16(gacc[mt][x][1], dla[mt], bv[2], bv[3]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // W = S o D on and below the diagonal (rows < L), and its row sums
  float rs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int tt = t0 + 16 * mt + grp + 8 * half;
      const bool row_in = tt < L;
      const float m_t = row_in ? Mt[tt] : 0.f;
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int y = 0; y < 2; ++y)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int j = 16 * (warp + 8 * x) + 8 * y + 2 * tig + u;
            const bool live = row_in && j <= tt;
            const float w =
                live ? sacc[mt][x][y][2 * half + u] * expf(A[j] - m_t) : 0.f;
            sacc[mt][x][y][2 * half + u] = w;
            rs[mt][half] += w;
          }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float x = rs[mt][half];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if (tig == 0) RS[(16 * mt + grp + 8 * half) * 8 + warp] = x;
    }
  __syncthreads();
  if (tid < TT && t0 + tid < L) {
    const int tt = t0 + tid;
    float rowsum = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) rowsum += RS[tid * 8 + w];
    const float m_t = Mt[tt];
    const float inter = expf(m0 - m_t);
    const float qn_t = rowsum + inter * QN[tid];
    const float floor_t = expf(-(Bc[tt] + m_t));
    const float den = fmaxf(fabsf(qn_t), floor_t);
    const float dden = -DHH[tid] / den;    // -r_t . h_t
    const bool on_abs = fabsf(qn_t) >= floor_t;
    const float sgn = qn_t > 0.f ? 1.f : (qn_t < 0.f ? -1.f : 0.f);
    const float dqn = on_abs ? sgn * dden : 0.f;
    Den[tid] = den;
    Dqn[tid] = dqn;
    Inter[tid] = inter;
    rb[R_DEN * L + tt] = den;
    rb[R_INTER * L + tt] = inter;
    rb[R_CQ * L + tt] = inter * dqn;
    rb[R_DBFLOOR * L + tt] = on_abs ? 0.f : -floor_t * dden;
  }
  __syncthreads();

  // dW = G / den + dqn, dS = dW o D; dS and W written as hi/lo planes
  // (every entry of the block's rows < Lp, zeros off the causal part);
  // the column sums of dW o W over the block's rows
  __nv_bfloat16* swb = sw + (size_t)bh * 4 * Lp * Lp;
  const size_t plane = (size_t)Lp * Lp;
  float cs[2][2][2];
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int y = 0; y < 2; ++y) cs[x][y][0] = cs[x][y][1] = 0.f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rl = 16 * mt + grp + 8 * half;
      const int tt = t0 + rl;
      if (tt >= Lp) continue;
      const bool row_in = tt < L;
      const float m_t = row_in ? Mt[tt] : 0.f;
      const float den = row_in ? Den[rl] : 1.f;
      const float dqn = row_in ? Dqn[rl] : 0.f;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int jb = 16 * (warp + 8 * x);
        if (jb >= Lp) continue;
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          const int j0 = jb + 8 * y + 2 * tig;
          float dsv[2], wv[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int j = j0 + u;
            const bool live = row_in && j <= tt;
            const float dw = live ? gacc[mt][x][y][2 * half + u] / den + dqn : 0.f;
            const float d = live ? expf(A[j] - m_t) : 0.f;
            dsv[u] = dw * d;
            wv[u] = sacc[mt][x][y][2 * half + u];
            cs[x][y][u] = fmaf(dw, wv[u], cs[x][y][u]);
          }
          uint32_t hi, lo;
          const size_t o = (size_t)tt * Lp + j0;
          split2(dsv[0], dsv[1], hi, lo);
          *reinterpret_cast<uint32_t*>(swb + o) = hi;
          *reinterpret_cast<uint32_t*>(swb + plane + o) = lo;
          split2(wv[0], wv[1], hi, lo);
          *reinterpret_cast<uint32_t*>(swb + 2 * plane + o) = hi;
          *reinterpret_cast<uint32_t*>(swb + 3 * plane + o) = lo;
        }
      }
    }
  }
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int y = 0; y < 2; ++y)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float s = cs[x][y][u];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        const int j = 16 * (warp + 8 * x) + 8 * y + 2 * tig + u;
        if (grp == 0 && j < L)
          colpart[((size_t)bh * gridDim.x + blockIdx.x) * L + j] = s;
      }

  // r = dh / den and ri = inter r for the block's rows < Lp, hi/lo planes
  __nv_bfloat16* rrb = rr + (size_t)bh * 4 * Lp * hd;
  const size_t rplane = (size_t)Lp * hd;
  const int nrow = min(TT, Lp - t0);
  const int per_row = hd / 8;
  for (int idx = tid; idx < nrow * per_row; idx += NTHREADS) {
    const int rl = idx / per_row, e8 = (idx % per_row) * 8;
    const int tt = t0 + rl;
    float x[8], y[8];
    if (tt < L) {
      const float4 a = *reinterpret_cast<const float4*>(dhb + (size_t)tt * hd + e8);
      const float4 b = *reinterpret_cast<const float4*>(dhb + (size_t)tt * hd + e8 + 4);
      const float den = Den[rl], inter = Inter[rl];
      x[0] = a.x / den; x[1] = a.y / den; x[2] = a.z / den; x[3] = a.w / den;
      x[4] = b.x / den; x[5] = b.y / den; x[6] = b.z / den; x[7] = b.w / den;
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = inter * x[i];
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = y[i] = 0.f;
    }
    const size_t o = (size_t)tt * hd + e8;
    split8(x, *reinterpret_cast<uint4*>(rrb + o),
           *reinterpret_cast<uint4*>(rrb + rplane + o));
    split8(y, *reinterpret_cast<uint4*>(rrb + 2 * rplane + o),
           *reinterpret_cast<uint4*>(rrb + 3 * rplane + o));
  }
}

// Pass 2, bf16.  Shared memory: a TC_STAGES ring whose stage holds, in the
// stream over f, C_in's and dC_out's chunk (64 x 16 fp32) and ri hi, ri lo,
// v (Lp x 16 bf16, 48-byte rows); in the L^2 part, dS's column chunk hi/lo
// (Lp x 16, 48-byte rows), its row chunk hi/lo (16 x Lp, 2 Lp + 16-byte
// rows), k's and q's rows (16 x 64, 144-byte rows).  Then C's and dC's
// chunk split (hi, lo; 64 rows of 48 bytes each), CQ, Wj (MAX_L), Red (8).
constexpr int ST_FC = 16;                  // f columns per chunk
constexpr int ROW48 = ST_FC * 2 + 16;      // 48
struct StateTcLayout {
  __host__ __device__ static int rs(int Lp) { return 2 * Lp + 16; }
  // the stream over f
  __host__ __device__ static int df_off() { return TE * ST_FC * 4; }
  __host__ __device__ static int ri_off() { return 2 * TE * ST_FC * 4; }
  __host__ __device__ static int stream(int Lp) { return ri_off() + 3 * Lp * ROW48; }
  // the L^2 part
  __host__ __device__ static int dsr_off(int Lp) { return 2 * Lp * ROW48; }
  __host__ __device__ static int kq_off(int Lp) { return dsr_off(Lp) + 2 * 16 * rs(Lp); }
  __host__ __device__ static int l2(int Lp) { return kq_off(Lp) + 2 * 16 * ROW144; }
  __host__ __device__ static int stage(int Lp) {
    const int s = stream(Lp) > l2(Lp) ? stream(Lp) : l2(Lp);
    return (s + 127) / 128 * 128;
  }
  __host__ __device__ static int split_off(int Lp) { return TC_STAGES * stage(Lp); }
  __host__ __device__ static int f_off(int Lp) { return split_off(Lp) + 4 * TE * ROW48; }
  __host__ __device__ static int bytes(int Lp) {
    return f_off(Lp) + (2 * MAX_L + NTHREADS / 32) * 4;
  }
};

__global__ void __launch_bounds__(NTHREADS, 1)
mlstm_bwd_state_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const float* __restrict__ c_in,
                          const float* __restrict__ n_in,
                          const float* __restrict__ dc_out,
                          const float* __restrict__ dn_out,
                          const __nv_bfloat16* __restrict__ sw,
                          const __nv_bfloat16* __restrict__ rr,
                          const float* __restrict__ rows,
                          const float* __restrict__ w_in,
                          float* __restrict__ dq, float* __restrict__ dk,
                          float* __restrict__ dn_in,
                          float* __restrict__ epart, int L, int hd) {
  using namespace mma_sm90;
  using Ly = StateTcLayout;
  extern __shared__ __align__(128) unsigned char st_smem[];
  const int Lp = (L + 15) / 16 * 16;
  float* CQ = reinterpret_cast<float*>(st_smem + Ly::f_off(Lp));
  float* Wj = CQ + MAX_L;
  float* Red = Wj + MAX_L;
  const uint32_t base = smem_u32(st_smem);
  const uint32_t ch_a = base + Ly::split_off(Lp), cl_a = ch_a + TE * ROW48;
  const uint32_t dh_a = cl_a + TE * ROW48, dl_a = dh_a + TE * ROW48;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = lane >> 2, tig = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const int bh = blockIdx.y;
  const int e0 = blockIdx.x * TE;
  const size_t rowoff = (size_t)bh * L * hd;
  const __nv_bfloat16* qb = q + rowoff;
  const __nv_bfloat16* kb = k + rowoff;
  const __nv_bfloat16* vb = v + rowoff;
  const float* cb = c_in + (size_t)bh * hd * hd + (size_t)e0 * hd;
  const float* db = dc_out + (size_t)bh * hd * hd + (size_t)e0 * hd;
  const __nv_bfloat16* rib = rr + (size_t)bh * 4 * Lp * hd + 2 * (size_t)Lp * hd;
  const __nv_bfloat16* swb = sw + (size_t)bh * 4 * Lp * Lp;
  const float* rb = rows + (size_t)bh * N_ROWS * L;
  for (int t = tid; t < L; t += NTHREADS) {
    CQ[t] = rb[R_CQ * L + t];
    Wj[t] = rb[R_WJ * L + t];
  }

  // the stream over f: chunk c is columns 16 c .. of C's and dC's rows
  // e0 .., of ri (hi, lo; Lp rows) and of v (rows past L zero-filled)
  const int nchunks = hd / ST_FC;
  auto fetch = [&](int c) {
    if (c < nchunks) {
      const uint32_t st = base + (c % TC_STAGES) * Ly::stage(Lp);
      const int f0 = c * ST_FC;
      for (int idx = tid; idx < 2 * TE * 4; idx += NTHREADS) {
        const int m = idx / (TE * 4), r = (idx / 4) % TE, pc = idx % 4;
        cp_async16(st + m * Ly::df_off() + r * ST_FC * 4 + pc * 16,
                   (m ? db : cb) + (size_t)r * hd + f0 + pc * 4, 16);
      }
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        for (int idx = tid; idx < 2 * Lp; idx += NTHREADS) {
          const int t = idx >> 1, pc = idx & 1;
          const bool in = m < 2 || t < L;
          const __nv_bfloat16* src =
              m < 2 ? rib + (size_t)m * Lp * hd + (size_t)t * hd
                    : vb + (size_t)(in ? t : 0) * hd;
          cp_async16(st + Ly::ri_off() + (m * Lp + t) * ROW48 + pc * 16,
                     src + f0 + pc * 8, in ? 16 : 0);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < TC_STAGES - 1; ++c) fetch(c);

  // dq, dk accumulators: rows t = 32 warp + 16 mt + grp (+ 8), columns
  // e0 + 8 nt + 2 tig (+ 1)
  float dqa[2][8][4], dka[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) dqa[mt][nt][c] = dka[mt][nt][c] = 0.f;
  const int m_base = 32 * warp;
  const bool mt_on[2] = {m_base < Lp, m_base + 16 < Lp};
  float cd = 0.f;            // this thread's share of <C_in, dC_out>

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();          // chunk c is in; chunk c - 1 is done with
    fetch(c + TC_STAGES - 1);
    const unsigned char* stp = st_smem + (c % TC_STAGES) * Ly::stage(Lp);
    const uint32_t st = base + (c % TC_STAGES) * Ly::stage(Lp);
    {
      // split C's and dC's chunk: thread -> row tid / 4, columns 4 (tid % 4)
      const int r = tid >> 2, c4 = (tid & 3) * 4;
      const float4 cx = *reinterpret_cast<const float4*>(stp + (r * ST_FC + c4) * 4);
      const float4 dx = *reinterpret_cast<const float4*>(
          stp + Ly::df_off() + (r * ST_FC + c4) * 4);
      cd = fmaf(cx.x, dx.x, cd);
      cd = fmaf(cx.y, dx.y, cd);
      cd = fmaf(cx.z, dx.z, cd);
      cd = fmaf(cx.w, dx.w, cd);
      uint2 hi, lo;
      unsigned char* sp = st_smem + Ly::split_off(Lp) + r * ROW48 + c4 * 2;
      split4(cx, hi, lo);
      *reinterpret_cast<uint2*>(sp) = hi;
      *reinterpret_cast<uint2*>(sp + TE * ROW48) = lo;
      split4(dx, hi, lo);
      *reinterpret_cast<uint2*>(sp + 2 * TE * ROW48) = hi;
      *reinterpret_cast<uint2*>(sp + 3 * TE * ROW48) = lo;
    }
    __syncthreads();
    if (mt_on[0]) {
      const uint32_t ri_a = st + Ly::ri_off();
      uint32_t ah[2][4], al[2][4], av[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt_on[mt]) {
          ldsm_x4(ah[mt], a_rows(ri_a, ROW48, m_base + 16 * mt, 0, mi, r8));
          ldsm_x4(al[mt], a_rows(ri_a + Lp * ROW48, ROW48, m_base + 16 * mt, 0, mi, r8));
          ldsm_x4(av[mt], a_rows(ri_a + 2 * Lp * ROW48, ROW48, m_base + 16 * mt, 0, mi, r8));
        }
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bch[4], bcl[4], bdh[4], bdl[4];
        ldsm_x4(bch, b_rows(ch_a, ROW48, 16 * np, 0, mi, r8));
        ldsm_x4(bcl, b_rows(cl_a, ROW48, 16 * np, 0, mi, r8));
        ldsm_x4(bdh, b_rows(dh_a, ROW48, 16 * np, 0, mi, r8));
        ldsm_x4(bdl, b_rows(dl_a, ROW48, 16 * np, 0, mi, r8));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (mt_on[mt]) {
            // dq += ri C^T: hi hi + hi lo + lo hi
            mma_bf16(dqa[mt][2 * np], ah[mt], bch[0], bch[1]);
            mma_bf16(dqa[mt][2 * np], ah[mt], bcl[0], bcl[1]);
            mma_bf16(dqa[mt][2 * np], al[mt], bch[0], bch[1]);
            mma_bf16(dqa[mt][2 * np + 1], ah[mt], bch[2], bch[3]);
            mma_bf16(dqa[mt][2 * np + 1], ah[mt], bcl[2], bcl[3]);
            mma_bf16(dqa[mt][2 * np + 1], al[mt], bch[2], bch[3]);
            // dk += v dC^T
            mma_bf16(dka[mt][2 * np], av[mt], bdh[0], bdh[1]);
            mma_bf16(dka[mt][2 * np], av[mt], bdl[0], bdl[1]);
            mma_bf16(dka[mt][2 * np + 1], av[mt], bdh[2], bdh[3]);
            mma_bf16(dka[mt][2 * np + 1], av[mt], bdl[2], bdl[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // the carry terms: dq += inter dqn n_in; dk_carry = w_j (dC v + dn_out)
  // and its dw_j w_j = k_j . dk_carry over the tile's columns
  const float win = w_in[bh];
  float* ep = epart + ((size_t)bh * gridDim.x + blockIdx.x) * (L + 1);
  float nin[8][2], dno[8][2];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const size_t o = (size_t)bh * hd + e0 + 8 * nt + 2 * tig + u;
      nin[nt][u] = n_in[o];
      dno[nt][u] = dn_out[o];
    }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = m_base + 16 * mt + grp + 8 * half;
      float dww = 0.f;
      if (t < L) {
        const float cq = CQ[t], wj = Wj[t];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float2 kf = bf2(*reinterpret_cast<const uint32_t*>(
              kb + (size_t)t * hd + e0 + 8 * nt + 2 * tig));
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float& a = dqa[mt][nt][2 * half + u];
            a = fmaf(cq, nin[nt][u], a);
            float& b = dka[mt][nt][2 * half + u];
            b = wj * (b + dno[nt][u]);
            dww = fmaf(u ? kf.y : kf.x, b, dww);
          }
        }
      }
      dww += __shfl_xor_sync(0xffffffffu, dww, 1);
      dww += __shfl_xor_sync(0xffffffffu, dww, 2);
      if (tig == 0 && t < L) ep[t] = dww;
    }
  }
  float dwin = cd;
  if (tid < TE) {
    const size_t o = (size_t)bh * hd + e0 + tid;
    dwin = fmaf(n_in[o], dn_out[o], dwin);
  }
  const float dwin_sum = block_sum(dwin, Red, tid);
  if (tid == 0) ep[L] = dwin_sum;

  // the L^2 part, chunk c = 16 columns j and 16 rows t of dS:
  // dq[t] += sum_j dS[t, j] k[j] over the column chunk, dk[j] += sum_t
  // dS[t, j] q[t] over the row chunk; dn_in's sum_t inter dqn_t q_t over
  // the chunk's rows of q (thread tid < 64: column e0 + tid)
  float dnq = 0.f;
  const size_t plane = (size_t)Lp * Lp;
  const int rsb = Ly::rs(Lp);
  const int nc2 = Lp / 16;
  auto fetch2 = [&](int c) {
    if (c < nc2) {
      const uint32_t st = base + (c % TC_STAGES) * Ly::stage(Lp);
      const int j0 = 16 * c;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        for (int idx = tid; idx < 2 * Lp; idx += NTHREADS) {
          const int t = idx >> 1, pc = idx & 1;
          cp_async16(st + (p * Lp + t) * ROW48 + pc * 16,
                     swb + p * plane + (size_t)t * Lp + j0 + pc * 8, 16);
        }
        // the row chunk: 16 rows of Lp / 8 16-byte pieces
        for (int idx = tid; idx < 16 * 32; idx += NTHREADS) {
          const int r = idx >> 5, pc = idx & 31;
          if (pc < Lp / 8)
            cp_async16(st + Ly::dsr_off(Lp) + (p * 16 + r) * rsb + pc * 16,
                       swb + p * plane + (size_t)(j0 + r) * Lp + pc * 8, 16);
        }
      }
      for (int idx = tid; idx < 2 * 16 * 8; idx += NTHREADS) {
        const int p = idx / 128, r = (idx / 8) % 16, pc = idx % 8;
        const int t = j0 + r;
        const bool in = t < L;
        cp_async16(st + Ly::kq_off(Lp) + (p * 16 + r) * ROW144 + pc * 16,
                   (p ? qb : kb) + (size_t)(in ? t : 0) * hd + e0 + pc * 8,
                   in ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  __syncthreads();            // every warp is done with the stream's ring
#pragma unroll
  for (int c = 0; c < TC_STAGES - 1; ++c) fetch2(c);
  for (int c = 0; c < nc2; ++c) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();
    fetch2(c + TC_STAGES - 1);
    const uint32_t st = base + (c % TC_STAGES) * Ly::stage(Lp);
    const int j0 = 16 * c;
    const uint32_t k_a = st + Ly::kq_off(Lp), q_a = k_a + 16 * ROW144;
    if (tid < TE) {
      const __nv_bfloat16* qr = reinterpret_cast<const __nv_bfloat16*>(
          st_smem + (c % TC_STAGES) * Ly::stage(Lp) + Ly::kq_off(Lp) +
          16 * ROW144) + tid;
      for (int r = 0; r < 16 && j0 + r < L; ++r)
        dnq = fmaf(CQ[j0 + r], __bfloat162float(qr[r * (ROW144 / 2)]), dnq);
    }
    // dq: the warp's rows t >= j0
    if (mt_on[0] && m_base + 31 >= j0) {
      uint32_t bk[4][4];
#pragma unroll
      for (int np = 0; np < 4; ++np)
        ldsm_x4_t(bk[np], b_cols(k_a, ROW144, 16 * np, 0, mi, r8));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt_on[mt] && m_base + 16 * mt + 15 >= j0) {
          uint32_t ah[4], al[4];
          ldsm_x4(ah, a_rows(st, ROW48, m_base + 16 * mt, 0, mi, r8));
          ldsm_x4(al, a_rows(st + Lp * ROW48, ROW48, m_base + 16 * mt, 0, mi, r8));
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            mma_bf16(dqa[mt][2 * np], ah, bk[np][0], bk[np][1]);
            mma_bf16(dqa[mt][2 * np], al, bk[np][0], bk[np][1]);
            mma_bf16(dqa[mt][2 * np + 1], ah, bk[np][2], bk[np][3]);
            mma_bf16(dqa[mt][2 * np + 1], al, bk[np][2], bk[np][3]);
          }
        }
      }
    }
    // dk: the warp's rows j <= j0 + 15
    if (mt_on[0] && m_base <= j0 + 15) {
      uint32_t bq[4][4];
#pragma unroll
      for (int np = 0; np < 4; ++np)
        ldsm_x4_t(bq[np], b_cols(q_a, ROW144, 16 * np, 0, mi, r8));
      const uint32_t sr_a = st + Ly::dsr_off(Lp);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt_on[mt] && m_base + 16 * mt <= j0 + 15) {
          uint32_t ah[4], al[4];
          ldsm_x4_t(ah, a_cols(sr_a, rsb, m_base + 16 * mt, 0, mi, r8));
          ldsm_x4_t(al, a_cols(sr_a + 16 * rsb, rsb, m_base + 16 * mt, 0, mi, r8));
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            mma_bf16(dka[mt][2 * np], ah, bq[np][0], bq[np][1]);
            mma_bf16(dka[mt][2 * np], al, bq[np][0], bq[np][1]);
            mma_bf16(dka[mt][2 * np + 1], ah, bq[np][2], bq[np][3]);
            mma_bf16(dka[mt][2 * np + 1], al, bq[np][2], bq[np][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if (tid < TE) {
    const size_t o = (size_t)bh * hd + e0 + tid;
    dn_in[o] = fmaf(win, dn_out[o], dnq);
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = m_base + 16 * mt + grp + 8 * half;
      if (t < L) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const size_t o = rowoff + (size_t)t * hd + e0 + 8 * nt + 2 * tig;
          *reinterpret_cast<float2*>(dq + o) =
              make_float2(dqa[mt][nt][2 * half], dqa[mt][nt][2 * half + 1]);
          *reinterpret_cast<float2*>(dk + o) =
              make_float2(dka[mt][nt][2 * half], dka[mt][nt][2 * half + 1]);
        }
      }
    }
}

// Pass 3, bf16.  Shared memory: a TC_STAGES ring whose stage holds k's
// columns (Lp x 32 bf16, 80-byte rows) and dC_out's chunk (32 x 64 fp32)
// in the first part, W's row chunk hi/lo (16 x Lp) and r's rows hi/lo (16 x
// 64) in the second; dC_out's chunk split (hi, lo; 144-byte rows); Wj.
constexpr int DV_EC = 32;                  // e rows of dC_out per chunk
constexpr int ROW80 = DV_EC * 2 + 16;      // 80
struct DvTcLayout {
  __host__ __device__ static int rs(int Lp) { return 2 * Lp + 16; }
  __host__ __device__ static int df_off(int Lp) { return Lp * ROW80; }
  __host__ __device__ static int part1(int Lp) { return df_off(Lp) + DV_EC * TE * 4; }
  __host__ __device__ static int r_off(int Lp) { return 2 * 16 * rs(Lp); }
  __host__ __device__ static int part2(int Lp) { return r_off(Lp) + 2 * 16 * ROW144; }
  __host__ __device__ static int stage(int Lp) {
    const int s = part1(Lp) > part2(Lp) ? part1(Lp) : part2(Lp);
    return (s + 127) / 128 * 128;
  }
  __host__ __device__ static int split_off(int Lp) { return TC_STAGES * stage(Lp); }
  __host__ __device__ static int f_off(int Lp) { return split_off(Lp) + 2 * DV_EC * ROW144; }
  __host__ __device__ static int bytes(int Lp) { return f_off(Lp) + MAX_L * 4; }
};

__global__ void __launch_bounds__(NTHREADS, 2)
mlstm_bwd_dv_tc_kernel(const __nv_bfloat16* __restrict__ k,
                       const float* __restrict__ dc_out,
                       const __nv_bfloat16* __restrict__ sw,
                       const __nv_bfloat16* __restrict__ rr,
                       const float* __restrict__ rows,
                       float* __restrict__ dv, int L, int hd) {
  using namespace mma_sm90;
  using Ly = DvTcLayout;
  extern __shared__ __align__(128) unsigned char dv_smem[];
  const int Lp = (L + 15) / 16 * 16;
  float* Wj = reinterpret_cast<float*>(dv_smem + Ly::f_off(Lp));
  const uint32_t base = smem_u32(dv_smem);
  const uint32_t dh_a = base + Ly::split_off(Lp), dl_a = dh_a + DV_EC * ROW144;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = lane >> 2, tig = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const int bh = blockIdx.y;
  const int f0 = blockIdx.x * TE;
  const size_t rowoff = (size_t)bh * L * hd;
  const __nv_bfloat16* kb = k + rowoff;
  const float* db = dc_out + (size_t)bh * hd * hd + f0;
  const __nv_bfloat16* swb = sw + (size_t)bh * 4 * Lp * Lp;
  const __nv_bfloat16* rb16 = rr + (size_t)bh * 4 * Lp * hd;
  const float* rb = rows + (size_t)bh * N_ROWS * L;
  for (int t = tid; t < L; t += NTHREADS) Wj[t] = rb[R_WJ * L + t];

  // k dC_out: chunk c is rows e = 32 c .. of dC_out's tile and k's columns
  const int nchunks = hd / DV_EC;
  auto fetch = [&](int c) {
    if (c < nchunks) {
      const uint32_t st = base + (c % TC_STAGES) * Ly::stage(Lp);
      const int e0 = c * DV_EC;
      for (int idx = tid; idx < Lp * 4; idx += NTHREADS) {
        const int j = idx / 4, pc = idx % 4;
        const bool in = j < L;
        cp_async16(st + j * ROW80 + pc * 16,
                   kb + (size_t)(in ? j : 0) * hd + e0 + pc * 8, in ? 16 : 0);
      }
      for (int idx = tid; idx < DV_EC * (TE / 4); idx += NTHREADS) {
        const int r = idx / (TE / 4), pc = idx % (TE / 4);
        cp_async16(st + Ly::df_off(Lp) + r * TE * 4 + pc * 16,
                   db + (size_t)(e0 + r) * hd + pc * 4, 16);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < TC_STAGES - 1; ++c) fetch(c);

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
  const int m_base = 32 * warp;
  const bool mt_on[2] = {m_base < Lp, m_base + 16 < Lp};

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();
    fetch(c + TC_STAGES - 1);
    const uint32_t st = base + (c % TC_STAGES) * Ly::stage(Lp);
    {
      // split dC's chunk: thread -> row tid / 8, columns 8 (tid % 8) ..
      const int r = tid >> 3, c8 = (tid & 7) * 8;
      const float* src = reinterpret_cast<const float*>(
          dv_smem + (c % TC_STAGES) * Ly::stage(Lp) + Ly::df_off(Lp)) + r * TE + c8;
      unsigned char* sp = dv_smem + Ly::split_off(Lp) + r * ROW144 + c8 * 2;
      split8(src, *reinterpret_cast<uint4*>(sp),
             *reinterpret_cast<uint4*>(sp + DV_EC * ROW144));
    }
    __syncthreads();
    if (mt_on[0]) {
#pragma unroll
      for (int ks = 0; ks < DV_EC / 16; ++ks) {
        uint32_t ak[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          if (mt_on[mt])
            ldsm_x4(ak[mt], a_rows(st, ROW80, m_base + 16 * mt, 16 * ks, mi, r8));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bh4[4], bl4[4];
          ldsm_x4_t(bh4, b_cols(dh_a, ROW144, 16 * np, 16 * ks, mi, r8));
          ldsm_x4_t(bl4, b_cols(dl_a, ROW144, 16 * np, 16 * ks, mi, r8));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (mt_on[mt]) {
              mma_bf16(acc[mt][2 * np], ak[mt], bh4[0], bh4[1]);
              mma_bf16(acc[mt][2 * np], ak[mt], bl4[0], bl4[1]);
              mma_bf16(acc[mt][2 * np + 1], ak[mt], bh4[2], bh4[3]);
              mma_bf16(acc[mt][2 * np + 1], ak[mt], bl4[2], bl4[3]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();            // every warp is done with the first ring

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = m_base + 16 * mt + grp + 8 * half;
      const float wj = j < L ? Wj[j] : 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[mt][nt][2 * half] *= wj;
        acc[mt][nt][2 * half + 1] *= wj;
      }
    }

  // W^T r: chunk c is rows t = 16 c .. of W (hi, lo; every column j) and
  // of r (hi, lo; the tile's columns)
  const size_t plane = (size_t)Lp * Lp, rplane = (size_t)Lp * hd;
  const int rsb = Ly::rs(Lp);
  const int nc2 = Lp / 16;
  auto fetch2 = [&](int c) {
    if (c < nc2) {
      const uint32_t st = base + (c % TC_STAGES) * Ly::stage(Lp);
      const int t0 = 16 * c;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        // 16 rows of Lp / 8 16-byte pieces
        for (int idx = tid; idx < 16 * 32; idx += NTHREADS) {
          const int r = idx >> 5, pc = idx & 31;
          if (pc < Lp / 8)
            cp_async16(st + (p * 16 + r) * rsb + pc * 16,
                       swb + (2 + p) * plane + (size_t)(t0 + r) * Lp + pc * 8,
                       16);
        }
      }
      for (int idx = tid; idx < 2 * 16 * 8; idx += NTHREADS) {
        const int p = idx / 128, r = (idx / 8) % 16, pc = idx % 8;
        cp_async16(st + Ly::r_off(Lp) + (p * 16 + r) * ROW144 + pc * 16,
                   rb16 + p * rplane + (size_t)(t0 + r) * hd + f0 + pc * 8, 16);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < TC_STAGES - 1; ++c) fetch2(c);
  for (int c = 0; c < nc2; ++c) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();
    fetch2(c + TC_STAGES - 1);
    const uint32_t st = base + (c % TC_STAGES) * Ly::stage(Lp);
    const int t0 = 16 * c;
    if (mt_on[0] && m_base <= t0 + 15) {      // W[t, j] = 0 for j > t
      uint32_t awh[2][4], awl[2][4];
      bool on[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        on[mt] = mt_on[mt] && m_base + 16 * mt <= t0 + 15;
        if (on[mt]) {
          ldsm_x4_t(awh[mt], a_cols(st, rsb, m_base + 16 * mt, 0, mi, r8));
          ldsm_x4_t(awl[mt], a_cols(st + 16 * rsb, rsb, m_base + 16 * mt, 0, mi, r8));
        }
      }
      const uint32_t r_a = st + Ly::r_off(Lp);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t brh[4], brl[4];
        ldsm_x4_t(brh, b_cols(r_a, ROW144, 16 * np, 0, mi, r8));
        ldsm_x4_t(brl, b_cols(r_a + 16 * ROW144, ROW144, 16 * np, 0, mi, r8));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (on[mt]) {
            mma_bf16(acc[mt][2 * np], awh[mt], brh[0], brh[1]);
            mma_bf16(acc[mt][2 * np], awh[mt], brl[0], brl[1]);
            mma_bf16(acc[mt][2 * np], awl[mt], brh[0], brh[1]);
            mma_bf16(acc[mt][2 * np + 1], awh[mt], brh[2], brh[3]);
            mma_bf16(acc[mt][2 * np + 1], awh[mt], brl[2], brl[3]);
            mma_bf16(acc[mt][2 * np + 1], awl[mt], brh[2], brh[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = m_base + 16 * mt + grp + 8 * half;
      if (j < L) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          *reinterpret_cast<float2*>(dv + rowoff + (size_t)j * hd + f0 + 8 * nt + 2 * tig) =
              make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
    }
}

// Pass 4, bf16: a 64 x 64 tile (e, f) of dC_in = w_in dC_out + q^T ri,
// 32 rows t of q's and ri's columns a chunk (144-byte rows), four warps of
// 32 x 32.
constexpr int CI_THREADS = 128;
constexpr int CI_KC = 32;
constexpr int CI_STAGE = 3 * CI_KC * ROW144;     // q, ri hi, ri lo

__global__ void __launch_bounds__(CI_THREADS)
mlstm_bwd_dcin_tc_kernel(const __nv_bfloat16* __restrict__ q,
                         const float* __restrict__ dc_out,
                         const __nv_bfloat16* __restrict__ rr,
                         const float* __restrict__ w_in,
                         float* __restrict__ dc_in, int L, int hd) {
  using namespace mma_sm90;
  extern __shared__ __align__(128) unsigned char ci_smem[];
  const int Lp = (L + 15) / 16 * 16;
  const uint32_t base = smem_u32(ci_smem);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = lane >> 2, tig = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const int bh = blockIdx.y;
  const int ntile = hd / TE;
  const int e0 = (blockIdx.x / ntile) * TE, f0 = (blockIdx.x % ntile) * TE;
  const int we = warp >> 1, wf = warp & 1;
  const __nv_bfloat16* qb = q + (size_t)bh * L * hd;
  const __nv_bfloat16* rib = rr + (size_t)bh * 4 * Lp * hd + 2 * (size_t)Lp * hd;
  const size_t rplane = (size_t)Lp * hd;

  const int nchunks = (Lp + CI_KC - 1) / CI_KC;
  auto fetch = [&](int c) {
    if (c < nchunks) {
      const uint32_t st = base + (c % TC_STAGES) * CI_STAGE;
      for (int idx = tid; idx < 3 * CI_KC * 8; idx += CI_THREADS) {
        const int p = idx / (CI_KC * 8), r = (idx / 8) % CI_KC, pc = idx % 8;
        const int t = c * CI_KC + r;
        const bool in = t < L;
        const __nv_bfloat16* src = p == 0 ? qb + e0 : rib + (p - 1) * rplane + f0;
        cp_async16(st + (p * CI_KC + r) * ROW144 + pc * 16,
                   src + (size_t)(in ? t : 0) * hd + pc * 8, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < TC_STAGES - 1; ++c) fetch(c);

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();
    fetch(c + TC_STAGES - 1);
    const uint32_t st = base + (c % TC_STAGES) * CI_STAGE;
#pragma unroll
    for (int ks = 0; ks < CI_KC / 16; ++ks) {
      uint32_t aq[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4_t(aq[mt], a_cols(st, ROW144, 32 * we + 16 * mt, 16 * ks, mi, r8));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bh4[4], bl4[4];
        ldsm_x4_t(bh4, b_cols(st + CI_KC * ROW144, ROW144, 32 * wf + 16 * np, 16 * ks, mi, r8));
        ldsm_x4_t(bl4, b_cols(st + 2 * CI_KC * ROW144, ROW144, 32 * wf + 16 * np, 16 * ks, mi, r8));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], aq[mt], bh4[0], bh4[1]);
          mma_bf16(acc[mt][2 * np], aq[mt], bl4[0], bl4[1]);
          mma_bf16(acc[mt][2 * np + 1], aq[mt], bh4[2], bh4[3]);
          mma_bf16(acc[mt][2 * np + 1], aq[mt], bl4[2], bl4[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const float win = w_in[bh];
  const float* dcb = dc_out + (size_t)bh * hd * hd;
  float* out = dc_in + (size_t)bh * hd * hd;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int e = e0 + 32 * we + 16 * mt + grp + 8 * half;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const size_t o = (size_t)e * hd + f0 + 32 * wf + 8 * nt + 2 * tig;
        const float2 d = *reinterpret_cast<const float2*>(dcb + o);
        *reinterpret_cast<float2*>(out + o) =
            make_float2(fmaf(win, d.x, acc[mt][nt][2 * half]),
                        fmaf(win, d.y, acc[mt][nt][2 * half + 1]));
      }
    }
}

// ---------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  const float *i_raw, *f_raw, *c_in, *n_in, *m_in, *h, *dh, *dc_out, *dn_out;
  float *dq, *dk, *dv, *di, *df, *dc_in, *dn_in;
  float *dS, *Wm, *rows, *w_in, *colpart, *epart;
  __nv_bfloat16 *sw, *rr;
  int bh, L, hd;
  cudaStream_t stream;
};

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int E>
cudaError_t launch_all(const Args& a) {
  constexpr int SE = E + 1, SR = E + 4;
  const int L = a.L;
  const int n_rowblocks = (L + TT - 1) / TT;
  const int n_tiles = a.hd / E;

  auto k1 = mlstm_bwd_rows_kernel<T, E>;
  const size_t b1 =
      (3 * MAX_L + 3 * TT * SE + 2 * L * SE + E + 2 * TT) * sizeof(float);
  cudaError_t err = set_smem(k1, b1);
  if (err != cudaSuccess) return err;
  k1<<<dim3(n_rowblocks, a.bh), NTHREADS, b1, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.i_raw, a.f_raw, a.n_in, a.m_in, a.h,
      a.dh, a.dS, a.Wm, a.rows, a.w_in, a.colpart, L, a.hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto k2 = mlstm_bwd_state_kernel<T, E>;
  const size_t b2 = (2 * L * SR + 2 * L * SE + 2 * E * SE + 3 * L +
                     NTHREADS / 32) * sizeof(float);
  err = set_smem(k2, b2);
  if (err != cudaSuccess) return err;
  k2<<<dim3(n_tiles, a.bh), NTHREADS, b2, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.c_in, a.n_in, a.dh, a.dc_out, a.dn_out,
      a.dS, a.rows, a.w_in, a.dq, a.dk, a.dc_in, a.dn_in, a.epart, L, a.hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto k3 = mlstm_bwd_dv_kernel<T, E>;
  const size_t b3 = (L * SE + 2 * E * SE + E * L + 2 * L) * sizeof(float);
  err = set_smem(k3, b3);
  if (err != cudaSuccess) return err;
  k3<<<dim3(n_tiles, a.bh), NTHREADS, b3, a.stream>>>(
      static_cast<const T*>(a.k), a.dh, a.dc_out, a.Wm, a.rows, a.dv, L,
      a.hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  mlstm_bwd_gates_kernel<<<a.bh, NTHREADS, 0, a.stream>>>(
      a.f_raw, a.rows, a.w_in, a.colpart, a.epart, n_rowblocks, n_tiles,
      a.di, a.df, L);
  return cudaGetLastError();
}

// the bf16 route: rows, state, dv, dC_in, gates
cudaError_t launch_tc(const Args& a) {
  const int L = a.L, Lp = (L + 15) / 16 * 16;
  const int n_rowblocks = (L + TT - 1) / TT;
  const int n_tiles = a.hd / TE;
  const auto* q = static_cast<const __nv_bfloat16*>(a.q);
  const auto* k = static_cast<const __nv_bfloat16*>(a.k);
  const auto* v = static_cast<const __nv_bfloat16*>(a.v);

  size_t bytes = RowsTcLayout::bytes(Lp);
  cudaError_t err = set_smem(mlstm_bwd_rows_tc_kernel, bytes);
  if (err != cudaSuccess) return err;
  mlstm_bwd_rows_tc_kernel<<<dim3(n_rowblocks, a.bh), NTHREADS, bytes,
                             a.stream>>>(
      q, k, v, a.i_raw, a.f_raw, a.n_in, a.m_in, a.h, a.dh, a.sw, a.rr,
      a.rows, a.w_in, a.colpart, L, a.hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  bytes = StateTcLayout::bytes(Lp);
  err = set_smem(mlstm_bwd_state_tc_kernel, bytes);
  if (err != cudaSuccess) return err;
  mlstm_bwd_state_tc_kernel<<<dim3(n_tiles, a.bh), NTHREADS, bytes,
                              a.stream>>>(
      q, k, v, a.c_in, a.n_in, a.dc_out, a.dn_out, a.sw, a.rr, a.rows,
      a.w_in, a.dq, a.dk, a.dn_in, a.epart, L, a.hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  bytes = DvTcLayout::bytes(Lp);
  err = set_smem(mlstm_bwd_dv_tc_kernel, bytes);
  if (err != cudaSuccess) return err;
  mlstm_bwd_dv_tc_kernel<<<dim3(n_tiles, a.bh), NTHREADS, bytes, a.stream>>>(
      k, a.dc_out, a.sw, a.rr, a.rows, a.dv, L, a.hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  bytes = TC_STAGES * CI_STAGE;
  err = set_smem(mlstm_bwd_dcin_tc_kernel, bytes);
  if (err != cudaSuccess) return err;
  mlstm_bwd_dcin_tc_kernel<<<dim3(n_tiles * n_tiles, a.bh), CI_THREADS,
                             bytes, a.stream>>>(q, a.dc_out, a.rr, a.w_in,
                                                a.dc_in, L, a.hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  mlstm_bwd_gates_kernel<<<a.bh, NTHREADS, 0, a.stream>>>(
      a.f_raw, a.rows, a.w_in, a.colpart, a.epart, n_rowblocks, n_tiles,
      a.di, a.df, L);
  return cudaGetLastError();
}

// the fp32 route: fp32 at every hd, bf16 at hd 8 and 16 (bf16 at hd a
// multiple of 64 is launch_tc's)
template <typename T>
cudaError_t launch_dtype(const Args& a) {
  switch (a.hd) {
    case 8: return launch_all<T, 8>(a);
    case 16: return launch_all<T, 16>(a);
    default:
      if constexpr (std::is_same_v<T, float>) return launch_all<T, 32>(a);
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of q, k, v: 0 = float32, 1 = bfloat16; everything else is float32.
// hd is 8, 16, or a multiple of 64 up to 1024; 1 <= L <= 256.  Scratch the
// caller allocates (mlstm_scan.bwd_scratch_shapes), with Lp = L rounded up
// to 16 and T = hd / 64 on the bf16 route (bf16 at hd a multiple of 64),
// hd / min(hd, 32) on the fp32 route: rows (bh, 5, L), w_in (bh,),
// colpart (bh, ceil(L / 32), L), epart (bh, T, L + 1), all fp32; the fp32
// route also dS, Wm (bh, L, L) fp32 (sw, rr may be null), the bf16 route
// sw (bh, 4, Lp, Lp) and rr (bh, 4, Lp, hd) bf16 (dS, Wm may be null).
// Launches the passes on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int repro_mlstm_chunk_bwd(
    const void* q, const void* k, const void* v, const void* i_raw,
    const void* f_raw, const void* c_in, const void* n_in, const void* m_in,
    const void* h, const void* dh, const void* dc_out, const void* dn_out,
    void* dq, void* dk, void* dv, void* di, void* df, void* dc_in,
    void* dn_in, void* dS, void* Wm, void* rows, void* w_in,
    void* colpart, void* epart, void* sw, void* rr, int bh, int L, int hd,
    int dtype, void* stream) {
  const bool tiled = hd % 64 == 0 && hd >= 64 && hd <= 1024;
  if (bh <= 0 || bh > 65535 || L < 1 || L > MAX_L ||
      !(tiled || hd == 8 || hd == 16) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const bool tc = dtype == 1 && tiled;
  const void* ptrs[] = {q, k, v, i_raw, f_raw, c_in, n_in, m_in, h, dh,
                        dc_out, dn_out, dq, dk, dv, di, df, dc_in, dn_in,
                        rows, w_in, colpart, epart, tc ? sw : dS,
                        tc ? rr : Wm};
  for (const void* p : ptrs)
    if (p == nullptr) return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  auto b = [](void* p) { return static_cast<__nv_bfloat16*>(p); };
  const Args a{q, k, v, f(i_raw), f(f_raw), f(c_in), f(n_in), f(m_in),
               f(h), f(dh), f(dc_out), f(dn_out), o(dq), o(dk), o(dv),
               o(di), o(df), o(dc_in), o(dn_in), o(dS), o(Wm),
               o(rows), o(w_in), o(colpart), o(epart), b(sw), b(rr), bh, L,
               hd, static_cast<cudaStream_t>(stream)};
  if (tc) return (int)launch_tc(a);
  return (int)(dtype ? launch_dtype<__nv_bfloat16>(a) : launch_dtype<float>(a));
}
