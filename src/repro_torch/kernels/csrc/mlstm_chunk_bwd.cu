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
// five L^2 hd ones (q k^T and dh v^T again, dS k, dS^T q, W^T r), 45.1
// GFLOP, against ~0.3 GB (C_in and dC_out read, dC_in written, q, k, v,
// h, dh read, dq, dk, dv written): 0.09 ms of bytes, 0.05 ms at the bf16
// tensor-core rate, 0.67 ms at fp32's 67 TFLOP/s.  This route runs every
// product as fp32 FMAs on the CUDA cores, so it is held to the fp32 rate:
// operations-bound.
//
// C is 4 MB of fp32 a row at hd 1024 and a block has at most 227 KB of
// shared memory, so the hd^2 products cut C into tiles of 32, as the
// forward does; no sum crosses blocks by atomics.  Four passes:
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
// hd 8 and 16 run the same passes with tiles of hd.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

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
// launches
// ---------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  const float *i_raw, *f_raw, *c_in, *n_in, *m_in, *h, *dh, *dc_out, *dn_out;
  float *dq, *dk, *dv, *di, *df, *dc_in, *dn_in;
  float *dS, *Wm, *rows, *w_in, *colpart, *epart;
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

template <typename T>
cudaError_t launch_dtype(const Args& a) {
  switch (a.hd) {
    case 8: return launch_all<T, 8>(a);
    case 16: return launch_all<T, 16>(a);
    default: return launch_all<T, 32>(a);
  }
}

}  // namespace

// dtype of q, k, v: 0 = float32, 1 = bfloat16; everything else is float32.
// hd is 8, 16, or a multiple of 64 up to 1024; 1 <= L <= 256.  Scratch the
// caller allocates: dS, Wm (bh, L, L), rows (bh, 5, L), w_in (bh,),
// colpart (bh, ceil(L / 32), L), epart (bh, hd / min(hd, 32), L + 1).
// Launches the four passes on `stream` and returns cudaGetLastError()
// (0 on success).
extern "C" int repro_mlstm_chunk_bwd(
    const void* q, const void* k, const void* v, const void* i_raw,
    const void* f_raw, const void* c_in, const void* n_in, const void* m_in,
    const void* h, const void* dh, const void* dc_out, const void* dn_out,
    void* dq, void* dk, void* dv, void* di, void* df, void* dc_in,
    void* dn_in, void* dS, void* Wm, void* rows, void* w_in,
    void* colpart, void* epart, int bh, int L, int hd, int dtype,
    void* stream) {
  const bool tiled = hd % 64 == 0 && hd >= 64 && hd <= 1024;
  if (bh <= 0 || bh > 65535 || L < 1 || L > MAX_L ||
      !(tiled || hd == 8 || hd == 16) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {q, k, v, i_raw, f_raw, c_in, n_in, m_in, h, dh,
                        dc_out, dn_out, dq, dk, dv, di, df, dc_in, dn_in,
                        dS, Wm, rows, w_in, colpart, epart};
  for (const void* p : ptrs)
    if (p == nullptr) return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  const Args a{q, k, v, f(i_raw), f(f_raw), f(c_in), f(n_in), f(m_in),
               f(h), f(dh), f(dc_out), f(dn_out), o(dq), o(dk), o(dv),
               o(di), o(df), o(dc_in), o(dn_in), o(dS), o(Wm),
               o(rows), o(w_in), o(colpart), o(epart), bh, L, hd,
               static_cast<cudaStream_t>(stream)};
  return (int)(dtype ? launch_dtype<__nv_bfloat16>(a) : launch_dtype<float>(a));
}
