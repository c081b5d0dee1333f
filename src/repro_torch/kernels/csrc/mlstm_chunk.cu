// One stabilised chunkwise-mLSTM step per (batch*head), for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/mlstm_scan.py:mlstm_chunk_step
// (body _kernel).  Same contract, per row bh of B*H:
//   q, k, v (L, hd) in fp32 or bf16, k already scaled by hd^-0.5 (the
//   model scales it at projection; the TPU kernel is called with
//   scale=1.0 and so is this one: nothing is scaled here);
//   i_raw, f_raw (L,) fp32; carry c_in (hd, hd), n_in (hd,), m_in () fp32.
//   Out: h (L, hd), c_out (hd, hd), n_out (hd,), m_out () in fp32.
// It computes what src/repro/models/xlstm.py:mlstm_chunk computes:
//   logf = logsigmoid(f), b_t = sum_{r<=t} logf_r, a_t = i_t - b_t,
//   M_t = max(m_in, cummax(a)_t), D_tj = exp(a_j - M_t) for j <= t,
//   h_t = (sum_j (q_t.k_j) D_tj v_j + exp(m_in - M_t) q_t c_in) / den_t,
//   den_t = max(|q_t . n_t|, exp(-(b_t + M_t))),
//   n_t = sum_j D_tj k_j + exp(m_in - M_t) n_in,
//   m_l = b_L + M_L, w_in = exp(m_in - m_l + b_L), w_j = exp(a_j + b_L - m_l),
//   c_out = w_in c_in + sum_j w_j k_j v_j^T, n_out = w_in n_in + sum_j w_j k_j.
// exp and log1p are the precise expf/log1pf (no fast math): the first chunk
// carries m_in = -1e30 and padded steps i = -1e30, f = +30, whose
// exponentials must come out as exact 0 (or inf where the reference's do).
//
// What bounds it on an H100.  At the serving shape (B*H = 16, L = 16,
// hd = 1024, bf16 q/k/v) reading c_in and writing c_out move 2 x 64 MiB;
// with q, k, v, h that is ~137 MB against ~1.1 GFLOP: bytes-bound, ~41 us
// at 3.35 TB/s.  At L = 256 it is ~176 MB (~53 us) against ~24 GFLOP
// (~24 us at the bf16 tensor-core rate, but 0.36 ms at the 67 TFLOP/s of
// fp32 on the CUDA cores): bytes-bound only on the tensor cores.
//
// C (hd x hd) is 4 MB of fp32 per row at hd = 1024, and a block has at
// most 227 KB of shared memory, so every path cuts C into column tiles
// of TF columns, one block per (tile, row), and streams the tile once.
//
// Short chunks (L <= MAX_SHORT = 16, the served L): one pass,
// mlstm_short_kernel, grid (hd / 64, B*H) of 128 threads.  Every block
// rebuilds its row's gate scalars (a warp scan), then streams its 64
// columns of c_in in chunks of 32 rows through a 4-stage cp.async ring,
// with q's, k's and n_in's matching 32 columns beside each chunk, and
// uses each row e of C once for everything: thread (tx, te) holds v[:,
// 4 tx .. 4 tx + 3] and h's partial sums for every step in registers, so
// a row costs one 16-byte load of C, three broadcast rows (q, k, kw = k
// w_j, transposed per chunk) and 144 FMAs: h[:, f] += q[:, e] C[e, f];
// c_out[e, f] = w_in C[e, f] + sum_j kw[j, e] v[j, f], stored at once in
// 16 bytes; S[tx, :] += q[tx, e] k[:, e] and q . n_in (each block
// recomputes them: 0.26 M MACs at L = 16, from L2).  The 8 row groups'
// partials are added at the end; then W = S o D, den, and h = (inter h +
// W v) / den.  All fp32 on the CUDA cores, no new rounding.
//
// Long chunks, two passes:
//   1. mlstm_gates_kernel, grid (ceil(L/32), B*H): every block rebuilds
//      the gate scalars of its row (block scans for the cumsum and cummax)
//      and computes 32 rows of W = (q k^T) o D (the causal part only) into
//      scratch, with den_t from the row sums of W plus exp(m_in - M_t)
//      q_t . n_in.  Block 0 writes w_j, w_in and m_out.  For bf16 q, k
//      (mlstm_gates_tc_kernel) q k^T runs on the tensor cores: bf16
//      products are exact in fp32, so only the summation order moves.
//   2. bf16 q, k, v (the prefill's L = 256): mlstm_state_tc_kernel, grid
//      (hd / 64, B*H), eight warps; c_in streamed in chunks of 32 rows
//      through a 3-stage cp.async ring with q's and k's matching columns.
//      The three products run on the tensor cores (mma.sync m16n8k16,
//      fp32 accumulators): h += q C, c_out = w_in C + kw^T v with kw =
//      k w_j, and after the stream h = inter h + W v.  q and v are bf16
//      already; each fp32 operand (C, kw, W) is split into bf16 hi + lo
//      (x - hi is exact in fp32), two products accumulating in fp32, so
//      ~16 mantissa bits reach the fp32 side: the accuracy class of fp32
//      FMAs on C, where one bf16 rounding of the carried state would move
//      every later chunk.
//      fp32 q, k, v (and hd 8, 16): mlstm_state_kernel, one block per
//      column tile of 32, the same products as fp32 FMAs on CUDA cores.
// c_out never aliases c_in.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int NTHREADS = 256;  // also the largest chunk length L
constexpr int MAX_L = 256;
constexpr int TT = 32;         // rows of W per pass-1 block

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// log(sigmoid(x)) in its stable form
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

// Pass 1.  Shared memory, in floats: A, Bc, Mt (MAX_L each), Qs (TT x SE),
// Ks (L x SE), Ns (E), QN (TT).
template <typename T, int E>
__global__ void __launch_bounds__(NTHREADS)
mlstm_gates_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const float* __restrict__ i_raw,
                   const float* __restrict__ f_raw,
                   const float* __restrict__ n_in,
                   const float* __restrict__ m_in, float* __restrict__ W,
                   float* __restrict__ gates, float* __restrict__ w_in,
                   float* __restrict__ m_out, int L, int hd) {
  constexpr int SE = E + 1;
  extern __shared__ float smem[];
  float* A = smem;               // a_j = i_j - b_j
  float* Bc = A + MAX_L;         // b_t (scan buffer first)
  float* Mt = Bc + MAX_L;        // M_t (scan buffer first)
  float* Qs = Mt + MAX_L;
  float* Ks = Qs + TT * SE;
  float* Ns = Ks + L * SE;
  float* QN = Ns + E;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const float m0 = m_in[bh];

  // gate scalars of the whole chunk
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

  const float b_last = Bc[L - 1];
  const float m_l = b_last + Mt[L - 1];
  if (blockIdx.x == 0) {
    if (tid < L)
      gates[((size_t)bh * 3 + 2) * L + tid] = expf(A[tid] + b_last - m_l);
    if (tid == 0) {
      w_in[bh] = expf(m0 - m_l + b_last);
      m_out[bh] = m_l;
    }
  }

  // S = q k^T for rows t0 .. t0+TT-1 and the causal columns j < jmax.
  // Thread (ty, tx) owns rows ty + 8i and columns tx + 32jj.
  const int jmax = min(L, t0 + TT);
  const int ty = tid / 32, tx = tid % 32;
  const int njj = jmax > tx ? (jmax - tx + 31) / 32 : 0;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.f;
  float qn = 0.f;
  const T* qb = q + (size_t)bh * L * hd;
  const T* kb = k + (size_t)bh * L * hd;

  for (int e0 = 0; e0 < hd; e0 += E) {
    __syncthreads();  // the previous chunk is done with Qs, Ks, Ns
    for (int idx = tid; idx < TT * E; idx += NTHREADS) {
      const int r = idx / E, e = idx % E;
      const int t = t0 + r;
      Qs[r * SE + e] = t < L ? to_float(qb[(size_t)t * hd + e0 + e]) : 0.f;
    }
    for (int idx = tid; idx < jmax * E; idx += NTHREADS) {
      const int j = idx / E, e = idx % E;
      Ks[j * SE + e] = to_float(kb[(size_t)j * hd + e0 + e]);
    }
    if (tid < E) Ns[tid] = n_in[(size_t)bh * hd + e0 + tid];
    __syncthreads();
    if (tid < TT) {
#pragma unroll 8
      for (int e = 0; e < E; ++e) qn = fmaf(Qs[tid * SE + e], Ns[e], qn);
    }
#pragma unroll 4
    for (int e = 0; e < E; ++e) {
      float qa[4], kk[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 8 * i) * SE + e];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        kk[jj] = jj < njj ? Ks[(tx + 32 * jj) * SE + e] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          acc[i][jj] = fmaf(qa[i], kk[jj], acc[i][jj]);
    }
  }
  if (tid < TT) QN[tid] = qn;
  __syncthreads();

  // W = S o D (zero above the diagonal), and den from W's row sums
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 8 * i;
    const int t = t0 + r;
    float rowsum = 0.f;
    if (t < L) {
      const float m_t = Mt[t];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = tx + 32 * jj;
        if (j < L) {
          const float w = j <= t ? acc[i][jj] * expf(A[j] - m_t) : 0.f;
          W[((size_t)bh * L + t) * L + j] = w;
          rowsum += w;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      rowsum += __shfl_xor_sync(0xffffffffu, rowsum, off);
    if (tx == 0 && t < L) {
      const float m_t = Mt[t];
      const float inter = expf(m0 - m_t);
      const float den = fmaxf(fabsf(rowsum + inter * QN[r]),
                              expf(-(Bc[t] + m_t)));
      gates[((size_t)bh * 3 + 0) * L + t] = inter;
      gates[((size_t)bh * 3 + 1) * L + t] = den;
    }
  }
}

// Pass 2.  Shared memory, in floats: Vs (L x TF), Qs (L x SE, later the
// W chunk), Ks (L x SE, k scaled by w_j), Cs (E x TF), Inter, Den, Wj (L).
template <typename T, int E, int TF>
__global__ void __launch_bounds__(NTHREADS)
mlstm_state_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ c_in,
                   const float* __restrict__ n_in,
                   const float* __restrict__ W,
                   const float* __restrict__ gates,
                   const float* __restrict__ w_in, float* __restrict__ h,
                   float* __restrict__ c_out, float* __restrict__ n_out,
                   int L, int hd) {
  constexpr int SE = E + 1;
  constexpr int CPT = TF / 8;            // columns per thread
  constexpr int RPT = MAX_L / 32;        // rows per thread (h)
  extern __shared__ float smem[];
  float* Vs = smem;
  float* Qs = Vs + L * TF;
  float* Ks = Qs + L * SE;
  float* Cs = Ks + L * SE;
  float* Inter = Cs + E * TF;
  float* Den = Inter + L;
  float* Wj = Den + L;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int f0 = blockIdx.x * TF;
  const T* qb = q + (size_t)bh * L * hd;
  const T* kb = k + (size_t)bh * L * hd;
  const T* vb = v + (size_t)bh * L * hd;
  const float* cb = c_in + (size_t)bh * hd * hd;
  float* cob = c_out + (size_t)bh * hd * hd;
  const float win = w_in[bh];

  for (int idx = tid; idx < L * TF; idx += NTHREADS) {
    const int j = idx / TF, f = idx % TF;
    Vs[idx] = to_float(vb[(size_t)j * hd + f0 + f]);
  }
  for (int t = tid; t < L; t += NTHREADS) {
    Inter[t] = gates[((size_t)bh * 3 + 0) * L + t];
    Den[t] = gates[((size_t)bh * 3 + 1) * L + t];
    Wj[t] = gates[((size_t)bh * 3 + 2) * L + t];
  }

  // h: thread (ty, tx) owns rows ty + 32i and columns tx + 8c
  const int ty = tid / 8, tx = tid % 8;
  const int nri = L > ty ? (L - ty + 31) / 32 : 0;
  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  // c_out: thread (te, tx) owns row te of the chunk and columns tx + 8c
  const int te = tid / 8;

  for (int e0 = 0; e0 < hd; e0 += E) {
    __syncthreads();  // Vs/gates loaded; the previous chunk is done
    for (int idx = tid; idx < L * E; idx += NTHREADS) {
      const int j = idx / E, e = idx % E;
      Qs[j * SE + e] = to_float(qb[(size_t)j * hd + e0 + e]);
      Ks[j * SE + e] = to_float(kb[(size_t)j * hd + e0 + e]) * Wj[j];
    }
    for (int idx = tid; idx < E * TF; idx += NTHREADS) {
      const int e = idx / TF, f = idx % TF;
      Cs[idx] = cb[(size_t)(e0 + e) * hd + f0 + f];
    }
    __syncthreads();

    // inter-chunk term of h: q[:, chunk] c_in[chunk, tile]
#pragma unroll 4
    for (int e = 0; e < E; ++e) {
      float cc[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) cc[c] = Cs[e * TF + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        if (i < nri) {
          const float qv = Qs[(ty + 32 * i) * SE + e];
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(qv, cc[c], acc[i][c]);
        }
      }
    }

    // carry: c_out[chunk, tile] and, for tile 0, n_out[chunk]
    if (te < E) {
      float s[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) s[c] = 0.f;
#pragma unroll 4
      for (int j = 0; j < L; ++j) {
        const float kw = Ks[j * SE + te];
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          s[c] = fmaf(kw, Vs[j * TF + tx + 8 * c], s[c]);
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int f = tx + 8 * c;
        cob[(size_t)(e0 + te) * hd + f0 + f] = fmaf(win, Cs[te * TF + f], s[c]);
      }
    }
    if (blockIdx.x == 0 && tid < E) {
      float s = 0.f;
      for (int j = 0; j < L; ++j) s += Ks[j * SE + tid];
      const size_t o = (size_t)bh * hd + e0 + tid;
      n_out[o] = fmaf(win, n_in[o], s);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (i < nri) {
      const float it = Inter[ty + 32 * i];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= it;
    }
  }

  // intra-chunk term of h: W v[:, tile], W streamed in chunks of E columns
  for (int j0 = 0; j0 < L; j0 += E) {
    const int jn = min(E, L - j0);
    __syncthreads();  // Qs is free again
    for (int idx = tid; idx < L * E; idx += NTHREADS) {
      const int t = idx / E, jj = idx % E;
      Qs[t * SE + jj] = jj < jn ? W[((size_t)bh * L + t) * L + j0 + jj] : 0.f;
    }
    __syncthreads();
    for (int jj = 0; jj < jn; ++jj) {
      float vv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = Vs[(j0 + jj) * TF + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        if (i < nri) {
          const float w = Qs[(ty + 32 * i) * SE + jj];
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(w, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (i < nri) {
      const int t = ty + 32 * i;
      const float den = Den[t];
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        h[((size_t)bh * L + t) * hd + f0 + tx + 8 * c] = acc[i][c] / den;
    }
  }
}

// ---------------------------------------------------------------------
// Short chunks: one pass
// ---------------------------------------------------------------------

constexpr int MAX_SHORT = 16;  // the one-pass kernel's largest L
constexpr int S_TF = 64;       // columns of C per block
constexpr int S_EC = 32;       // rows of C per chunk
constexpr int S_STAGES = 4;    // chunks in flight
constexpr int S_THREADS = 128;
constexpr int S_TX = S_TF / 4;            // 16 column quads
constexpr int S_TE = S_THREADS / S_TX;    // 8 row groups
constexpr int S_TS = MAX_SHORT + 4;       // transposed rows, 80 bytes

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float4 load_f4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load_f4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Shared memory of the one-pass kernel, in bytes: the ring of chunks
// (C rows e0 .. e0 + 31 of the tile in fp32; q's and k's columns
// e0 .. e0 + 31 of every step; n_in's 32), the chunk's q, k and kw = k w_j
// transposed to (e, step) in fp32, and the gate scalars.  After the
// stream the ring holds the row groups' partial h, S and q . n_in.
template <typename T>
struct ShortLayout {
  static constexpr int QBYTES = MAX_SHORT * S_EC * (int)sizeof(T);
  static constexpr int STAGE = S_EC * S_TF * 4 + 2 * QBYTES + S_EC * 4;
  static constexpr int Q_OFF = S_EC * S_TF * 4;
  static constexpr int K_OFF = Q_OFF + QBYTES;
  static constexpr int N_OFF = K_OFF + QBYTES;
  static constexpr int T_OFF = S_STAGES * STAGE;        // QT, KT, KWT
  static constexpr int G_OFF = T_OFF + 3 * S_EC * S_TS * 4;
  static constexpr int BYTES = G_OFF + (8 * MAX_SHORT + MAX_SHORT * MAX_SHORT) * 4;
  static_assert(S_TE * MAX_SHORT * (S_TF + MAX_SHORT + 1) * 4 <= T_OFF,
                "the partials fit in the ring");
};

// Inclusive warp scan of x (sum, or max) over the lanes
template <bool MAX>
__device__ __forceinline__ float warp_scan(float x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x = MAX ? fmaxf(x, y) : x + y;
  }
  return x;
}

// Thread (tx, te) owns columns 4 tx .. 4 tx + 3 of the tile and the
// chunk rows te, te + 8, te + 16, te + 24: for each such row e it adds
// q[:, e] C[e, cols] to its h for every step (16 x 4 accumulators), and
// writes c_out[e, cols] from its v[:, cols] (held in registers) and
// kw[:, e]; it also sums S[tx, :] and q[tx] . n_in over its rows.  The
// eight row groups' partial h, S and q . n_in are added at the end.
template <typename T>
__global__ void __launch_bounds__(S_THREADS)
mlstm_short_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ i_raw,
                   const float* __restrict__ f_raw,
                   const float* __restrict__ c_in,
                   const float* __restrict__ n_in,
                   const float* __restrict__ m_in, float* __restrict__ h,
                   float* __restrict__ c_out, float* __restrict__ n_out,
                   float* __restrict__ m_out, int L, int hd) {
  using namespace mma_sm90;
  using Ly = ShortLayout<T>;
  constexpr int QP = S_EC * (int)sizeof(T) / 16;   // 16-byte pieces a q row
  extern __shared__ __align__(16) unsigned char short_smem[];
  float* QT = reinterpret_cast<float*>(short_smem + Ly::T_OFF);  // (EC, TS)
  float* KT = QT + S_EC * S_TS;
  float* KWT = KT + S_EC * S_TS;
  float* G = reinterpret_cast<float*>(short_smem + Ly::G_OFF);
  float* A = G;                     // a_j = i_j - b_j
  float* Bc = A + MAX_SHORT;        // b_t
  float* Mt = Bc + MAX_SHORT;       // M_t
  float* Wj = Mt + MAX_SHORT;       // w_j (0 past L)
  float* Inter = Wj + MAX_SHORT;    // exp(m_in - M_t)
  float* Den = Inter + MAX_SHORT;
  float* Ws = Den + 2 * MAX_SHORT;  // W (L x L), rows of MAX_SHORT

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = tid % S_TX, te = tid / S_TX;
  const int bh = blockIdx.y;
  const int f0 = blockIdx.x * S_TF, f4 = 4 * tx;
  const int nchunks = hd / S_EC;
  const T* qb = q + (size_t)bh * L * hd;
  const T* kb = k + (size_t)bh * L * hd;
  const T* vb = v + (size_t)bh * L * hd;
  const float* cb = c_in + (size_t)bh * hd * hd;
  float* cob = c_out + (size_t)bh * hd * hd;
  const float* nb = n_in + (size_t)bh * hd;
  const uint32_t base = smem_u32(short_smem);

  // chunk c into stage c % S_STAGES; a group is committed even past the
  // last chunk, so the wait count stays exact
  auto fetch = [&](int c) {
    if (c < nchunks) {
      const int e0 = c * S_EC;
      const uint32_t st = base + (c % S_STAGES) * Ly::STAGE;
      for (int idx = tid; idx < S_EC * S_TF / 4; idx += S_THREADS) {
        const int e = idx / (S_TF / 4), pc = idx % (S_TF / 4);
        cp_async16(st + (e * S_TF + pc * 4) * 4,
                   cb + (size_t)(e0 + e) * hd + f0 + pc * 4, 16);
      }
      for (int idx = tid; idx < 2 * L * QP; idx += S_THREADS) {
        const int which = idx / (L * QP), r = idx % (L * QP);
        const int t = r / QP, pc = r % QP;
        const T* src = (which ? kb : qb) + (size_t)t * hd + e0;
        cp_async16(st + (which ? Ly::K_OFF : Ly::Q_OFF) + t * S_EC * (int)sizeof(T) +
                       pc * 16,
                   reinterpret_cast<const unsigned char*>(src) + pc * 16, 16);
      }
      if (tid < S_EC / 4)
        cp_async16(st + Ly::N_OFF + tid * 16, nb + e0 + tid * 4, 16);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < S_STAGES - 1; ++c) fetch(c);

  // gate scalars of the chunk: warp 0, step t = lane
  const float m0 = m_in[bh];
  if (warp == 0) {
    const int t = lane;
    const float lf = t < L ? log_sigmoid(f_raw[(size_t)bh * L + t]) : 0.f;
    const float bsum = warp_scan<false>(lf, lane);
    const float a = t < L ? i_raw[(size_t)bh * L + t] - bsum : -INFINITY;
    const float amax = warp_scan<true>(a, lane);
    if (t < MAX_SHORT) {
      A[t] = a;
      Bc[t] = bsum;
      Mt[t] = fmaxf(m0, amax);
    }
  }
  // v[:, cols] in registers (zero past L)
  float vr[MAX_SHORT][4];
#pragma unroll
  for (int j = 0; j < MAX_SHORT; ++j) {
    const float4 x = j < L ? load_f4(vb + (size_t)j * hd + f0 + f4)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    vr[j][0] = x.x;
    vr[j][1] = x.y;
    vr[j][2] = x.z;
    vr[j][3] = x.w;
  }
  __syncthreads();
  const float b_last = Bc[L - 1];
  const float m_l = b_last + Mt[L - 1];
  const float win = expf(m0 - m_l + b_last);
  if (tid < MAX_SHORT) {
    Wj[tid] = tid < L ? expf(A[tid] + b_last - m_l) : 0.f;
    Inter[tid] = tid < L ? expf(m0 - Mt[tid]) : 0.f;
  }
  if (blockIdx.x == 0 && tid == 0) m_out[bh] = m_l;
  // (the loop's first barrier publishes Wj and Inter)

  float hacc[MAX_SHORT][4];
  float sacc[MAX_SHORT];
#pragma unroll
  for (int t = 0; t < MAX_SHORT; ++t) {
    hacc[t][0] = hacc[t][1] = hacc[t][2] = hacc[t][3] = 0.f;
    sacc[t] = 0.f;
  }
  float qn = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<S_STAGES - 2>();
    __syncthreads();       // chunk c is in; the transposes are free
    fetch(c + S_STAGES - 1);
    const int e0 = c * S_EC;
    const unsigned char* st = short_smem + (c % S_STAGES) * Ly::STAGE;
    const float* Cs = reinterpret_cast<const float*>(st);
    const T* Qs = reinterpret_cast<const T*>(st + Ly::Q_OFF);
    const T* Ks = reinterpret_cast<const T*>(st + Ly::K_OFF);
    const float* Ns = reinterpret_cast<const float*>(st + Ly::N_OFF);

    // q, k and kw = k w_j transposed to (e, step), zero past L
    for (int idx = tid; idx < S_EC * MAX_SHORT; idx += S_THREADS) {
      const int e = idx % S_EC, t = idx / S_EC;
      const float qv = t < L ? load_f(Qs + t * S_EC + e) : 0.f;
      const float kv = t < L ? load_f(Ks + t * S_EC + e) : 0.f;
      QT[e * S_TS + t] = qv;
      KT[e * S_TS + t] = kv;
      KWT[e * S_TS + t] = kv * Wj[t];
    }
    __syncthreads();
    if (blockIdx.x == 0 && tid < S_EC) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < MAX_SHORT; ++j) s += KWT[tid * S_TS + j];
      n_out[(size_t)bh * hd + e0 + tid] = fmaf(win, Ns[tid], s);
    }

#pragma unroll 1
    for (int r = 0; r < S_EC / S_TE; ++r) {
      const int e = te + S_TE * r;
      const float4 cc = *reinterpret_cast<const float4*>(Cs + e * S_TF + f4);
      const float* qe = QT + e * S_TS;
      const float* ke = KT + e * S_TS;
      const float* kwe = KWT + e * S_TS;
      float4 co = make_float4(0.f, 0.f, 0.f, 0.f);
      const float qt = qe[tx];
      qn = fmaf(qt, Ns[e], qn);
#pragma unroll
      for (int j4 = 0; j4 < MAX_SHORT / 4; ++j4) {
        const float4 qq = *reinterpret_cast<const float4*>(qe + 4 * j4);
        const float4 kk = *reinterpret_cast<const float4*>(ke + 4 * j4);
        const float4 kw = *reinterpret_cast<const float4*>(kwe + 4 * j4);
        const float qa[4] = {qq.x, qq.y, qq.z, qq.w};
        const float ka[4] = {kk.x, kk.y, kk.z, kk.w};
        const float wa[4] = {kw.x, kw.y, kw.z, kw.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = 4 * j4 + u;
          hacc[t][0] = fmaf(qa[u], cc.x, hacc[t][0]);
          hacc[t][1] = fmaf(qa[u], cc.y, hacc[t][1]);
          hacc[t][2] = fmaf(qa[u], cc.z, hacc[t][2]);
          hacc[t][3] = fmaf(qa[u], cc.w, hacc[t][3]);
          co.x = fmaf(wa[u], vr[t][0], co.x);
          co.y = fmaf(wa[u], vr[t][1], co.y);
          co.z = fmaf(wa[u], vr[t][2], co.z);
          co.w = fmaf(wa[u], vr[t][3], co.w);
          sacc[t] = fmaf(qt, ka[u], sacc[t]);
        }
      }
      *reinterpret_cast<float4*>(cob + (size_t)(e0 + e) * hd + f0 + f4) =
          make_float4(fmaf(win, cc.x, co.x), fmaf(win, cc.y, co.y),
                      fmaf(win, cc.z, co.z), fmaf(win, cc.w, co.w));
    }
  }
  cp_async_wait<0>();
  __syncthreads();         // the ring is done with: it takes the partials

  // partials of row group te: h (steps x 64 columns), S (steps x steps),
  // q . n_in (steps)
  float* Hp = reinterpret_cast<float*>(short_smem);
  float* Sp = Hp + S_TE * MAX_SHORT * S_TF;
  float* Qp = Sp + S_TE * MAX_SHORT * MAX_SHORT;
#pragma unroll
  for (int t = 0; t < MAX_SHORT; ++t) {
    *reinterpret_cast<float4*>(Hp + (te * MAX_SHORT + t) * S_TF + f4) =
        make_float4(hacc[t][0], hacc[t][1], hacc[t][2], hacc[t][3]);
    Sp[(te * MAX_SHORT + tx) * MAX_SHORT + t] = sacc[t];
  }
  Qp[te * MAX_SHORT + tx] = qn;
  __syncthreads();
  // W = S o D (zero above the diagonal) and den from W's row sums
  if (tid < L) {
    const int t = tid;
    const float m_t = Mt[t];
    float qnt = 0.f;
#pragma unroll
    for (int g = 0; g < S_TE; ++g) qnt += Qp[g * MAX_SHORT + t];
    float rowsum = 0.f;
    for (int j = 0; j < MAX_SHORT; ++j) {
      float sv = 0.f;
#pragma unroll
      for (int g = 0; g < S_TE; ++g) sv += Sp[(g * MAX_SHORT + t) * MAX_SHORT + j];
      const float w = j <= t ? sv * expf(A[j] - m_t) : 0.f;
      Ws[t * MAX_SHORT + j] = w;
      rowsum += w;
    }
    Den[t] = fmaxf(fabsf(rowsum + Inter[t] * qnt), expf(-(Bc[t] + m_t)));
  }
  __syncthreads();

  // h = (inter * q C + W v) / den for steps te and te + 8
#pragma unroll
  for (int half = 0; half < MAX_SHORT / S_TE; ++half) {
    const int t = te + S_TE * half;
    if (t < L) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int g = 0; g < S_TE; ++g) {
        const float4 x = *reinterpret_cast<const float4*>(Hp + (g * MAX_SHORT + t) * S_TF + f4);
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
      }
      const float it = Inter[t];
      acc = make_float4(acc.x * it, acc.y * it, acc.z * it, acc.w * it);
#pragma unroll
      for (int j = 0; j < MAX_SHORT; ++j) {
        const float w = Ws[t * MAX_SHORT + j];
        acc.x = fmaf(w, vr[j][0], acc.x);
        acc.y = fmaf(w, vr[j][1], acc.y);
        acc.z = fmaf(w, vr[j][2], acc.z);
        acc.w = fmaf(w, vr[j][3], acc.w);
      }
      const float den = Den[t];
      *reinterpret_cast<float4*>(h + ((size_t)bh * L + t) * hd + f0 + f4) =
          make_float4(acc.x / den, acc.y / den, acc.z / den, acc.w / den);
    }
  }
}

// ---------------------------------------------------------------------
// Long chunks in bf16: the state pass on the tensor cores
// ---------------------------------------------------------------------

// Pass 1 for bf16 q, k: as mlstm_gates_kernel, with S = q k^T for the
// block's 32 rows on the tensor cores (bf16 products are exact in fp32,
// so only the fp32 summation order differs) from a 2-stage cp.async ring
// of 64-column slices of q and k.  Eight warps; warp w owns key columns
// 16 w .. 16 w + 15 and 16 (w + 8) .. of both 16-row tiles.  W is written
// on and below the diagonal only (the state pass reads no more).
constexpr int G_EK = 64;                  // hd columns per slice
constexpr int G_ROW = G_EK * 2 + 16;      // 144-byte smem rows

__global__ void __launch_bounds__(NTHREADS)
mlstm_gates_tc_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const float* __restrict__ i_raw,
                      const float* __restrict__ f_raw,
                      const float* __restrict__ n_in,
                      const float* __restrict__ m_in, float* __restrict__ W,
                      float* __restrict__ gates, float* __restrict__ w_in,
                      float* __restrict__ m_out, int L, int hd) {
  using namespace mma_sm90;
  extern __shared__ __align__(128) unsigned char gates_smem[];
  float* A = reinterpret_cast<float*>(gates_smem);   // a_j = i_j - b_j
  float* Bc = A + MAX_L;         // b_t (scan buffer first)
  float* Mt = Bc + MAX_L;        // M_t (scan buffer first)
  float* QN = Mt + MAX_L;        // (TT,)
  float* RS = QN + TT;           // row sums of W, (TT, 8 warps)
  const int ring_off = (3 * MAX_L + TT + TT * 8) * 4;
  const int t0 = blockIdx.x * TT;
  const int jmax = min(L, t0 + TT);
  const int jrows = (jmax + 15) / 16 * 16;
  const int stage_bytes = (TT + jrows) * G_ROW;
  const uint32_t ring = smem_u32(gates_smem) + ring_off;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = lane >> 2, tig = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const int bh = blockIdx.y;
  const float m0 = m_in[bh];
  const __nv_bfloat16* qb = q + (size_t)bh * L * hd;
  const __nv_bfloat16* kb = k + (size_t)bh * L * hd;
  const int nslices = hd / G_EK;

  // slice c: q rows t0 .. t0 + 31 and k rows 0 .. jrows - 1, hd columns
  // 64 c .. 64 c + 63; rows past L are zero-filled
  auto fetch = [&](int c) {
    if (c < nslices) {
      const uint32_t st = ring + (c % 2) * stage_bytes;
      for (int idx = tid; idx < (TT + jrows) * (G_EK / 8); idx += NTHREADS) {
        const int r = idx / (G_EK / 8), pc = idx % (G_EK / 8);
        const bool is_q = r < TT;
        const int t = is_q ? t0 + r : r - TT;
        const bool in = t < L;
        const __nv_bfloat16* src =
            (is_q ? qb : kb) + (size_t)(in ? t : 0) * hd + c * G_EK + pc * 8;
        cp_async16(st + r * G_ROW + pc * 16, src, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  fetch(0);

  // gate scalars of the whole chunk
  const int t = tid;
  Bc[t] = t < L ? log_sigmoid(f_raw[(size_t)bh * L + t]) : 0.f;
  __syncthreads();
  block_scan<false>(Bc, tid);
  const float a = t < L ? i_raw[(size_t)bh * L + t] - Bc[t] : -INFINITY;
  A[t] = a;
  Mt[t] = a;
  __syncthreads();
  block_scan<true>(Mt, tid);
  Mt[t] = fmaxf(m0, Mt[t]);
  // q_t . n_in for the block's rows, fp32: 8 lanes a row
  {
    const int r = tid / 8, part = tid % 8;
    float qn = 0.f;
    if (t0 + r < L) {
      const __nv_bfloat16* qr = qb + (size_t)(t0 + r) * hd;
      const float* nr = n_in + (size_t)bh * hd;
      for (int e = part; e < hd; e += 8)
        qn = fmaf(__bfloat162float(qr[e]), nr[e], qn);
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      qn += __shfl_xor_sync(0xffffffffu, qn, off);
    if (part == 0) QN[r] = qn;
  }
  __syncthreads();

  const float b_last = Bc[L - 1];
  const float m_l = b_last + Mt[L - 1];
  if (blockIdx.x == 0) {
    if (tid < L)
      gates[((size_t)bh * 3 + 2) * L + tid] = expf(A[tid] + b_last - m_l);
    if (tid == 0) {
      w_in[bh] = expf(m0 - m_l + b_last);
      m_out[bh] = m_l;
    }
  }

  // S for rows t0 + 16 mt + .., key columns 16 np + .. (np = warp, warp + 8)
  float acc[2][2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int y = 0; y < 2; ++y)
        acc[mt][x][y][0] = acc[mt][x][y][1] = acc[mt][x][y][2] = acc[mt][x][y][3] = 0.f;
  const bool np_on[2] = {16 * warp < jrows, 16 * (warp + 8) < jrows};
  for (int c = 0; c < nslices; ++c) {
    __syncthreads();          // slice c - 1 is done with: its stage refills
    fetch(c + 1);
    cp_async_wait<1>();
    __syncthreads();          // slice c is in
    const uint32_t st = ring + (c % 2) * stage_bytes;
    if (np_on[0]) {
#pragma unroll
      for (int ks = 0; ks < G_EK / 16; ++ks) {
        uint32_t qa[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldsm_x4(qa[mt], st + (16 * mt + 8 * (mi & 1) + r8) * G_ROW +
                              (2 * ks + (mi >> 1)) * 16);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          if (np_on[x]) {
            const int np = warp + 8 * x;
            uint32_t bk[4];
            ldsm_x4(bk, st + (TT + 16 * np + 8 * (mi >> 1) + r8) * G_ROW +
                            (2 * ks + (mi & 1)) * 16);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_bf16(acc[mt][x][0], qa[mt], bk[0], bk[1]);
              mma_bf16(acc[mt][x][1], qa[mt], bk[2], bk[3]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // W = S o D on and below the diagonal, and its row sums
  float rs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int tt = t0 + 16 * mt + grp + 8 * half;
      if (tt >= L) continue;
      const float m_t = Mt[tt];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        if (!np_on[x]) continue;
#pragma unroll
        for (int y = 0; y < 2; ++y) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int j = 16 * (warp + 8 * x) + 8 * y + 2 * tig + u;
            if (j <= tt) {
              const float w = acc[mt][x][y][2 * half + u] * expf(A[j] - m_t);
              W[((size_t)bh * L + tt) * L + j] = w;
              rs[mt][half] += w;
            }
          }
        }
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
    gates[((size_t)bh * 3 + 0) * L + tt] = inter;
    gates[((size_t)bh * 3 + 1) * L + tt] =
        fmaxf(fabsf(rowsum + inter * QN[tid]), expf(-(Bc[tt] + m_t)));
  }
}

constexpr int T_TF = 64;        // columns of C per block
constexpr int T_EC = 32;        // rows of C per chunk (and j per W chunk)
constexpr int T_WARPS = NTHREADS / 32;
constexpr int T_STAGES = 3;     // chunks of C, q, k in flight

// Shared memory, in bytes, for Lp = L rounded up to 16: a T_STAGES ring of
// (C chunk fp32, q columns bf16 with rows padded to 80 bytes, k columns
// bf16); C's chunk split into hi / lo bf16 (rows padded to 144 bytes);
// kw = k w_j split into hi / lo (later W's chunk); v's tile; the gates.
// Row paddings put the 8 rows of every ldmatrix phase in 8 bank groups.
struct TcLayout {
  static constexpr int QROW = T_EC * 2 + 16;     // 80
  static constexpr int CROW = T_TF * 2 + 16;     // 144
  __host__ __device__ static int stage(int Lp) {
    return T_EC * T_TF * 4 + Lp * QROW + Lp * T_EC * 2;
  }
  __host__ __device__ static int q_off(int) { return T_EC * T_TF * 4; }
  __host__ __device__ static int k_off(int Lp) { return q_off(Lp) + Lp * QROW; }
  __host__ __device__ static int chi_off(int Lp) { return T_STAGES * stage(Lp); }
  __host__ __device__ static int clo_off(int Lp) { return chi_off(Lp) + T_EC * CROW; }
  __host__ __device__ static int kwhi_off(int Lp) { return clo_off(Lp) + T_EC * CROW; }
  __host__ __device__ static int kwlo_off(int Lp) { return kwhi_off(Lp) + Lp * QROW; }
  __host__ __device__ static int v_off(int Lp) { return kwlo_off(Lp) + Lp * QROW; }
  __host__ __device__ static int g_off(int Lp) { return v_off(Lp) + Lp * CROW; }
  __host__ __device__ static int bytes(int Lp) {
    return g_off(Lp) + (3 * MAX_L + T_WARPS * T_EC) * 4;
  }
};

__global__ void __launch_bounds__(NTHREADS, 1)
mlstm_state_tc_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const float* __restrict__ c_in,
                      const float* __restrict__ n_in,
                      const float* __restrict__ W,
                      const float* __restrict__ gates,
                      const float* __restrict__ w_in, float* __restrict__ h,
                      float* __restrict__ c_out, float* __restrict__ n_out,
                      int L, int hd) {
  using namespace mma_sm90;
  using Ly = TcLayout;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const int Lp = (L + 15) / 16 * 16;
  float* Inter = reinterpret_cast<float*>(tc_smem + Ly::g_off(Lp));
  float* Den = Inter + MAX_L;
  float* Wj = Den + MAX_L;
  float* Npart = Wj + MAX_L;                  // (T_WARPS, T_EC)
  __nv_bfloat16* Chi = reinterpret_cast<__nv_bfloat16*>(tc_smem + Ly::chi_off(Lp));
  __nv_bfloat16* Clo = reinterpret_cast<__nv_bfloat16*>(tc_smem + Ly::clo_off(Lp));
  __nv_bfloat16* KWhi = reinterpret_cast<__nv_bfloat16*>(tc_smem + Ly::kwhi_off(Lp));
  __nv_bfloat16* KWlo = reinterpret_cast<__nv_bfloat16*>(tc_smem + Ly::kwlo_off(Lp));
  const uint32_t base = smem_u32(tc_smem);
  const uint32_t chi_a = base + Ly::chi_off(Lp), clo_a = base + Ly::clo_off(Lp);
  const uint32_t kwhi_a = base + Ly::kwhi_off(Lp), kwlo_a = base + Ly::kwlo_off(Lp);
  const uint32_t v_a = base + Ly::v_off(Lp);
  constexpr int QE = Ly::QROW / 2, CE = Ly::CROW / 2;   // row strides, bf16

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = lane >> 2, tig = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const int bh = blockIdx.y;
  const int f0 = blockIdx.x * T_TF;
  const int nchunks = hd / T_EC;
  const __nv_bfloat16* qb = q + (size_t)bh * L * hd;
  const __nv_bfloat16* kb = k + (size_t)bh * L * hd;
  const __nv_bfloat16* vb = v + (size_t)bh * L * hd;
  const float* cb = c_in + (size_t)bh * hd * hd;
  float* cob = c_out + (size_t)bh * hd * hd;
  const float win = w_in[bh];

  // v's tile (rows >= L zero) and the gates, in the first group
  for (int idx = tid; idx < Lp * (T_TF / 8); idx += NTHREADS) {
    const int j = idx / (T_TF / 8), pc = idx % (T_TF / 8);
    const bool in = j < L;
    cp_async16(v_a + j * Ly::CROW + pc * 16,
               vb + (size_t)(in ? j : 0) * hd + f0 + pc * 8, in ? 16 : 0);
  }
  for (int t = tid; t < L; t += NTHREADS) {
    Inter[t] = gates[((size_t)bh * 3 + 0) * L + t];
    Den[t] = gates[((size_t)bh * 3 + 1) * L + t];
    Wj[t] = gates[((size_t)bh * 3 + 2) * L + t];
  }
  auto fetch = [&](int c) {
    if (c < nchunks) {
      const int e0 = c * T_EC;
      const uint32_t st = base + (c % T_STAGES) * Ly::stage(Lp);
      for (int idx = tid; idx < T_EC * T_TF / 4; idx += NTHREADS) {
        const int e = idx / (T_TF / 4), pc = idx % (T_TF / 4);
        cp_async16(st + (e * T_TF + pc * 4) * 4,
                   cb + (size_t)(e0 + e) * hd + f0 + pc * 4, 16);
      }
      // q rows >= L zero-filled; k rows >= L are never read
      for (int idx = tid; idx < Lp * 4 + L * 4; idx += NTHREADS) {
        const bool is_k = idx >= Lp * 4;
        const int r = is_k ? idx - Lp * 4 : idx;
        const int t = r / 4, pc = r % 4;
        const bool in = t < L;
        const __nv_bfloat16* src = (is_k ? kb : qb) + (size_t)(in ? t : 0) * hd + e0 + pc * 8;
        const uint32_t dst = is_k ? st + Ly::k_off(Lp) + t * T_EC * 2 + pc * 16
                                  : st + Ly::q_off(Lp) + t * Ly::QROW + pc * 16;
        cp_async16(dst, src, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < T_STAGES - 1; ++c) fetch(c);

  // h accumulators: rows 32 warp + 16 mt, all 8 n8 tiles of the 64 columns
  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
  const int m_base = 32 * warp;
  const bool mt_on[2] = {m_base < L, m_base + 16 < L};
  // c_out tile of this warp: rows 16 (warp % 2) of the chunk, n8 tiles
  // 2 (warp / 2) and 2 (warp / 2) + 1
  const int cmt = warp & 1, cnp = warp >> 1;

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<T_STAGES - 2>();
    __syncthreads();          // chunk c is in; chunk c - 1 is done with
    fetch(c + T_STAGES - 1);
    const int e0 = c * T_EC;
    const unsigned char* st = tc_smem + (c % T_STAGES) * Ly::stage(Lp);
    const float* Cs = reinterpret_cast<const float*>(st);
    const __nv_bfloat16* Kr = reinterpret_cast<const __nv_bfloat16*>(st + Ly::k_off(Lp));
    const uint32_t q_a = base + (c % T_STAGES) * Ly::stage(Lp) + Ly::q_off(Lp);

    // split C's chunk: thread -> row tid / 8, columns 8 (tid % 8) ..
    {
      const int e = tid / 8, f = (tid % 8) * 8;
      const float4 c0 = *reinterpret_cast<const float4*>(Cs + e * T_TF + f);
      const float4 c1 = *reinterpret_cast<const float4*>(Cs + e * T_TF + f + 4);
      const float x[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      split8(x, *reinterpret_cast<uint4*>(Chi + e * CE + f),
             *reinterpret_cast<uint4*>(Clo + e * CE + f));
    }
    // kw = k w_j, split: thread -> rows j = idx / 4, columns 8 (tid % 4) ..
    // (idx = tid + 256 i); its fp32 sums over those rows are its share of
    // n_out
    float ns[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int idx = tid; idx < Lp * 4; idx += NTHREADS) {
      const int j = idx >> 2, e8 = (idx & 3) * 8;
      float kw[8];
      if (j < L) {
        const uint4 raw = *reinterpret_cast<const uint4*>(Kr + j * T_EC + e8);
        const __nv_bfloat162* kp = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float wj = Wj[j];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float2 kf = __bfloat1622float2(kp[x]);
          kw[2 * x] = kf.x * wj;
          kw[2 * x + 1] = kf.y * wj;
        }
      } else {
#pragma unroll
        for (int x = 0; x < 8; ++x) kw[x] = 0.f;
      }
#pragma unroll
      for (int x = 0; x < 8; ++x) ns[x] += kw[x];
      split8(kw, *reinterpret_cast<uint4*>(KWhi + j * QE + e8),
             *reinterpret_cast<uint4*>(KWlo + j * QE + e8));
    }
    if (blockIdx.x == 0) {
      // lanes l, l ^ 4, l ^ 8, ... hold the same columns
#pragma unroll
      for (int x = 0; x < 8; ++x) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          ns[x] += __shfl_xor_sync(0xffffffffu, ns[x], off);
      }
      if (lane < 4) {
#pragma unroll
        for (int x = 0; x < 8; ++x) Npart[warp * T_EC + lane * 8 + x] = ns[x];
      }
    }
    __syncthreads();

    // h += q[:, chunk] (C_hi + C_lo)[chunk, tile]
#pragma unroll
    for (int ks = 0; ks < T_EC / 16; ++ks) {
      uint32_t qa[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        if (mt_on[mt])
          ldsm_x4(qa[mt], q_a + (m_base + 16 * mt + 8 * (mi & 1) + r8) * Ly::QROW +
                              (2 * ks + (mi >> 1)) * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const uint32_t off = (16 * ks + 8 * (mi & 1) + r8) * Ly::CROW + (2 * np + (mi >> 1)) * 16;
        uint32_t bh4[4], bl4[4];
        ldsm_x4_t(bh4, chi_a + off);
        ldsm_x4_t(bl4, clo_a + off);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (mt_on[mt]) {
            mma_bf16(acc[mt][2 * np], qa[mt], bh4[0], bh4[1]);
            mma_bf16(acc[mt][2 * np], qa[mt], bl4[0], bl4[1]);
            mma_bf16(acc[mt][2 * np + 1], qa[mt], bh4[2], bh4[3]);
            mma_bf16(acc[mt][2 * np + 1], qa[mt], bl4[2], bl4[3]);
          }
        }
      }
    }

    // c_out[chunk, tile] = w_in C + (kw_hi + kw_lo)^T v
    // hi and lo products in separate accumulators: four independent chains
    float co[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float cl[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int kj = 0; kj < Lp / 16; ++kj) {
      // A = kw^T from kw (j rows, e columns) by .trans: matrix mi holds
      // j 16 kj + 8 (mi / 2) + r8, e chunk 2 cmt + mi % 2
      const uint32_t aoff = (16 * kj + 8 * (mi >> 1) + r8) * Ly::QROW + (2 * cmt + (mi & 1)) * 16;
      uint32_t ah[4], al[4], bv[4];
      ldsm_x4_t(ah, kwhi_a + aoff);
      ldsm_x4_t(al, kwlo_a + aoff);
      ldsm_x4_t(bv, v_a + (16 * kj + 8 * (mi & 1) + r8) * Ly::CROW + (2 * cnp + (mi >> 1)) * 16);
      mma_bf16(co[0], ah, bv[0], bv[1]);
      mma_bf16(cl[0], al, bv[0], bv[1]);
      mma_bf16(co[1], ah, bv[2], bv[3]);
      mma_bf16(cl[1], al, bv[2], bv[3]);
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int f = 8 * (2 * cnp + x) + 2 * tig;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int e = 16 * cmt + grp + 8 * half;
        const float2 cc = *reinterpret_cast<const float2*>(Cs + e * T_TF + f);
        *reinterpret_cast<float2*>(cob + (size_t)(e0 + e) * hd + f0 + f) =
            make_float2(fmaf(win, cc.x, co[x][2 * half] + cl[x][2 * half]),
                        fmaf(win, cc.y, co[x][2 * half + 1] + cl[x][2 * half + 1]));
      }
    }
    if (blockIdx.x == 0 && tid < T_EC) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < T_WARPS; ++w) s += Npart[w * T_EC + tid];
      const size_t o = (size_t)bh * hd + e0 + tid;
      n_out[o] = fmaf(win, n_in[o], s);
    }
  }
  cp_async_wait<0>();

  // h = inter h + (W_hi + W_lo) v, W streamed in chunks of 32 columns
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = m_base + 16 * mt + grp + 8 * half;
      const float it = t < L ? Inter[t] : 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[mt][nt][2 * half] *= it;
        acc[mt][nt][2 * half + 1] *= it;
      }
    }
  }
  const float* wb = W + (size_t)bh * L * L;
  for (int j0 = 0; j0 < Lp; j0 += T_EC) {
    __syncthreads();          // kw (then the last W chunk) is done with
    // thread -> column jj = lane of rows t = warp + 8 u: all its loads
    // in flight at once
    {
      float w[MAX_L / T_WARPS];
#pragma unroll
      for (int u = 0; u < MAX_L / T_WARPS; ++u) {
        const int t = warp + T_WARPS * u, j = j0 + lane;
        w[u] = t < L && j <= t ? wb[(size_t)t * L + j] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < MAX_L / T_WARPS; ++u) {
        const int t = warp + T_WARPS * u;
        if (t < Lp) split_bf16(w[u], KWhi[t * QE + lane], KWlo[t * QE + lane]);
      }
    }
    __syncthreads();
    if (j0 > m_base + 31) continue;   // above this warp's diagonal: W is 0
#pragma unroll
    for (int ks = 0; ks < T_EC / 16; ++ks) {
      if (j0 + 16 * ks >= Lp) break;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt_on[mt]) {
          const uint32_t aoff = (m_base + 16 * mt + 8 * (mi & 1) + r8) * Ly::QROW + (2 * ks + (mi >> 1)) * 16;
          ldsm_x4(ah[mt], kwhi_a + aoff);
          ldsm_x4(al[mt], kwlo_a + aoff);
        }
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bv[4];
        ldsm_x4_t(bv, v_a + (j0 + 16 * ks + 8 * (mi & 1) + r8) * Ly::CROW + (2 * np + (mi >> 1)) * 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (mt_on[mt]) {
            mma_bf16(acc[mt][2 * np], ah[mt], bv[0], bv[1]);
            mma_bf16(acc[mt][2 * np], al[mt], bv[0], bv[1]);
            mma_bf16(acc[mt][2 * np + 1], ah[mt], bv[2], bv[3]);
            mma_bf16(acc[mt][2 * np + 1], al[mt], bv[2], bv[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = m_base + 16 * mt + grp + 8 * half;
      if (t < L) {
        const float den = Den[t];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          *reinterpret_cast<float2*>(h + ((size_t)bh * L + t) * hd + f0 + 8 * nt + 2 * tig) =
              make_float2(acc[mt][nt][2 * half] / den, acc[mt][nt][2 * half + 1] / den);
      }
    }
  }
}

// ---------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  const float *i_raw, *f_raw, *c_in, *n_in, *m_in;
  float *h, *c_out, *n_out, *m_out, *W, *gates, *w_in;
  int bh, L, hd;
  cudaStream_t stream;
};

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
cudaError_t launch_short(const Args& a) {
  auto kern = mlstm_short_kernel<T>;
  const size_t bytes = ShortLayout<T>::BYTES;
  cudaError_t err = set_smem(kern, bytes);
  if (err != cudaSuccess) return err;
  kern<<<dim3(a.hd / S_TF, a.bh), S_THREADS, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.i_raw, a.f_raw, a.c_in, a.n_in, a.m_in,
      a.h, a.c_out, a.n_out, a.m_out, a.L, a.hd);
  return cudaGetLastError();
}

template <typename T, int E>
cudaError_t launch_gates(const Args& a) {
  auto gk = mlstm_gates_kernel<T, E>;
  const size_t bytes =
      (3 * MAX_L + TT * (E + 1) + a.L * (E + 1) + E + TT) * sizeof(float);
  cudaError_t err = set_smem(gk, bytes);
  if (err != cudaSuccess) return err;
  gk<<<dim3((a.L + TT - 1) / TT, a.bh), NTHREADS, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), a.i_raw,
      a.f_raw, a.n_in, a.m_in, a.W, a.gates, a.w_in, a.m_out, a.L, a.hd);
  return cudaGetLastError();
}

template <typename T, int E, int TF>
cudaError_t launch_state(const Args& a) {
  auto sk = mlstm_state_kernel<T, E, TF>;
  const size_t bytes =
      (a.L * TF + 2 * a.L * (E + 1) + E * TF + 3 * a.L) * sizeof(float);
  cudaError_t err = set_smem(sk, bytes);
  if (err != cudaSuccess) return err;
  sk<<<dim3(a.hd / TF, a.bh), NTHREADS, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.c_in, a.n_in, a.W, a.gates, a.w_in, a.h,
      a.c_out, a.n_out, a.L, a.hd);
  return cudaGetLastError();
}

cudaError_t launch_gates_tc(const Args& a) {
  const int jrows = (a.L + 15) / 16 * 16;       // the largest block's
  const size_t bytes = (3 * MAX_L + TT + TT * 8) * 4 + 2 * (TT + jrows) * G_ROW;
  cudaError_t err = set_smem(mlstm_gates_tc_kernel, bytes);
  if (err != cudaSuccess) return err;
  mlstm_gates_tc_kernel<<<dim3((a.L + TT - 1) / TT, a.bh), NTHREADS, bytes,
                          a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k), a.i_raw, a.f_raw, a.n_in,
      a.m_in, a.W, a.gates, a.w_in, a.m_out, a.L, a.hd);
  return cudaGetLastError();
}

cudaError_t launch_state_tc(const Args& a) {
  const size_t bytes = TcLayout::bytes((a.L + 15) / 16 * 16);
  cudaError_t err = set_smem(mlstm_state_tc_kernel, bytes);
  if (err != cudaSuccess) return err;
  mlstm_state_tc_kernel<<<dim3(a.hd / T_TF, a.bh), NTHREADS, bytes, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.c_in, a.n_in, a.W, a.gates,
      a.w_in, a.h, a.c_out, a.n_out, a.L, a.hd);
  return cudaGetLastError();
}

// the two-pass path, on CUDA cores (fp32, or hd 8 / 16)
template <typename T>
cudaError_t launch_two_pass(const Args& a) {
  cudaError_t err;
  switch (a.hd) {
    case 8:
      err = launch_gates<T, 8>(a);
      return err != cudaSuccess ? err : launch_state<T, 8, 8>(a);
    case 16:
      err = launch_gates<T, 16>(a);
      return err != cudaSuccess ? err : launch_state<T, 16, 16>(a);
    default:
      err = launch_gates<T, 32>(a);
      return err != cudaSuccess ? err : launch_state<T, 32, 32>(a);
  }
}

}  // namespace

// dtype of q, k, v: 0 = float32, 1 = bfloat16; everything else is float32.
// hd is 8, 16, or a multiple of 64 up to 1024.  L <= MAX_SHORT (16) with
// hd a multiple of 64 runs the one pass; otherwise the gates pass
// and a state pass (bf16 with hd a multiple of 64: the tensor cores),
// with W (bh, L, L), gates (bh, 3, L) and w_in (bh,) scratch the caller
// allocates (unused by the one pass: they may be null there).  Launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int repro_mlstm_chunk_fwd(
    const void* q, const void* k, const void* v, const void* i_raw,
    const void* f_raw, const void* c_in, const void* n_in, const void* m_in,
    void* h, void* c_out, void* n_out, void* m_out, void* W, void* gates,
    void* w_in, int bh, int L, int hd, int dtype, void* stream) {
  const bool tiled = hd % 64 == 0 && hd >= 64 && hd <= 1024;
  if (bh <= 0 || bh > 65535 || L < 1 || L > MAX_L ||
      !(tiled || hd == 8 || hd == 16) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  const Args a{q, k, v, f(i_raw), f(f_raw), f(c_in), f(n_in), f(m_in),
               o(h), o(c_out), o(n_out), o(m_out), o(W), o(gates), o(w_in),
               bh, L, hd, static_cast<cudaStream_t>(stream)};
  if (tiled && L <= MAX_SHORT)
    return (int)(dtype ? launch_short<__nv_bfloat16>(a) : launch_short<float>(a));
  if (W == nullptr || gates == nullptr || w_in == nullptr)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch_two_pass<float>(a);
  if (!tiled) return (int)launch_two_pass<__nv_bfloat16>(a);
  const cudaError_t err = launch_gates_tc(a);
  return (int)(err != cudaSuccess ? err : launch_state_tc(a));
}
