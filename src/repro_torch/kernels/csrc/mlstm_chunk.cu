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
// (~24 us at the bf16 tensor-core rate): still bytes-bound.
//
// What this first design does about it.  The TPU kernel holds C (hd x hd)
// whole in VMEM; at hd = 1024 that is 4 MB of fp32 per row, and a block
// has at most 227 KB of shared memory.  So C is cut into column tiles of
// TF columns, and the work into two passes on the stream:
//   1. mlstm_gates_kernel, grid (ceil(L/32), B*H): every block rebuilds the
//      gate scalars of its row (block scans for the cumsum and cummax) and
//      computes 32 rows of W = (q k^T) o D (the causal part only) into
//      scratch, with den_t from the row sums of W (q_t . sum_j D_tj k_j is
//      sum_j W_tj) plus exp(m_in - M_t) q_t . n_in.  Block 0 writes w_j,
//      w_in and m_out.
//   2. mlstm_state_kernel, grid (hd/TF, B*H): one block per column tile
//      f of C streams c_in[:, f] once, in chunks of E rows, and uses each
//      chunk for both products: h[:, f] += q[:, e] c_in[e, f] and
//      c_out[e, f] = w_in c_in[e, f] + sum_j (w_j k_j[e]) v_j[f].  Then it
//      adds W v[:, f], scales and divides, and writes h[:, f].  The blocks
//      of tile 0 also write n_out.
// c_out never aliases c_in.  With 16 x 32 = 512 blocks at the serving
// shape the grid covers the card's 132 SMs.  All arithmetic is fp32 on
// the CUDA cores; tensor cores (wgmma), TMA and fusing the two passes are
// the work of a later change, and PERF.md records this kernel's time
// against its bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>

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

template <typename T, int E, int TF>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* i_raw, const float* f_raw, const float* c_in,
                   const float* n_in, const float* m_in, float* h,
                   float* c_out, float* n_out, float* m_out, float* W,
                   float* gates, float* w_in, int bh, int L, int hd,
                   cudaStream_t stream) {
  auto gk = mlstm_gates_kernel<T, E>;
  const size_t g_bytes =
      (3 * MAX_L + TT * (E + 1) + L * (E + 1) + E + TT) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g_bytes);
  if (err != cudaSuccess) return err;
  gk<<<dim3((L + TT - 1) / TT, bh), NTHREADS, g_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), i_raw, f_raw, n_in,
      m_in, W, gates, w_in, m_out, L, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto sk = mlstm_state_kernel<T, E, TF>;
  const size_t s_bytes =
      (L * TF + 2 * L * (E + 1) + E * TF + 3 * L) * sizeof(float);
  err = cudaFuncSetAttribute(
      sk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s_bytes);
  if (err != cudaSuccess) return err;
  sk<<<dim3(hd / TF, bh), NTHREADS, s_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), c_in, n_in, W, gates, w_in, h, c_out, n_out,
      L, hd);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const float* i_raw, const float* f_raw,
                        const float* c_in, const float* n_in,
                        const float* m_in, float* h, float* c_out,
                        float* n_out, float* m_out, float* W, float* gates,
                        float* w_in, int bh, int L, cudaStream_t s) {
  switch (hd) {
    case 8:
      return launch<T, 8, 8>(q, k, v, i_raw, f_raw, c_in, n_in, m_in, h,
                             c_out, n_out, m_out, W, gates, w_in, bh, L, hd, s);
    case 16:
      return launch<T, 16, 16>(q, k, v, i_raw, f_raw, c_in, n_in, m_in, h,
                               c_out, n_out, m_out, W, gates, w_in, bh, L, hd,
                               s);
    case 64:
    case 128:
    case 1024:
      return launch<T, 32, 32>(q, k, v, i_raw, f_raw, c_in, n_in, m_in, h,
                               c_out, n_out, m_out, W, gates, w_in, bh, L, hd,
                               s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of q, k, v: 0 = float32, 1 = bfloat16; everything else is float32.
// W (bh, L, L), gates (bh, 3, L) and w_in (bh,) are scratch the caller
// allocates.  Launches both passes on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int repro_mlstm_chunk_fwd(
    const void* q, const void* k, const void* v, const void* i_raw,
    const void* f_raw, const void* c_in, const void* n_in, const void* m_in,
    void* h, void* c_out, void* n_out, void* m_out, void* W, void* gates,
    void* w_in, int bh, int L, int hd, int dtype, void* stream) {
  if (bh <= 0 || bh > 65535 || L < 1 || L > MAX_L)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 0)
    return (int)dispatch_hd<float>(hd, q, k, v, f(i_raw), f(f_raw), f(c_in),
                                   f(n_in), f(m_in), o(h), o(c_out),
                                   o(n_out), o(m_out), o(W), o(gates),
                                   o(w_in), bh, L, s);
  if (dtype == 1)
    return (int)dispatch_hd<__nv_bfloat16>(
        hd, q, k, v, f(i_raw), f(f_raw), f(c_in), f(n_in), f(m_in), o(h),
        o(c_out), o(n_out), o(m_out), o(W), o(gates), o(w_in), bh, L, s);
  return (int)cudaErrorInvalidValue;
}
