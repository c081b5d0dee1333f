// The gradient of prefill attention (GQA; causal, sliding-window and
// unmasked), for Hopper.
//
// Computes the gradient of the function of the TPU kernel
// src/repro/kernels/flash_attention.py:flash_attention_bhsd, which the
// reference differentiates through XLA's autodiff of its twin
// src/repro/models/attention.py:flash_attn (the Pallas kernel has no
// backward kernel of its own).  Same contract as flash_attention.cu:
//   q, dout, out, dq (B, H, Sq, hd); k, v, dk, dv (B, KVH, Skv, hd); each
//   addressed through its (b, head, seq) strides in elements, hd
//   contiguous, so the model's (B, S, H, hd) tensors are read and the
//   gradients written in that layout in place.  lse (B, H, Sq) fp32 is
//   the forward's row log-sum-exp of the scaled scores (-inf for a row
//   with no key left).  Query head h reads KV head h / (H / KVH).
//   Masks are the forward's and no more: kv padding, causal kpos <= qpos
//   (no offset, also when Sq != Skv), window kpos > qpos - window.
// With P = exp(scale q k^T - lse) (0 where masked), D = rowsum(dout * out):
//   dv = P^T dout,  dS = P * (dout v^T - D),  dq = scale dS k,
//   dk = scale dS^T q.
// A row with no key left (only with a window) has lse = -inf and adds
// nothing.  Its forward output is the mean of V (masked scores are a
// finite -1e30, as in the oracle), whose gradient in V the plain version's
// autograd spreads over all keys: there the two would differ, in dv only,
// so the wrapper (flash_attention.py:flash_attention_bshd) refuses a call
// under grad whose shape leaves such a row (Sq >= Skv + window).  Self-
// attention always sees its own key and the unmasked calls see all, so no
// model's path meets such a row.
//
// Three passes, deterministic, no atomics:
//   1. bwd_delta_kernel: D = rowsum(dout * out) in fp32, one warp a row.
//   2. dK and dV: a block per (b, kv head, 64-key tile) holds its K and V
//      and accumulates dK and dV in registers while it walks the G query
//      heads of its KV head and, for each, the 64-row q tiles that see
//      its keys (the causal and window limits skip the rest): the G heads
//      are summed inside the block, with no cross-block reduction.
//   3. dQ: a block per (b, head, 64-row q tile) holds Q, dout, lse and D
//      and accumulates dQ over the key tiles its rows see.
//   Both recompute S and P from lse (no (Sq, Skv) tensor reaches memory).
// Two routes, picked by dtype and head dim:
//   * bf16 at hd 64 and 128 (every model of the zoo but the reduced
//     configs): bwd_dkdv_tc_kernel and bwd_dq_tc_kernel, products on the
//     tensor cores (mma.sync m16n8k16, fp32 accumulators; P and dS
//     rounded to bf16 as the next product's operand), see below.
//   * fp32, and bf16 at hd 8-32: bwd_dkdv_kernel and bwd_dq_kernel on the
//     CUDA cores, exact in fp32: operands in shared memory as fp32 (bf16
//     converted on load), 4x4 (S, dP) and 4x(hd/16) (dK, dV, dQ)
//     register micro-tiles.
//   Gradients are written in the inputs' dtype.
//
// What bounds it on an H100: the backward does 2.5x the forward's FLOPs
// (S again, dP, dV, dK, dQ), at qwen3-0.6b's shape (B 4, S 2048, 16/8
// heads of 128, causal) 1.7e11 against ~170 MB of inputs and gradients,
// so the bound is the tensor cores' rate (0.174 ms at 989 TFLOP/s).
// mma.sync reaches a part of that rate; wgmma with TMA-fed tiles (as the
// forward) is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"

namespace {

constexpr int BQ = 64;           // query rows per tile
constexpr int BKV = 64;          // keys per tile
constexpr int NTHREADS = 256;

struct BwdParams {
  int sq, skv, h, kvh, causal, window;
  float scale;
  // (b, head, seq) strides in elements of q, k, v, out, dout, dq, dk, dv
  long long s[8][3];
};
enum { Q = 0, K, V, O, DO, DQ, DK, DV };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// Whether query qpos sees key kpos: the forward's mask_score, with kv
// padding and the padded query rows of a tile masked too.
__device__ __forceinline__ bool visible(int qpos, int kpos,
                                        const BwdParams& p) {
  return qpos < p.sq && kpos < p.skv && !(p.causal && kpos > qpos) &&
         !(p.window > 0 && kpos <= qpos - p.window);
}

// Shared-memory layout in floats: rows of hd + 1 (and 64 + 1) so that the
// 16 column threads of a micro-tile read 16 different banks.
template <int HD>
struct Smem {
  static constexpr int ST = HD + 1;
  static constexpr int PT = BKV + 1;
};

// Load ROWS rows of a (seq, hd) slice as fp32, zero past `limit`.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ss, int first,
                                          int limit) {
  for (int i = threadIdx.x; i < ROWS * HD; i += NTHREADS) {
    const int r = i / HD, d = i % HD;
    const int pos = first + r;
    dst[r * Smem<HD>::ST + d] = pos < limit ? to_f(src[pos * ss + d]) : 0.f;
  }
}

// s[i][j] = sum_d A[ty + 16 i][d] B[tx + 16 j][d] and the same for a2, b2
// (the S = Q K^T and dP = dO V^T micro-tiles, in one pass over d).
template <int HD>
__device__ __forceinline__ void two_products(const float* A, const float* B,
                                             const float* A2,
                                             const float* B2, int ty, int tx,
                                             float (&s)[4][4],
                                             float (&s2)[4][4]) {
  constexpr int ST = Smem<HD>::ST;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = s2[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[4], b[4], a2[4], b2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = A[(ty + 16 * i) * ST + d];
      a2[i] = A2[(ty + 16 * i) * ST + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = B[(tx + 16 * j) * ST + d];
      b2[j] = B2[(tx + 16 * j) * ST + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        s2[i][j] = fmaf(a2[i], b2[j], s2[i][j]);
      }
  }
}

// The output micro-tile of a thread: rows orow + TR i, columns ocol + TC j.
template <int HD>
struct OutTile {
  static constexpr int TC = HD < 16 ? HD : 16;
  static constexpr int TR = NTHREADS / TC;
  static constexpr int RPT = 64 / TR;
  static constexpr int CPT = HD / TC;
};

// ---------------------------------------------------------------------------
// 1. D = rowsum(dout * out)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, int hd, const BwdParams p) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, bi = bh / p.h, head = bh % p.h;
  const int qpos = blockIdx.x * (NTHREADS / 32) + warp;
  if (qpos >= p.sq) return;
  const T* orow = o + bi * p.s[O][0] + head * p.s[O][1] + qpos * p.s[O][2];
  const T* drow =
      dout + bi * p.s[DO][0] + head * p.s[DO][1] + qpos * p.s[DO][2];
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc += to_f(orow[d]) * to_f(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[(size_t)bh * p.sq + qpos] = acc;
}

// ---------------------------------------------------------------------------
// 2. dK, dV: a block per (b, kv head, key tile), over its G query heads
// ---------------------------------------------------------------------------

template <int HD>
struct DkdvSmem {
  static constexpr int ST = Smem<HD>::ST, PT = Smem<HD>::PT;
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + BKV * ST;
  static constexpr int Q_OFF = V_OFF + BKV * ST;
  static constexpr int DO_OFF = Q_OFF + BQ * ST;
  static constexpr int P_OFF = DO_OFF + BQ * ST;
  static constexpr int DS_OFF = P_OFF + BQ * PT;
  static constexpr int L_OFF = DS_OFF + BQ * PT;
  static constexpr int D_OFF = L_OFF + BQ;
  static constexpr size_t BYTES = (D_OFF + BQ) * sizeof(float);
};

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, const BwdParams p) {
  using L = DkdvSmem<HD>;
  using OT = OutTile<HD>;
  constexpr int ST = L::ST, PT = L::PT;
  extern __shared__ float smem[];
  float* Ks = smem + L::K_OFF;
  float* Vs = smem + L::V_OFF;
  float* Qs = smem + L::Q_OFF;
  float* dOs = smem + L::DO_OFF;
  float* Ps = smem + L::P_OFF;
  float* dSs = smem + L::DS_OFF;
  float* Ls = smem + L::L_OFF;
  float* Ds = smem + L::D_OFF;

  const int tid = threadIdx.x;
  const int bkv = blockIdx.y, bi = bkv / p.kvh, kv_head = bkv % p.kvh;
  const int g = p.h / p.kvh;
  const int k_first = blockIdx.x * BKV;
  const int k_last = min(k_first + BKV, p.skv) - 1;
  load_tile<T, HD, BKV>(Ks, k + bi * p.s[K][0] + kv_head * p.s[K][1],
                        p.s[K][2], k_first, p.skv);
  load_tile<T, HD, BKV>(Vs, v + bi * p.s[V][0] + kv_head * p.s[V][1],
                        p.s[V][2], k_first, p.skv);

  // the query rows that see any of keys [k_first, k_last]
  const int q_lo = p.causal ? k_first : 0;
  const int q_hi = p.window > 0 ? min(p.sq - 1, k_last + p.window - 1)
                                : p.sq - 1;
  const int ty = tid / 16, tx = tid % 16;
  const int orow = tid / OT::TC, ocol = tid % OT::TC;
  float dk_acc[OT::RPT][OT::CPT], dv_acc[OT::RPT][OT::CPT];
#pragma unroll
  for (int i = 0; i < OT::RPT; ++i)
#pragma unroll
    for (int j = 0; j < OT::CPT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int gi = 0; gi < g && q_lo <= q_hi; ++gi) {
    const int head = kv_head * g + gi;
    const size_t row0 = ((size_t)bi * p.h + head) * p.sq;
    const T* qb = q + bi * p.s[Q][0] + head * p.s[Q][1];
    const T* db = dout + bi * p.s[DO][0] + head * p.s[DO][1];
    for (int t = q_lo / BQ; t <= q_hi / BQ; ++t) {
      const int q_first = t * BQ;
      __syncthreads();  // the previous step is done with Qs, dOs, Ps, dSs
      load_tile<T, HD, BQ>(Qs, qb, p.s[Q][2], q_first, p.sq);
      load_tile<T, HD, BQ>(dOs, db, p.s[DO][2], q_first, p.sq);
      for (int r = tid; r < BQ; r += NTHREADS) {
        const int qpos = q_first + r;
        Ls[r] = qpos < p.sq ? lse[row0 + qpos] : 0.f;
        Ds[r] = qpos < p.sq ? delta[row0 + qpos] : 0.f;
      }
      __syncthreads();

      // S = Q K^T and dP = dO V^T; rows ty + 16 i (queries), columns
      // tx + 16 j (keys)
      float s[4][4], dp[4][4];
      two_products<HD>(Qs, Ks, dOs, Vs, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const bool vis = visible(q_first + r, k_first + c, p);
          const float pr = vis ? expf(s[i][j] * p.scale - Ls[r]) : 0.f;
          Ps[r * PT + c] = pr;
          dSs[r * PT + c] = pr * (dp[i][j] - Ds[r]);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over the tile's query rows
#pragma unroll 2
      for (int qq = 0; qq < BQ; ++qq) {
        float pv[OT::RPT], sv[OT::RPT], dov[OT::CPT], qv[OT::CPT];
#pragma unroll
        for (int i = 0; i < OT::RPT; ++i) {
          pv[i] = Ps[qq * PT + orow + OT::TR * i];
          sv[i] = dSs[qq * PT + orow + OT::TR * i];
        }
#pragma unroll
        for (int j = 0; j < OT::CPT; ++j) {
          dov[j] = dOs[qq * ST + ocol + OT::TC * j];
          qv[j] = Qs[qq * ST + ocol + OT::TC * j];
        }
#pragma unroll
        for (int i = 0; i < OT::RPT; ++i)
#pragma unroll
          for (int j = 0; j < OT::CPT; ++j) {
            dv_acc[i][j] = fmaf(pv[i], dov[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(sv[i], qv[j], dk_acc[i][j]);
          }
      }
    }
  }

  T* dkb = dk + bi * p.s[DK][0] + kv_head * p.s[DK][1];
  T* dvb = dv + bi * p.s[DV][0] + kv_head * p.s[DV][1];
#pragma unroll
  for (int i = 0; i < OT::RPT; ++i) {
    const int kpos = k_first + orow + OT::TR * i;
    if (kpos < p.skv) {
#pragma unroll
      for (int j = 0; j < OT::CPT; ++j) {
        const int c = ocol + OT::TC * j;
        dkb[kpos * p.s[DK][2] + c] = from_f<T>(dk_acc[i][j] * p.scale);
        dvb[kpos * p.s[DV][2] + c] = from_f<T>(dv_acc[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ: a block per (b, head, q tile), over the key tiles its rows see
// ---------------------------------------------------------------------------

template <int HD>
struct DqSmem {
  static constexpr int ST = Smem<HD>::ST, PT = Smem<HD>::PT;
  static constexpr int Q_OFF = 0;
  static constexpr int DO_OFF = Q_OFF + BQ * ST;
  static constexpr int K_OFF = DO_OFF + BQ * ST;
  static constexpr int V_OFF = K_OFF + BKV * ST;
  static constexpr int DS_OFF = V_OFF + BKV * ST;
  static constexpr int L_OFF = DS_OFF + BQ * PT;
  static constexpr int D_OFF = L_OFF + BQ;
  static constexpr size_t BYTES = (D_OFF + BQ) * sizeof(float);
};

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, const BwdParams p) {
  using L = DqSmem<HD>;
  using OT = OutTile<HD>;
  constexpr int ST = L::ST, PT = L::PT;
  extern __shared__ float smem[];
  float* Qs = smem + L::Q_OFF;
  float* dOs = smem + L::DO_OFF;
  float* Ks = smem + L::K_OFF;
  float* Vs = smem + L::V_OFF;
  float* dSs = smem + L::DS_OFF;
  float* Ls = smem + L::L_OFF;
  float* Ds = smem + L::D_OFF;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y, bi = bh / p.h, head = bh % p.h;
  const int kv_head = head / (p.h / p.kvh);
  // heaviest (last) query tiles first, as the forward
  const int q_first = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int q_last = min(q_first + BQ, p.sq) - 1;
  const size_t row0 = (size_t)bh * p.sq;
  load_tile<T, HD, BQ>(Qs, q + bi * p.s[Q][0] + head * p.s[Q][1], p.s[Q][2],
                       q_first, p.sq);
  load_tile<T, HD, BQ>(dOs, dout + bi * p.s[DO][0] + head * p.s[DO][1],
                       p.s[DO][2], q_first, p.sq);
  for (int r = tid; r < BQ; r += NTHREADS) {
    const int qpos = q_first + r;
    Ls[r] = qpos < p.sq ? lse[row0 + qpos] : 0.f;
    Ds[r] = qpos < p.sq ? delta[row0 + qpos] : 0.f;
  }

  // the keys that rows [q_first, q_last] see
  const int k_lo = p.window > 0 ? max(0, q_first - p.window + 1) : 0;
  const int k_hi = p.causal ? min(p.skv - 1, q_last) : p.skv - 1;
  const T* kb = k + bi * p.s[K][0] + kv_head * p.s[K][1];
  const T* vb = v + bi * p.s[V][0] + kv_head * p.s[V][1];
  const int ty = tid / 16, tx = tid % 16;
  const int orow = tid / OT::TC, ocol = tid % OT::TC;
  float dq_acc[OT::RPT][OT::CPT];
#pragma unroll
  for (int i = 0; i < OT::RPT; ++i)
#pragma unroll
    for (int j = 0; j < OT::CPT; ++j) dq_acc[i][j] = 0.f;

  for (int t = k_lo / BKV; k_lo <= k_hi && t <= k_hi / BKV; ++t) {
    const int k_first = t * BKV;
    __syncthreads();  // the previous tile is done with Ks, Vs, dSs
    load_tile<T, HD, BKV>(Ks, kb, p.s[K][2], k_first, p.skv);
    load_tile<T, HD, BKV>(Vs, vb, p.s[V][2], k_first, p.skv);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_products<HD>(Qs, Ks, dOs, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool vis = visible(q_first + r, k_first + c, p);
        const float pr = vis ? expf(s[i][j] * p.scale - Ls[r]) : 0.f;
        dSs[r * PT + c] = pr * (dp[i][j] - Ds[r]);
      }
    }
    __syncthreads();

    // dQ += dS K over the tile's keys
#pragma unroll 2
    for (int kk = 0; kk < BKV; ++kk) {
      float sv[OT::RPT], kv[OT::CPT];
#pragma unroll
      for (int i = 0; i < OT::RPT; ++i)
        sv[i] = dSs[(orow + OT::TR * i) * PT + kk];
#pragma unroll
      for (int j = 0; j < OT::CPT; ++j) kv[j] = Ks[kk * ST + ocol + OT::TC * j];
#pragma unroll
      for (int i = 0; i < OT::RPT; ++i)
#pragma unroll
        for (int j = 0; j < OT::CPT; ++j)
          dq_acc[i][j] = fmaf(sv[i], kv[j], dq_acc[i][j]);
    }
  }

  T* dqb = dq + bi * p.s[DQ][0] + head * p.s[DQ][1];
#pragma unroll
  for (int i = 0; i < OT::RPT; ++i) {
    const int qpos = q_first + orow + OT::TR * i;
    if (qpos < p.sq) {
#pragma unroll
      for (int j = 0; j < OT::CPT; ++j)
        dqb[qpos * p.s[DQ][2] + ocol + OT::TC * j] =
            from_f<T>(dq_acc[i][j] * p.scale);
    }
  }
}


// ---------------------------------------------------------------------------
// bf16 at hd 64 and 128 on the tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------
//
// The same two passes with the products on bf16 mma.sync and fp32
// accumulators: a block of 4 warps, each warp 16 rows of the block's 64
// (keys in dK/dV, queries in dQ), walking the other side 16 at a time.
// Tiles sit in shared memory as bf16, rows padded by 8 elements so that
// ldmatrix's eight row addresses fall in eight bank groups, filled by
// cp.async (zeros past the sequence).  S^T and dP^T (dK/dV) or S and dP
// (dQ) come from mma's C fragments; P and dS are formed there in fp32,
// rounded to bf16 and fed to the next mma as A fragments without
// passing through shared memory (the flash-attention-2 layout trick).
// That rounding of P and dS is what this path adds to the CUDA-core
// kernels' numerics.

constexpr int TC_ROWS = 64;          // a block's rows, and a loaded tile's
constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;

template <int HD>
struct TcSmem {
  static constexpr int LD = HD + 8;                 // padded row, elements
  static constexpr int TILE = TC_ROWS * LD;         // one tile, elements
  static constexpr size_t BYTES =
      4 * TILE * sizeof(__nv_bfloat16) + 2 * TC_ROWS * sizeof(float);
};

// Copy 64 rows of a (seq, HD) bf16 slice into a padded tile, zeros past
// `limit` (the source address stays in bounds).
template <int HD>
__device__ __forceinline__ void tc_load(__nv_bfloat16* dst,
                                        const __nv_bfloat16* src,
                                        long long ss, int first, int limit) {
  using namespace mma_sm90;
  constexpr int CH = HD / 8;
  for (int i = threadIdx.x; i < TC_ROWS * CH; i += TC_THREADS) {
    const int r = i / CH, c = i % CH;
    const int pos = first + r;
    const __nv_bfloat16* g = src + (long long)min(pos, limit - 1) * ss + 8 * c;
    cp_async16(smem_u32(dst + r * TcSmem<HD>::LD + 8 * c), g,
               pos < limit ? 16 : 0);
  }
}

// A fragment (16 rows x 16 k) of a row-major padded tile at (r0, k0)
template <int HD>
__device__ __forceinline__ void lds_a(uint32_t (&a)[4],
                                      const __nv_bfloat16* tile, int r0,
                                      int k0) {
  const int l = threadIdx.x % 32;
  const int r = r0 + (l % 8) + 8 * ((l / 8) % 2), k = k0 + 8 * (l / 16);
  mma_sm90::ldsm_x4(a, mma_sm90::smem_u32(tile + r * TcSmem<HD>::LD + k));
}
// B fragments of two n-tiles (n0..n0+15) x k16 from a tile stored [n][k]
template <int HD>
__device__ __forceinline__ void lds_b_nk(uint32_t (&b)[4],
                                         const __nv_bfloat16* tile, int n0,
                                         int k0) {
  const int l = threadIdx.x % 32;
  const int n = n0 + (l % 8) + 8 * (l / 16), k = k0 + 8 * ((l / 8) % 2);
  mma_sm90::ldsm_x4(b, mma_sm90::smem_u32(tile + n * TcSmem<HD>::LD + k));
}
// the same from a tile stored [k][n] (ldmatrix.trans)
template <int HD>
__device__ __forceinline__ void lds_b_kn(uint32_t (&b)[4],
                                         const __nv_bfloat16* tile, int k0,
                                         int n0) {
  const int l = threadIdx.x % 32;
  const int k = k0 + (l % 8) + 8 * ((l / 8) % 2), n = n0 + 8 * (l / 16);
  mma_sm90::ldsm_x4_t(b, mma_sm90::smem_u32(tile + k * TcSmem<HD>::LD + n));
}

// x (16 x 16) += A (16 x HD) B^T (HD x 16), A and B row-major tiles at
// rows a0 and b0: the S = Q K^T and dP = dO V^T micro-tiles (and their
// transposes), as two n-tiles of C fragments
template <int HD>
__device__ __forceinline__ void tc_abt(float (&x)[2][4],
                                       const __nv_bfloat16* A, int a0,
                                       const __nv_bfloat16* B, int b0) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) x[t][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4], b[4];
    lds_a<HD>(a, A, a0, 16 * kk);
    lds_b_nk<HD>(b, B, b0, 16 * kk);
    mma_sm90::mma_bf16(x[0], a, b[0], b[1]);
    mma_sm90::mma_bf16(x[1], a, b[2], b[3]);
  }
}

// acc (16 x HD) += A (16 x 16, fragments in registers) B (16 x HD, rows
// k0.. of a row-major tile)
template <int HD>
__device__ __forceinline__ void tc_acc(float (&acc)[HD / 8][4],
                                       const uint32_t (&a)[4],
                                       const __nv_bfloat16* B, int k0) {
#pragma unroll
  for (int np = 0; np < HD / 16; ++np) {
    uint32_t b[4];
    lds_b_kn<HD>(b, B, k0, 16 * np);
    mma_sm90::mma_bf16(acc[2 * np], a, b[0], b[1]);
    mma_sm90::mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
  }
}

// Two n-tiles of C fragments (16 x 16) as the A fragment of one k-step
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4],
                                       const float (&x)[2][4]) {
  a[0] = mma_sm90::pack_bf16(x[0][0], x[0][1]);
  a[1] = mma_sm90::pack_bf16(x[0][2], x[0][3]);
  a[2] = mma_sm90::pack_bf16(x[1][0], x[1][1]);
  a[3] = mma_sm90::pack_bf16(x[1][2], x[1][3]);
}

// Write a (16 x HD) accumulator times `mul` as bf16 rows r0.. of a
// (seq, HD) slice, rows at or past `limit` dropped
template <int HD>
__device__ __forceinline__ void tc_store(__nv_bfloat16* dst, long long ss,
                                         int r0, int limit,
                                         const float (&acc)[HD / 8][4],
                                         float mul) {
  const int l = threadIdx.x % 32, g = l / 4, tig = l % 4;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int c = 8 * j + 2 * tig;
    if (r0 + g < limit)
      *reinterpret_cast<__nv_bfloat162*>(dst + (r0 + g) * ss + c) =
          __floats2bfloat162_rn(acc[j][0] * mul, acc[j][1] * mul);
    if (r0 + g + 8 < limit)
      *reinterpret_cast<__nv_bfloat162*>(dst + (r0 + g + 8) * ss + c) =
          __floats2bfloat162_rn(acc[j][2] * mul, acc[j][3] * mul);
  }
}

template <int HD>
__global__ void __launch_bounds__(TC_THREADS)
bwd_dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, const BwdParams p) {
  using L = TcSmem<HD>;
  extern __shared__ __align__(16) uint8_t tc_smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* Vs = Ks + L::TILE;
  __nv_bfloat16* Qs = Vs + L::TILE;
  __nv_bfloat16* dOs = Qs + L::TILE;
  float* Ls = reinterpret_cast<float*>(dOs + L::TILE);
  float* Ds = Ls + TC_ROWS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, tig = lane % 4;
  const int bkv = blockIdx.y, bi = bkv / p.kvh, kv_head = bkv % p.kvh;
  const int grp = p.h / p.kvh;
  const int k_first = blockIdx.x * TC_ROWS;
  const int k_last = min(k_first + TC_ROWS, p.skv) - 1;
  const int kw = 16 * warp;                 // this warp's keys in the tile
  tc_load<HD>(Ks, k + bi * p.s[K][0] + kv_head * p.s[K][1], p.s[K][2],
              k_first, p.skv);
  tc_load<HD>(Vs, v + bi * p.s[V][0] + kv_head * p.s[V][1], p.s[V][2],
              k_first, p.skv);
  mma_sm90::cp_async_commit();

  const int q_lo = p.causal ? k_first : 0;
  const int q_hi = p.window > 0 ? min(p.sq - 1, k_last + p.window - 1)
                                : p.sq - 1;
  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[j][i] = dv_acc[j][i] = 0.f;

  for (int gi = 0; gi < grp && q_lo <= q_hi; ++gi) {
    const int head = kv_head * grp + gi;
    const size_t row0 = ((size_t)bi * p.h + head) * p.sq;
    const __nv_bfloat16* qb = q + bi * p.s[Q][0] + head * p.s[Q][1];
    const __nv_bfloat16* db = dout + bi * p.s[DO][0] + head * p.s[DO][1];
    for (int t = q_lo / TC_ROWS; t <= q_hi / TC_ROWS; ++t) {
      const int q_first = t * TC_ROWS;
      __syncthreads();    // the previous step is done with Qs, dOs, Ls, Ds
      tc_load<HD>(Qs, qb, p.s[Q][2], q_first, p.sq);
      tc_load<HD>(dOs, db, p.s[DO][2], q_first, p.sq);
      mma_sm90::cp_async_commit();
      for (int r = tid; r < TC_ROWS; r += TC_THREADS) {
        const int qpos = q_first + r;
        Ls[r] = qpos < p.sq ? lse[row0 + qpos] : 0.f;
        Ds[r] = qpos < p.sq ? delta[row0 + qpos] : 0.f;
      }
      mma_sm90::cp_async_wait<0>();
      __syncthreads();

      for (int c = 0; c < TC_ROWS / 16; ++c) {
        // S^T = K Q^T and dP^T = V dO^T: rows this warp's keys, columns
        // queries 16 c .. 16 c + 15 of the tile
        float st[2][4], dpt[2][4];
        tc_abt<HD>(st, Ks, kw, Qs, 16 * c);
        tc_abt<HD>(dpt, Vs, kw, dOs, 16 * c);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int kr = kw + g8 + 8 * (i / 2);
            const int qc = 16 * c + 8 * nt + 2 * tig + (i % 2);
            const bool vis = visible(q_first + qc, k_first + kr, p);
            const float pr = vis ? expf(st[nt][i] * p.scale - Ls[qc]) : 0.f;
            st[nt][i] = pr;
            dpt[nt][i] = pr * (dpt[nt][i] - Ds[qc]);
          }
        uint32_t pa[4], dsa[4];
        c_to_a(pa, st);
        c_to_a(dsa, dpt);
        tc_acc<HD>(dv_acc, pa, dOs, 16 * c);      // dV += P^T dO
        tc_acc<HD>(dk_acc, dsa, Qs, 16 * c);      // dK += dS^T Q
      }
    }
  }
  mma_sm90::cp_async_wait<0>();     // a block with no q tile drains K, V
  tc_store<HD>(dk + bi * p.s[DK][0] + kv_head * p.s[DK][1], p.s[DK][2],
               k_first + kw, p.skv, dk_acc, p.scale);
  tc_store<HD>(dv + bi * p.s[DV][0] + kv_head * p.s[DV][1], p.s[DV][2],
               k_first + kw, p.skv, dv_acc, 1.f);
}

template <int HD>
__global__ void __launch_bounds__(TC_THREADS)
bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, const BwdParams p) {
  using L = TcSmem<HD>;
  extern __shared__ __align__(16) uint8_t tc_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* dOs = Qs + L::TILE;
  __nv_bfloat16* Ks = dOs + L::TILE;
  __nv_bfloat16* Vs = Ks + L::TILE;
  float* Ls = reinterpret_cast<float*>(Vs + L::TILE);
  float* Ds = Ls + TC_ROWS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, tig = lane % 4;
  const int bh = blockIdx.y, bi = bh / p.h, head = bh % p.h;
  const int kv_head = head / (p.h / p.kvh);
  const int q_first = (gridDim.x - 1 - blockIdx.x) * TC_ROWS;
  const int q_last = min(q_first + TC_ROWS, p.sq) - 1;
  const int qw = 16 * warp;               // this warp's queries in the tile
  const size_t row0 = (size_t)bh * p.sq;
  tc_load<HD>(Qs, q + bi * p.s[Q][0] + head * p.s[Q][1], p.s[Q][2], q_first,
              p.sq);
  tc_load<HD>(dOs, dout + bi * p.s[DO][0] + head * p.s[DO][1], p.s[DO][2],
              q_first, p.sq);
  mma_sm90::cp_async_commit();
  for (int r = tid; r < TC_ROWS; r += TC_THREADS) {
    const int qpos = q_first + r;
    Ls[r] = qpos < p.sq ? lse[row0 + qpos] : 0.f;
    Ds[r] = qpos < p.sq ? delta[row0 + qpos] : 0.f;
  }

  const int k_lo = p.window > 0 ? max(0, q_first - p.window + 1) : 0;
  const int k_hi = p.causal ? min(p.skv - 1, q_last) : p.skv - 1;
  const __nv_bfloat16* kb = k + bi * p.s[K][0] + kv_head * p.s[K][1];
  const __nv_bfloat16* vb = v + bi * p.s[V][0] + kv_head * p.s[V][1];
  float dq_acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq_acc[j][i] = 0.f;

  for (int t = k_lo / TC_ROWS; k_lo <= k_hi && t <= k_hi / TC_ROWS; ++t) {
    const int k_first = t * TC_ROWS;
    __syncthreads();              // the previous tile is done with Ks, Vs
    tc_load<HD>(Ks, kb, p.s[K][2], k_first, p.skv);
    tc_load<HD>(Vs, vb, p.s[V][2], k_first, p.skv);
    mma_sm90::cp_async_commit();
    mma_sm90::cp_async_wait<0>();
    __syncthreads();

    for (int c = 0; c < TC_ROWS / 16; ++c) {
      // S = Q K^T and dP = dO V^T: rows this warp's queries, columns
      // keys 16 c .. 16 c + 15 of the tile
      float s[2][4], dp[2][4];
      tc_abt<HD>(s, Qs, qw, Ks, 16 * c);
      tc_abt<HD>(dp, dOs, qw, Vs, 16 * c);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qr = qw + g8 + 8 * (i / 2);
          const int kc = 16 * c + 8 * nt + 2 * tig + (i % 2);
          const bool vis = visible(q_first + qr, k_first + kc, p);
          const float pr = vis ? expf(s[nt][i] * p.scale - Ls[qr]) : 0.f;
          dp[nt][i] = pr * (dp[nt][i] - Ds[qr]);
        }
      uint32_t dsa[4];
      c_to_a(dsa, dp);
      tc_acc<HD>(dq_acc, dsa, Ks, 16 * c);        // dQ += dS K
    }
  }
  mma_sm90::cp_async_wait<0>();     // a block with no key tile drains Q, dO
  tc_store<HD>(dq + bi * p.s[DQ][0] + head * p.s[DQ][1], p.s[DQ][2],
               q_first + qw, p.sq, dq_acc, p.scale);
}

template <int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, void* dk, void* dv, int b, const BwdParams& p,
                      cudaStream_t stream) {
  using T = __nv_bfloat16;
  const size_t bytes = TcSmem<HD>::BYTES;
  auto dkdv = bwd_dkdv_tc_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((p.skv + TC_ROWS - 1) / TC_ROWS, b * p.kvh), TC_THREADS, bytes,
         stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                   static_cast<const T*>(v), static_cast<const T*>(dout), lse,
                   delta, static_cast<T*>(dk), static_cast<T*>(dv), p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto dqk = bwd_dq_tc_kernel<HD>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  dqk<<<dim3((p.sq + TC_ROWS - 1) / TC_ROWS, b * p.h), TC_THREADS, bytes,
        stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(dout), lse,
                  delta, static_cast<T*>(dq), p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int b,
                   const BwdParams& p, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  bwd_delta_kernel<T><<<dim3((p.sq + NTHREADS / 32 - 1) / (NTHREADS / 32),
                             b * p.h),
                        NTHREADS, 0, stream>>>(static_cast<const T*>(o), dot,
                                               delta, HD, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value && HD >= 64) {
    return launch_tc<HD>(q, k, v, dout, lse, delta, dq, dk, dv, b, p,
                         stream);
  } else {
    auto dkdv = bwd_dkdv_kernel<T, HD>;
    err = cudaFuncSetAttribute(dkdv,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)DkdvSmem<HD>::BYTES);
    if (err != cudaSuccess) return err;
    dkdv<<<dim3((p.skv + BKV - 1) / BKV, b * p.kvh), NTHREADS,
           DkdvSmem<HD>::BYTES, stream>>>(qt, kt, vt, dot, lse, delta,
                                          static_cast<T*>(dk),
                                          static_cast<T*>(dv), p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    auto dqk = bwd_dq_kernel<T, HD>;
    err = cudaFuncSetAttribute(dqk,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)DqSmem<HD>::BYTES);
    if (err != cudaSuccess) return err;
    dqk<<<dim3((p.sq + BQ - 1) / BQ, b * p.h), NTHREADS, DqSmem<HD>::BYTES,
          stream>>>(qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), p);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        float* delta, void* dq, void* dk, void* dv, int b,
                        const BwdParams& p, cudaStream_t s) {
  switch (hd) {
    case 8: return launch<T, 8>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, p, s);
    case 16: return launch<T, 16>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, p, s);
    case 32: return launch<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, p, s);
    case 64: return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, p, s);
    case 128: return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, p, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q, out, dout, dq (B, H, Sq, hd); k, v, dk, dv (B, KVH, Skv, hd); each
// addressed as base + b*s[0] + head*s[1] + pos*s[2] (elements; strides =
// three each of q, k, v, out, dout, dq, dk, dv), hd contiguous.  lse
// (B, H, Sq) fp32 from the forward; delta (B, H, Sq) fp32 scratch.  dtype:
// 0 = float32, 1 = bfloat16 (all eight tensors alike).  window <= 0 means
// no window.  Launches three kernels on `stream` and returns the first
// CUDA error (0 on success).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int b, int h, int kvh, int sq, int skv, int hd,
    const long long* strides, int causal, int window, float scale,
    int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || h <= 0 || kvh <= 0 || h % kvh ||
      (long long)b * h > 65535)
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.sq = sq;
  p.skv = skv;
  p.h = h;
  p.kvh = kvh;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) p.s[t][i] = strides[3 * t + i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_hd<float>(hd, q, k, v, o, dout, lse, delta, dq, dk,
                                   dv, b, p, s);
  if (dtype == 1)
    return (int)dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, dout, lse, delta,
                                           dq, dk, dv, b, p, s);
  return (int)cudaErrorInvalidValue;
}
