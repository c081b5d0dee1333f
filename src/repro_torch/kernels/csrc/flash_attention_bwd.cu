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
// Passes, deterministic, no atomics:
//   1. bwd_delta_kernel: D = rowsum(dout * out) in fp32, 16 bytes a lane,
//      into the rowstats scratch (2, B*H, Sq_pad): plane 0 lse * log2(e)
//      (+inf on the padded rows past Sq, so their P is exactly 0), plane 1
//      D (0 there).  Sq_pad is Sq rounded up to 128.
//   2. dK and dV: a block per key tile holds its K and V and accumulates
//      dK and dV while it walks the query heads of its KV head and, for
//      each, the q tiles that see its keys (the causal and window limits
//      skip the rest).
//   3. dQ: a block per (b, head, q tile) holds Q, dout, lse and D and
//      accumulates dQ over the key tiles its rows see.
//   Both recompute S and P from lse (no (Sq, Skv) tensor reaches memory);
//   the dQ pass recomputes S and dP rather than adding dQ up with atomics,
//   so the kernel does 7 tile products where the bound counts 5.
// Two routes, picked by dtype and head dim:
//   * bf16 at hd 64 and 128 (every model of the zoo but the reduced
//     configs): bwd_dkdv_wgmma_kernel and bwd_dq_wgmma_kernel, wgmma on
//     tiles that TMA brings into swizzled shared memory (see below), and
//     bwd_dkdv_reduce_kernel where the G query heads of a KV head are
//     split over several blocks.
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
//
// The bf16 route, built like the forward (flash_attention.cu) from the
// pieces of wgmma_sm90.cuh:
//   * dK/dV: a block of three warpgroups per (b, KV head, head split,
//     128-key tile); blocks of the first key tiles (the most query rows
//     under a causal mask) are issued first.  K and V come once by TMA
//     into swizzled shared memory; each consumer warpgroup owns 64 of the
//     keys.  The producer warpgroup (its registers given to the consumers,
//     setmaxnreg 24 / 240) streams the 64-row q tiles its keys see through
//     a two-stage ring, each stage Q, dO (tiled TMA) and the rows' lse and
//     D (bulk copies), with full and empty mbarriers.  Per q tile:
//     S^T = K Q^T and dP^T = V dO^T on SS wgmma (m64n64k16, fp32 in
//     registers); P^T = exp2(S^T scale log2e - lse log2e) on the SFU and
//     dS^T = P^T (dP^T - D) in registers, masked element by element only
//     on a tile that crosses the causal diagonal or the window's edge;
//     then dV += P^T dO and dK += dS^T Q on RS wgmma, P^T and dS^T rounded
//     to bf16 as the A operand straight from the accumulators, dO and Q
//     read as the MN-major B operand (as the forward reads V).  At hd 128
//     the registers hold one tile's products at a time, so the consumer
//     warpgroups take turns to issue them (ping-pong, two named
//     barriers): one forms P^T and dS^T while the tensor cores work for
//     the other.  (In the dQ pass, whose products are lighter, turns
//     measured slower, and it has none.)
//   * When B * KVH * (key tiles) leaves fewer than about two blocks an SM
//     (granite-34b's MQA, G 48), the G query heads of a KV head are split
//     over several blocks (flash_attention.py:bwd_splits): each writes its
//     fp32 partial dK and dV into a scratch the wrapper allocates, and
//     bwd_dkdv_reduce_kernel sums the partials in split order.
//   * dQ: three warpgroups per (b, head, 128-row q tile), heaviest tiles
//     first; Q and dO stay in shared memory, K and V stream through a
//     three-stage ring of 64-key tiles.  S = Q K^T and dP = dO V^T on SS
//     wgmma, dS in registers, dQ += dS K on RS wgmma with K as the
//     MN-major B operand.
//   Rows past Sq and keys past Skv are zero in the tiles (TMA fills them);
//   padded rows get P = 0 from their +inf lse, padded keys are masked in
//   the dQ pass and never stored by the dK/dV pass.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma_sm90.cuh"

namespace {

using namespace wgmma_sm90;

constexpr int BQ = 64;           // query rows per tile
constexpr int BKV = 64;          // keys per tile
constexpr int NTHREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

struct BwdParams {
  int sq, skv, h, kvh, causal, window;
  float scale;
  int sq_pad;         // rows of a rowstats plane per (b, head)
  long long plane;    // floats in one rowstats plane: B * H * sq_pad
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
// 1. D = rowsum(dout * out), and lse in the exp2 domain
// ---------------------------------------------------------------------------

// A row of HD elements is CH 16-byte chunks, one a lane: a warp takes
// 32 / CH rows (16 at bf16 hd 64) and sums each row over its CH lanes.
template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ rowstats,
                 const BwdParams p) {
  constexpr int VEC = 16 / sizeof(T);           // elements a chunk
  constexpr int CH = HD / VEC;                  // chunks a row
  constexpr int ROWS = NTHREADS / CH;           // rows a block
  const int r = threadIdx.x / CH, c = threadIdx.x % CH;
  const int bh = blockIdx.y, bi = bh / p.h, head = bh % p.h;
  const int qpos = blockIdx.x * ROWS + r;
  float acc = 0.f;
  if (qpos < p.sq) {
    const uint4 ov = *reinterpret_cast<const uint4*>(
        o + bi * p.s[O][0] + head * p.s[O][1] + qpos * p.s[O][2] + c * VEC);
    const uint4 dv = *reinterpret_cast<const uint4*>(
        dout + bi * p.s[DO][0] + head * p.s[DO][1] + qpos * p.s[DO][2] +
        c * VEC);
    const T* oe = reinterpret_cast<const T*>(&ov);
    const T* de = reinterpret_cast<const T*>(&dv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc += to_f(oe[i]) * to_f(de[i]);
  }
#pragma unroll
  for (int off = CH / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (c == 0 && qpos < p.sq_pad) {
    const size_t row = (size_t)bh * p.sq_pad + qpos;
    rowstats[row] =
        qpos < p.sq ? lse[(size_t)bh * p.sq + qpos] * LOG2E : INFINITY;
    rowstats[p.plane + row] = acc;
  }
}

// ---------------------------------------------------------------------------
// 2. dK, dV on the CUDA cores: a block per (b, kv head, key tile), over
//    its G query heads
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
    const size_t drow0 = ((size_t)bi * p.h + head) * p.sq_pad;
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
        Ds[r] = qpos < p.sq ? delta[drow0 + qpos] : 0.f;
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
// 3. dQ on the CUDA cores: a block per (b, head, q tile), over the key
//    tiles its rows see
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
  const size_t drow0 = (size_t)bh * p.sq_pad;
  load_tile<T, HD, BQ>(Qs, q + bi * p.s[Q][0] + head * p.s[Q][1], p.s[Q][2],
                       q_first, p.sq);
  load_tile<T, HD, BQ>(dOs, dout + bi * p.s[DO][0] + head * p.s[DO][1],
                       p.s[DO][2], q_first, p.sq);
  for (int r = tid; r < BQ; r += NTHREADS) {
    const int qpos = q_first + r;
    Ls[r] = qpos < p.sq ? lse[row0 + qpos] : 0.f;
    Ds[r] = qpos < p.sq ? delta[drow0 + qpos] : 0.f;
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
// bf16 at hd 64 and 128: wgmma on TMA-fed swizzled tiles
// ---------------------------------------------------------------------------

constexpr int CONSUMERS = 256;          // two consumer warpgroups
constexpr int WG_THREADS = CONSUMERS + 128;   // and one producer
constexpr int KT = 128;     // keys of a dK/dV block (64 a consumer)
constexpr int QT = 64;      // query rows of a dK/dV stage
constexpr int QB_WG = 128;  // query rows of a dQ block (64 a consumer)
constexpr int KS = 64;      // keys of a dQ stage
constexpr int BOX = 64;     // rows of one TMA box
constexpr int ROW_PAD = 128;            // rowstats' rows: Sq rounded up

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64 x 64 accumulator (32 floats a thread) as the four A fragments of
// the k-steps over its columns
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float* x) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j][0] = pack_bf16(x[8 * j], x[8 * j + 1]);
    a[j][1] = pack_bf16(x[8 * j + 2], x[8 * j + 3]);
    a[j][2] = pack_bf16(x[8 * j + 4], x[8 * j + 5]);
    a[j][3] = pack_bf16(x[8 * j + 6], x[8 * j + 7]);
  }
}

// X (64 x 64) = A (64 rows of a tile, K-major) B^T (64 rows, K-major): the
// product over hd, HDP/16 SS wgmmas, committed as one group.  a_rows and
// b_rows are the tiles' rows per column block.
template <int HD>
__device__ __forceinline__ void product_over_hd(float* x, uint32_t a_s,
                                                int a_rows, uint32_t b_s,
                                                int b_rows) {
  using G = Swz<HD>;
#pragma unroll
  for (int kk = 0; kk < G::HDP / 16; ++kk) {
    const uint32_t cb = (kk * 32) / G::RB, kin = (kk * 32) % G::RB;
    wgmma_ss_n64(x,
                 make_desc(a_s + cb * a_rows * G::RB + kin, 16, 8 * G::RB,
                           G::LAYOUT),
                 make_desc(b_s + cb * b_rows * G::RB + kin, 16, 8 * G::RB,
                           G::LAYOUT),
                 kk > 0);
  }
  wgmma_commit();
}

// ACC (64 x HD) += A (64 x 64, four k-steps of fragments) B (64 rows of a
// tile of `rows` rows per column block, MN-major)
template <int HD>
__device__ __forceinline__ void product_over_rows(float* acc,
                                                  const uint32_t (&a)[4][4],
                                                  uint32_t b_s, int rows) {
  using G = Swz<HD>;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_rs<G::HDP>(acc, a[j],
                     make_desc(b_s + j * 16 * G::RB, rows * G::RB, 8 * G::RB,
                               G::LAYOUT));
}

// Write a 64 x HD accumulator (rows row0.., this thread's rows row0 +
// 16 w + lane / 4 and + 8) times `mul` as bf16, rows at or past `limit`
// dropped
template <int HD>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* dst, long long ss,
                                           int r0, int limit,
                                           const float* acc, float mul) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < HD / 2; i += 4) {
    const int col = 8 * (i / 4) + 2 * (lane % 4);
    if (r0 < limit)
      *reinterpret_cast<__nv_bfloat162*>(dst + r0 * ss + col) =
          __floats2bfloat162_rn(acc[i] * mul, acc[i + 1] * mul);
    if (r0 + 8 < limit)
      *reinterpret_cast<__nv_bfloat162*>(dst + (r0 + 8) * ss + col) =
          __floats2bfloat162_rn(acc[i + 2] * mul, acc[i + 3] * mul);
  }
}

template <int HD>
struct DkdvTiles {
  static constexpr int KV_BYTES = KT * HD * 2;   // K or V
  static constexpr int QT_BYTES = QT * HD * 2;   // Q or dO of a stage
  static constexpr int ROW_BYTES = QT * 4;       // lse or D of a stage
  static constexpr int STAGES = 2;
  // K, V, the stages' Q, then their dO (1 KB-aligned tiles), then the
  // stages' lse and D, then kv_full and the stages' full and empty
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + STAGES * QT_BYTES;
  static constexpr int ROWS_OFF = DO_OFF + STAGES * QT_BYTES;
  static constexpr int BAR_OFF = ROWS_OFF + STAGES * 2 * ROW_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (2 * STAGES + 1) + 1024;
};

// dK, dV of one 128-key tile over the q tiles of heads [g0, g1) of its KV
// head.  Grid: x = (b * KVH + kv head) * splits + split, y = key tile.
// splits 1 writes bf16 dk, dv; more write the fp32 partials
// part[(grad * splits + split), b * KVH + kv head, kpos, :] (grad 0 dK
// before its scale, 1 dV) for bwd_dkdv_reduce_kernel.
template <int HD>
__global__ void __launch_bounds__(WG_THREADS, 1)
bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const float* __restrict__ rowstats,
                      float* __restrict__ part, int splits,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, const BwdParams p) {
  using L = DkdvTiles<HD>;
  using G = Swz<HD>;
  constexpr int NST = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t k_s = base, v_s = base + L::KV_BYTES;
  auto q_s = [&](int st) { return base + L::Q_OFF + st * L::QT_BYTES; };
  auto do_s = [&](int st) { return base + L::DO_OFF + st * L::QT_BYTES; };
  auto rows_off = [&](int st) { return L::ROWS_OFF + st * 2 * L::ROW_BYTES; };
  const uint32_t bars = base + L::BAR_OFF;
  const uint32_t kv_full = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + NST + st); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bkv = blockIdx.x / splits, split = blockIdx.x % splits;
  const int bi = bkv / p.kvh, kv_head = bkv % p.kvh;
  const int g = p.h / p.kvh;
  const int g0 = split * g / splits, g1 = (split + 1) * g / splits;
  const int k_first = blockIdx.y * KT;
  const int k_last = min(k_first + KT, p.skv) - 1;
  // the q tiles that see any of keys [k_first, k_last], for each head
  const int q_lo = p.causal ? k_first : 0;
  const int q_hi = p.window > 0 ? min(p.sq - 1, k_last + p.window - 1)
                                : p.sq - 1;
  const int t_lo = q_lo / QT;
  const int nt = q_lo <= q_hi ? q_hi / QT - t_lo + 1 : 0;
  const int n = nt * (g1 - g0);

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < NST; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == CONSUMERS) {
      mbar_expect_tx(kv_full, 2 * L::KV_BYTES);
#pragma unroll
      for (int cb = 0; cb < G::NBLK; ++cb)
#pragma unroll
        for (int hb = 0; hb < KT / BOX; ++hb) {
          const uint32_t off = cb * KT * G::RB + hb * BOX * G::RB;
          tma_load_4d(k_s + off, &tm_k, kv_full, cb * G::RB / 2,
                      k_first + hb * BOX, kv_head, bi);
          tma_load_4d(v_s + off, &tm_v, kv_full, cb * G::RB / 2,
                      k_first + hb * BOX, kv_head, bi);
        }
      for (int i = 0; i < n; ++i) {
        const int st = i % NST;
        const int head = kv_head * g + g0 + i / nt;
        const int q_first = (t_lo + i % nt) * QT;
        if (i >= NST) mbar_wait(empty(st), ((i - NST) / NST) & 1);
        mbar_expect_tx(full(st), 2 * L::QT_BYTES + 2 * L::ROW_BYTES);
#pragma unroll
        for (int cb = 0; cb < G::NBLK; ++cb) {
          tma_load_4d(q_s(st) + cb * QT * G::RB, &tm_q, full(st),
                      cb * G::RB / 2, q_first, head, bi);
          tma_load_4d(do_s(st) + cb * QT * G::RB, &tm_do, full(st),
                      cb * G::RB / 2, q_first, head, bi);
        }
        const float* rs =
            rowstats + ((size_t)bi * p.h + head) * p.sq_pad + q_first;
        bulk_load(base + rows_off(st), rs, L::ROW_BYTES, full(st));
        bulk_load(base + rows_off(st) + L::ROW_BYTES, rs + p.plane,
                  L::ROW_BYTES, full(st));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid / 128, t4 = lane % 4;
    const int kw_lo = k_first + 64 * wg;          // this warpgroup's keys
    const int krow = kw_lo + 16 * (warp % 4) + lane / 4;   // and + 8
    const float sl2 = p.scale * LOG2E;
    float dk_acc[G::HDP / 2], dv_acc[G::HDP / 2];
#pragma unroll
    for (int i = 0; i < G::HDP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    float s[32], dp[32];
    uint32_t pa[4][4], da[4][4];

    // the warpgroups take turns to issue their products (ping-pong), so
    // one forms P^T and dS^T while the tensor cores work for the other;
    // warpgroup 0 goes first, and 1 hands no turn on after its last
    auto my_turn = [&]() { named_sync(1 + wg); };
    auto your_turn = [&]() { named_arrive(2 - wg); };
    mbar_wait(kv_full, 0);
    if (wg == 1 && n > 0) your_turn();
    for (int i = 0; i < n; ++i) {
      const int st = i % NST;
      const int q_first = (t_lo + i % nt) * QT;
      mbar_wait(full(st), (i / NST) & 1);
      // S^T = K Q^T and dP^T = V dO^T: rows this warpgroup's keys,
      // columns the tile's queries
      my_turn();
      wgmma_fence();
      product_over_hd<HD>(s, k_s + wg * 64 * G::RB, KT, q_s(st), QT);
      product_over_hd<HD>(dp, v_s + wg * 64 * G::RB, KT, do_s(st), QT);
      your_turn();
      const float* ls =
          reinterpret_cast<const float*>(gbase + rows_off(st));
      const float* dd = ls + QT;
      wgmma_wait_1();
      fence_regs<32>(s);
      // P^T = exp2(S^T scale log2e - lse log2e); a padded query row has
      // lse +inf and P 0
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const float2 l = *reinterpret_cast<const float2*>(ls + 8 * m + 2 * t4);
        s[4 * m] = ex2(fmaf(s[4 * m], sl2, -l.x));
        s[4 * m + 1] = ex2(fmaf(s[4 * m + 1], sl2, -l.y));
        s[4 * m + 2] = ex2(fmaf(s[4 * m + 2], sl2, -l.x));
        s[4 * m + 3] = ex2(fmaf(s[4 * m + 3], sl2, -l.y));
      }
      const bool full_tile =
          (!p.causal || kw_lo + 63 <= q_first) &&
          (p.window <= 0 || kw_lo > q_first + QT - 1 - p.window);
      if (!full_tile) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int kpos = krow + 8 * ((j % 4) / 2);
          const int qpos = q_first + 8 * (j / 4) + 2 * t4 + (j % 2);
          if ((p.causal && kpos > qpos) ||
              (p.window > 0 && kpos <= qpos - p.window))
            s[j] = 0.f;
        }
      }
      wgmma_wait_0();
      fence_regs<32>(dp);
      // dS^T = P^T (dP^T - D)
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const float2 d = *reinterpret_cast<const float2*>(dd + 8 * m + 2 * t4);
        dp[4 * m] = s[4 * m] * (dp[4 * m] - d.x);
        dp[4 * m + 1] = s[4 * m + 1] * (dp[4 * m + 1] - d.y);
        dp[4 * m + 2] = s[4 * m + 2] * (dp[4 * m + 2] - d.x);
        dp[4 * m + 3] = s[4 * m + 3] * (dp[4 * m + 3] - d.y);
      }
      to_a(pa, s);
      to_a(da, dp);
      // dV += P^T dO, dK += dS^T Q
      fence_regs<G::HDP / 2>(dv_acc);
      fence_regs<G::HDP / 2>(dk_acc);
      my_turn();
      wgmma_fence();
      product_over_rows<HD>(dv_acc, pa, do_s(st), QT);
      product_over_rows<HD>(dk_acc, da, q_s(st), QT);
      wgmma_commit();
      if (wg == 0 || i + 1 < n) your_turn();
      wgmma_wait_0();
      fence_regs<G::HDP / 2>(dv_acc);
      fence_regs<G::HDP / 2>(dk_acc);
      mbar_arrive(empty(st));
    }

    if (splits == 1) {
      store_bf16<HD>(dk + bi * p.s[DK][0] + kv_head * p.s[DK][1],
                     p.s[DK][2], krow, p.skv, dk_acc, p.scale);
      store_bf16<HD>(dv + bi * p.s[DV][0] + kv_head * p.s[DV][1],
                     p.s[DV][2], krow, p.skv, dv_acc, 1.f);
    } else {
      const size_t bkvs = gridDim.x / splits;
      float* pk = part + ((size_t)split * bkvs + bkv) * p.skv * HD;
      float* pv = pk + (size_t)splits * bkvs * p.skv * HD;
#pragma unroll
      for (int i = 0; i < HD / 2; i += 4) {
        const int col = 8 * (i / 4) + 2 * t4;
        if (krow < p.skv) {
          *reinterpret_cast<float2*>(pk + (size_t)krow * HD + col) =
              make_float2(dk_acc[i], dk_acc[i + 1]);
          *reinterpret_cast<float2*>(pv + (size_t)krow * HD + col) =
              make_float2(dv_acc[i], dv_acc[i + 1]);
        }
        if (krow + 8 < p.skv) {
          *reinterpret_cast<float2*>(pk + (size_t)(krow + 8) * HD + col) =
              make_float2(dk_acc[i + 2], dk_acc[i + 3]);
          *reinterpret_cast<float2*>(pv + (size_t)(krow + 8) * HD + col) =
              make_float2(dv_acc[i + 2], dv_acc[i + 3]);
        }
      }
    }
  }
}

// dk = scale * sum over splits of the dK partials, dv = the sum of the dV
// partials, in split order; four columns a thread
template <int HD>
__global__ void __launch_bounds__(NTHREADS)
bwd_dkdv_reduce_kernel(const float* __restrict__ part,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int splits, int bkvs,
                       const BwdParams p) {
  const size_t n = (size_t)bkvs * p.skv * (HD / 4);     // float4s a split
  const float4* pk = reinterpret_cast<const float4*>(part);
  const float4* pv = pk + (size_t)splits * n;
  for (size_t idx = (size_t)blockIdx.x * NTHREADS + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * NTHREADS) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
    for (int sp = 0; sp < splits; ++sp) {
      const float4 x = pk[sp * n + idx], y = pv[sp * n + idx];
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
    }
    const int col = 4 * (int)(idx % (HD / 4));
    const size_t row = idx / (HD / 4);
    const int kpos = (int)(row % p.skv), bkv = (int)(row / p.skv);
    const int bi = bkv / p.kvh, kv_head = bkv % p.kvh;
    const float sc = p.scale;
    uint2 uk, uv;
    uk.x = pack_bf16(a.x * sc, a.y * sc);
    uk.y = pack_bf16(a.z * sc, a.w * sc);
    uv.x = pack_bf16(c.x, c.y);
    uv.y = pack_bf16(c.z, c.w);
    *reinterpret_cast<uint2*>(dk + bi * p.s[DK][0] + kv_head * p.s[DK][1] +
                              kpos * p.s[DK][2] + col) = uk;
    *reinterpret_cast<uint2*>(dv + bi * p.s[DV][0] + kv_head * p.s[DV][1] +
                              kpos * p.s[DV][2] + col) = uv;
  }
}

template <int HD>
struct DqTiles {
  static constexpr int Q_BYTES = QB_WG * HD * 2;   // Q or dO
  static constexpr int KV_BYTES = KS * HD * 2;     // K or V of a stage
  static constexpr int STAGES = 3;
  // Q, dO, then the stages' K and V, then q_full and the stages' full and
  // empty mbarriers
  static constexpr int KV_OFF = 2 * Q_BYTES;
  static constexpr int BAR_OFF = KV_OFF + STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (2 * STAGES + 1) + 1024;
};

// dQ of one 128-row q tile of one head over the key tiles its rows see.
// Grid: x = b * H + head, y = q tile (the last, heaviest, first).
template <int HD>
__global__ void __launch_bounds__(WG_THREADS, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ rowstats,
                    __nv_bfloat16* __restrict__ dq, const BwdParams p) {
  using L = DqTiles<HD>;
  using G = Swz<HD>;
  constexpr int NST = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, do_s = base + L::Q_BYTES;
  auto k_s = [&](int st) { return base + L::KV_OFF + st * 2 * L::KV_BYTES; };
  auto v_s = [&](int st) { return k_s(st) + L::KV_BYTES; };
  const uint32_t bars = base + L::BAR_OFF;
  const uint32_t q_full = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + NST + st); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x, bi = bh / p.h, head = bh % p.h;
  const int kv_head = head / (p.h / p.kvh);
  const int q_first = (gridDim.y - 1 - blockIdx.y) * QB_WG;
  const int q_last = min(q_first + QB_WG, p.sq) - 1;
  // the key tiles that rows [q_first, q_last] see
  const int k_lo = p.window > 0 ? max(0, q_first - p.window + 1) : 0;
  const int k_hi = p.causal ? min(p.skv - 1, q_last) : p.skv - 1;
  const int t_lo = k_lo / KS;
  const int n = k_lo <= k_hi ? k_hi / KS - t_lo + 1 : 0;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < NST; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == CONSUMERS) {
      mbar_expect_tx(q_full, 2 * L::Q_BYTES);
#pragma unroll
      for (int cb = 0; cb < G::NBLK; ++cb)
#pragma unroll
        for (int hb = 0; hb < QB_WG / BOX; ++hb) {
          const uint32_t off = cb * QB_WG * G::RB + hb * BOX * G::RB;
          tma_load_4d(q_s + off, &tm_q, q_full, cb * G::RB / 2,
                      q_first + hb * BOX, head, bi);
          tma_load_4d(do_s + off, &tm_do, q_full, cb * G::RB / 2,
                      q_first + hb * BOX, head, bi);
        }
      for (int i = 0; i < n; ++i) {
        const int st = i % NST, k_first = (t_lo + i) * KS;
        if (i >= NST) mbar_wait(empty(st), ((i - NST) / NST) & 1);
        mbar_expect_tx(full(st), 2 * L::KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < G::NBLK; ++cb) {
          tma_load_4d(k_s(st) + cb * KS * G::RB, &tm_k, full(st),
                      cb * G::RB / 2, k_first, kv_head, bi);
          tma_load_4d(v_s(st) + cb * KS * G::RB, &tm_v, full(st),
                      cb * G::RB / 2, k_first, kv_head, bi);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid / 128, t4 = lane % 4;
    const int wq_lo = q_first + 64 * wg;           // this warpgroup's rows
    const int qrow = wq_lo + 16 * (warp % 4) + lane / 4;   // and + 8
    const float sl2 = p.scale * LOG2E;
    // the rows' lse (exp2 domain; +inf past Sq) and D
    const float* rs = rowstats + (size_t)bh * p.sq_pad;
    const float l0 = rs[qrow], l1 = rs[qrow + 8];
    const float d0 = rs[p.plane + qrow], d1 = rs[p.plane + qrow + 8];
    float dq_acc[G::HDP / 2];
#pragma unroll
    for (int i = 0; i < G::HDP / 2; ++i) dq_acc[i] = 0.f;
    float s[32], dp[32];
    uint32_t da[4][4];

    mbar_wait(q_full, 0);
    for (int i = 0; i < n; ++i) {
      const int st = i % NST, k_first = (t_lo + i) * KS;
      mbar_wait(full(st), (i / NST) & 1);
      // S = Q K^T and dP = dO V^T: rows this warpgroup's queries, columns
      // the tile's keys
      wgmma_fence();
      product_over_hd<HD>(s, q_s + wg * 64 * G::RB, QB_WG, k_s(st), KS);
      product_over_hd<HD>(dp, do_s + wg * 64 * G::RB, QB_WG, v_s(st), KS);
      wgmma_wait_1();
      fence_regs<32>(s);
#pragma unroll
      for (int j = 0; j < 32; ++j)
        s[j] = ex2(fmaf(s[j], sl2, (j % 4) < 2 ? -l0 : -l1));
      const bool full_tile =
          k_first + KS <= p.skv &&
          (!p.causal || k_first + KS - 1 <= wq_lo) &&
          (p.window <= 0 || k_first > wq_lo + 63 - p.window);
      if (!full_tile) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int qpos = qrow + 8 * ((j % 4) / 2);
          const int kpos = k_first + 8 * (j / 4) + 2 * t4 + (j % 2);
          if (kpos >= p.skv || (p.causal && kpos > qpos) ||
              (p.window > 0 && kpos <= qpos - p.window))
            s[j] = 0.f;
        }
      }
      wgmma_wait_0();
      fence_regs<32>(dp);
#pragma unroll
      for (int j = 0; j < 32; ++j)
        dp[j] = s[j] * (dp[j] - ((j % 4) < 2 ? d0 : d1));
      to_a(da, dp);
      // dQ += dS K
      fence_regs<G::HDP / 2>(dq_acc);
      wgmma_fence();
      product_over_rows<HD>(dq_acc, da, k_s(st), KS);
      wgmma_commit();
      wgmma_wait_0();
      fence_regs<G::HDP / 2>(dq_acc);
      mbar_arrive(empty(st));
    }
    store_bf16<HD>(dq + bi * p.s[DQ][0] + head * p.s[DQ][1], p.s[DQ][2],
                   qrow, p.sq, dq_acc, p.scale);
  }
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* dout, const float* rowstats,
                         float* part, int splits, void* dq, void* dk,
                         void* dv, int b, const BwdParams& p,
                         cudaStream_t stream) {
  using T = __nv_bfloat16;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map<HD>(&mq, q, b, p.h, p.sq, p.s[Q][0], p.s[Q][1], p.s[Q][2],
                    BOX) ||
      !make_map<HD>(&mk, k, b, p.kvh, p.skv, p.s[K][0], p.s[K][1], p.s[K][2],
                    BOX) ||
      !make_map<HD>(&mv, v, b, p.kvh, p.skv, p.s[V][0], p.s[V][1], p.s[V][2],
                    BOX) ||
      !make_map<HD>(&mdo, dout, b, p.h, p.sq, p.s[DO][0], p.s[DO][1],
                    p.s[DO][2], BOX))
    return cudaErrorInvalidValue;

  auto dkdv = bwd_dkdv_wgmma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DkdvTiles<HD>::SMEM);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3(b * p.kvh * splits, (p.skv + KT - 1) / KT), WG_THREADS,
         DkdvTiles<HD>::SMEM, stream>>>(mq, mk, mv, mdo, rowstats, part,
                                        splits, static_cast<T*>(dk),
                                        static_cast<T*>(dv), p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    const long long n4 = (long long)b * p.kvh * p.skv * (HD / 4);
    const long long want = (n4 + NTHREADS - 1) / NTHREADS;
    const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
    bwd_dkdv_reduce_kernel<HD><<<blocks, NTHREADS, 0, stream>>>(
        part, static_cast<T*>(dk), static_cast<T*>(dv), splits, b * p.kvh,
        p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  auto dqk = bwd_dq_wgmma_kernel<HD>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DqTiles<HD>::SMEM);
  if (err != cudaSuccess) return err;
  dqk<<<dim3(b * p.h, (p.sq + QB_WG - 1) / QB_WG), WG_THREADS,
        DqTiles<HD>::SMEM, stream>>>(mq, mk, mv, mdo, rowstats,
                                     static_cast<T*>(dq), p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* rowstats, float* part, int splits, void* dq,
                   void* dk, void* dv, int b, const BwdParams& p,
                   cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  constexpr int delta_rows = NTHREADS / (HD * (int)sizeof(T) / 16);
  bwd_delta_kernel<T, HD>
      <<<dim3((p.sq_pad + delta_rows - 1) / delta_rows, b * p.h), NTHREADS,
          0, stream>>>(static_cast<const T*>(o), dot, lse, rowstats, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value && HD >= 64) {
    return launch_wgmma<HD>(q, k, v, dout, rowstats, part, splits, dq, dk,
                            dv, b, p, stream);
  } else {
    if (splits != 1) return cudaErrorInvalidValue;
    const float* delta = rowstats + p.plane;
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
                        float* rowstats, float* part, int splits, void* dq,
                        void* dk, void* dv, int b, const BwdParams& p,
                        cudaStream_t s) {
  switch (hd) {
    case 8: return launch<T, 8>(q, k, v, o, dout, lse, rowstats, part, splits, dq, dk, dv, b, p, s);
    case 16: return launch<T, 16>(q, k, v, o, dout, lse, rowstats, part, splits, dq, dk, dv, b, p, s);
    case 32: return launch<T, 32>(q, k, v, o, dout, lse, rowstats, part, splits, dq, dk, dv, b, p, s);
    case 64: return launch<T, 64>(q, k, v, o, dout, lse, rowstats, part, splits, dq, dk, dv, b, p, s);
    case 128: return launch<T, 128>(q, k, v, o, dout, lse, rowstats, part, splits, dq, dk, dv, b, p, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q, out, dout, dq (B, H, Sq, hd); k, v, dk, dv (B, KVH, Skv, hd); each
// addressed as base + b*s[0] + head*s[1] + pos*s[2] (elements; strides =
// three each of q, k, v, out, dout, dq, dk, dv), hd contiguous.  lse
// (B, H, Sq) fp32 from the forward.  rowstats: (2, B*H, Sq_pad) fp32
// scratch, Sq_pad = Sq rounded up to 128.  splits: the blocks that share
// the query heads of one KV head in the dK/dV pass (1 but for bf16 at hd
// 64 and 128, and at most H / KVH); part: (2, splits, B*KVH, Skv, hd) fp32
// scratch where splits > 1, else null.  dtype: 0 = float32, 1 = bfloat16
// (all eight tensors alike).  window <= 0 means no window.  Launches the
// passes on `stream` and returns the first CUDA error (0 on success).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* rowstats, float* part,
    void* dq, void* dk, void* dv, int b, int h, int kvh, int sq, int skv,
    int hd, const long long* strides, int causal, int window, float scale,
    int splits, int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || h <= 0 || kvh <= 0 || h % kvh ||
      (long long)b * h > 65535 || splits < 1 || splits > h / kvh ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.sq = sq;
  p.skv = skv;
  p.h = h;
  p.kvh = kvh;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.sq_pad = (sq + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
  p.plane = (long long)b * h * p.sq_pad;
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) p.s[t][i] = strides[3 * t + i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_hd<float>(hd, q, k, v, o, dout, lse, rowstats, part,
                                   splits, dq, dk, dv, b, p, s);
  if (dtype == 1)
    return (int)dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, dout, lse,
                                           rowstats, part, splits, dq, dk,
                                           dv, b, p, s);
  return (int)cudaErrorInvalidValue;
}
