// Prefill attention with GQA, causal and sliding-window masks, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_bhsd (body _kernel).  Same function:
//   q (B, H, Sq, hd); k, v (B, KVH, Skv, hd); out (B, H, Sq, hd) in q's
//   dtype, each addressed through its (b, head, seq) strides in elements,
//   hd contiguous.  The TPU op's contiguous (B*H, S, hd) layout is one
//   set of strides; the model's (B, S, H, hd) tensors are read and
//   written in place with theirs (no transposing copy).  Query head h
//   reads KV head h / (H / KVH).
//   Masks: kv padding; causal kpos <= qpos with no offset (also when
//   Sq != Skv); window kpos > qpos - window (also without causal).
//   A masked score is -1e30 (finite), exactly as the reference oracle
//   (src/repro/kernels/ref.py:attention_ref), so a row with no key left
//   averages V over all Skv keys, as that oracle does.
//   Online softmax with m, l and acc in fp32; out = acc / max(l, 1e-30).
//   For training the caller may pass lse (B, H, Sq) fp32: each row's
//   log-sum-exp of its scaled scores, which the backward
//   (flash_attention_bwd.cu) recomputes P from; -inf for a row with no
//   key left.  Serving passes null and pays one predicated branch.
//
// What bounds it on an H100: causal attention at the serving path's
// prefill shape (B=4, S=2048, H=16, hd=128) needs 2*S^2*hd FLOPs per head
// (the causal half of QK^T and PV), 6.9e10 in all, against ~100 MB of
// q, k, v and out: ~680 FLOP per byte, above the card's ~295 bf16
// FLOP/byte ridge, so the bound is the tensor-core rate (~69 us at
// 989 TFLOP/s).  At the serving shape (S=16) it is launch latency.
//
// bf16 (every head dim): flash_attention_bf16_kernel, on the tensor cores.
//   * A block owns 128 query rows: two consumer warpgroups of 64 rows
//     each and one producer warpgroup.  It walks the 128-key tiles that
//     its rows reach (the causal and window limits skip the rest, as the
//     TPU kernel's pl.when does); only the diagonal and edge tiles are
//     masked element by element.  Blocks are issued heaviest (last query
//     rows) first.
//   * S = Q K^T and O += P V run on bf16 wgmma with fp32 accumulators in
//     registers (m64n128k16 for S, m64n<hd>k16 for PV).  Q, K and V sit
//     in shared memory in the 128/64/32-byte swizzled layouts that TMA
//     writes and wgmma reads through its matrix descriptors (K-major Q and
//     K; V as the MN-major B operand, so it is never transposed).  hd 8 is
//     zero-padded to 16 in the tiles: the padding adds 0 to QK^T and is
//     never stored.
//   * The online softmax runs on the S accumulator fragments in registers
//     (the scale folded into exp2, on the SFU); P is rounded to bf16 in
//     registers and fed to the PV wgmma as its A operand, so it never
//     passes through shared memory.  That rounding is the one this kernel
//     adds to the TPU kernel's numerics (which keep P in fp32); l sums the
//     unrounded p.
//   * Each tile issues S(t) and then PV(t - 1) and waits for S(t) only,
//     so the softmax of tile t runs while the tensor cores finish
//     PV(t - 1); and the two consumer warpgroups take turns to issue
//     (ping-pong, two named barriers), so one runs its softmax while the
//     tensor cores work for the other.
//   * K/V live in a ring of three stages in shared memory (224 KB at hd
//     128: one block per SM).  One producer thread fills it with TMA
//     copies (cp.async.bulk.tensor through a tensor map per operand, made
//     on the host from the caller's strides), each stage with a "full"
//     mbarrier (the copies' bytes landed) and an "empty" one (every
//     consumer thread is past its PV).  The producer warpgroup gives its
//     registers to the consumers (setmaxnreg 24 / 240).
//   What it leaves (PERF.md): the softmax's SFU and issue time per tile,
//   which the consumers still pay in series with their own products.
// fp32: flash_attention_fp32_kernel, exact on the CUDA cores.  TF32 would
//   not hold the fp32 check's 1e-4 of a row's largest value, and the fp32
//   runs (the decode-consistency runs, the fp32 checks) need that: a
//   64-row q tile and 64-key tiles in shared memory as fp32, S by 4x4
//   register micro-tiles, a warp per 8 rows for the softmax, then
//   acc = acc * corr + P V.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace {

using namespace wgmma_sm90;

constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  int sq, skv, h, kvh, causal, window;
  float scale;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
};

// First and last key a query row may see, before kv padding.
__device__ __forceinline__ int key_lo(int qpos, int window) {
  return window > 0 ? max(0, qpos - window + 1) : 0;
}
__device__ __forceinline__ int key_hi(int qpos, int skv, int causal) {
  return causal ? min(skv - 1, qpos) : skv - 1;
}

// The kv tiles [*begin, *end) that query rows [q_first, q_last] need.  A
// row with no key left (only possible with a window, once qpos >= Skv +
// window - 1, and then for every later row) averages over all keys, so
// such a block visits every tile.
__device__ __forceinline__ void tile_range(int q_first, int q_last,
                                           const Params& p, int bkv,
                                           int* begin, int* end) {
  if (key_lo(q_last, p.window) > key_hi(q_last, p.skv, p.causal)) {
    *begin = 0;
    *end = (p.skv + bkv - 1) / bkv;
  } else {
    *begin = key_lo(q_first, p.window) / bkv;
    *end = key_hi(q_last, p.skv, p.causal) / bkv + 1;
  }
}

// The score of (qpos, kpos) after masking: -inf for kv padding (p = 0),
// MASKED for a causal or window mask.
__device__ __forceinline__ float mask_score(float x, int qpos, int kpos,
                                            const Params& p) {
  if (kpos >= p.skv) return -INFINITY;
  if ((p.causal && kpos > qpos) || (p.window > 0 && kpos <= qpos - p.window))
    return MASKED;
  return x;
}

// The row's log-sum-exp (natural log) of its scaled scores, for the
// backward (flash_attention_bwd.cu): m the row max in the natural domain,
// l the sum of exp(s - m).  A row with no key left (its max is still
// MASKED) gets -inf, so the backward's P = exp(s - lse) is never formed
// for it and its gradient is 0.
__device__ __forceinline__ float row_lse(float m, float l, bool empty) {
  return empty ? -INFINITY : m + logf(l);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 128;       // query rows per block: two warpgroups
constexpr int TC_BKV = 128;      // keys per tile
constexpr int TC_THREADS = 256;

// Shared-memory tile geometry for head dim HD: the swizzled column blocks
// of wgmma_sm90.cuh (Swz), a Q tile and the K/V ring.
template <int HD>
struct Tile : Swz<HD> {
  static constexpr int HDP = Swz<HD>::HDP;
  static constexpr int RB = Swz<HD>::RB;
  static constexpr int Q_BYTES = TC_BQ * HDP * 2;
  static constexpr int KV_BYTES = TC_BKV * HDP * 2;
  static constexpr int STAGES = 3;                // the K/V ring
  static constexpr int BYTES = Q_BYTES + STAGES * 2 * KV_BYTES;
  // 1 KB alignment slack, then the ring's full and empty mbarriers and Q's
  static constexpr int SMEM = BYTES + 1024 + 8 * (2 * STAGES + 1);
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Scale one S tile into the exp2 domain, mask it where `full` is false, and
// turn it into p = exp2(x - m) in place; updates m and this thread's part
// of l and returns the rescale factors of the rows' old m in c0, c1.
template <int SN>
__device__ __forceinline__ void softmax_tile(float* s, bool full, int qpos0,
                                             int qpos1, int kv_first,
                                             int lane, float scale_log2,
                                             const Params& p, float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& c0, float& c1) {
  if (full) {
#pragma unroll
    for (int i = 0; i < SN; ++i) s[i] *= scale_log2;
  } else {
#pragma unroll
    for (int i = 0; i < SN; ++i) {
      const int kpos = kv_first + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
      s[i] = mask_score(s[i] * scale_log2, (i % 4) < 2 ? qpos0 : qpos1, kpos,
                        p);
    }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < SN; i += 4) {
    mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[i + 2], s[i + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  c0 = ex2(m0 - mn0);
  c1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
  for (int i = 0; i < SN; i += 4) {
    s[i] = ex2(s[i] - mn0);
    s[i + 1] = ex2(s[i + 1] - mn0);
    s[i + 2] = ex2(s[i + 2] - mn1);
    s[i + 3] = ex2(s[i + 3] - mn1);
    ls0 += s[i] + s[i + 1];
    ls1 += s[i + 2] + s[i + 3];
  }
  l0 = l0 * c0 + ls0;
  l1 = l1 * c1 + ls1;
}

// Thread t of warp w (0..7) holds, of each accumulator (wgmma's layout:
// 16 rows per warp, blocks of 8 columns), rows 16w + t/4 and +8, columns
// 2(t%4) and +1: element i is row +8*((i%4)/2), column 8(i/4) + 2(t%4) +
// i%2.  The P fragments of k-step j are S blocks 2j and 2j+1.  The tensor
// maps of q, k, v sit in the parameter space (__grid_constant__), where
// TMA reads them.
template <int HD>
__global__ void __launch_bounds__(TC_THREADS + 128, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, const Params p) {
  using L = Tile<HD>;
  constexpr int HDP = L::HDP;
  constexpr int SN = TC_BKV / 2;
  constexpr int ON = HDP / 2;
  constexpr int NST = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  auto k_s = [&](int st) { return base + L::Q_BYTES + st * 2 * L::KV_BYTES; };
  auto v_s = [&](int st) { return k_s(st) + L::KV_BYTES; };
  // full[st]: the stage's copies have landed (TMA's byte count); empty[st]:
  // every consumer thread is past its PV
  const uint32_t bars = base + L::BYTES;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (NST + st); };
  const uint32_t q_full = bars + 8 * 2 * NST;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int bi = bh / p.h, head = bh % p.h;
  const int kv_head = head / (p.h / p.kvh);
  const int q_first = (gridDim.x - 1 - blockIdx.x) * TC_BQ;

  int t_begin, t_end;
  tile_range(q_first, min(q_first + TC_BQ - 1, p.sq - 1), p, TC_BKV,
             &t_begin, &t_end);
  const int n = t_end - t_begin;

  if (tid == 0) {
    for (int st = 0; st < NST; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), TC_THREADS);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= TC_THREADS / 32) {
    // the producer warpgroup hands its registers to the consumers; one
    // lane keeps the ring full with TMA copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == TC_THREADS) {
      mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int cb = 0; cb < L::NBLK; ++cb)
        tma_load_4d(q_s + cb * TC_BQ * L::RB, &tm_q, q_full, cb * L::RB / 2,
                    q_first, head, bi);
      for (int i = 0; i < n; ++i) {
        const int st = i % NST, kv_first = (t_begin + i) * TC_BKV;
        if (i >= NST) mbar_wait(empty(st), ((i - NST) / NST) & 1);
        mbar_expect_tx(full(st), 2 * L::KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < L::NBLK; ++cb) {
          tma_load_4d(k_s(st) + cb * TC_BKV * L::RB, &tm_k, full(st),
                      cb * L::RB / 2, kv_first, kv_head, bi);
          tma_load_4d(v_s(st) + cb * TC_BKV * L::RB, &tm_v, full(st),
                      cb * L::RB / 2, kv_first, kv_head, bi);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid / 128;
    __nv_bfloat16* ob = o + bi * p.o_sb + head * p.o_sh;
    const int row0 = 16 * warp + lane / 4;
    const int qpos0 = q_first + row0, qpos1 = qpos0 + 8;
    const int wg_lo = q_first + 64 * wg, wg_hi = wg_lo + 63;
    const float scale_log2 = p.scale * LOG2E;

    float o_acc[ON];
#pragma unroll
    for (int i = 0; i < ON; ++i) o_acc[i] = 0.f;
    float m0 = MASKED, m1 = MASKED, l0 = 0.f, l1 = 0.f;
    uint32_t pa[TC_BKV / 16][4];
    float s[SN];

    auto issue_s = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const uint32_t kb_off = (kk * 32) / L::RB, kin = (kk * 32) % L::RB;
        const uint64_t da = make_desc(
            q_s + kb_off * TC_BQ * L::RB + wg * 64 * L::RB + kin, 16,
            8 * L::RB, L::LAYOUT);
        const uint64_t db = make_desc(k_s(st) + kb_off * TC_BKV * L::RB + kin,
                                      16, 8 * L::RB, L::LAYOUT);
        wgmma_ss_n128(s, da, db, kk > 0);
      }
      wgmma_commit();
    };
    auto issue_pv = [&](int st) {
#pragma unroll
      for (int j = 0; j < TC_BKV / 16; ++j) {
        const uint64_t db = make_desc(v_s(st) + j * 16 * L::RB,
                                      TC_BKV * L::RB, 8 * L::RB, L::LAYOUT);
        wgmma_rs<HDP>(o_acc, pa[j], db);
      }
      wgmma_commit();
    };
    auto softmax = [&](int kv_first, float& c0, float& c1) {
      const bool full_tile = kv_first + TC_BKV <= p.skv &&
                             (!p.causal || kv_first + TC_BKV - 1 <= wg_lo) &&
                             (p.window <= 0 || kv_first > wg_hi - p.window);
      softmax_tile<SN>(s, full_tile, qpos0, qpos1, kv_first, lane, scale_log2,
                       p, m0, m1, l0, l1, c0, c1);
    };
    auto pack = [&]() {
#pragma unroll
      for (int j = 0; j < TC_BKV / 16; ++j) {
        pa[j][0] = pack_bf16(s[8 * j], s[8 * j + 1]);
        pa[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
        pa[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
        pa[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
      }
    };
    // the warpgroups take turns to issue their products (ping-pong): one
    // runs its softmax while the tensor cores work for the other.  Barrier
    // 1 + w lets warpgroup w issue; warpgroup 0 goes first.
    auto my_turn = [&]() { named_sync(1 + wg); };
    auto your_turn = [&]() { named_arrive(2 - wg); };
    if (wg == 1) your_turn();

    // tile 0: S, softmax, P
    mbar_wait(q_full, 0);
    mbar_wait(full(0), 0);
    my_turn();
    wgmma_fence();
    issue_s(0);
    your_turn();
    wgmma_wait_0();
    fence_regs<SN>(s);
    {
      float c0, c1;
      softmax(t_begin * TC_BKV, c0, c1);
    }
    pack();
    // then S(i) and PV(i - 1) together: the softmax of tile i runs while
    // the tensor cores finish PV(i - 1)
    for (int i = 1; i < n; ++i) {
      mbar_wait(full(i % NST), (i / NST) & 1);
      my_turn();
      fence_regs<ON>(o_acc);
      wgmma_fence();
      issue_s(i % NST);
      issue_pv((i - 1) % NST);
      your_turn();
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_regs<SN>(s);
      float c0, c1;
      softmax((t_begin + i) * TC_BKV, c0, c1);
      wgmma_wait_0();
      fence_regs<ON>(o_acc);
      mbar_arrive(empty((i - 1) % NST));   // PV(i - 1) is done with it
#pragma unroll
      for (int j = 0; j < ON; j += 4) {
        o_acc[j] *= c0;
        o_acc[j + 1] *= c0;
        o_acc[j + 2] *= c1;
        o_acc[j + 3] *= c1;
      }
      pack();
    }
    // PV of the last tile; warpgroup 1 issues last and hands no turn on
    my_turn();
    fence_regs<ON>(o_acc);
    wgmma_fence();
    issue_pv((n - 1) % NST);
    if (wg == 0) your_turn();
    wgmma_wait_0();
    fence_regs<ON>(o_acc);

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    if (lse != nullptr && lane % 4 == 0) {
      // m is in the exp2 domain of the scaled scores: lse = m ln 2 + ln l
      float* lb = lse + (size_t)bh * p.sq;
      if (qpos0 < p.sq) lb[qpos0] = row_lse(m0 / LOG2E, l0, m0 == MASKED);
      if (qpos1 < p.sq) lb[qpos1] = row_lse(m1 / LOG2E, l1, m1 == MASKED);
    }
#pragma unroll
    for (int i = 0; i < ON; i += 4) {
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      if (col < HD) {
        if (qpos0 < p.sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + qpos0 * p.o_ss + col) =
              __floats2bfloat162_rn(o_acc[i] * inv0, o_acc[i + 1] * inv0);
        if (qpos1 < p.sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + qpos1 * p.o_ss + col) =
              __floats2bfloat162_rn(o_acc[i + 2] * inv1, o_acc[i + 3] * inv1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int NTHREADS = 256;

// Shared-memory layout, in floats.  Q and K rows are padded by one float so
// that the 16 column-threads of the score tile read 16 different banks.
template <int HD>
struct Smem {
  static constexpr int QK_STRIDE = HD + 1;
  static constexpr int S_STRIDE = BKV + 1;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + BQ * QK_STRIDE;
  static constexpr int V_OFF = K_OFF + BKV * QK_STRIDE;
  static constexpr int S_OFF = V_OFF + BKV * HD;
  static constexpr int M_OFF = S_OFF + BQ * S_STRIDE;
  static constexpr int L_OFF = M_OFF + BQ;
  static constexpr int C_OFF = L_OFF + BQ;
  static constexpr int FLOATS = C_OFF + BQ;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_attention_fp32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ o,
                            float* __restrict__ lse, const Params p) {
  using L = Smem<HD>;
  extern __shared__ float smem[];
  float* Qs = smem + L::Q_OFF;
  float* Ks = smem + L::K_OFF;
  float* Vs = smem + L::V_OFF;
  float* Ss = smem + L::S_OFF;
  float* Ms = smem + L::M_OFF;
  float* Ls = smem + L::L_OFF;
  float* Cs = smem + L::C_OFF;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int bi = bh / p.h, head = bh % p.h;
  const int kv_head = head / (p.h / p.kvh);
  const int q_first = blockIdx.x * BQ;
  const float* qb = q + bi * p.q_sb + head * p.q_sh;
  const float* kb = k + bi * p.k_sb + kv_head * p.k_sh;
  const float* vb = v + bi * p.v_sb + kv_head * p.v_sh;
  float* ob = o + bi * p.o_sb + head * p.o_sh;

  // Q tile, pre-scaled; rows past Sq are zero and never stored
  for (int i = tid; i < BQ * HD; i += NTHREADS) {
    const int r = i / HD, d = i % HD;
    const int qpos = q_first + r;
    Qs[r * L::QK_STRIDE + d] = qpos < p.sq ? qb[qpos * p.q_ss + d] * p.scale : 0.f;
  }
  for (int r = tid; r < BQ; r += NTHREADS) {
    Ms[r] = MASKED;
    Ls[r] = 0.f;
    Cs[r] = 1.f;
  }

  int t_begin, t_end;
  tile_range(q_first, min(q_first + BQ - 1, p.sq - 1), p, BKV, &t_begin,
             &t_end);

  // score tile: thread (ty, tx) owns rows ty + 16i, columns tx + 16j
  const int ty = tid / 16, tx = tid % 16;
  // output tile: thread (orow, ocol) owns rows orow + TR*i, cols ocol + TC*j
  constexpr int TC = HD < 16 ? HD : 16;
  constexpr int TR = NTHREADS / TC;
  constexpr int RPT = BQ / TR;
  constexpr int CPT = HD / TC;
  const int orow = tid / TC, ocol = tid % TC;
  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  const int warp = tid / 32, lane = tid % 32;
  constexpr int ROWS_PER_WARP = BQ / (NTHREADS / 32);

  for (int t = t_begin; t < t_end; ++t) {
    const int kv_first = t * BKV;
    __syncthreads();  // the previous tile's P V is done with Vs and Ss
    for (int i = tid; i < BKV * HD; i += NTHREADS) {
      const int r = i / HD, d = i % HD;
      const int kpos = kv_first + r;
      const bool in = kpos < p.skv;
      Ks[r * L::QK_STRIDE + d] = in ? kb[kpos * p.k_ss + d] : 0.f;
      Vs[r * HD + d] = in ? vb[kpos * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    // S = (scale Q) K^T, masked
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * L::QK_STRIDE + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 16 * j) * L::QK_STRIDE + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        Ss[r * L::S_STRIDE + c] = mask_score(s[i][j], q_first + r, kv_first + c, p);
      }
    }
    __syncthreads();

    // online softmax, one warp per row, two columns per lane
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr;
      float* srow = Ss + r * L::S_STRIDE;
      const float x0 = srow[lane], x1 = srow[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = Ms[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      srow[lane] = p0;
      srow[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        Ls[r] = Ls[r] * corr + sum;
        Ms[r] = m_new;
        Cs[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float c = Cs[orow + TR * i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= c;
    }
#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      float pr[RPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pr[i] = Ss[(orow + TR * i) * L::S_STRIDE + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) vv[j] = Vs[kk * HD + ocol + TC * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(pr[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = orow + TR * i;
    const int qpos = q_first + r;
    if (qpos < p.sq) {
      const float inv = 1.f / fmaxf(Ls[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        ob[qpos * p.o_ss + ocol + TC * j] = acc[i][j] * inv;
      if (lse != nullptr && ocol == 0)
        lse[(size_t)bh * p.sq + qpos] = row_lse(Ms[r], Ls[r], Ms[r] == MASKED);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int bh, const Params& p,
                        cudaStream_t stream) {
  const int b = bh / p.h;
  CUtensorMap mq, mk, mv;
  if (!make_map<HD>(&mq, q, b, p.h, p.sq, p.q_sb, p.q_sh, p.q_ss, TC_BQ) ||
      !make_map<HD>(&mk, k, b, p.kvh, p.skv, p.k_sb, p.k_sh, p.k_ss,
                    TC_BKV) ||
      !make_map<HD>(&mv, v, b, p.kvh, p.skv, p.v_sb, p.v_sh, p.v_ss,
                    TC_BKV))
    return cudaErrorInvalidValue;
  auto kern = flash_attention_bf16_kernel<HD>;
  const size_t bytes = Tile<HD>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + TC_BQ - 1) / TC_BQ, bh);
  kern<<<grid, TC_THREADS + 128, bytes, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* o,
                        float* lse, int bh, const Params& p,
                        cudaStream_t stream) {
  auto kern = flash_attention_fp32_kernel<HD>;
  const size_t bytes = Smem<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + BQ - 1) / BQ, bh);
  kern<<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, p);
  return cudaGetLastError();
}

cudaError_t dispatch(int hd, int dtype, const void* q, const void* k,
                     const void* v, void* o, float* lse, int bh,
                     const Params& p, cudaStream_t s) {
  if (dtype == 0) {
    switch (hd) {
      case 8: return launch_fp32<8>(q, k, v, o, lse, bh, p, s);
      case 16: return launch_fp32<16>(q, k, v, o, lse, bh, p, s);
      case 32: return launch_fp32<32>(q, k, v, o, lse, bh, p, s);
      case 64: return launch_fp32<64>(q, k, v, o, lse, bh, p, s);
      case 128: return launch_fp32<128>(q, k, v, o, lse, bh, p, s);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 8: return launch_bf16<8>(q, k, v, o, lse, bh, p, s);
      case 16: return launch_bf16<16>(q, k, v, o, lse, bh, p, s);
      case 32: return launch_bf16<32>(q, k, v, o, lse, bh, p, s);
      case 64: return launch_bf16<64>(q, k, v, o, lse, bh, p, s);
      case 128: return launch_bf16<128>(q, k, v, o, lse, bh, p, s);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, H, Sq, hd), k and v (B, KVH, Skv, hd), out (B, H, Sq, hd), each
// addressed as base + b*strides[0] + head*strides[1] + pos*strides[2]
// (elements; strides = q's three, k's, v's, out's), hd contiguous, every
// row 16-byte aligned.  lse: null, or (B, H, Sq) fp32 contiguous, where
// each row's log-sum-exp of its scaled scores is written for the backward
// (-inf for a row with no key left).  dtype: 0 = float32, 1 = bfloat16.
// window <= 0 means no window.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, float* lse,
                                         int b,
                                         int h, int kvh, int sq, int skv,
                                         int hd, const long long* strides,
                                         int causal, int window, float scale,
                                         int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || h <= 0 || kvh <= 0 || h % kvh ||
      (long long)b * h > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.sq = sq;
  p.skv = skv;
  p.h = h;
  p.kvh = kvh;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  return (int)dispatch(hd, dtype, q, k, v, o, lse, b * h, p,
                       static_cast<cudaStream_t>(stream));
}

