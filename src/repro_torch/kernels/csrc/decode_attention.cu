// Decode attention for Hopper: one query token per sequence against a
// (ring-buffer) KV cache, the G query heads of one KV head packed as rows.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention_packed (body _kernel).  Same contract:
//   q (B*KVH, G, hd); k, v (B, Sc, KVH, hd), addressed through their
//   (b, kvh, slot) strides; out (B*KVH, G, hd) in q's dtype.  Query head
//   h = kvh * G + g.
//   Scale 1/sqrt(hd) on the scores.  Slots >= valid (and >= Sc) are masked
//   and the tiles past them are skipped, so valid == 0 gives zeros: the TPU
//   kernel's acc / max(l, 1e-30) with l = 0.  Online softmax, m, l and acc
//   in fp32.
//
// The cache is read in place with the caller's strides: the model keeps
// it as (B, Sc, KVH, hd), whose (b, kvh, slot) strides are
// (Sc*KVH*hd, hd, KVH*hd); the TPU op's transpose to (B*KVH, Sc, hd)
// would copy the whole cache in every layer at every step.
//
// What bounds it on an H100: every valid K and V row is read once, and
// each row feeds only 2*G*hd FLOPs of QK^T and PV (G <= 48: at most 48
// FLOP per byte in bf16), far below the card's ~295 FLOP/byte ridge.  So
// the bound is the bytes of K and V up to `valid` over 3.35 TB/s: ~10 us
// for qwen3-0.6b's and qwen1.5-0.5b's caches at B 4, Sc 2080, ~5 us for
// starcoder2-3b's at B 4, Sc 4096.  Keeping those bytes in flight is the
// design's job: Little's law at 3.35 TB/s and ~1 us of latency asks ~25
// KB in flight on each of the 132 SMs.
//
// Both kernels split the slots up to `valid` into `nsplit` chunks chosen
// on the host (no split past `valid`, none empty), since B*KVH rows alone
// fill few SMs (8 for starcoder2-3b at B 4).  A block packs at most GROUP
// = 16 query heads, one m16 tile of the tensor cores: G > 16 (granite-34b's
// MQA: 48 heads over one KV head) is cut into ceil(G / 16) groups of rows,
// each its own block over the same K/V slots, with the per-warp arithmetic
// of G <= 16 unchanged (grid (B*KVH, nsplit, groups)).  The groups read
// the same K/V rows, ceil(G / 16) times, from L2 after the first; a
// design that keeps ceil(G / 16) A fragments a warp and reads K/V once
// is a later redesign.  Each block writes partial (acc, m, l) in fp32,
// and a second small kernel, one block per (row, query head), combines
// them.
//
// bf16 (decode_attention_bf16_kernel, the served path): four warps, each
// with its own ring of K/V tiles of 32 slots in shared memory, in bf16 as
// they arrived, filled by cp.async (STAGES deep: 48 KB a warp, so 64-128
// KB of cache in flight on each SM); the 16-byte chunks of a row are
// XOR-swizzled by the row's low bits, so ldmatrix reads them without bank
// conflicts.  A warp takes every fourth tile of the block's chunk and
// keeps its own softmax state (m, l, acc), so the walk needs no block
// barrier; the block merges its warps' states once, at the end.  QK^T and PV run on the tensor cores (mma.sync m16n8k16, bf16
// in, fp32 accumulators): the G query rows, zero-padded to 16, are one A
// tile, held in registers for the whole walk; K rows are the B operand by
// ldmatrix, V by ldmatrix.trans; q stays unscaled in bf16 and the scale
// is folded into the exp2 of the fp32 scores.  P is rounded to bf16 for
// PV, reused from the S accumulators as the A operand: the one rounding
// the TPU kernel does not make (its p stays fp32); l sums the unrounded p.
//
// fp32 (decode_attention_fp32_kernel, exact on the CUDA cores): each
// block walks its chunk in tiles of 32 slots, the next tile's 16-byte
// loads in registers while the current one (in shared memory) is used;
// lane j of a warp owns slot j for QK^T, a thread owns output columns for
// PV.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int TK = 32;          // slots per tile: one per lane
constexpr int GROUP = 16;       // query heads a block packs (one m16 tile)
constexpr int MAX_G = 48;       // query heads per KV head: 3 groups
constexpr float M_INIT = -1e30f;

// the bf16 tensor-core kernel
constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TS = 32;              // slots per warp tile
constexpr int RING_BYTES = 49152;   // each warp's K/V ring

__device__ __forceinline__ void unpack(const uint4& raw, float* out,
                                       float) {
  const float4 f = *reinterpret_cast<const float4*>(&raw);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}
__device__ __forceinline__ float to_float(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// One tile's K and V rows t0 .. t0 + TK - 1 into registers, 16 bytes a
// load, neighbouring threads on neighbouring addresses of a row; rows at
// or past `hi` are zeros (never garbage that could make p * v a NaN).
template <typename T, int VPT, int VROW>
__device__ __forceinline__ void load_tile(uint4 (&kreg)[VPT],
                                          uint4 (&vreg)[VPT],
                                          const T* __restrict__ kb,
                                          const T* __restrict__ vb,
                                          long long k_ss, long long v_ss,
                                          int t0, int hi, int tid) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int idx = tid + i * NTHREADS;
    const int r = idx / VROW, c = (idx % VROW) * VEC;
    const int slot = t0 + r;
    if (slot < hi) {
      kreg[i] = *reinterpret_cast<const uint4*>(kb + (size_t)slot * k_ss + c);
      vreg[i] = *reinterpret_cast<const uint4*>(vb + (size_t)slot * v_ss + c);
    } else {
      kreg[i] = make_uint4(0u, 0u, 0u, 0u);
      vreg[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Shared-memory layout in floats, for g rows.  K rows are padded by one
// float so that the 32 lanes (32 slots) read 32 different banks.
template <int HD>
struct Layout {
  static constexpr int K_STRIDE = HD + 1;
  __host__ __device__ static int q_off() { return 0; }
  __host__ __device__ static int k_off(int g) { return g * HD; }
  __host__ __device__ static int v_off(int g) {
    return k_off(g) + TK * K_STRIDE;
  }
  __host__ __device__ static int p_off(int g) { return v_off(g) + TK * HD; }
  __host__ __device__ static int corr_off(int g) { return p_off(g) + g * TK; }
  __host__ __device__ static int floats(int g) { return corr_off(g) + g; }
};

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
decode_attention_fp32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, float* __restrict__ part_acc,
                        float* __restrict__ part_ml, int kvh, int g, int n,
                        int chunk, long long k_sb, long long k_sh,
                        long long k_ss, long long v_sb, long long v_sh,
                        long long v_ss, float scale) {
  using L = Layout<HD>;
  constexpr int VEC = 16 / sizeof(T);          // elements per 16-byte load
  constexpr int VROW = HD / VEC;               // loads per cache row
  constexpr int VPT = TK * VROW / NTHREADS;    // loads per thread per tile
  static_assert(TK * VROW % NTHREADS == 0, "tile must split over threads");
  constexpr int GSTEP = NTHREADS / HD;         // threads per output column
  constexpr int RG = (GROUP + GSTEP - 1) / GSTEP;  // rows per thread in PV
  constexpr int WG = GROUP / NWARPS;           // rows per warp in QK^T

  // this block's query heads r0 .. r0 + gl - 1 of the row's g; the
  // shared layout holds gs = min(g, GROUP) rows in every block
  const int r0 = blockIdx.z * GROUP;
  const int gl = min(GROUP, g - r0);
  const int gs = min(g, GROUP);
  extern __shared__ float smem[];
  float* Qs = smem + L::q_off();
  float* Ks = smem + L::k_off(gs);
  float* Vs = smem + L::v_off(gs);
  float* Ps = smem + L::p_off(gs);
  float* Cs = smem + L::corr_off(gs);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row = blockIdx.x;                  // b * kvh + h
  const int split = blockIdx.y;
  const int b = row / kvh, h = row % kvh;
  const T* kb = k + (size_t)b * k_sb + (size_t)h * k_sh;
  const T* vb = v + (size_t)b * v_sb + (size_t)h * v_sh;
  const int lo = split * chunk;
  const int hi = min(lo + chunk, n);

  for (int i = tid; i < gl * HD; i += NTHREADS)
    Qs[i] = to_float(q[((size_t)row * g + r0) * HD + i]) * scale;

  // softmax state of the rows this warp owns: g = warp + NWARPS * i
  float m_r[WG], l_r[WG];
#pragma unroll
  for (int i = 0; i < WG; ++i) {
    m_r[i] = M_INIT;
    l_r[i] = 0.f;
  }
  // PV accumulators: column d, rows g0 + GSTEP * i
  const int d = tid % HD, g0 = tid / HD;
  float acc[RG];
#pragma unroll
  for (int i = 0; i < RG; ++i) acc[i] = 0.f;

  uint4 kreg[VPT], vreg[VPT];
  const int n_tiles = hi > lo ? (hi - lo + TK - 1) / TK : 0;
  if (n_tiles > 0)
    load_tile<T, VPT, VROW>(kreg, vreg, kb, vb, k_ss, v_ss, lo, hi, tid);
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = lo + t * TK;
    __syncthreads();    // Q is in place; the previous PV is done with smem
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int idx = tid + i * NTHREADS;
      const int r = idx / VROW, c = (idx % VROW) * VEC;
      float kf[VEC], vf[VEC];
      unpack(kreg[i], kf, T());
      unpack(vreg[i], vf, T());
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        Ks[r * L::K_STRIDE + c + j] = kf[j];
        Vs[r * HD + c + j] = vf[j];
      }
    }
    __syncthreads();
    if (t + 1 < n_tiles)   // in flight during the math
      load_tile<T, VPT, VROW>(kreg, vreg, kb, vb, k_ss, v_ss, t0 + TK, hi,
                              tid);

    // scores of slot t0 + lane for this warp's rows, then online softmax
    float s[WG];
#pragma unroll
    for (int i = 0; i < WG; ++i) s[i] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < HD; ++dd) {
      const float kv = Ks[lane * L::K_STRIDE + dd];
#pragma unroll
      for (int i = 0; i < WG; ++i) {
        const int gi = warp + NWARPS * i;
        if (gi < gl) s[i] = fmaf(Qs[gi * HD + dd], kv, s[i]);
      }
    }
    const bool in = t0 + lane < hi;
#pragma unroll
    for (int i = 0; i < WG; ++i) {
      const int gi = warp + NWARPS * i;
      if (gi < gl) {
        const float x = in ? s[i] : -INFINITY;
        const float m_new = fmaxf(m_r[i], warp_max(x));
        const float p = expf(x - m_new);
        const float corr = expf(m_r[i] - m_new);
        l_r[i] = l_r[i] * corr + warp_sum(p);
        m_r[i] = m_new;
        Ps[gi * TK + lane] = p;
        if (lane == 0) Cs[gi] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      const int gi = g0 + GSTEP * i;
      if (gi < gl) {
        float a = acc[i] * Cs[gi];
#pragma unroll 8
        for (int j = 0; j < TK; ++j) a = fmaf(Ps[gi * TK + j], Vs[j * HD + d], a);
        acc[i] = a;
      }
    }
  }

  const size_t base = (size_t)row * gridDim.y + split;   // (row, split)
#pragma unroll
  for (int i = 0; i < RG; ++i) {
    const int gi = g0 + GSTEP * i;
    if (gi < gl) part_acc[(base * g + r0 + gi) * HD + d] = acc[i];
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < WG; ++i) {
      const int gi = warp + NWARPS * i;
      if (gi < gl) {
        part_ml[(base * g + r0 + gi) * 2] = m_r[i];
        part_ml[(base * g + r0 + gi) * 2 + 1] = l_r[i];
      }
    }
  }
}

// Combine the splits of one (row, query head): weights exp(m_s - M), M the
// largest m; one block per (row, head) so that B*KVH*G blocks share the
// work, a thread per output column.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
decode_attention_combine_kernel(const float* __restrict__ part_acc,
                                const float* __restrict__ part_ml,
                                T* __restrict__ out, int g, int hd,
                                int nsplit) {
  const int row = blockIdx.x, gi = blockIdx.y;
  float m_max = M_INIT;
  for (int s = 0; s < nsplit; ++s)
    m_max = fmaxf(m_max, part_ml[(((size_t)row * nsplit + s) * g + gi) * 2]);
  for (int d = threadIdx.x; d < hd; d += NTHREADS) {
    float num = 0.f, den = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const size_t r = ((size_t)row * nsplit + s) * g + gi;
      const float w = expf(part_ml[r * 2] - m_max);
      den = fmaf(w, part_ml[r * 2 + 1], den);
      num = fmaf(w, part_acc[r * hd + d], num);
    }
    out[((size_t)row * g + gi) * hd + d] = from_float<T>(num / fmaxf(den, 1e-30f));
  }
}

// Shared memory of the bf16 kernel: per warp, STAGES stages of a K tile
// then a V tile, TS rows of HD bf16 each.
template <int HD>
struct TcLayout {
  static constexpr int ROW_BYTES = HD * 2;
  static constexpr int CHUNKS = HD / 8;             // 16-byte chunks a row
  static constexpr int TILE_BYTES = TS * ROW_BYTES;
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  static constexpr int STAGES = RING_BYTES / STAGE_BYTES;
  static constexpr int WARP_BYTES = STAGES * STAGE_BYTES;
  static constexpr int BLOCK_BYTES = TC_WARPS * WARP_BYTES;
  static_assert(STAGES >= 2, "the ring needs two stages");
};

// byte offset of 16-byte chunk c of row r: chunks XOR-swizzled by r % 8,
// so the 8 rows one ldmatrix phase reads fall in 8 different bank groups
template <int ROW_BYTES>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * ROW_BYTES + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One (row, split, group of query heads) per block; warp w walks tiles w,
// w + 4, ... of the chunk with its own (acc, m, l), and the block merges
// the four at the end into the split's partial of its group's heads.
template <int HD>
__global__ void __launch_bounds__(TC_THREADS, 1)
decode_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             float* __restrict__ part_acc,
                             float* __restrict__ part_ml, int kvh, int g,
                             int n, int chunk, long long k_sb, long long k_sh,
                             long long k_ss, long long v_sb, long long v_sh,
                             long long v_ss, float scale) {
  using namespace mma_sm90;
  using Lt = TcLayout<HD>;
  constexpr int KSTEPS = HD / 16;    // k-steps of QK^T
  constexpr int NT = HD / 8;         // n8 tiles of PV
  constexpr int STAGES = Lt::STAGES;
  extern __shared__ __align__(128) unsigned char tc_smem[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tig = lane & 3;
  const int row = blockIdx.x, split = blockIdx.y;
  const int r0 = blockIdx.z * GROUP;       // query heads r0 .. r0 + gl - 1
  const int gl = min(GROUP, g - r0);
  const int b = row / kvh, h = row % kvh;
  const __nv_bfloat16* kb = k + (size_t)b * k_sb + (size_t)h * k_sh;
  const __nv_bfloat16* vb = v + (size_t)b * v_sb + (size_t)h * v_sh;
  const int lo = split * chunk;
  const int hi = min(lo + chunk, n);
  const int n_tiles = hi > lo ? (hi - lo + TS - 1) / TS : 0;
  const int my_tiles =
      n_tiles > warp ? (n_tiles - warp + TC_WARPS - 1) / TC_WARPS : 0;
  const uint32_t ring = smem_u32(tc_smem) + warp * Lt::WARP_BYTES;
  const float scale_log2 = scale * 1.4426950408889634f;

  // my tile i into stage i % STAGES; rows at or past `hi` are zero-filled
  // (src size 0), never garbage that could make p * v a NaN.  A group is
  // committed even past the last tile, so the wait count stays exact.
  auto fetch = [&](int i) {
    if (i < my_tiles) {
      const int t0 = lo + (warp + i * TC_WARPS) * TS;
      const uint32_t ks = ring + (i % STAGES) * Lt::STAGE_BYTES;
      const uint32_t vs = ks + Lt::TILE_BYTES;
#pragma unroll
      for (int j = 0; j < TS * Lt::CHUNKS / 32; ++j) {
        const int idx = lane + 32 * j;
        const int r = idx / Lt::CHUNKS, c = idx % Lt::CHUNKS;
        const bool in = t0 + r < hi;
        const size_t slot = in ? t0 + r : lo;
        cp_async16(ks + swz<Lt::ROW_BYTES>(r, c), kb + slot * k_ss + c * 8,
                   in ? 16 : 0);
        cp_async16(vs + swz<Lt::ROW_BYTES>(r, c), vb + slot * v_ss + c * 8,
                   in ? 16 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) fetch(i);

  // the group's Q, rows >= gl zero, as the A operand of every k-step of
  // QK^T
  uint32_t qa[KSTEPS][4];
  const __nv_bfloat16* qr = q + ((size_t)row * g + r0) * HD;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c0 = kk * 16 + 2 * tig;
    qa[kk][0] = grp < gl ? ld_pair(qr + grp * HD + c0) : 0u;
    qa[kk][1] = grp + 8 < gl ? ld_pair(qr + (grp + 8) * HD + c0) : 0u;
    qa[kk][2] = grp < gl ? ld_pair(qr + grp * HD + c0 + 8) : 0u;
    qa[kk][3] = grp + 8 < gl ? ld_pair(qr + (grp + 8) * HD + c0 + 8) : 0u;
  }

  // softmax state of rows grp and grp + 8 (m in units of raw scores; l
  // this thread's share of the row sum, reduced over the quad at the end)
  float m0 = M_INIT, m1 = M_INIT, l0 = 0.f, l1 = 0.f;
  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

  for (int i = 0; i < my_tiles; ++i) {
    fetch(i + STAGES - 1);
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const uint32_t ks = ring + (i % STAGES) * Lt::STAGE_BYTES;
    const uint32_t vs = ks + Lt::TILE_BYTES;
    const int t0 = lo + (warp + i * TC_WARPS) * TS;

    // S (16 x TS) = Q K^T: n8 tile j holds slots t0 + 8j ..
    float s[TS / 8][4];
#pragma unroll
    for (int j = 0; j < TS / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int jp = 0; jp < TS / 16; ++jp) {
        // matrix lane / 8 = mi: slots 16 jp + 8 (mi / 2) + lane % 8, chunk
        // 2 kk + mi % 2 -> b0, b1 of tiles 2 jp and 2 jp + 1
        uint32_t bk[4];
        const int mi = lane >> 3;
        ldsm_x4(bk, ks + swz<Lt::ROW_BYTES>(16 * jp + 8 * (mi >> 1) + (lane & 7),
                                            2 * kk + (mi & 1)));
        mma_bf16(s[2 * jp], qa[kk], bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], qa[kk], bk[2], bk[3]);
      }
    }

    // mask the slots past `hi`, then the online softmax of both rows
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < TS / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (t0 + 8 * j + 2 * tig + e >= hi) s[j][e] = s[j][2 + e] = -INFINITY;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f((m0 - mn0) * scale_log2);
    const float c1 = exp2f((m1 - mn1) * scale_log2);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < TS / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = exp2f((s[j][e] - mn0) * scale_log2);
        s[j][2 + e] = exp2f((s[j][2 + e] - mn1) * scale_log2);
        ps0 += s[j][e];
        ps1 += s[j][2 + e];
      }
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      o[nt][0] *= c0;
      o[nt][1] *= c0;
      o[nt][2] *= c1;
      o[nt][3] *= c1;
    }

    // O += P V: P in bf16 from the S accumulators (k-step kp covers slots
    // 16 kp .. 16 kp + 15, S tiles 2 kp and 2 kp + 1), V by ldmatrix.trans
#pragma unroll
    for (int kp = 0; kp < TS / 16; ++kp) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kp][0], s[2 * kp][1]),
                              pack_bf16(s[2 * kp][2], s[2 * kp][3]),
                              pack_bf16(s[2 * kp + 1][0], s[2 * kp + 1][1]),
                              pack_bf16(s[2 * kp + 1][2], s[2 * kp + 1][3])};
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        // matrix mi: slots 16 kp + 8 (mi % 2) + lane % 8, chunk 2 np +
        // mi / 2 -> b0, b1 of n8 tiles 2 np and 2 np + 1
        uint32_t bv[4];
        const int mi = lane >> 3;
        ldsm_x4_t(bv, vs + swz<Lt::ROW_BYTES>(16 * kp + 8 * (mi & 1) + (lane & 7),
                                              2 * np + (mi >> 1)));
        mma_bf16(o[2 * np], pa, bv[0], bv[1]);
        mma_bf16(o[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
    __syncwarp();    // the stage is refilled by the next fetch
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // merge the four warps' states through shared memory (the rings are
  // done with): per warp m, l (16 rows) and acc (16 x HD), then per row
  // the largest m and each warp's weight
  __syncthreads();
  float* Ms = reinterpret_cast<float*>(tc_smem);       // (TC_WARPS, 16)
  float* Ls = Ms + TC_WARPS * 16;                      // (TC_WARPS, 16)
  float* Wt = Ls + TC_WARPS * 16;                      // (TC_WARPS, 16)
  float* Mrow = Wt + TC_WARPS * 16;                    // (16,) merged m, l
  float* Lrow = Mrow + 16;
  float* Acc = Lrow + 16;                              // (TC_WARPS, 16, HD)
  if (tig == 0) {
    Ms[warp * 16 + grp] = m0;
    Ms[warp * 16 + grp + 8] = m1;
    Ls[warp * 16 + grp] = l0;
    Ls[warp * 16 + grp + 8] = l1;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = nt * 8 + 2 * tig;
    *reinterpret_cast<float2*>(Acc + (warp * 16 + grp) * HD + col) =
        make_float2(o[nt][0], o[nt][1]);
    *reinterpret_cast<float2*>(Acc + (warp * 16 + grp + 8) * HD + col) =
        make_float2(o[nt][2], o[nt][3]);
  }
  __syncthreads();
  if (threadIdx.x < 16) {
    const int r = threadIdx.x;
    float mx = M_INIT;
#pragma unroll
    for (int w = 0; w < TC_WARPS; ++w) mx = fmaxf(mx, Ms[w * 16 + r]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < TC_WARPS; ++w) {
      const float wt = exp2f((Ms[w * 16 + r] - mx) * scale_log2);
      Wt[w * 16 + r] = wt;
      l = fmaf(wt, Ls[w * 16 + r], l);
    }
    Mrow[r] = mx;
    Lrow[r] = l;
  }
  __syncthreads();
  // the split's partial (row, split); m in units of scaled scores, as the
  // combine pass takes it
  const size_t base = (size_t)row * gridDim.y + split;
  for (int idx = threadIdx.x; idx < gl * HD; idx += TC_THREADS) {
    const int r = idx / HD, d = idx % HD;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < TC_WARPS; ++w)
      a = fmaf(Wt[w * 16 + r], Acc[(w * 16 + r) * HD + d], a);
    part_acc[(base * g + r0 + r) * HD + d] = a;
  }
  if (threadIdx.x < gl) {
    part_ml[(base * g + r0 + threadIdx.x) * 2] = Mrow[threadIdx.x] * scale;
    part_ml[(base * g + r0 + threadIdx.x) * 2 + 1] = Lrow[threadIdx.x];
  }
}

// The bf16 kernel's shared memory is past the 48 KB default; the limit is
// a property of the current device, so it is set before every launch.
template <int HD>
cudaError_t tc_attributes() {
  return cudaFuncSetAttribute(decode_attention_bf16_kernel<HD>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              TcLayout<HD>::BLOCK_BYTES);
}

struct Args {
  const void *q, *k, *v;
  void* out;
  float* ws;
  int bkv, kvh, g, n, nsplit, chunk;
  // blocks of query heads a row's G is cut into, and the rows each block's
  // shared layout holds
  int groups() const { return (g + GROUP - 1) / GROUP; }
  int gs() const { return g < GROUP ? g : GROUP; }
  long long ks[3], vs[3];
  float scale;
  cudaStream_t stream;
};

template <typename T>
cudaError_t combine(const Args& a, int hd) {
  const float* part_acc = a.ws;
  const float* part_ml = a.ws + (size_t)a.bkv * a.nsplit * a.g * hd;
  decode_attention_combine_kernel<T><<<dim3(a.bkv, a.g), NTHREADS, 0, a.stream>>>(
      part_acc, part_ml, static_cast<T*>(a.out), a.g, hd, a.nsplit);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_fp32(const Args& a) {
  const size_t bytes = (size_t)Layout<HD>::floats(a.gs()) * sizeof(float);
  decode_attention_fp32_kernel<float, HD>
      <<<dim3(a.bkv, a.nsplit, a.groups()), NTHREADS, bytes, a.stream>>>(
          static_cast<const float*>(a.q), static_cast<const float*>(a.k),
          static_cast<const float*>(a.v), a.ws,
          a.ws + (size_t)a.bkv * a.nsplit * a.g * HD, a.kvh, a.g, a.n, a.chunk,
          a.ks[0], a.ks[1], a.ks[2], a.vs[0], a.vs[1], a.vs[2], a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return combine<float>(a, HD);
}

template <int HD>
cudaError_t launch_bf16(const Args& a) {
  cudaError_t err = tc_attributes<HD>();
  if (err != cudaSuccess) return err;
  decode_attention_bf16_kernel<HD>
      <<<dim3(a.bkv, a.nsplit, a.groups()), TC_THREADS,
         TcLayout<HD>::BLOCK_BYTES, a.stream>>>(
          static_cast<const __nv_bfloat16*>(a.q),
          static_cast<const __nv_bfloat16*>(a.k),
          static_cast<const __nv_bfloat16*>(a.v), a.ws,
          a.ws + (size_t)a.bkv * a.nsplit * a.g * HD, a.kvh, a.g, a.n, a.chunk,
          a.ks[0], a.ks[1], a.ks[2], a.vs[0], a.vs[1], a.vs[2], a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return combine<__nv_bfloat16>(a, HD);
}

template <int HD>
cudaError_t occupancy_bf16(int* blocks_per_sm) {
  const cudaError_t err = tc_attributes<HD>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, decode_attention_bf16_kernel<HD>, TC_THREADS,
      TcLayout<HD>::BLOCK_BYTES);
}

template <int HD>
cudaError_t occupancy_fp32(int g, int* blocks_per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, decode_attention_fp32_kernel<float, HD>, NTHREADS,
      (size_t)Layout<HD>::floats(g < GROUP ? g : GROUP) * sizeof(float));
}

}  // namespace

// The blocks of the kernel for (hd, g, dtype) that fit on one SM of the
// current device at once (its registers and shared memory set them); the
// caller sizes the splits by it, for B*KVH * ceil(g / 16) block rows.
// dtype as in repro_decode_attention_fwd.  Returns a CUDA error code (0
// on success).
extern "C" int repro_decode_attention_blocks_per_sm(int hd, int g, int dtype,
                                                    int* blocks_per_sm) {
  if (g <= 0 || g > MAX_G) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && hd == 64) return (int)occupancy_fp32<64>(g, blocks_per_sm);
  if (dtype == 0 && hd == 128) return (int)occupancy_fp32<128>(g, blocks_per_sm);
  if (dtype == 1 && hd == 64) return (int)occupancy_bf16<64>(blocks_per_sm);
  if (dtype == 1 && hd == 128) return (int)occupancy_bf16<128>(blocks_per_sm);
  return (int)cudaErrorInvalidValue;
}

// q (bkv, g, hd) contiguous; k, v addressed as base + b*sb + h*sh + slot*ss
// (elements, row b = bkv-row / kvh, h = bkv-row % kvh), hd contiguous and
// 16-byte aligned; out (bkv, g, hd), g <= 48 (blocks of 16 heads).
// n = min(valid, Sc) slots are read, in nsplit chunks of `chunk` slots
// (nsplit * chunk >= n, every chunk non-empty unless n == 0 and nsplit
// == 1).  workspace:
// bkv*nsplit*g*(hd + 2) floats.  dtype: 0 = float32 (the exact CUDA-core
// kernel), 1 = bfloat16 (the tensor-core kernel).  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int repro_decode_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* workspace,
    int bkv, int kvh, int g, int hd, int n, int nsplit, int chunk,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, float scale, int dtype, void* stream) {
  if (bkv <= 0 || kvh <= 0 || bkv % kvh || g <= 0 || g > MAX_G || n < 0 ||
      nsplit <= 0 || nsplit > 65535 || chunk <= 0 ||
      (long long)nsplit * chunk < n || workspace == nullptr)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, static_cast<float*>(workspace), bkv, kvh, g, n,
               nsplit, chunk, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss}, scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0 && hd == 64) return (int)launch_fp32<64>(a);
  if (dtype == 0 && hd == 128) return (int)launch_fp32<128>(a);
  if (dtype == 1 && hd == 64) return (int)launch_bf16<64>(a);
  if (dtype == 1 && hd == 128) return (int)launch_bf16<128>(a);
  return (int)cudaErrorInvalidValue;
}
