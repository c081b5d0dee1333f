// Decode attention for Hopper: one query token per sequence against a
// (ring-buffer) KV cache, the G query heads of one KV head packed as rows.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention_packed (body _kernel).  Same contract:
//   q (B*KVH, G, hd); k, v (B, Sc, KVH, hd), addressed through their
//   (b, kvh, slot) strides; out (B*KVH, G, hd) in q's dtype.  Query head
//   h = kvh * G + g.
//   Scale 1/sqrt(hd) on q.  Slots >= valid (and >= Sc) are masked and the
//   tiles past them are skipped, so valid == 0 gives zeros: the TPU
//   kernel's acc / max(l, 1e-30) with l = 0.  Online softmax, m, l and acc
//   in fp32; p stays fp32 for PV (the TPU kernel casts it to v's dtype
//   after upcasting v to fp32, which is no cast at all).
//
// The cache is read in place with the caller's strides: the model keeps
// it as (B, Sc, KVH, hd), whose (b, kvh, slot) strides are
// (Sc*KVH*hd, hd, KVH*hd); the TPU op's transpose to (B*KVH, Sc, hd)
// would copy the whole cache in every layer at every step.
//
// What bounds it on an H100: every valid K and V row is read once, and
// each row feeds only 2*G*hd FLOPs of QK^T and PV (G <= 16: at most 16
// FLOP per byte in bf16), far below the card's ~295 FLOP/byte ridge.  So
// the bound is the bytes of K and V up to `valid` over 3.35 TB/s: ~10 us
// for qwen3-0.6b's and qwen1.5-0.5b's caches at B 4, Sc 2080, ~5 us for
// starcoder2-3b's at B 4, Sc 4096.
//
// What this first design does about it:
//   * flash-decoding: B*KVH rows alone fill few of the 132 SMs (8 for
//     starcoder2-3b at B 4), so the slots up to `valid` are cut into
//     `nsplit` chunks chosen on the host from `valid` and the SM count
//     (no split past `valid`, none empty); grid (B*KVH, nsplit).  Each
//     block writes its partial (acc, m, l) in fp32 and a second small
//     kernel, one block per (row, query head), combines them (also for a
//     single split: one code path);
//   * each block walks its chunk in tiles of 32 slots: 16-byte coalesced
//     loads of K and V into registers for the next tile while the current
//     one (in shared memory as fp32) is used, so a tile's loads are in
//     flight during the previous tile's arithmetic;
//   * QK^T: lane j of a warp owns slot j of the tile, the warps split the
//     G rows, and the score stays in a register through the softmax
//     (warp max and sum by shuffles); PV: a thread owns output columns d
//     for its rows, reading p (broadcast) and V rows (conflict-free).
// Tensor cores, TMA and a deeper pipeline are later work; PERF.md records
// this kernel's time against its bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int TK = 32;          // slots per tile: one per lane
constexpr int MAX_G = 16;       // query heads per KV head
constexpr float M_INIT = -1e30f;

__device__ __forceinline__ void unpack(const uint4& raw, float* out,
                                       float) {
  const float4 f = *reinterpret_cast<const float4*>(&raw);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}
__device__ __forceinline__ void unpack(const uint4& raw, float* out,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
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
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
  constexpr int RG = (MAX_G + GSTEP - 1) / GSTEP;  // rows per thread in PV
  constexpr int WG = MAX_G / NWARPS;           // rows per warp in QK^T

  extern __shared__ float smem[];
  float* Qs = smem + L::q_off();
  float* Ks = smem + L::k_off(g);
  float* Vs = smem + L::v_off(g);
  float* Ps = smem + L::p_off(g);
  float* Cs = smem + L::corr_off(g);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row = blockIdx.x;                  // b * kvh + h
  const int split = blockIdx.y;
  const int b = row / kvh, h = row % kvh;
  const T* kb = k + (size_t)b * k_sb + (size_t)h * k_sh;
  const T* vb = v + (size_t)b * v_sb + (size_t)h * v_sh;
  const int lo = split * chunk;
  const int hi = min(lo + chunk, n);

  for (int i = tid; i < g * HD; i += NTHREADS)
    Qs[i] = to_float(q[(size_t)row * g * HD + i]) * scale;

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
        if (gi < g) s[i] = fmaf(Qs[gi * HD + dd], kv, s[i]);
      }
    }
    const bool in = t0 + lane < hi;
#pragma unroll
    for (int i = 0; i < WG; ++i) {
      const int gi = warp + NWARPS * i;
      if (gi < g) {
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
      if (gi < g) {
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
    if (gi < g) part_acc[(base * g + gi) * HD + d] = acc[i];
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < WG; ++i) {
      const int gi = warp + NWARPS * i;
      if (gi < g) {
        part_ml[(base * g + gi) * 2] = m_r[i];
        part_ml[(base * g + gi) * 2 + 1] = l_r[i];
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

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* ws, int bkv, int kvh, int g, int n, int nsplit,
                   int chunk, const long long* ks, const long long* vs,
                   float scale, cudaStream_t stream) {
  const size_t bytes = (size_t)Layout<HD>::floats(g) * sizeof(float);
  float* part_acc = ws;
  float* part_ml = ws + (size_t)bkv * nsplit * g * HD;
  decode_attention_kernel<T, HD><<<dim3(bkv, nsplit), NTHREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), part_acc, part_ml, kvh, g, n, chunk, ks[0],
      ks[1], ks[2], vs[0], vs[1], vs[2], scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_attention_combine_kernel<T><<<dim3(bkv, g), NTHREADS, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), g, HD, nsplit);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* out, float* ws, int bkv, int kvh, int g, int n,
                        int nsplit, int chunk, const long long* ks,
                        const long long* vs, float scale,
                        cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, out, ws, bkv, kvh, g, n, nsplit, chunk, ks, vs, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, ws, bkv, kvh, g, n, nsplit, chunk, ks, vs, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (bkv, g, hd) contiguous; k, v addressed as base + b*sb + h*sh + slot*ss
// (elements, row b = bkv-row / kvh, h = bkv-row % kvh), hd contiguous and
// 16-byte aligned; out (bkv, g, hd).  n = min(valid, Sc) slots are read,
// in nsplit chunks of `chunk` slots (nsplit * chunk >= n, every chunk
// non-empty unless n == 0 and nsplit == 1).  workspace:
// bkv*nsplit*g*(hd + 2) floats.  dtype: 0 = float32, 1 = bfloat16.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int repro_decode_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* workspace,
    int bkv, int kvh, int g, int hd, int n, int nsplit, int chunk,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, float scale, int dtype, void* stream) {
  if (bkv <= 0 || kvh <= 0 || bkv % kvh || g <= 0 || g > MAX_G || n < 0 ||
      nsplit <= 0 || nsplit > 65535 || chunk <= 0 ||
      (long long)nsplit * chunk < n || workspace == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long ks[3] = {k_sb, k_sh, k_ss};
  const long long vs[3] = {v_sb, v_sh, v_ss};
  float* ws = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_hd<float>(hd, q, k, v, out, ws, bkv, kvh, g, n,
                                   nsplit, chunk, ks, vs, scale, s);
  if (dtype == 1)
    return (int)dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, ws, bkv, kvh, g,
                                           n, nsplit, chunk, ks, vs, scale, s);
  return (int)cudaErrorInvalidValue;
}
