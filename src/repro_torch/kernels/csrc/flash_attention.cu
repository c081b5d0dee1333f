// Prefill attention with GQA, causal and sliding-window masks, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_bhsd (body _kernel).  Same contract:
//   q (B*H, Sq, hd); k, v (B*KVH, Skv, hd); out (B*H, Sq, hd) in q's dtype.
//   GQA kv row of query row bh: (bh / H) * KVH + (bh % H) / (H / KVH).
//   Masks: kv padding; causal kpos <= qpos with no offset (also when
//   Sq != Skv); window kpos > qpos - window (also without causal).
//   A masked score is -1e30 (finite), exactly as the reference oracle
//   (src/repro/kernels/ref.py:attention_ref), so a row with no key left
//   averages V over all Skv keys, as that oracle does.
//   Online softmax with m, l and acc in fp32; out = acc / max(l, 1e-30).
//
// What bounds it on an H100: causal attention at the serving path's
// prefill shape (B=4, S=2048, H=16, hd=128) needs 2*S^2*hd FLOPs per head
// (the causal half of QK^T and PV), 6.9e10 in all, against ~100 MB of
// q, k, v and out: ~680 FLOP per byte, above the card's ~295 bf16
// FLOP/byte ridge, so the bound is the tensor-core rate (~69 us at
// 989 TFLOP/s).  At the serving shape (S=16) it is launch latency.
//
// What this first design does about it: nothing clever yet.  It is a
// simple, exact kernel on the CUDA cores in fp32:
//   * grid (ceil(Sq/64), B*H); each block owns one 64-row q tile and
//     loops over the 64-row kv tiles itself (this loop replaces the TPU's
//     sequential third grid axis);
//   * the loop runs only over the kv tiles that the causal/window limits
//     of the block's rows reach (the TPU kernel's pl.when skips);
//   * Q (pre-scaled), K, V and the score tile live in dynamic shared
//     memory as fp32 (116 KB at hd=128), m/l/corr per row in shared
//     memory, the output accumulator in registers;
//   * 256 threads: S = Q K^T as 4x4 register micro-tiles, one warp per
//     8 rows for the softmax, then acc = acc*corr + P V.
// Tensor cores (mma.sync / wgmma), TMA and warp specialisation are the
// work of a later change; PERF.md records this kernel's time against its
// bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int NTHREADS = 256;
constexpr float MASKED = -1e30f;

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

// First and last key a query row may see, before kv padding.
__device__ __forceinline__ int key_lo(int qpos, int window) {
  return window > 0 ? max(0, qpos - window + 1) : 0;
}
__device__ __forceinline__ int key_hi(int qpos, int skv, int causal) {
  return causal ? min(skv - 1, qpos) : skv - 1;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int sq,
                       int skv, int h, int kvh, int causal, int window,
                       float scale) {
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
  const int q_first = blockIdx.x * BQ;
  const int kv_row = (bh / h) * kvh + (bh % h) / (h / kvh);
  const T* qb = q + (size_t)bh * sq * HD;
  const T* kb = k + (size_t)kv_row * skv * HD;
  const T* vb = v + (size_t)kv_row * skv * HD;
  T* ob = o + (size_t)bh * sq * HD;

  // Q tile, pre-scaled; rows past Sq are zero and never stored
  for (int i = tid; i < BQ * HD; i += NTHREADS) {
    const int r = i / HD, d = i % HD;
    const int qpos = q_first + r;
    Qs[r * L::QK_STRIDE + d] =
        qpos < sq ? to_float(qb[(size_t)qpos * HD + d]) * scale : 0.f;
  }
  for (int r = tid; r < BQ; r += NTHREADS) {
    Ms[r] = MASKED;
    Ls[r] = 0.f;
    Cs[r] = 1.f;
  }

  // kv tiles this block needs.  A row with no key left (only possible with
  // a window, once qpos >= Skv + window - 1, and then for every later row)
  // averages over all keys, so such a block visits every tile.
  const int q_last = min(q_first + BQ - 1, sq - 1);
  int t_begin, t_end;
  if (key_lo(q_last, window) > key_hi(q_last, skv, causal)) {
    t_begin = 0;
    t_end = (skv + BKV - 1) / BKV;
  } else {
    t_begin = key_lo(q_first, window) / BKV;
    t_end = key_hi(q_last, skv, causal) / BKV + 1;
  }

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
      const bool in = kpos < skv;
      Ks[r * L::QK_STRIDE + d] = in ? to_float(kb[(size_t)kpos * HD + d]) : 0.f;
      Vs[r * HD + d] = in ? to_float(vb[(size_t)kpos * HD + d]) : 0.f;
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
      const int qpos = q_first + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = kv_first + c;
        float val = s[i][j];
        if (kpos >= skv)
          val = -INFINITY;  // padding: never a key, p = 0
        else if ((causal && kpos > qpos) ||
                 (window > 0 && kpos <= qpos - window))
          val = MASKED;
        Ss[r * L::S_STRIDE + c] = val;
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
      float p[RPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) p[i] = Ss[(orow + TR * i) * L::S_STRIDE + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) vv[j] = Vs[kk * HD + ocol + TC * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = orow + TR * i;
    const int qpos = q_first + r;
    if (qpos < sq) {
      const float inv = 1.f / fmaxf(Ls[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        ob[(size_t)qpos * HD + ocol + TC * j] = from_float<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int sq, int skv, int h, int kvh, int causal,
                   int window, float scale, cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, HD>;
  const size_t bytes = Smem<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  kern<<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, skv, h, kvh, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, int bh, int sq, int skv, int h, int kvh,
                        int causal, int window, float scale,
                        cudaStream_t stream) {
  switch (hd) {
    case 8:
      return launch<T, 8>(q, k, v, o, bh, sq, skv, h, kvh, causal, window, scale, stream);
    case 16:
      return launch<T, 16>(q, k, v, o, bh, sq, skv, h, kvh, causal, window, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, bh, sq, skv, h, kvh, causal, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, bh, sq, skv, h, kvh, causal, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, bh, sq, skv, h, kvh, causal, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no window.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, int bh,
                                         int sq, int skv, int h, int kvh,
                                         int hd, int causal, int window,
                                         float scale, int dtype,
                                         void* stream) {
  if (bh <= 0 || sq <= 0 || skv <= 0 || h <= 0 || kvh <= 0 || h % kvh)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_hd<float>(hd, q, k, v, o, bh, sq, skv, h, kvh,
                                   causal, window, scale, s);
  if (dtype == 1)
    return (int)dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, bh, sq, skv, h,
                                           kvh, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
