// AdamW's update of every leaf of a training step, as one multi-tensor pass,
// for Hopper.
//
// It replaces no TPU kernel: the reference updates its parameters in its
// jitted step (src/repro/training/optimizer.py:adamw_update), which XLA
// fuses.  The port's eager leaf loop (kernels/adamw.py:adamw_step_plain)
// ran ~21 fp32 passes a leaf through two scratch tensors the size of the
// leaf, ~7,000 launches a step for qwen3-0.6b's 310 leaves, so the host's
// dispatch of the update held the card idle.
//
// The contract.  A table of leaves, one row of 8 int64 a leaf (packed by
// kernels/adamw.py:leaf_table): the addresses of the parameter p (bf16 or
// fp32), its gradient g (of p's dtype, laid out as p), its fp32 moments m
// and v, the element count n, the leaf's first chunk, and flags.  Each leaf
// is cut into chunks of CHUNK elements; chunk c belongs to the last leaf
// whose first chunk is <= c.
//
//   adamw_sumsq_kernel: a fixed grid walks the chunks (block b takes b,
//     b + G, ...); each thread sums g*g in fp64 in a fixed order and each
//     block writes one fp64 partial after a fixed tree reduction, so the
//     sum is the same run to run on one card.
//   adamw_finish_kernel: one block sums the partials in a fixed order and
//     writes gnorm = sqrt(sum) and the clip scale as the leaf loop's caller
//     computes them with ATen: min(reciprocal(max(gnorm, 1e-9)) * clip, 1)
//     (`clip / t` is `t.reciprocal() * clip` in PyTorch).
//   adamw_update_kernel: a block a chunk; each element's g, p, m, v read
//     once and m, v, p written once, with the leaf loop's ATen operations
//     in its order, each rounded to fp32 (__fmul_rn, __fadd_rn, __fdiv_rn,
//     __fsqrt_rn: nothing contracted into an FMA), so the two agree bit for
//     bit.  ATen's CUDA division by a Python scalar multiplies by the fp32
//     reciprocal; the wrapper passes those reciprocals.  p is cast back
//     round-to-nearest-even, as `p.copy_` does.
//
// What bounds it on an H100: bytes, far below the ridge.  A bf16 parameter
// moves 22 bytes in the update (g, p, m, v read; m, v, p written) and 2 in
// the norm's read of g: 14.3 GB, 4.3 ms at 3.35 TB/s, for qwen3-0.6b's
// 596 M parameters.  What the design does about it: one read of g for the
// norm and one pass for the update, nothing else in device memory; loads
// and stores of 16 bytes a thread (8 elements: one uint4 of bf16 or two
// float4 of fp32), with a scalar tail and a scalar route for a leaf whose
// addresses are not all 16-byte aligned; three launches a step whatever
// the number of leaves.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NTHREADS = 256;
constexpr long long CHUNK = 32768;     // kernels/adamw.py: CHUNK

// flags of a leaf (kernels/adamw.py: BF16, DECAY, VEC)
constexpr long long BF16 = 1, DECAY = 2, VEC = 4;

struct Leaf {
  long long p, g, m, v, n, first, flags, pad;
};

struct Hyper {
  float lr, b1, omb1, b2, omb2, inv_bc1, inv_bc2, eps, wd;
};

// the last leaf whose first chunk is <= c (leaves have >= 1 chunk each)
__device__ __forceinline__ int find_leaf(const Leaf* leaves, int nleaves,
                                         long long c) {
  int lo = 0, hi = nleaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (leaves[mid].first <= c) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void load8(const float* s, float* x) {
  const float4 a = reinterpret_cast<const float4*>(s)[0];
  const float4 b = reinterpret_cast<const float4*>(s)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* s, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(s);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* d, const float* x) {
  reinterpret_cast<float4*>(d)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(d)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* d, const float* x) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    h[k] = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
  *reinterpret_cast<uint4*>(d) = u;
}

__device__ __forceinline__ void store1(float* d, float x) { *d = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* d, float x) {
  *d = __float2bfloat16_rn(x);
}

// One element, the leaf loop's operations in its order:
//   g = g scale; m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2;
//   d = (m / bc1) / (sqrt(v / bc2) + eps) [+ wd p]; p = p - lr d
__device__ __forceinline__ void adamw_elem(float g, float& p, float& m,
                                           float& v, float scale,
                                           const Hyper& h, bool decay) {
  g = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(g, h.omb1));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(g, g), h.omb2));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.inv_bc2)), h.eps);
  float d = __fdiv_rn(__fmul_rn(m, h.inv_bc1), den);
  if (decay) d = __fadd_rn(d, __fmul_rn(p, h.wd));
  p = __fsub_rn(p, __fmul_rn(d, h.lr));
}

template <typename T>
__device__ __forceinline__ void update_chunk(const Leaf& L, long long start,
                                             long long end, float scale,
                                             const Hyper& h) {
  T* __restrict__ p = reinterpret_cast<T*>(L.p);
  const T* __restrict__ g = reinterpret_cast<const T*>(L.g);
  float* __restrict__ m = reinterpret_cast<float*>(L.m);
  float* __restrict__ v = reinterpret_cast<float*>(L.v);
  const bool decay = (L.flags & DECAY) != 0;
  long long tail = start;
  if (L.flags & VEC) {
    tail = start + ((end - start) & ~7LL);
    for (long long i = start + 8LL * threadIdx.x; i < tail;
         i += 8LL * NTHREADS) {
      float gx[8], px[8], mx[8], vx[8];
      load8(g + i, gx);
      load8(p + i, px);
      load8(m + i, mx);
      load8(v + i, vx);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        adamw_elem(gx[k], px[k], mx[k], vx[k], scale, h, decay);
      store8(m + i, mx);
      store8(v + i, vx);
      store8(p + i, px);
    }
  }
  for (long long i = tail + threadIdx.x; i < end; i += NTHREADS) {
    float pi = to_f(p[i]), mi = m[i], vi = v[i];
    adamw_elem(to_f(g[i]), pi, mi, vi, scale, h, decay);
    m[i] = mi;
    v[i] = vi;
    store1(p + i, pi);
  }
}

template <typename T>
__device__ __forceinline__ void sumsq_chunk(const Leaf& L, long long start,
                                            long long end, double& acc) {
  const T* __restrict__ g = reinterpret_cast<const T*>(L.g);
  long long tail = start;
  if (L.flags & VEC) {
    tail = start + ((end - start) & ~7LL);
    for (long long i = start + 8LL * threadIdx.x; i < tail;
         i += 8LL * NTHREADS) {
      float x[8];
      load8(g + i, x);
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += (double)x[k] * (double)x[k];
    }
  }
  for (long long i = tail + threadIdx.x; i < end; i += NTHREADS) {
    const double x = to_f(g[i]);
    acc += x * x;
  }
}

// the block's sum in a fixed order, valid in thread 0
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warp_sums[NTHREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x < 32) {
    x = threadIdx.x < NTHREADS / 32 ? warp_sums[threadIdx.x] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  }
  return x;
}

__global__ void __launch_bounds__(NTHREADS)
adamw_sumsq_kernel(const Leaf* __restrict__ leaves, int nleaves,
                   long long nchunks, double* __restrict__ partials) {
  __shared__ Leaf L;
  double acc = 0.0;
  for (long long c = blockIdx.x; c < nchunks; c += gridDim.x) {
    __syncthreads();                  // every thread is done with the last L
    if (threadIdx.x == 0) L = leaves[find_leaf(leaves, nleaves, c)];
    __syncthreads();
    const long long start = (c - L.first) * CHUNK;
    const long long end = min(start + CHUNK, L.n);
    if (L.flags & BF16)
      sumsq_chunk<__nv_bfloat16>(L, start, end, acc);
    else
      sumsq_chunk<float>(L, start, end, acc);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(NTHREADS)
adamw_finish_kernel(const double* __restrict__ partials, int n, float clip,
                    float* __restrict__ out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += NTHREADS) acc += partials[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) {
    const float gnorm = (float)sqrt(acc);
    // torch.clamp keeps a NaN, fmaxf / fminf would drop it
    const float lo = isnan(gnorm) ? gnorm : fmaxf(gnorm, 1e-9f);
    const float s = __fmul_rn(__fdiv_rn(1.0f, lo), clip);
    out[0] = gnorm;
    out[1] = isnan(s) ? s : fminf(s, 1.0f);
  }
}

__global__ void __launch_bounds__(NTHREADS)
adamw_update_kernel(const Leaf* __restrict__ leaves, int nleaves,
                    const float* __restrict__ scale_p, Hyper h) {
  __shared__ Leaf L;
  const long long c = blockIdx.x;
  if (threadIdx.x == 0) L = leaves[find_leaf(leaves, nleaves, c)];
  __syncthreads();
  const long long start = (c - L.first) * CHUNK;
  const long long end = min(start + CHUNK, L.n);
  const float scale = *scale_p;
  if (L.flags & BF16)
    update_chunk<__nv_bfloat16>(L, start, end, scale, h);
  else
    update_chunk<float>(L, start, end, scale, h);
}

}  // namespace

// The gradients' global norm and clip scale: `nblocks` partials of the sum
// of squares, then out[0] = gnorm, out[1] = scale (fp32).  Two launches.
extern "C" int repro_adamw_grad_norm(const void* leaves, int nleaves,
                                     long long nchunks, void* partials,
                                     int nblocks, float clip, void* out,
                                     void* stream) {
  if (leaves == nullptr || nleaves <= 0 || nchunks < nleaves ||
      nchunks > 0x7fffffffLL || partials == nullptr || nblocks <= 0 ||
      out == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  adamw_sumsq_kernel<<<nblocks, NTHREADS, 0, s>>>(
      static_cast<const Leaf*>(leaves), nleaves, nchunks,
      static_cast<double*>(partials));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  adamw_finish_kernel<<<1, NTHREADS, 0, s>>>(
      static_cast<const double*>(partials), nblocks, clip,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// Every leaf's update in place, given the clip scale (a device fp32).  One
// launch, a block a chunk.
extern "C" int repro_adamw_update(const void* leaves, int nleaves,
                                  long long nchunks, const void* scale,
                                  float lr, float b1, float omb1, float b2,
                                  float omb2, float inv_bc1, float inv_bc2,
                                  float eps, float wd, void* stream) {
  if (leaves == nullptr || nleaves <= 0 || nchunks < nleaves ||
      nchunks > 0x7fffffffLL || scale == nullptr)
    return (int)cudaErrorInvalidValue;
  const Hyper h{lr, b1, omb1, b2, omb2, inv_bc1, inv_bc2, eps, wd};
  adamw_update_kernel<<<(unsigned)nchunks, NTHREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(leaves), nleaves,
      static_cast<const float*>(scale), h);
  return (int)cudaGetLastError();
}
