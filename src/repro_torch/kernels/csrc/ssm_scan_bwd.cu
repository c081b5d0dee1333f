// Gradient of the Mamba within-chunk selective scan, for Hopper.
//
// The gradient of the TPU kernel src/repro/kernels/ssm_scan.py:39
// ssm_chunk_scan (whose forward ssm_scan.cu ports).  The reference has no
// backward kernel: it trains through XLA's autodiff of the plain scan
// (src/repro/kernels/ref.py:55 ssm_chunk_scan_ref and the associative scan
// src/repro/models/ssm.py:84 _chunk_scan).  This kernel computes that
// gradient.  Per lane (b, d, st), with h the forward's output:
//   g_{L-1} = dh_{L-1},  g_t = dh_t + da_{t+1} * g_{t+1}   (t from L-2 to 0)
//   d dbx_t = g_t,       d da_t = g_t * h_{t-1}            (h_{-1} = 0)
// Inputs da, h, dh and outputs d da, d dbx are (B, L, D, ST) fp32,
// contiguous, in the forward's layout: step t of lane j at b*L*N + t*N + j
// with N = D*ST.
//
// Rounding: each product and each sum is rounded to fp32 on its own
// (__fmul_rn, __fadd_rn: no fused multiply-add), as ssm_scan.cu does.
// Autograd through the plain loop (ssm_chunk_scan_plain) forms exactly
// these products and two-term sums (a two-term sum does not depend on its
// order), so kernel and plain backward agree bit for bit.
//
// What bounds it on an H100: one multiply-add and one multiply per
// element against 20 bytes moved (da, h, dh read; d da, d dbx written):
// far below the ~295 FLOP/byte ridge, so bytes over 3.35 TB/s: 2.68 GB,
// 0.80 ms at Jamba's (B 4, L 256, D 8192, ST 16), 0.20 ms at B 1.
//
// What its design does about it (the forward's, walked backwards):
//   * one thread per 4 lanes with 16-byte float4 loads and stores (a
//     scalar path when D*ST % 4 != 0 or a pointer is not 16-byte aligned);
//     neighbouring threads own neighbouring lanes, so every warp's access
//     is a coalesced 512-byte run at each step;
//   * t walks from L-1 down to 0, UNROLL steps at a time, the loads of da
//     (at t+1), dh and h (at t-1) of all UNROLL steps issued before the
//     first is used (none depends on the carried g);
//   * grid (ceil(N / (4 * NTHREADS)), B), as the forward.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int UNROLL = 8;

__device__ __forceinline__ float fmul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float4 fmul(const float4& a, const float4& b) {
  return make_float4(fmul(a.x, b.x), fmul(a.y, b.y), fmul(a.z, b.z),
                     fmul(a.w, b.w));
}
__device__ __forceinline__ float4 fadd(const float4& a, const float4& b) {
  return make_float4(fadd(a.x, b.x), fadd(a.y, b.y), fadd(a.z, b.z),
                     fadd(a.w, b.w));
}

// One thread, one V of lanes of sequence blockIdx.y (V = float4: four
// lanes, V = float: one).  n counts V's per step.
template <typename V>
__global__ void __launch_bounds__(NTHREADS)
ssm_scan_bwd_kernel(const V* __restrict__ da, const V* __restrict__ h,
                    const V* __restrict__ dh, V* __restrict__ dda,
                    V* __restrict__ ddbx, int L, long long n) {
  const long long i = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (i >= n) return;
  const size_t base = (size_t)blockIdx.y * (size_t)L * (size_t)n + i;
  const V* pa = da + base;
  const V* ph = h + base;
  const V* pd = dh + base;
  V* pga = dda + base;
  V* pgb = ddbx + base;
  const V zero{};
  // step t reads da_{t+1} (none at t = L-1), dh_t and h_{t-1} (0 at t = 0)
  auto a_at = [&](int t) { return t + 1 < L ? __ldg(pa + (size_t)(t + 1) * n)
                                            : zero; };
  auto h_at = [&](int t) { return t > 0 ? __ldg(ph + (size_t)(t - 1) * n)
                                        : zero; };
  V g = zero;
  int t = L - 1;
  for (; t + 1 >= UNROLL; t -= UNROLL) {
    V a[UNROLL], d[UNROLL], hp[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      a[u] = a_at(t - u);
      d[u] = __ldg(pd + (size_t)(t - u) * n);
      hp[u] = h_at(t - u);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      // g_t = dh_t + da_{t+1} g_{t+1}; at t = L-1 the product is 0 * 0
      // and dh + 0 is dh exactly
      g = fadd(d[u], fmul(a[u], g));
      pgb[(size_t)(t - u) * n] = g;
      pga[(size_t)(t - u) * n] = fmul(g, hp[u]);
    }
  }
  for (; t >= 0; --t) {
    g = fadd(__ldg(pd + (size_t)t * n), fmul(a_at(t), g));
    pgb[(size_t)t * n] = g;
    pga[(size_t)t * n] = fmul(g, h_at(t));
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// da, h, dh, dda, ddbx: (b, l, n) fp32 contiguous, n = D * ST.  Returns
// the CUDA error of the launch (0 on success); launches on `stream`, no
// sync.
extern "C" int repro_ssm_chunk_scan_bwd(const void* da, const void* h,
                                        const void* dh, void* dda,
                                        void* ddbx, int b, int l,
                                        long long n, void* stream) {
  if (b <= 0 || b > 65535 || l <= 0 || n <= 0 || da == nullptr ||
      h == nullptr || dh == nullptr || dda == nullptr || ddbx == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0 && aligned16(da) && aligned16(h) &&
                   aligned16(dh) && aligned16(dda) && aligned16(ddbx);
  const long long lanes = vec ? n / 4 : n;
  const long long blocks = (lanes + NTHREADS - 1) / NTHREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)b);
  if (vec)
    ssm_scan_bwd_kernel<float4><<<grid, NTHREADS, 0, s>>>(
        static_cast<const float4*>(da), static_cast<const float4*>(h),
        static_cast<const float4*>(dh), static_cast<float4*>(dda),
        static_cast<float4*>(ddbx), l, lanes);
  else
    ssm_scan_bwd_kernel<float><<<grid, NTHREADS, 0, s>>>(
        static_cast<const float*>(da), static_cast<const float*>(h),
        static_cast<const float*>(dh), static_cast<float*>(dda),
        static_cast<float*>(ddbx), l, lanes);
  return (int)cudaGetLastError();
}
