// Mamba within-chunk selective scan for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py: ssm_chunk_scan
// (body _kernel).  Same contract:
//   da, dbx (B, L, D, ST) fp32, contiguous; h (B, L, D, ST) fp32 with
//   h_t = da_t * h_{t-1} + dbx_t from h_0 = 0, every h_t written.
// Each (b, d, st) lane is an independent recurrence along t; the lanes of
// one step are contiguous (D*ST floats), so step t of lane j sits at
// b*L*N + t*N + j with N = D*ST.  The TPU kernel cuts D into VMEM blocks
// of block_d and pads D; here nothing is padded: a thread owns lanes and
// the grid's edge is masked.
//
// Rounding: h is computed as a product rounded to fp32, then a sum rounded
// to fp32 (__fmul_rn, __fadd_rn: no fused multiply-add), which is what the
// plain version (a mul and an add per step in PyTorch) and the reference
// compute, so kernel and plain agree bit for bit.
//
// What bounds it on an H100: one multiply and one add per element, three
// fp32 tensors moved once (da and dbx read, h written): 12 bytes per
// element, far below the ~295 FLOP/byte ridge.  The bound is bytes over
// 3.35 TB/s: 1.61 GB = 0.48 ms at Jamba's (B 4, L 256, D 8192, ST 16),
// 0.12 ms at B 1.
//
// What this first design does about it:
//   * one thread per 4 lanes with 16-byte float4 loads and stores (a
//     scalar path when D*ST % 4 != 0 or a pointer is not 16-byte aligned);
//     neighbouring threads own neighbouring lanes, so every warp's access
//     is a coalesced 512-byte run at each step;
//   * the loop over t is unrolled by UNROLL steps whose loads of da and dbx
//     are all issued before the first of them is used (they do not depend
//     on h), so a thread keeps UNROLL * 32 bytes in flight instead of
//     waiting one DRAM latency per step;
//   * grid (ceil(N / (4 * NTHREADS)), B): at B 4, 32,768 threads per
//     sequence, 131,072 in all, one wave on 132 SMs.
// A fused kernel that forms da/dbx from dt, A, B, x and contracts with C on
// the fly (never writing (B, L, D, ST) to memory) is later work.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int UNROLL = 8;

__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

__device__ __forceinline__ float4 step(const float4& a, const float4& h,
                                       const float4& b) {
  return make_float4(step(a.x, h.x, b.x), step(a.y, h.y, b.y),
                     step(a.z, h.z, b.z), step(a.w, h.w, b.w));
}

// One thread, one V of lanes of sequence blockIdx.y: V = float4 owns four
// lanes [4*i, 4*i + 4) (16-byte loads), V = float one lane (any D*ST, any
// alignment).  n counts V's per step.
template <typename V>
__global__ void __launch_bounds__(NTHREADS)
ssm_scan_kernel(const V* __restrict__ da, const V* __restrict__ dbx,
                V* __restrict__ h, int L, long long n) {
  const long long i = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (i >= n) return;
  const size_t base = (size_t)blockIdx.y * (size_t)L * (size_t)n + i;
  const V* pa = da + base;
  const V* pb = dbx + base;
  V* ph = h + base;
  V carry{};
  int t = 0;
  for (; t + UNROLL <= L; t += UNROLL) {
    V a[UNROLL], b[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      a[u] = __ldg(pa + (size_t)(t + u) * n);
      b[u] = __ldg(pb + (size_t)(t + u) * n);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      carry = step(a[u], carry, b[u]);
      ph[(size_t)(t + u) * n] = carry;
    }
  }
  for (; t < L; ++t) {
    carry = step(__ldg(pa + (size_t)t * n), carry, __ldg(pb + (size_t)t * n));
    ph[(size_t)t * n] = carry;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// da, dbx, h: (b, l, n) fp32 contiguous, n = D * ST.  Returns the CUDA
// error of the launch (0 on success); launches on `stream`, no sync.
extern "C" int repro_ssm_chunk_scan_fwd(const void* da, const void* dbx,
                                        void* h, int b, int l, long long n,
                                        void* stream) {
  if (b <= 0 || b > 65535 || l <= 0 || n <= 0 || da == nullptr ||
      dbx == nullptr || h == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0 && aligned16(da) && aligned16(dbx) &&
                   aligned16(h);
  const long long lanes = vec ? n / 4 : n;
  const long long blocks = (lanes + NTHREADS - 1) / NTHREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)b);
  if (vec)
    ssm_scan_kernel<float4><<<grid, NTHREADS, 0, s>>>(
        static_cast<const float4*>(da), static_cast<const float4*>(dbx),
        static_cast<float4*>(h), l, lanes);
  else
    ssm_scan_kernel<float><<<grid, NTHREADS, 0, s>>>(
        static_cast<const float*>(da), static_cast<const float*>(dbx),
        static_cast<float*>(h), l, lanes);
  return (int)cudaGetLastError();
}
