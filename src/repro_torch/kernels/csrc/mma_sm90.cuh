// Warp-level building blocks shared by the decode-attention and mLSTM
// kernels: cp.async copies into shared memory,
// ldmatrix, and the bf16 tensor-core product mma.sync.m16n8k16 with fp32
// accumulation.
//
// Fragment layouts of m16n8k16 (lane = 4 * group + tig):
//   A (16 x 16, row-major), a[0..3] of two bf16 each:
//     a0 (row group,     cols 2 tig, 2 tig + 1)   a1 (row group + 8, same)
//     a2 (row group,     cols 2 tig + 8, + 9)     a3 (row group + 8, same)
//   B (16 x 8), b[0..1]: b0 (rows 2 tig, 2 tig + 1; col group),
//     b1 (rows 2 tig + 8, + 9; col group)
//   C (16 x 8 fp32), c[0..3]: c0, c1 (row group, cols 2 tig, 2 tig + 1),
//     c2, c3 (row group + 8, same cols)
// ldmatrix.x4 loads four 8 x 8 bf16 matrices, lanes 8i .. 8i + 7 giving
// the row addresses (16 bytes each) of matrix i; without .trans a lane
// receives (row lane / 4, cols 2 (lane % 4), + 1) of each matrix, with
// .trans its transpose.  So a matrix stored with k contiguous gives a B
// fragment (or, stored with rows contiguous, an A fragment) without
// .trans, and one stored with n (or m) contiguous gives it with .trans.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a b, bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16 (lo in the low half), rounded to
// nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// x = hi + lo with hi = bf16(x) and lo = bf16(x - hi): the pair keeps ~16
// of fp32's 24 mantissa bits (x - hi is exact in fp32)
__device__ __forceinline__ void split_bf16(float x, __nv_bfloat16& hi,
                                           __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

// eight floats split as above, packed: hi (and lo) as 8 bf16 in 16 bytes
__device__ __forceinline__ void split8(const float* x, uint4& hi, uint4& lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 hb = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    const float2 hf = __bfloat1622float2(hb);
    const __nv_bfloat162 lb =
        __floats2bfloat162_rn(x[2 * i] - hf.x, x[2 * i + 1] - hf.y);
    h[i] = *reinterpret_cast<const uint32_t*>(&hb);
    l[i] = *reinterpret_cast<const uint32_t*>(&lb);
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

}  // namespace mma_sm90
