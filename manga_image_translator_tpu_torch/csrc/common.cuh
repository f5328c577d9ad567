// Helpers shared by the port's CUDA kernels.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mit {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reduction through a 32-float shared scratch; every thread gets
// the result. blockDim.x must be a multiple of 32.
template <bool IS_MAX>
__device__ __forceinline__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = IS_MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = (lane < nwarps) ? scratch[lane] : (IS_MAX ? -INFINITY : 0.0f);
  r = IS_MAX ? warp_max(r) : warp_sum(r);
  return r;
}

// exact (erf) GELU, as torch.nn.functional.gelu(approximate='none')
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

// ---- asynchronous copies and tensor-core products (sm_80+) --------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of N bytes (4, 8 or 16) from global to shared memory; only
// src_bytes of them are read, the rest of the N are zero-filled (0 = a
// zero fill that reads nothing). N = 16 bypasses L1.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)), "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)), "l"(src), "n"(N), "r"(src_bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the four 8x8 b16 matrices whose rows the 32 lanes address (lanes 8j to
// 8j + 7: rows 0-7 of matrix j), one register each: a 16x16 A fragment
// when lanes 0-15 address its rows at k 0 and lanes 16-31 at k 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// the same four 8x8 b16 matrices, transposed: from a [k][n] row-major
// panel, lanes 0-15 addressing rows k0..k0+15 at column n0 and lanes 16-31
// the same rows at n0 + 8, r[0..1] is the 16x8 B fragment of columns
// n0..n0+7 and r[2..3] that of n0+8..n0+15
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// two transposed matrices (lanes 0-15 address rows k0..k0+15): one B
// fragment
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// Grid-wide barrier of a persistent kernel whose blocks are all resident
// (a cooperative launch guarantees it), in one atomic per block: block 0
// adds 0x80000000 - (blocks - 1) to the counter *bar, every other block 1,
// so the counter's top bit flips once all have arrived and its low bits
// come back to where they were (the buffer, zeroed once, serves every
// barrier and every launch). Thread 0 fences the block's writes (ordered
// after the others' by the block barrier) and polls; data written by other
// blocks before the barrier must then be read past L1 (cp.async.cg,
// ld.global.cg), which is not coherent across SMs.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    volatile unsigned* vbar = bar;
    __threadfence();
    const unsigned old = atomicAdd(bar, add);
    while (((old ^ *vbar) & 0x80000000u) == 0) {
    }
    __threadfence();
  }
  __syncthreads();
}

// d += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a (16x8, row) . b (8x8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// round to TF32 (10 mantissa bits, to nearest, ties away from zero: the
// result of cvt.rna.tf32.f32) with two integer operations, which issue at
// the full ALU rate where the conversion instruction does not
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo with both TF32: the split of the 3xTF32 product
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// (value, index) order of a top-k: larger value first, ties to the lower
// index (lax.top_k's order)
__device__ __forceinline__ bool topk_before(float av, int ai, float bv,
                                            int bi) {
  return av > bv || (av == bv && ai < bi);
}

}  // namespace mit
