// Shared device helpers for the moshi_tpu_torch kernels (plain C entry
// points, loaded with ctypes by kernels/build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define MT_FULL_MASK 0xffffffffu

__device__ __forceinline__ float mt_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(MT_FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ int mt_warp_sum_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(MT_FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ float mt_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(MT_FULL_MASK, v, o));
  return v;
}

// Sum over the whole block; every thread gets the result.  `red` holds at
// least 32 floats of shared memory.  Contains __syncthreads: call from all
// threads.
__device__ __forceinline__ float mt_block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = mt_warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < nwarps ? red[lane] : 0.f;
  v = mt_warp_sum(v);
  __syncthreads();
  return v;
}

__device__ __forceinline__ float mt_block_max(float v, float* red,
                                              float empty) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = mt_warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < nwarps ? red[lane] : empty;
  v = mt_warp_max(v);
  __syncthreads();
  return v;
}

// An activation element that may be stored as f32 or bf16.
__device__ __forceinline__ float mt_load(const void* p, long long i,
                                         int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// Round an f32 value to bf16 (nearest even) and back: a bf16 product or a
// bf16 cast in the reference kernels.
__device__ __forceinline__ float mt_bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 16 bytes from global to shared memory, asynchronously (cp.async, through
// L2 only), and the waits for the groups committed.
__device__ __forceinline__ void mt_cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void mt_cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void mt_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Ask L2 for the line that holds p (no register waits on it).
__device__ __forceinline__ void mt_prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

#define MT_ERROR_STRING_FN                                         \
  extern "C" const char* mt_error_string(int e) {                  \
    return cudaGetErrorString(static_cast<cudaError_t>(e));        \
  }
