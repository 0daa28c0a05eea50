// float8_e4m3fn helpers for the KV-ring kernels (fp8 rings,
// LMConfig.kv_dtype = "float8_e4m3fn").
#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "common.cuh"

typedef __nv_fp8_storage_t fp8;  // one e4m3 value's bits

// f32 -> e4m3 by the reference's rule (XLA's convert, which the JAX
// package's ring writes take): round to nearest even in range; NaN with
// x's sign for |x| > 464 and for NaN.  At 464 exactly the tie goes to the
// even neighbour, 448.  In range the hardware's satfinite conversion is
// that rounding (nothing in range saturates), so only the rule's edge is
// written out here.
__device__ __forceinline__ fp8 mt_fp8_e4m3(float x) {
  if (!(fabsf(x) <= 464.f)) return signbit(x) ? fp8(0xFF) : fp8(0x7F);
  return __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
}

// Ring element types: how many values one 16-byte load holds, and their
// exact widening to f32 (e4m3 -> f16 -> f32 is exact: every e4m3 value,
// subnormals included, is an f16 value).  widen takes the loaded vector
// by value, so that the caller's load stays one 16-byte load.
template <typename T>
struct RingElem;

template <>
struct RingElem<bf16> {
  static constexpr int PER16 = 8;
  __device__ static __forceinline__ void widen(const uint4 w, float* e) {
    const bf16* p = reinterpret_cast<const bf16*>(&w);
#pragma unroll
    for (int t = 0; t < 8; ++t) e[t] = __bfloat162float(p[t]);
  }
};

template <>
struct RingElem<fp8> {
  static constexpr int PER16 = 16;
  __device__ static __forceinline__ void widen(const uint4 w, float* e) {
    const __nv_fp8x2_storage_t* p =
        reinterpret_cast<const __nv_fp8x2_storage_t*>(&w);
#pragma unroll
    for (int t = 0; t < 8; ++t) {  // the low byte is the first value
      const float2 f = __half22float2(
          __half2(__nv_cvt_fp8x2_to_halfraw2(p[t], __NV_E4M3)));
      e[2 * t] = f.x;
      e[2 * t + 1] = f.y;
    }
  }
};
