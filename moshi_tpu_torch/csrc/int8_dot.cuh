// The int8-activation pieces shared by K1 (int8_matvec.cu) and K5
// (attn_ffn_fused.cu): the per-32-block activation quantization and the
// integer dot of one weight row with it, scales applied per block.
//
// Weights are planar-packed nibbles (q4_k, q4_0: byte j of a row holds
// w[j] in its low and w[j+K/2] in its high nibble, unsigned) or natural
// int8 (q8_0).  Scales are bf16 [rows, K/32] (es/em for q4_k, d otherwise).
#pragma once

#include "common.cuh"

namespace mt_i8 {

constexpr int QK = 32;
constexpr int FMT_Q4K = 0, FMT_Q40 = 1, FMT_Q80 = 2;

// One 32-block of the activation, one element per lane of a warp: the
// block scale dx = amax * (1/127) (1 when amax is 0; the product, not the
// quotient, as XLA computes the JAX kernel's amax / 127), xq = rint(v/dx)
// (divide, then round half to even), and xs = dx * sum(xq) of the
// QUANTIZED values.  Element i of block b; call from all 32 lanes.
__device__ __forceinline__ void quant_block(float v, int i, int b, int lane,
                                            int8_t* xq, float* dx,
                                            float* xs) {
  const float amax = mt_warp_max(fabsf(v));
  const float d = amax > 0.f ? amax * (1.f / 127.f) : 1.f;
  const int q = __float2int_rn(v / d);
  xq[i] = (int8_t)q;
  const int s = mt_warp_sum_i(q);
  if (lane == 0) {
    dx[b] = d;
    xs[b] = (float)s * d;
  }
}

__device__ __forceinline__ int dp4a_nibbles(unsigned w, int shift, int a,
                                            int acc) {
  return __dp4a((int)((w >> shift) & 0x0F0F0F0Fu), a, acc);
}

// The dot of one weight row with the quantized activation (xq 16-byte
// aligned, in global or shared memory), scales applied per 32-block:
//
//   sum_b  es[b] * dx[b] * P[b]  -  em[b] * xs[b]     (q4_k)
//   sum_b  d[b] * (dx[b] * P[b]  -  8 * xs[b])        (q4_0)
//   sum_b  d[b] * dx[b] * P[b]                        (q8_0)
//
// with P[b] the integer dot over block b.  One warp per row: 16-byte
// loads per lane (32 nibbles), __dp4a on nibble words masked to
// 0x0F0F0F0F, the per-block partial finished by one shuffle between the
// two lanes that share a 32-block.  The warp-summed result is returned to
// every lane.
template <int FMT>
__device__ __forceinline__ float row_dot(
    const uint8_t* __restrict__ qrow, const bf16* __restrict__ s1,
    const bf16* __restrict__ s2, const int8_t* __restrict__ xq,
    const float* __restrict__ dx, const float* __restrict__ xs, int K,
    int lane) {
  float acc = 0.f;
  if (FMT == FMT_Q80) {
#pragma unroll 4
    for (int base = 0; base < K; base += 512) {
      const int c = base + lane * 16;
      const bool act = c < K;
      int p = 0;
      if (act) {
        const int4 w = *reinterpret_cast<const int4*>(qrow + c);
        const int4 a = *reinterpret_cast<const int4*>(xq + c);
        p = __dp4a(w.x, a.x, p);
        p = __dp4a(w.y, a.y, p);
        p = __dp4a(w.z, a.z, p);
        p = __dp4a(w.w, a.w, p);
      }
      p += __shfl_xor_sync(MT_FULL_MASK, p, 1);  // lanes 2i, 2i+1 share a block
      if (act && (lane & 1) == 0) {
        const int b = c / QK;
        acc += __bfloat162float(s1[b]) * ((float)p * dx[b]);
      }
    }
  } else {
    const int K2 = K / 2;
#pragma unroll 4
    for (int base = 0; base < K2; base += 512) {
      const int c = base + lane * 16;
      const bool act = c < K2;
      int plo = 0, phi = 0;
      if (act) {
        const uint4 w = *reinterpret_cast<const uint4*>(qrow + c);
        const int4 al = *reinterpret_cast<const int4*>(xq + c);
        const int4 ah = *reinterpret_cast<const int4*>(xq + K2 + c);
        plo = dp4a_nibbles(w.x, 0, al.x, plo);
        plo = dp4a_nibbles(w.y, 0, al.y, plo);
        plo = dp4a_nibbles(w.z, 0, al.z, plo);
        plo = dp4a_nibbles(w.w, 0, al.w, plo);
        phi = dp4a_nibbles(w.x, 4, ah.x, phi);
        phi = dp4a_nibbles(w.y, 4, ah.y, phi);
        phi = dp4a_nibbles(w.z, 4, ah.z, phi);
        phi = dp4a_nibbles(w.w, 4, ah.w, phi);
      }
      plo += __shfl_xor_sync(MT_FULL_MASK, plo, 1);
      phi += __shfl_xor_sync(MT_FULL_MASK, phi, 1);
      if (act && (lane & 1) == 0) {
        const int bl = c / QK, bh = (K2 + c) / QK;
        if (FMT == FMT_Q4K) {
          acc += __bfloat162float(s1[bl]) * ((float)plo * dx[bl]) -
                 __bfloat162float(s2[bl]) * xs[bl];
          acc += __bfloat162float(s1[bh]) * ((float)phi * dx[bh]) -
                 __bfloat162float(s2[bh]) * xs[bh];
        } else {
          acc += __bfloat162float(s1[bl]) * ((float)plo * dx[bl] - 8.f * xs[bl]);
          acc += __bfloat162float(s1[bh]) * ((float)phi * dx[bh] - 8.f * xs[bh]);
        }
      }
    }
  }
  return mt_warp_sum(acc);
}

}  // namespace mt_i8
