// The int8-activation pieces shared by K1 (int8_matvec.cu) and K5
// (attn_ffn_fused.cu): the per-32-block activation quantization and the
// integer dot of one weight row with it, scales applied per block.
//
// Weights are planar-packed nibbles (q4_k, q4_0: byte j of a row holds
// w[j] in its low and w[j+K/2] in its high nibble, unsigned) or natural
// int8 (q8_0; and q4_k / q4_0 in unpacked storage, PACKED false: byte j
// holds w[j], q4_k 0..15, q4_0 signed with its -8 zero point folded in).
// Scales are bf16 [rows, K/32] (es/em for q4_k, d otherwise).
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

// The activation's prep (K1 and K12): row blockIdx.x of x [m, K] (f32 or
// bf16), optionally rms-normed with alpha (eps 1e-8), quantized per
// 32-block into xq [m, K], dx and xs [m, K/32].  One block per row.
__global__ void prep_kernel(const void* __restrict__ x, int x_bf16,
                            const void* __restrict__ alpha, int alpha_bf16,
                            int K, int8_t* __restrict__ xq,
                            float* __restrict__ dx, float* __restrict__ xs) {
  __shared__ float red[32];
  // row blockIdx.x of x [m, K]
  x = static_cast<const char*>(x) +
      (size_t)blockIdx.x * K * (x_bf16 ? sizeof(bf16) : sizeof(float));
  xq += (size_t)blockIdx.x * K;
  dx += (size_t)blockIdx.x * (K / QK);
  xs += (size_t)blockIdx.x * (K / QK);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float r = 1.f;
  if (alpha != nullptr) {
    float acc = 0.f;
    for (int i = threadIdx.x; i < K; i += blockDim.x) {
      const float v = mt_load(x, i, x_bf16);
      acc += v * v;
    }
    acc = mt_block_sum(acc, red);
    r = 1.f / sqrtf(acc / (float)K + 1e-8f);
  }
  const int nb = K / QK;
  for (int b = warp; b < nb; b += nwarps) {
    const int i = b * QK + lane;
    float v = mt_load(x, i, x_bf16);
    if (alpha != nullptr) v = v * r * mt_load(alpha, i, alpha_bf16);
    mt_i8::quant_block(v, i, b, lane, xq, dx, xs);
  }
}

__device__ __forceinline__ int dp4a_nibbles(unsigned w, int shift, int a,
                                            int acc) {
  return __dp4a((int)((w >> shift) & 0x0F0F0F0Fu), a, acc);
}

// The dot of one weight row with MR quantized activation rows at once
// (row r at xq + r*K, dx/xs + r*K/32; xq 16-byte aligned, in global or
// shared memory), scales applied per 32-block:
//
//   sum_b  es[b] * dx[b] * P[b]  -  em[b] * xs[b]     (q4_k, either storage)
//   sum_b  d[b] * (dx[b] * P[b]  -  8 * xs[b])        (q4_0 packed)
//   sum_b  d[b] * dx[b] * P[b]                        (q8_0, q4_0 unpacked)
//
// with P[b] the integer dot over block b.  One warp per weight row: 16-byte
// loads per lane (32 nibbles), each used for every activation row, __dp4a
// on nibble words masked to 0x0F0F0F0F, the per-block partial finished by
// one shuffle between the two lanes that share a 32-block, whose even lane
// then applies the block's scales.  Unpacked 4-bit storage takes the same
// walk with two 16-byte loads per lane, the values of the two halves that
// the packed load's nibbles hold, on __dp4a directly: the same integer
// dots and the same epilogue, so on q4_k both storages give the same bits.
// Each row's sum takes the same order, block by block, whatever MR is.  MR
// is the compile-time row count: 1, or MAXM with only the first m rows
// computed.  out[r] receives the warp-summed result of row r on every lane.
constexpr int MAXM = 8;

template <int FMT, bool PACKED, int MR>
__device__ __forceinline__ void row_dots(
    const uint8_t* __restrict__ qrow, const bf16* __restrict__ s1,
    const bf16* __restrict__ s2, const int8_t* __restrict__ xq,
    const float* __restrict__ dx, const float* __restrict__ xs, int K, int m,
    int lane, float (&out)[MR]) {
  const int nb = K / QK;
  const int rows = MR == 1 ? 1 : m;
  float acc[MR];
#pragma unroll
  for (int r = 0; r < MR; ++r) acc[r] = 0.f;
  // The block's scales are read by the even lane of each pair.  With
  // several rows each is used MR times and is read before the rows' dots;
  // at one row it is read after the shuffle (reading it early measured
  // slower there on the H100, and reading it late slower with 8 rows).
  if (FMT == FMT_Q80) {
#pragma unroll (MR == 1 ? 4 : 1)
    for (int base = 0; base < K; base += 512) {
      const int c = base + lane * 16;
      const bool act = c < K;
      const bool lead = act && (lane & 1) == 0;  // lanes 2i, 2i+1 share a block
      const int b = c / QK;
      int4 w = make_int4(0, 0, 0, 0);
      if (act) w = *reinterpret_cast<const int4*>(qrow + c);
      float s = 0.f;
      if (MR > 1 && lead) s = __bfloat162float(s1[b]);
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        if (r < rows) {
          int p = 0;
          if (act) {
            const int4 a =
                *reinterpret_cast<const int4*>(xq + (long long)r * K + c);
            p = __dp4a(w.x, a.x, p);
            p = __dp4a(w.y, a.y, p);
            p = __dp4a(w.z, a.z, p);
            p = __dp4a(w.w, a.w, p);
          }
          p += __shfl_xor_sync(MT_FULL_MASK, p, 1);
          if (lead) {
            if (MR == 1) s = __bfloat162float(s1[b]);
            acc[r] += s * ((float)p * dx[r * nb + b]);
          }
        }
      }
    }
  } else {
    const int K2 = K / 2;
#pragma unroll (MR == 1 ? 4 : 1)
    for (int base = 0; base < K2; base += 512) {
      const int c = base + lane * 16;
      const bool act = c < K2;
      const bool lead = act && (lane & 1) == 0;
      const int bl = c / QK, bh = (K2 + c) / QK;
      // packed: w holds both halves' nibbles; unpacked: w the low half's
      // 16 values, wh the high half's
      uint4 w = make_uint4(0u, 0u, 0u, 0u), wh = w;
      if (act) {
        w = *reinterpret_cast<const uint4*>(qrow + c);
        if (!PACKED) wh = *reinterpret_cast<const uint4*>(qrow + K2 + c);
      }
      float sl = 0.f, sh = 0.f, ml = 0.f, mh = 0.f;
      auto scales = [&] {
        sl = __bfloat162float(s1[bl]);
        sh = __bfloat162float(s1[bh]);
        if (FMT == FMT_Q4K) {
          ml = __bfloat162float(s2[bl]);
          mh = __bfloat162float(s2[bh]);
        }
      };
      if (MR > 1 && lead) scales();
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        if (r < rows) {
          int plo = 0, phi = 0;
          if (act) {
            const int8_t* xr = xq + (long long)r * K;
            const int4 al = *reinterpret_cast<const int4*>(xr + c);
            const int4 ah = *reinterpret_cast<const int4*>(xr + K2 + c);
            if (PACKED) {
              plo = dp4a_nibbles(w.x, 0, al.x, plo);
              plo = dp4a_nibbles(w.y, 0, al.y, plo);
              plo = dp4a_nibbles(w.z, 0, al.z, plo);
              plo = dp4a_nibbles(w.w, 0, al.w, plo);
              phi = dp4a_nibbles(w.x, 4, ah.x, phi);
              phi = dp4a_nibbles(w.y, 4, ah.y, phi);
              phi = dp4a_nibbles(w.z, 4, ah.z, phi);
              phi = dp4a_nibbles(w.w, 4, ah.w, phi);
            } else {
              plo = __dp4a((int)w.x, al.x, plo);
              plo = __dp4a((int)w.y, al.y, plo);
              plo = __dp4a((int)w.z, al.z, plo);
              plo = __dp4a((int)w.w, al.w, plo);
              phi = __dp4a((int)wh.x, ah.x, phi);
              phi = __dp4a((int)wh.y, ah.y, phi);
              phi = __dp4a((int)wh.z, ah.z, phi);
              phi = __dp4a((int)wh.w, ah.w, phi);
            }
          }
          plo += __shfl_xor_sync(MT_FULL_MASK, plo, 1);
          phi += __shfl_xor_sync(MT_FULL_MASK, phi, 1);
          if (lead) {
            if (MR == 1) scales();
            const float* dr = dx + r * nb;
            const float* sr = xs + r * nb;
            if (FMT == FMT_Q4K) {
              acc[r] += sl * ((float)plo * dr[bl]) - ml * sr[bl];
              acc[r] += sh * ((float)phi * dr[bh]) - mh * sr[bh];
            } else if (PACKED) {
              acc[r] += sl * ((float)plo * dr[bl] - 8.f * sr[bl]);
              acc[r] += sh * ((float)phi * dr[bh] - 8.f * sr[bh]);
            } else {  // the zero point is in the values
              acc[r] += sl * ((float)plo * dr[bl]);
              acc[r] += sh * ((float)phi * dr[bh]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MR; ++r)
    if (r < rows) out[r] = mt_warp_sum(acc[r]);
}

// row_dots at one activation row (K5's form), returned to every lane.
template <int FMT, bool PACKED>
__device__ __forceinline__ float row_dot(
    const uint8_t* __restrict__ qrow, const bf16* __restrict__ s1,
    const bf16* __restrict__ s2, const int8_t* __restrict__ xq,
    const float* __restrict__ dx, const float* __restrict__ xs, int K,
    int lane) {
  float out[1];
  row_dots<FMT, PACKED, 1>(qrow, s1, s2, xq, dx, xs, K, 1, lane, out);
  return out[0];
}

// Bytes of one weight row of K values: K / 2 for packed nibbles, K for
// int8 values.
template <int FMT, bool PACKED>
__host__ __device__ constexpr long long row_bytes(int K) {
  return (FMT == FMT_Q80 || !PACKED) ? K : K / 2;
}

// The C interface's format codes: 0-2 the formats (FMT_*) in their own
// storage (q4 packed), 3 and 4 q4_k and q4_0 in unpacked int8 storage.
constexpr int CODE_Q4K_I8 = 3, CODE_Q40_I8 = 4;

}  // namespace mt_i8
