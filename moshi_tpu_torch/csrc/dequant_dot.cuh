// The dequant matvec's two halves, used by the depformer megakernel K14
// (dep_step.cu) alone: staging a group of at most MAXM activation rows in
// shared memory, and one warp's dot of a weight row against the staged
// rows.  K2, K6, K7, K8 (dequant_matvec.cu, glu_matvec.cu) and the
// temporal megakernel K13 (temporal_step.cu) take the tile form of
// dequant_tile.cuh, which keeps this arithmetic and every output's sum
// order, and share the constants, Weight and allow_smem of this file.
//
// The arithmetic is that of moshi_tpu/quant/pallas_matmul.py's
// f32-dequant kernel bodies (_q8_kernel, _q4_0_kernel, _q4_k_kernel and
// the GLU's _q8_dot / _q4k_dot):
//
//   xn = rms_norm(x) * alpha          (optional, eps 1e-8, f32)
//   w  = bf16( (q - 8) * d )          q4_0, unsigned planar nibbles
//      = bf16( q * es )               q4_k, minus sum_b xs[b] * em[b]
//      = bf16( q * d )                q8_0, natural int8
//   y  = sum_k bf16(xn)[k] * w[k]     products exact in f32, f32 sums
//
// with xs[b] the 32-block sums of the f32 xn (q4_k's min term).
#pragma once

#include "common.cuh"

namespace dq {

constexpr int QK = 32;
constexpr int MAXM = 8;   // activation rows one block stages (a row group)
constexpr int FMT_Q4K = 0, FMT_Q40 = 1, FMT_Q80 = 2;

// Bytes of the bf16 rows [mg, K] at the start of shared memory, rounded
// up to 16 so that the q4_k block sums behind them stay aligned.
inline __host__ __device__ size_t xb_bytes(int mg, int K) {
  return ((size_t)mg * K * sizeof(bf16) + 15) / 16 * 16;
}

// Stage rows [m0, m0 + mg) of x [M, K] (f32 or bf16): each normalized
// with alpha if given, rounded to bf16 into xb [mg, K], and for q4_k its
// 32-block sums of the f32 values into bsum [mg, K/32].  Every thread of
// the block calls it; it ends with a barrier.
template <int FMT>
__device__ __forceinline__ void stage_rows(const void* __restrict__ x,
                                           int x_bf16,
                                           const void* __restrict__ alpha,
                                           int alpha_bf16, int m0, int mg,
                                           int K, bf16* xb, float* bsum,
                                           float* red) {
  const int nb = K / QK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int m = 0; m < mg; ++m) {
    const long long xo = (long long)(m0 + m) * K;   // row m0 + m of x
    const long long so = (long long)m * K;          // row m of xb
    float r = 1.f;
    if (alpha != nullptr) {
      float acc = 0.f;
      for (int i = threadIdx.x; i < K; i += blockDim.x) {
        const float v = mt_load(x, xo + i, x_bf16);
        acc += v * v;
      }
      acc = mt_block_sum(acc, red);
      r = 1.f / sqrtf(acc / (float)K + 1e-8f);
    }
    for (int b = warp; b < nb; b += nwarps) {
      const int i = b * QK + lane;
      float v = mt_load(x, xo + i, x_bf16);
      if (alpha != nullptr) v = v * r * mt_load(alpha, i, alpha_bf16);
      xb[so + i] = __float2bfloat16_rn(v);
      if (FMT == FMT_Q4K) {
        const float s = mt_warp_sum(v);
        if (lane == 0) bsum[m * nb + b] = s;
      }
    }
  }
  __syncthreads();
}

// One warp's lane partials of weight row r (a row of the flat [rows, ...]
// view of the whole stacked weight) against the mg staged rows:
// acc[m] += xb[m] . w, and for q4_k accmin[m] += bsum[m] . em.  Each lane
// streams 16 bytes per step (32 nibbles, or 16 int8 values); the caller
// sums the partials over the warp.
template <int FMT>
__device__ __forceinline__ void row_dot(const uint8_t* __restrict__ q,
                                        const bf16* __restrict__ s1,
                                        const bf16* __restrict__ s2,
                                        long long r, int K, int mg,
                                        const bf16* xb, const float* bsum,
                                        float (&acc)[MAXM],
                                        float (&accmin)[MAXM]) {
  const int nb = K / QK;
  const int lane = threadIdx.x & 31;
  const bf16* srow1 = s1 + r * nb;
  if (FMT == FMT_Q80) {
    const int8_t* qrow = reinterpret_cast<const int8_t*>(q) + r * K;
    for (int c = lane * 16; c < K; c += 512) {
      const int4 w4 = *reinterpret_cast<const int4*>(qrow + c);
      const int8_t* w = reinterpret_cast<const int8_t*>(&w4);
      const float d = __bfloat162float(srow1[c / QK]);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float wv = mt_bf16_round((float)w[j] * d);
#pragma unroll
        for (int m = 0; m < MAXM; ++m)
          if (m < mg) acc[m] += __bfloat162float(xb[(long long)m * K + c + j]) * wv;
      }
    }
  } else {
    const int K2 = K / 2;
    const uint8_t* qrow = q + r * K2;
    const bf16* srow2 = FMT == FMT_Q4K ? s2 + r * nb : nullptr;
    for (int c = lane * 16; c < K2; c += 512) {
      const uint4 w4 = *reinterpret_cast<const uint4*>(qrow + c);
      const uint8_t* w = reinterpret_cast<const uint8_t*>(&w4);
      const int bl = c / QK, bh = (K2 + c) / QK;
      const float slo = __bfloat162float(srow1[bl]);
      const float shi = __bfloat162float(srow1[bh]);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int nlo = w[j] & 15, nhi = w[j] >> 4;
        float wlo, whi;
        if (FMT == FMT_Q40) {
          wlo = mt_bf16_round((float)(nlo - 8) * slo);
          whi = mt_bf16_round((float)(nhi - 8) * shi);
        } else {
          wlo = mt_bf16_round((float)nlo * slo);
          whi = mt_bf16_round((float)nhi * shi);
        }
#pragma unroll
        for (int m = 0; m < MAXM; ++m)
          if (m < mg)
            acc[m] += __bfloat162float(xb[(long long)m * K + c + j]) * wlo +
                      __bfloat162float(xb[(long long)m * K + K2 + c + j]) * whi;
      }
      if (FMT == FMT_Q4K && (lane & 1) == 0) {  // one lane per 32-block
        const float elo = __bfloat162float(srow2[bl]);
        const float ehi = __bfloat162float(srow2[bh]);
#pragma unroll
        for (int m = 0; m < MAXM; ++m)
          if (m < mg) accmin[m] += bsum[m * nb + bl] * elo + bsum[m * nb + bh] * ehi;
      }
    }
  }
}

// The row's result for staged row m: the warp's sum, minus the q4_k min
// term.  Every lane of the warp calls it.
template <int FMT>
__device__ __forceinline__ float row_result(const float (&acc)[MAXM],
                                            const float (&accmin)[MAXM],
                                            int m) {
  float v = mt_warp_sum(acc[m]);
  if (FMT == FMT_Q4K) v -= mt_warp_sum(accmin[m]);
  return v;
}

// A block-quantized weight: its packed values and bf16 scales (es and em
// for q4_k; d and null for q4_0 and q8_0), rows addressed in the flat
// [rows, ...] view of the whole (stacked) weight.
struct Weight {
  const uint8_t* q;
  const bf16* s1;
  const bf16* s2;
};

// Row r of w against one staged row (mg = 1): one warp, every lane gets
// the result.  K14's products.
template <int FMT>
__device__ __forceinline__ float row_dot1(const Weight& w, long long r, int K,
                                          const bf16* xb,
                                          const float* bsum) {
  float acc[MAXM], accmin[MAXM];
#pragma unroll
  for (int m = 0; m < MAXM; ++m) acc[m] = accmin[m] = 0.f;
  row_dot<FMT>(w.q, w.s1, w.s2, r, K, 1, xb, bsum, acc, accmin);
  return row_result<FMT>(acc, accmin, 0);
}

// Stage one f32 row [K] that other blocks of a cooperative grid wrote,
// read through L2 (__ldcg: another SM's write is not in this SM's L1):
// bf16 into xb, the 32-block sums into bsum.  Every thread of the block
// calls it; it ends with a barrier.
__device__ __forceinline__ void stage_row_l2(const float* x, int K, bf16* xb,
                                             float* bsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int b = warp; b < K / QK; b += nwarps) {
    const float v = __ldcg(x + b * QK + lane);
    xb[b * QK + lane] = __float2bfloat16_rn(v);
    const float s = mt_warp_sum(v);
    if (lane == 0) bsum[b] = s;
  }
  __syncthreads();
}

// Row l of a stacked [L, n] vector stored as f32 or bf16 (a layer's norm).
__device__ __forceinline__ const void* row_of(const void* v, int is_bf16,
                                              int l, int n) {
  return is_bf16 ? static_cast<const void*>(static_cast<const bf16*>(v) +
                                            (long long)l * n)
                 : static_cast<const void*>(static_cast<const float*>(v) +
                                            (long long)l * n);
}

// Raise a block's dynamic shared memory limit where it needs more than
// the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace dq
