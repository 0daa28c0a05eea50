// K2: dequant-in-matvec for block-quantized stacked weights, m <= 8 rows.
//
// Replaces moshi_tpu/quant/pallas_matmul.py qmatmul_pallas_stacked (kernel
// bodies _q4_0_kernel / _q4_k_kernel / _q8_kernel and their _s/_norm
// variants, f32-dequant branch):
//
//   xn = rms_norm(x) * alpha[layer]   (optional, eps 1e-8, f32)
//   w  = bf16( (q - 8) * d )          q4_0, unsigned planar nibbles
//      = bf16( q * es )               q4_k, minus sum_b xs[b] * em[b]
//      = bf16( q * d )                q8_0, natural int8
//   y  = sum_k bf16(xn)[k] * w[k]     products exact in f32, f32 sums
//
// with xs[b] the 32-block sums of the f32 xn (q4_k's min term).  On the
// 7B frame this serves the depformer linear_out, q4_0 at K = 4224
// (nb = 132, which the int8 kernel does not take).
//
// Bound on the H100: bytes.  One pass over the packed weight of the
// selected layer; the activation (m x K) is tiny.  Design: each block
// normalizes and bf16-rounds the activation rows into shared memory (and
// the q4_k block sums), then each warp streams one output row with
// 16-byte loads per lane (32 nibbles), dequantizes in registers and
// accumulates m rows at once.  The Pallas kernel carried nothing across
// grid steps, so nothing changes there; the per-block activation prep is
// recomputed by every block because it is a few KB from L2.
#include "common.cuh"

namespace {

constexpr int QK = 32;
constexpr int MAXM = 8;
constexpr int FMT_Q4K = 0, FMT_Q40 = 1, FMT_Q80 = 2;

template <int FMT>
__global__ void dequant_matvec_kernel(const void* __restrict__ x, int x_bf16,
                                      const void* __restrict__ alpha,
                                      int alpha_bf16, int M, int K,
                                      const uint8_t* __restrict__ q,
                                      const bf16* __restrict__ s1,
                                      const bf16* __restrict__ s2,
                                      float* __restrict__ y, int O,
                                      long long row0) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[32];
  const int nb = K / QK;
  bf16* xb = reinterpret_cast<bf16*>(smem);                      // [M, K]
  float* bsum = reinterpret_cast<float*>(
      smem + ((size_t)M * K * sizeof(bf16) + 15) / 16 * 16);     // [M, nb]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int m = 0; m < M; ++m) {
    const long long xo = (long long)m * K;
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
      xb[xo + i] = __float2bfloat16_rn(v);
      if (FMT == FMT_Q4K) {
        const float s = mt_warp_sum(v);
        if (lane == 0) bsum[m * nb + b] = s;
      }
    }
  }
  __syncthreads();

  const int o = blockIdx.x * nwarps + warp;
  if (o >= O) return;  // after the only barrier: whole warps leave
  const long long r = row0 + o;
  const bf16* srow1 = s1 + r * nb;
  float acc[MAXM], accmin[MAXM];
#pragma unroll
  for (int m = 0; m < MAXM; ++m) acc[m] = accmin[m] = 0.f;

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
          if (m < M) acc[m] += __bfloat162float(xb[(long long)m * K + c + j]) * wv;
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
          if (m < M)
            acc[m] += __bfloat162float(xb[(long long)m * K + c + j]) * wlo +
                      __bfloat162float(xb[(long long)m * K + K2 + c + j]) * whi;
      }
      if (FMT == FMT_Q4K && (lane & 1) == 0) {  // one lane per 32-block
        const float elo = __bfloat162float(srow2[bl]);
        const float ehi = __bfloat162float(srow2[bh]);
#pragma unroll
        for (int m = 0; m < MAXM; ++m)
          if (m < M) accmin[m] += bsum[m * nb + bl] * elo + bsum[m * nb + bh] * ehi;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MAXM; ++m) {
    if (m < M) {
      float v = mt_warp_sum(acc[m]);
      if (FMT == FMT_Q4K) v -= mt_warp_sum(accmin[m]);
      if (lane == 0) y[(long long)m * O + o] = v;
    }
  }
}

template <int FMT>
cudaError_t launch(const void* x, int x_bf16, const void* alpha,
                   int alpha_bf16, int M, int K, const void* q,
                   const void* s1, const void* s2, void* y, int O,
                   long long row0, cudaStream_t st) {
  const int threads = 256, rows_per_block = threads / 32;
  const size_t xbytes = ((size_t)M * K * sizeof(bf16) + 15) / 16 * 16;
  const size_t smem =
      xbytes + (FMT == FMT_Q4K ? (size_t)M * (K / QK) * sizeof(float) : 0);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dequant_matvec_kernel<FMT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dequant_matvec_kernel<FMT>
      <<<(O + rows_per_block - 1) / rows_per_block, threads, smem, st>>>(
          x, x_bf16, alpha, alpha_bf16, M, K,
          static_cast<const uint8_t*>(q), static_cast<const bf16*>(s1),
          static_cast<const bf16*>(s2), static_cast<float*>(y), O, row0);
  return cudaGetLastError();
}

}  // namespace

MT_ERROR_STRING_FN

// x [M, K] (f32 or bf16), alpha [K] or null; q/s1/s2 the whole (stacked)
// weight, row0 the first row of the selected layer; y [M, O] f32.
extern "C" int mt_dequant_matvec(const void* x, int x_bf16, const void* alpha,
                                 int alpha_bf16, int M, int K, const void* q,
                                 const void* s1, const void* s2, void* y,
                                 int O, long long row0, int fmt,
                                 void* stream) {
  if (M < 1 || M > MAXM) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case FMT_Q4K:
      return launch<FMT_Q4K>(x, x_bf16, alpha, alpha_bf16, M, K, q, s1, s2, y,
                             O, row0, st);
    case FMT_Q40:
      return launch<FMT_Q40>(x, x_bf16, alpha, alpha_bf16, M, K, q, s1, s2, y,
                             O, row0, st);
    case FMT_Q80:
      return launch<FMT_Q80>(x, x_bf16, alpha, alpha_bf16, M, K, q, s1, s2, y,
                             O, row0, st);
    default:
      return cudaErrorInvalidValue;
  }
}
