// K2 and K6: dequant-in-matvec for block-quantized weights, any number of
// activation rows.
//
// K2 replaces moshi_tpu/quant/pallas_matmul.py qmatmul_pallas_stacked (a
// layer of a stacked weight, kernel bodies _q4_0_kernel / _q4_k_kernel /
// _q8_kernel and their _s/_norm variants, f32-dequant branch); K6
// replaces qmatmul_pallas (a flat [O, K] weight, the same kernel bodies).
// Both are one template: K6 is the stacked kernel at row0 = 0, behind its
// own C entry.  The arithmetic is in dequant_dot.cuh.  On the 7B frame at
// B = 1 K2 serves the depformer linear_out (q4_0 at K = 4224, nb = 132,
// which the int8 kernel does not take); at B > 1 it serves every
// projection but the GLUs, and K6 the text head and the depformer
// in-projection.
//
// Bound on the H100: bytes.  One pass over the packed weight of the
// selected layer; the activation (m x K) is small.  Design: the grid's y
// dimension walks groups of at most 8 activation rows; each block
// normalizes and bf16-rounds its group's rows into shared memory (and
// the q4_k block sums), then each warp streams one output row with
// 16-byte loads per lane (32 nibbles), dequantizes in registers and
// accumulates its group's rows at once.  The Pallas kernel carried
// nothing across grid steps, so nothing changes there; the per-block
// activation prep is recomputed by every block because it is a few KB
// from L2.  At m > 8 each row group reads the weight again (from L2 where
// it fits), and at K = 11264 a group of 8 stages 191 KB, one block per SM.
#include "dequant_dot.cuh"

namespace {

using dq::MAXM;

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
  const int m0 = blockIdx.y * MAXM, mg = min(MAXM, M - m0);
  bf16* xb = reinterpret_cast<bf16*>(smem);                       // [mg, K]
  float* bsum = reinterpret_cast<float*>(smem + dq::xb_bytes(mg, K));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  dq::stage_rows<FMT>(x, x_bf16, alpha, alpha_bf16, m0, mg, K, xb, bsum, red);

  const int o = blockIdx.x * nwarps + warp;
  if (o >= O) return;  // after the only barrier: whole warps leave
  float acc[MAXM], accmin[MAXM];
#pragma unroll
  for (int m = 0; m < MAXM; ++m) acc[m] = accmin[m] = 0.f;
  dq::row_dot<FMT>(q, s1, s2, row0 + o, K, mg, xb, bsum, acc, accmin);
#pragma unroll
  for (int m = 0; m < MAXM; ++m) {
    if (m < mg) {
      const float v = dq::row_result<FMT>(acc, accmin, m);
      if (lane == 0) y[(long long)(m0 + m) * O + o] = v;
    }
  }
}

template <int FMT>
cudaError_t launch(const void* x, int x_bf16, const void* alpha,
                   int alpha_bf16, int M, int K, const void* q,
                   const void* s1, const void* s2, void* y, int O,
                   long long row0, cudaStream_t st) {
  const int threads = 256, rows_per_block = threads / 32;
  const size_t smem = dq::smem_bytes(FMT, M < MAXM ? M : MAXM, K);
  cudaError_t err = dq::allow_smem(dequant_matvec_kernel<FMT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((O + rows_per_block - 1) / rows_per_block,
                  (M + MAXM - 1) / MAXM);
  dequant_matvec_kernel<FMT><<<grid, threads, smem, st>>>(
      x, x_bf16, alpha, alpha_bf16, M, K, static_cast<const uint8_t*>(q),
      static_cast<const bf16*>(s1), static_cast<const bf16*>(s2),
      static_cast<float*>(y), O, row0);
  return cudaGetLastError();
}

int dispatch(const void* x, int x_bf16, const void* alpha, int alpha_bf16,
             int M, int K, const void* q, const void* s1, const void* s2,
             void* y, int O, long long row0, int fmt, void* stream) {
  if (M < 1 || K % dq::QK) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case dq::FMT_Q4K:
      return launch<dq::FMT_Q4K>(x, x_bf16, alpha, alpha_bf16, M, K, q, s1,
                                 s2, y, O, row0, st);
    case dq::FMT_Q40:
      return launch<dq::FMT_Q40>(x, x_bf16, alpha, alpha_bf16, M, K, q, s1,
                                 s2, y, O, row0, st);
    case dq::FMT_Q80:
      return launch<dq::FMT_Q80>(x, x_bf16, alpha, alpha_bf16, M, K, q, s1,
                                 s2, y, O, row0, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

MT_ERROR_STRING_FN

// K2.  x [M, K] (f32 or bf16), alpha [K] or null; q/s1/s2 the whole
// (stacked) weight, row0 the first row of the selected layer; y [M, O]
// f32.
extern "C" int mt_dequant_matvec(const void* x, int x_bf16, const void* alpha,
                                 int alpha_bf16, int M, int K, const void* q,
                                 const void* s1, const void* s2, void* y,
                                 int O, long long row0, int fmt,
                                 void* stream) {
  return dispatch(x, x_bf16, alpha, alpha_bf16, M, K, q, s1, s2, y, O, row0,
                  fmt, stream);
}

// K6.  The same product for a flat weight q/s1/s2 [O, ...].
extern "C" int mt_qmatmul(const void* x, int x_bf16, const void* alpha,
                          int alpha_bf16, int M, int K, const void* q,
                          const void* s1, const void* s2, void* y, int O,
                          int fmt, void* stream) {
  return dispatch(x, x_bf16, alpha, alpha_bf16, M, K, q, s1, s2, y, O, 0,
                  fmt, stream);
}
