// K8 and K7: the dequant GLU, any number of activation rows.
//
// K8 replaces moshi_tpu/quant/pallas_matmul.py glu_matmul_pallas_stacked
// (kernel bodies _glu_q4k_kernel / _glu_q8_kernel and their _s/_nonorm
// variants); K7 replaces glu_matmul_pallas (a flat [2H, K] weight, the
// same kernel bodies: _glu_q4k_kernel_s calls _glu_q4k_kernel).  Both are
// one template: K7 is the stacked kernel at row0 = 0, behind its own C
// entry, as K6 is K2's.  For a fused linear_in [.., 2H, K] at layer l,
// gate rows [0, H) and value rows [H, 2H) of the layer,
//
//   g = xn . Wg[o],  v = xn . Wv[o]     K2's arithmetic (dequant_dot.cuh),
//                                       each with its own q4_k min term
//   y = g * (1 / (1 + exp(-g))) * v     in f32, the Pallas kernel's _silu
//
// with the optional rms pre-norm alpha[l] fused.  q4_k and q8_0 only: the
// JAX package takes the two-call form (the dequant matvec over 2H rows,
// then silu(gate) * value) for q4_0, and so does the port.
//
// Bound on the H100: bytes, one pass over the layer's 2H packed rows.
// Design: K2's, with each warp streaming gate row o and value row H + o
// against the same staged activation rows and writing one output, so the
// gate and value never leave registers.  expf, not __expf: the build
// passes no fast-math flag.
#include "dequant_dot.cuh"

namespace {

using dq::MAXM;

template <int FMT>
__global__ void glu_matvec_kernel(const void* __restrict__ x, int x_bf16,
                                  const void* __restrict__ alpha,
                                  int alpha_bf16, int M, int K,
                                  const uint8_t* __restrict__ q,
                                  const bf16* __restrict__ s1,
                                  const bf16* __restrict__ s2,
                                  float* __restrict__ y, int H,
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
  if (o >= H) return;  // after the only barrier: whole warps leave
  float ag[MAXM], amg[MAXM], av[MAXM], amv[MAXM];
#pragma unroll
  for (int m = 0; m < MAXM; ++m) ag[m] = amg[m] = av[m] = amv[m] = 0.f;
  dq::row_dot<FMT>(q, s1, s2, row0 + o, K, mg, xb, bsum, ag, amg);
  dq::row_dot<FMT>(q, s1, s2, row0 + H + o, K, mg, xb, bsum, av, amv);
#pragma unroll
  for (int m = 0; m < MAXM; ++m) {
    if (m < mg) {
      const float g = dq::row_result<FMT>(ag, amg, m);
      const float v = dq::row_result<FMT>(av, amv, m);
      if (lane == 0)
        y[(long long)(m0 + m) * H + o] = g * (1.f / (1.f + expf(-g))) * v;
    }
  }
}

template <int FMT>
cudaError_t launch(const void* x, int x_bf16, const void* alpha,
                   int alpha_bf16, int M, int K, const void* q,
                   const void* s1, const void* s2, void* y, int H,
                   long long row0, cudaStream_t st) {
  const int threads = 256, rows_per_block = threads / 32;
  const size_t smem = dq::smem_bytes(FMT, M < MAXM ? M : MAXM, K);
  cudaError_t err = dq::allow_smem(glu_matvec_kernel<FMT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((H + rows_per_block - 1) / rows_per_block,
                  (M + MAXM - 1) / MAXM);
  glu_matvec_kernel<FMT><<<grid, threads, smem, st>>>(
      x, x_bf16, alpha, alpha_bf16, M, K, static_cast<const uint8_t*>(q),
      static_cast<const bf16*>(s1), static_cast<const bf16*>(s2),
      static_cast<float*>(y), H, row0);
  return cudaGetLastError();
}

}  // namespace

MT_ERROR_STRING_FN

// x [M, K] (f32 or bf16), alpha [K] or null; q/s1/s2 the whole (stacked)
// fused linear_in, row0 the first row of the selected layer (its 2H rows:
// gate, then value); y [M, H] f32.  fmt: 0 q4_k, 2 q8_0.
extern "C" int mt_glu_matvec(const void* x, int x_bf16, const void* alpha,
                             int alpha_bf16, int M, int K, const void* q,
                             const void* s1, const void* s2, void* y, int H,
                             long long row0, int fmt, void* stream) {
  if (M < 1 || H < 1 || K % dq::QK) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case dq::FMT_Q4K:
      return launch<dq::FMT_Q4K>(x, x_bf16, alpha, alpha_bf16, M, K, q, s1,
                                 s2, y, H, row0, st);
    case dq::FMT_Q80:
      return launch<dq::FMT_Q80>(x, x_bf16, alpha, alpha_bf16, M, K, q, s1,
                                 s2, y, H, row0, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// K7.  The same GLU for a flat fused linear_in q/s1/s2 [2H, ...].
extern "C" int mt_glu_matmul(const void* x, int x_bf16, const void* alpha,
                             int alpha_bf16, int M, int K, const void* q,
                             const void* s1, const void* s2, void* y, int H,
                             int fmt, void* stream) {
  return mt_glu_matvec(x, x_bf16, alpha, alpha_bf16, M, K, q, s1, s2, y, H,
                       0, fmt, stream);
}
