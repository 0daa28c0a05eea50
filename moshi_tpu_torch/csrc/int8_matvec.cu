// K1: integer-dot matvec for block-quantized weights, 1 to 8 activation
// rows.
//
// Replaces moshi_tpu/quant/pallas_matmul_int8.py qmatmul_i8 / glu_matmul_i8
// (_qmatmul_i8_impl, kernel body _mk_kernel with _prep_int8_activation,
// _int8_partial_dots and the _epilogue_* functions):
//
//   y[o] = sum_b  es[o,b] * dx[b] * P[o,b]  -  em[o,b] * xs[b]     (q4_k)
//   y[o] = sum_b  d[o,b] * (dx[b] * P[o,b]  -  8 * xs[b])          (q4_0)
//   y[o] = sum_b  d[o,b] * dx[b] * P[o,b]         (q8_0, q4_0 unpacked)
//
// where the activation row x (optionally rms-normed with alpha, eps 1e-8)
// is quantized per 32-block to int8 xq with dx = amax * (1/127) (1 when
// amax is 0; the product, not the quotient, as XLA computes the JAX
// kernel's amax / 127), xq = rint(x/dx) (divide, then round half to
// even), xs = dx * sum(xq) of the QUANTIZED values, and P[o,b] is the integer dot of weight row o
// with xq over block b.  The GLU form reads gate row o and value row o+H
// of the fused [2H, K] weight and returns silu(gate) * value.
//
// Weights: see int8_dot.cuh, which holds the quantization and the row dot
// this kernel shares with K5 (attn_ffn_fused.cu).  Stacked weights
// [L, O, ...] are addressed by row0 = layer * rows/layer.  A 4-bit weight
// in unpacked int8 storage (the Pallas kernel's packed=False body, one
// activation row) takes the same kernel with the PACKED switch off: twice
// the weight bytes, no nibble masks, and on q4_k the packed form's bits.
//
// The Pallas kernel quantized the activation at grid step 0 into scratch
// that later grid steps read; CUDA blocks run in no order, so this is two
// launches on one stream: `prep` (one block per activation row, each row
// normed and quantized on its own) writes xq/dx/xs, `matvec` reads them.
// At m > 1 rows (MOSHI_TPU_INT8_MAX_M > 1) each warp loads a weight row
// once and forms its dot with every activation row (row_dots); one row is
// the same body instantiated for one row.
//
// Bound on the H100: bytes.  At m = 1 every weight byte is used once for
// 2 integer ops (4 per packed byte), about 1/300 of what the int8 tensor
// rate could absorb, so the packed weight stream over HBM (3.35 TB/s) is
// the floor.  Design: one warp per output row, 16-byte loads per lane
// (32 nibbles), __dp4a on nibble words masked to 0x0F0F0F0F, the per-block
// partial dot finished by one shuffle between the two lanes that share a
// 32-block, the f32 scale epilogue per block, and a warp sum at the end.
// No shared memory, no tensor cores: simple first.  (Letting each lane
// scale its own half-block instead, with no shuffle, measured 17-25%
// slower on an H100 for the 4096-wide matvecs: every lane then loads the
// scales.)
#include "int8_dot.cuh"

namespace {

using mt_i8::FMT_Q40;
using mt_i8::FMT_Q4K;
using mt_i8::FMT_Q80;
using mt_i8::prep_kernel;
using mt_i8::QK;

// y [M, O]; row r of the activation at xq + r*K, dx/xs + r*nb.  MR is 1
// (M = 1) or MAXM (1 < M <= MAXM).
template <int FMT, bool PACKED, bool GLU, int MR>
__global__ void matvec_kernel(const uint8_t* __restrict__ q,
                              const bf16* __restrict__ s1,
                              const bf16* __restrict__ s2,
                              const int8_t* __restrict__ xq,
                              const float* __restrict__ dx,
                              const float* __restrict__ xs,
                              float* __restrict__ y, int O, int K, int M,
                              long long row0) {
  const int o = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (o >= O) return;  // whole warps leave together
  const int nb = K / QK;
  const long long row_bytes = mt_i8::row_bytes<FMT, PACKED>(K);
  long long r = row0 + o;
  float g[MR], v[MR];
  mt_i8::row_dots<FMT, PACKED, MR>(q + r * row_bytes, s1 + r * nb,
                                   FMT == FMT_Q4K ? s2 + r * nb : nullptr, xq,
                                   dx, xs, K, M, lane, g);
  if (GLU) {
    r = row0 + O + o;
    mt_i8::row_dots<FMT, PACKED, MR>(q + r * row_bytes, s1 + r * nb,
                                     FMT == FMT_Q4K ? s2 + r * nb : nullptr,
                                     xq, dx, xs, K, M, lane, v);
  }
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      if (MR == 1 || m < M)
        y[(long long)m * O + o] =
            GLU ? g[m] * (1.f / (1.f + expf(-g[m]))) * v[m] : g[m];
    }
  }
}

template <int FMT, bool PACKED, int MR>
void launch_rows(int glu, dim3 grid, dim3 block, cudaStream_t st,
                 const uint8_t* q, const bf16* s1, const bf16* s2,
                 const int8_t* xq, const float* dx, const float* xs, float* y,
                 int O, int K, int M, long long row0) {
  if (glu)
    matvec_kernel<FMT, PACKED, true, MR><<<grid, block, 0, st>>>(
        q, s1, s2, xq, dx, xs, y, O, K, M, row0);
  else
    matvec_kernel<FMT, PACKED, false, MR><<<grid, block, 0, st>>>(
        q, s1, s2, xq, dx, xs, y, O, K, M, row0);
}

// Unpacked 4-bit storage is one activation row only (the JAX package's
// int8_shape_ok), so it instantiates MR = 1 alone.
template <int FMT, bool PACKED>
cudaError_t launch_matvec(int glu, int M, dim3 grid, dim3 block,
                          cudaStream_t st, const uint8_t* q, const bf16* s1,
                          const bf16* s2, const int8_t* xq, const float* dx,
                          const float* xs, float* y, int O, int K,
                          long long row0) {
  if (M > 1) {
    if constexpr (!PACKED && FMT != FMT_Q80)
      return cudaErrorInvalidValue;
    else
      launch_rows<FMT, PACKED, mt_i8::MAXM>(glu, grid, block, st, q, s1, s2,
                                            xq, dx, xs, y, O, K, M, row0);
  } else {
    launch_rows<FMT, PACKED, 1>(glu, grid, block, st, q, s1, s2, xq, dx, xs, y,
                                O, K, 1, row0);
  }
  return cudaSuccess;
}

}  // namespace

MT_ERROR_STRING_FN

// x [M, K] (f32 or bf16, 1 <= M <= 8), alpha [K] or null; scratch xq
// [M, K] i8, dx/xs [M, K/32] f32; q/s1/s2 the whole (stacked) weight; y
// [M, O] f32.  O is the output count (H for the GLU form); row0 the first
// row of the selected layer; fmt a format code (int8_dot.cuh: 3 and 4 are
// q4_k and q4_0 in unpacked storage, M = 1 only).  *launched receives the
// number of kernels launched (2 on success).
extern "C" int mt_int8_matvec(const void* x, int x_bf16, const void* alpha,
                              int alpha_bf16, int M, int K, void* xq,
                              void* dx, void* xs, const void* q,
                              const void* s1, const void* s2, void* y, int O,
                              long long row0, int fmt, int glu, void* stream,
                              int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  if (M < 1 || M > mt_i8::MAXM || fmt < 0 || fmt > mt_i8::CODE_Q40_I8 ||
      (fmt >= mt_i8::CODE_Q4K_I8 && M != 1))
    return cudaErrorInvalidValue;
  prep_kernel<<<M, 1024, 0, st>>>(x, x_bf16, alpha, alpha_bf16, K,
                                  static_cast<int8_t*>(xq),
                                  static_cast<float*>(dx),
                                  static_cast<float*>(xs));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  *launched = 1;
  const int threads = 256, rows_per_block = threads / 32;
  const dim3 grid((O + rows_per_block - 1) / rows_per_block), block(threads);
  const uint8_t* qb = static_cast<const uint8_t*>(q);
  const bf16* a = static_cast<const bf16*>(s1);
  const bf16* b = static_cast<const bf16*>(s2);
  const int8_t* xqp = static_cast<const int8_t*>(xq);
  const float* dxp = static_cast<const float*>(dx);
  const float* xsp = static_cast<const float*>(xs);
  float* yp = static_cast<float*>(y);
  switch (fmt) {
    case FMT_Q4K:
      err = launch_matvec<FMT_Q4K, true>(glu, M, grid, block, st, qb, a, b,
                                         xqp, dxp, xsp, yp, O, K, row0);
      break;
    case FMT_Q40:
      err = launch_matvec<FMT_Q40, true>(glu, M, grid, block, st, qb, a, b,
                                         xqp, dxp, xsp, yp, O, K, row0);
      break;
    case FMT_Q80:
      err = launch_matvec<FMT_Q80, false>(glu, M, grid, block, st, qb, a, b,
                                          xqp, dxp, xsp, yp, O, K, row0);
      break;
    case mt_i8::CODE_Q4K_I8:
      err = launch_matvec<FMT_Q4K, false>(glu, M, grid, block, st, qb, a, b,
                                          xqp, dxp, xsp, yp, O, K, row0);
      break;
    default:  // CODE_Q40_I8
      err = launch_matvec<FMT_Q40, false>(glu, M, grid, block, st, qb, a, b,
                                          xqp, dxp, xsp, yp, O, K, row0);
      break;
  }
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err == cudaSuccess) *launched = 2;
  return err;
}
