// K8 and K7: the dequant GLU, any number of activation rows.
//
// K8 replaces moshi_tpu/quant/pallas_matmul.py glu_matmul_pallas_stacked
// (kernel bodies _glu_q4k_kernel / _glu_q8_kernel and their _s/_nonorm
// variants); K7 replaces glu_matmul_pallas (a flat [2H, K] weight, the
// same kernel bodies: _glu_q4k_kernel_s calls _glu_q4k_kernel).  Both are
// one kernel: K7 is the stacked form at row0 = 0, behind its own C entry,
// as K6 is K2's.  For a fused linear_in [.., 2H, K] at layer l, gate rows
// [0, H) and value rows [H, 2H) of the layer,
//
//   g = xn . Wg[o],  v = xn . Wv[o]     K2's arithmetic, each with its own
//                                       q4_k min term
//   y = g * (1 / (1 + exp(-g))) * v     in f32, the Pallas kernel's _silu
//
// with the optional rms pre-norm alpha[l] fused.  q4_k and q8_0 only: the
// JAX package takes the two-call form (the dequant matvec over 2H rows,
// then silu(gate) * value) for q4_0, and so does the port.
//
// Bound on the H100: by its bytes at one activation row (one pass over
// the layer's 2H packed rows); from a few rows on, by the issue of the
// f32 arithmetic that keeps every sum's order (one FMUL, one FFMA and one
// FADD per element pair and row), as K2's.
//
// Design: K2's kernel (dequant_tile.cuh tile_kernel, GLU on).  Each block
// stages and norms its group of activation rows once, on a grid of about
// one wave; each warp walks tiles of R weight rows, R / 2 gates o.. and
// their R / 2 values H + o.. (R = 4; 2, one gate and its value, at one
// activation row or where the wider tiles would leave half a wave idle),
// so that every staged word, read once and without bank conflicts, serves
// the gate and the value row.  A tile past the end clamps its gate rows
// to H - 1 and its value rows to 2H - 1, each half apart.  The sums are
// in the order dequant_tile.cuh's header states for each row, bit for
// bit: after the transposed warp sums, g sits in lane l < 16 and v in
// lane l + 16, and one shuffle brings v to g before the epilogue.  expf,
// not __expf: the build passes no fast-math flag.
#include "dequant_tile.cuh"

namespace {

int dispatch(const dqt::Call& a, int fmt) {
  switch (fmt) {
    case dq::FMT_Q4K:
      return dqt::launch_fmt<dq::FMT_Q4K, true>(a);
    case dq::FMT_Q80:
      return dqt::launch_fmt<dq::FMT_Q80, true>(a);
    default:
      return cudaErrorInvalidValue;
  }
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
  return dispatch({x, x_bf16, alpha, alpha_bf16, M, K, q, s1, s2, y, H, row0,
                   static_cast<cudaStream_t>(stream)},
                  fmt);
}

// K7.  The same GLU for a flat fused linear_in q/s1/s2 [2H, ...].
extern "C" int mt_glu_matmul(const void* x, int x_bf16, const void* alpha,
                             int alpha_bf16, int M, int K, const void* q,
                             const void* s1, const void* s2, void* y, int H,
                             int fmt, void* stream) {
  return mt_glu_matvec(x, x_bf16, alpha, alpha_bf16, M, K, q, s1, s2, y, H,
                       0, fmt, stream);
}
