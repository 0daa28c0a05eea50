// K2 and K6: dequant-in-matvec for block-quantized weights, any number of
// activation rows.
//
// K2 replaces moshi_tpu/quant/pallas_matmul.py qmatmul_pallas_stacked (a
// layer of a stacked weight, kernel bodies _q4_0_kernel / _q4_k_kernel /
// _q8_kernel and their _s/_norm variants, f32-dequant branch); K6
// replaces qmatmul_pallas (a flat [O, K] weight, the same kernel bodies).
// Both are one template: K6 is the stacked kernel at row0 = 0, behind its
// own C entry.  On the 7B frame at B = 1 K2 serves the depformer
// linear_out (q4_0 at K = 4224, nb = 132, which the int8 kernel does not
// take); at B > 1 it serves every projection but the GLUs, and K6 the
// text head and the depformer in-projection (in the TTS pool every
// temporal product but the GLU).
//
// Bound on the H100: by its bytes at m <= 8 rows (one pass over the
// packed weight of the selected layer; the activation is a few KB), but
// keeping every output's f32 sum order takes one FMUL, one FFMA and one
// FADD per element pair and row, about 1.5 f32 operations per weight
// element and row besides the dequantization, so from a few rows on the
// kernel is limited by the issue of that arithmetic, not by memory: at
// m = 8, loading the weights one step ahead or not at all ahead reads the
// same time (two steps ahead reads slower, for the registers it holds).
//
// Design (dequant_tile.cuh's tile_kernel, which K7 and K8 share): a
// grid of about one wave (at most the SMs times the blocks that fit on
// one, never more than the output rows need) times the groups of 1, 4 or
// 8 activation rows.  Each block issues
// its first weight loads, then stages and norms its group once (a
// lane-major tile layout in shared memory, in f32 where 8 rows fit, else
// bf16; every row's norm reduced at once in the norm's 256-thread shape;
// all of a thread's loads issued before their first use), then each warp
// walks output tiles of R weight rows (4, or 2 at one activation row; half
// that where the wider tiles would leave half a wave idle), loading one
// step ahead and the next tile's first step before its warp sums.  Per
// step a lane reads 16 bytes of each of its R rows, dequantizes them as
// bf16 pairs and reads each staged word once (conflict-free) for all R
// rows.  Every output keeps the f32 sum order that dequant_tile.cuh's
// header states, bit for bit.
#include "dequant_tile.cuh"

namespace {

using dqt::Call;

int dispatch(const Call& a, int fmt) {
  switch (fmt) {
    case dq::FMT_Q4K:
      return dqt::launch_fmt<dq::FMT_Q4K, false>(a);
    case dq::FMT_Q40:
      return dqt::launch_fmt<dq::FMT_Q40, false>(a);
    case dq::FMT_Q80:
      return dqt::launch_fmt<dq::FMT_Q80, false>(a);
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
  return dispatch({x, x_bf16, alpha, alpha_bf16, M, K, q, s1, s2, y, O, row0,
                   static_cast<cudaStream_t>(stream)},
                  fmt);
}

// K6.  The same product for a flat weight q/s1/s2 [O, ...].
extern "C" int mt_qmatmul(const void* x, int x_bf16, const void* alpha,
                          int alpha_bf16, int M, int K, const void* q,
                          const void* s1, const void* s2, void* y, int O,
                          int fmt, void* stream) {
  return dispatch({x, x_bf16, alpha, alpha_bf16, M, K, q, s1, s2, y, O, 0,
                   static_cast<cudaStream_t>(stream)},
                  fmt);
}
