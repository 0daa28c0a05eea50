// K1: integer-dot matvec for block-quantized weights, 1 to 8 activation
// rows, in one launch.
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
// Weights: see int8_dot.cuh, which holds the quantization and the row dots
// this kernel shares with K5 (attn_ffn_fused.cu).  Stacked weights
// [L, O, ...] are addressed by row0 = layer * rows/layer.  A 4-bit weight
// in unpacked int8 storage (the Pallas kernel's packed=False body, one
// activation row) takes the same kernel with the PACKED switch off: twice
// the weight bytes, no nibble masks, and on q4_k the packed form's bits.
//
// The Pallas kernel quantized the activation at grid step 0 into scratch
// that later grid steps read.  Here every block quantizes (and norms) the
// activation rows into its own shared memory (int8_dot.cuh stage_rows,
// the norm's sum in one order whatever the block, norm_scale, so the same
// bits in every block), which costs a block a few microseconds of L2
// reads and no second launch.  At m > 1 rows (MOSHI_TPU_INT8_MAX_M > 1)
// each warp loads a weight row once and forms its dot with every
// activation row; one row is the same body instantiated for one row.
//
// Bound on the H100: bytes.  At m = 1 every weight byte is used once for
// 2 integer ops (4 per packed byte), about 1/300 of what the int8 tensor
// rate could absorb, so the weight stream over HBM (3.35 TB/s) is the
// floor.  Design: a persistent grid of one wave (the blocks an SM holds,
// queried once per instance, times the SMs; capped at a row a warp), the
// outputs dealt to the warps a group at a time in turn (at each step the
// warps read neighbouring rows, as DRAM pages would have it), walked in
// groups of
// NR weight rows (a GLU's gate and value row) a chunk of CHUNK_LOADS
// 16-byte loads a lane at a time (int8_dot.cuh RowWalk): each block asks
// for its activation row first, each warp then issues its first two
// chunks before the block stages the activation, and each next chunk
// (with, at a group's start, the group's scales, copied 16 bytes at a time
// into the warp's part of shared memory) before it consumes the one in
// hand, so a chunk's loads are in flight through the arithmetic.  (The
// first chunks copied by bulk copies into shared memory instead, which no
// load queue holds, measured slower: the block then waited for them to
// land before its matvec.)
// Each output's sum keeps the order of one warp a row: the even lane of
// each pair adds the block terms in block order, then a warp sum.
#include <mutex>

#include "int8_dot.cuh"

namespace {

using mt_i8::FMT_Q40;
using mt_i8::FMT_Q4K;
using mt_i8::FMT_Q80;
using mt_i8::QK;

// Tuning: threads a block, and weight rows a warp's group holds in flight
// (a GLU group is one gate/value pair; at 8 activation rows a group of
// other products is one row).
constexpr int THREADS = 512;
constexpr int NR = 2;
constexpr int NWARPS = THREADS / 32;

__host__ __device__ constexpr int group_rows(bool glu, int mr) {
  return glu || mr == 1 ? NR : NR / 2;
}

// Dynamic shared memory: xq [M, K] int8, dx and xs [M, K/32] f32, then one
// region that first holds an activation row [K] f32 and, with the norm,
// alpha [K] f32 (the staging), and then each warp's scale staging (two
// groups of NR rows of 2 * K/32 bf16; the matvec).
size_t smem_bytes(int K, int M, bool norm) {
  const size_t nb = K / QK;
  const size_t rows = (norm ? 2 : 1) * (size_t)K * sizeof(float);
  const size_t scales = (size_t)NWARPS * 2 * NR * 2 * nb * sizeof(bf16);
  return (size_t)M * K + 2 * (size_t)M * nb * sizeof(float) +
         (rows > scales ? rows : scales);
}

// y [M, O]; MR is 1 (M = 1) or MAXM (1 < M <= MAXM).
template <int FMT, bool PACKED, bool GLU, int MR>
__global__ void __launch_bounds__(THREADS, 1) matvec_kernel(
    const void* __restrict__ x, int x_bf16, const void* __restrict__ alpha,
    int alpha_bf16, const uint8_t* __restrict__ q,
    const bf16* __restrict__ s1, const bf16* __restrict__ s2,
    float* __restrict__ y, int O, int K, int M, long long row0) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[32];
  // stage: start
  constexpr int R = group_rows(GLU, MR);
  constexpr int OUTS = GLU ? R / 2 : R;  // outputs a group
  using Walk = mt_i8::RowWalk<FMT, PACKED, R, MR>;
  const int nb = K / QK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int8_t* xq = reinterpret_cast<int8_t*>(smem);
  float* dx = reinterpret_cast<float*>(smem + (size_t)M * K);
  float* xs = dx + M * nb;
  float* xf = xs + M * nb;   // the staging's rows, then the scales
  float* af = xf + K;
  bf16* sc = reinterpret_cast<bf16*>(xf) + (size_t)warp * 2 * NR * 2 * nb;
  const Walk walk(q, s1, FMT == FMT_Q4K ? s2 : nullptr, K);
  // this warp's groups of OUTS outputs, dealt in turn
  const mt_i8::Deal deal{(long long)blockIdx.x * NWARPS + warp,
                         (long long)gridDim.x * NWARPS, OUTS, O};
  const int ngroups = deal.groups();
  // the weight rows of group g (a GLU's gate and value rows side by side);
  // returns how many are valid
  auto rows_of = [=](int g, long long(&rows)[R]) {
    const int o = deal.first(g), n = deal.count(g);
#pragma unroll
    for (int u = 0; u < OUTS; ++u) {
      const long long ou = o + (u < n ? u : 0);
      if (GLU) {
        rows[2 * u] = row0 + ou;
        rows[2 * u + 1] = row0 + O + ou;
      } else {
        rows[u] = row0 + ou;
      }
    }
    return GLU ? 2 * n : n;
  };
  auto done = [=](int g, const float(&out)[R][MR], int n) {
    if (lane != 0) return;
    const int o = deal.first(g);
#pragma unroll
    for (int u = 0; u < OUTS; ++u) {
      if ((GLU ? 2 * u : u) < n) {
#pragma unroll
        for (int i = 0; i < MR; ++i) {
          if (MR == 1 || i < M) {
            const float gt = out[GLU ? 2 * u : u][i];
            const float v = out[GLU ? 2 * u + 1 : u][i];
            y[(long long)i * O + o + u] =
                GLU ? gt * (1.f / (1.f + expf(-gt))) * v : gt;
          }
        }
      }
    }
  };
  // x's first row and alpha asked for first, then the first two units'
  // weights, in flight while the block stages x; their scales after (the
  // staging's rows share their memory)
  if (alpha != nullptr) mt_i8::load_row(alpha, alpha_bf16, K, af);
  mt_i8::load_row(x, x_bf16, K, xf);
  typename Walk::Buf a, b;
  long long r0[R], r1[R];
  int n0, n1;
  const int primed =
      walk.prime(a, b, 2, ngroups, rows_of, r0, n0, r1, n1, lane, nullptr);
  mt_i8::stage_rows(x, x_bf16, alpha, alpha_bf16, K, M, xq, dx, xs, xf, af,
                    red);
  walk.prime_scales(primed, r0, n0, r1, n1, lane, sc);
  // stage: activation staged
  walk.walk(a, b, primed, ngroups, rows_of, done, xq, dx, xs, M, lane, sc);
  // stage: end
}

// One launch: the grid is the blocks an SM holds (queried once for this
// instance, at its first call's shared memory, with the largest dynamic
// shared memory the card allows opted into) times the SMs, capped at one
// warp an output.
template <int FMT, bool PACKED, bool GLU, int MR>
cudaError_t launch(const void* x, int x_bf16, const void* alpha,
                   int alpha_bf16, const uint8_t* q, const bf16* s1,
                   const bf16* s2, float* y, int O, int K, int M,
                   long long row0, cudaStream_t st) {
  auto* kernel = &matvec_kernel<FMT, PACKED, GLU, MR>;
  const size_t smem = smem_bytes(K, M, alpha != nullptr);
  static int wave = 0;
  static cudaError_t query = cudaSuccess;
  static std::once_flag once;
  std::call_once(once, [&] {
    query = mt_i8::one_wave(reinterpret_cast<const void*>(kernel), THREADS,
                            smem, &wave);
  });
  if (query != cudaSuccess) return query;
  int blocks = wave;
  const int need = (O + NWARPS - 1) / NWARPS;
  if (blocks > need) blocks = need;
  kernel<<<blocks, THREADS, smem, st>>>(x, x_bf16, alpha, alpha_bf16, q, s1,
                                        s2, y, O, K, M, row0);
  return cudaGetLastError();
}

// Unpacked 4-bit storage is one activation row only (the JAX package's
// int8_shape_ok), so it instantiates MR = 1 alone.
template <int FMT, bool PACKED>
cudaError_t launch_fmt(int glu, const void* x, int x_bf16, const void* alpha,
                       int alpha_bf16, const uint8_t* q, const bf16* s1,
                       const bf16* s2, float* y, int O, int K, int M,
                       long long row0, cudaStream_t st) {
  if (M > 1) {
    if constexpr (!PACKED && FMT != FMT_Q80) {
      return cudaErrorInvalidValue;
    } else {
      return glu ? launch<FMT, PACKED, true, mt_i8::MAXM>(
                       x, x_bf16, alpha, alpha_bf16, q, s1, s2, y, O, K, M,
                       row0, st)
                 : launch<FMT, PACKED, false, mt_i8::MAXM>(
                       x, x_bf16, alpha, alpha_bf16, q, s1, s2, y, O, K, M,
                       row0, st);
    }
  }
  return glu ? launch<FMT, PACKED, true, 1>(x, x_bf16, alpha, alpha_bf16, q,
                                            s1, s2, y, O, K, 1, row0, st)
             : launch<FMT, PACKED, false, 1>(x, x_bf16, alpha, alpha_bf16, q,
                                             s1, s2, y, O, K, 1, row0, st);
}

}  // namespace

MT_ERROR_STRING_FN

// x [M, K] (f32 or bf16, 1 <= M <= 8), alpha [K] or null; q/s1/s2 the
// whole (stacked) weight (s1, s2 16-byte aligned); y [M, O] f32.  O is the
// output count (H for the GLU form); row0 the first row of the selected
// layer; fmt a format code (int8_dot.cuh: 3 and 4 are q4_k and q4_0 in
// unpacked storage, M = 1 only).  One launch; returns its CUDA error.
extern "C" int mt_int8_matvec(const void* x, int x_bf16, const void* alpha,
                              int alpha_bf16, int M, int K, const void* q,
                              const void* s1, const void* s2, void* y, int O,
                              long long row0, int fmt, int glu,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || M > mt_i8::MAXM || fmt < 0 || fmt > mt_i8::CODE_Q40_I8 ||
      (fmt >= mt_i8::CODE_Q4K_I8 && M != 1) || K % (8 * QK))
    return cudaErrorInvalidValue;
  const uint8_t* qb = static_cast<const uint8_t*>(q);
  const bf16* a = static_cast<const bf16*>(s1);
  const bf16* b = static_cast<const bf16*>(s2);
  float* yp = static_cast<float*>(y);
  switch (fmt) {
    case FMT_Q4K:
      return launch_fmt<FMT_Q4K, true>(glu, x, x_bf16, alpha, alpha_bf16, qb,
                                       a, b, yp, O, K, M, row0, st);
    case FMT_Q40:
      return launch_fmt<FMT_Q40, true>(glu, x, x_bf16, alpha, alpha_bf16, qb,
                                       a, b, yp, O, K, M, row0, st);
    case FMT_Q80:
      return launch_fmt<FMT_Q80, false>(glu, x, x_bf16, alpha, alpha_bf16,
                                        qb, a, b, yp, O, K, M, row0, st);
    case mt_i8::CODE_Q4K_I8:
      return launch_fmt<FMT_Q4K, false>(glu, x, x_bf16, alpha, alpha_bf16,
                                        qb, a, b, yp, O, K, M, row0, st);
    default:  // CODE_Q40_I8
      return launch_fmt<FMT_Q40, false>(glu, x, x_bf16, alpha, alpha_bf16,
                                        qb, a, b, yp, O, K, M, row0, st);
  }
}
