// K12: K1's q4_k matvec at one activation row, split over K in segments,
// in one launch.
//
// Replaces moshi_tpu/quant/pallas_matmul_int8.py qmatmul_i8's two opt-in
// forms for packed q4_k weights at m = 1 with more than 128 blocks and
// K/2 a multiple of 512 (the 7B temporal linear_out, K = 11264):
//   the k-segment form (MOSHI_TPU_KSEG=1; _mk_kernel_kseg, _prep_kseg),
//   entry mt_int8_kseg, and the split-spread form
//   (MOSHI_TPU_SPLIT_SPREAD=1; _mk_kernel_split, _prep_pair), entry
//   mt_int8_split.
//
// The function is K1's (int8_matvec.cu): the row x (optionally rms-normed
// with alpha) quantized per 32-block into xq, dx, xs with K1's bits, P[o,b]
// the integer dot of weight row o with xq over block b, and per block the
// term es[o,b]*(dx[b]*P[o,b]) - em[o,b]*xs[b].  The planar packing puts lo
// block b and hi block K/64 + b in the same packed bytes, so segment s,
// packed columns [s*2048, (s+1)*2048), owns 64 lo and 64 hi blocks (128
// lanes of the TPU kernels' seg-major order; the last segment may be
// short) and every packed byte belongs to one segment.  In a segment the
// even lane of each pair of lanes adds the terms of its blocks, step by
// step (a 16-byte load a lane a step, 512 columns), lo then hi.  The two
// forms differ only in the order of the f32 sum over the segments:
//   k-segment: each segment's lane partials warp-summed, then the
//     segments added in order into 0: y = ((0 + y_0) + y_1) + ...;
//   split-spread: the segments' partials added lane by lane in segment
//     order, then one warp sum.
//
// Bound on the H100: bytes, as K1 (the packed nibbles and the bf16 es/em
// once: 28.8 MB per 7B linear_out, 8.6 us at 3.35 TB/s).  Design: K1's
// one launch at one row (int8_dot.cuh stage_rows, RowWalk): a one-wave
// grid, each block staging the activation while each warp's first two
// units are in flight, the rows dealt to the warps NR at a time.  At one
// activation row a RowWalk chunk is 4 16-byte loads a lane, 2048 packed
// columns: exactly a segment, its lane's steps the terms above in their
// order.  So the walk, handing over each chunk's lane partials
// (RowWalk::walk<true>), gives each form what it folds: the k-segment
// form warp-sums a chunk's partials and adds the sums in order into 0,
// the split-spread form adds the partials lane by lane and warp-sums at
// the row's last chunk.  (A form on thread-block clusters, a block a
// segment staging only its segment's activation and the partials folded
// in block 0 over distributed shared memory, measured slower on the
// H100: its staging waited behind the weight loads in flight as K1's
// does, and its launch cost more.)
#include <mutex>

#include "int8_dot.cuh"

namespace {

using mt_i8::FMT_Q4K;
using mt_i8::QK;

constexpr int SEG_COLS = 2048;  // packed columns a segment
constexpr int MAX_SEGS = 8;
// Tuning: threads a block, weight rows a warp's group.
constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int NR = 2;
using Walk = mt_i8::RowWalk<FMT_Q4K, true, NR, 1>;
static_assert(Walk::STEPS * 512 == SEG_COLS, "a chunk is a segment");

// Dynamic shared memory: xq [K] int8, dx and xs [K/32] f32, then one
// region that first holds the activation row [K] f32 and, with the norm,
// alpha [K] f32 (the staging), and then each warp's scale staging (two
// groups of NR rows of 2 * K/32 bf16).
size_t smem_bytes(int K, bool norm) {
  const size_t nb = K / QK;
  const size_t rows = (norm ? 2 : 1) * (size_t)K * sizeof(float);
  const size_t scales = (size_t)NWARPS * 2 * NR * 2 * nb * sizeof(bf16);
  return (size_t)K + 2 * nb * sizeof(float) +
         (rows > scales ? rows : scales);
}

template <bool KSEG>
__global__ void __launch_bounds__(THREADS, 1) split_kernel(
    const void* __restrict__ x, int x_bf16, const void* __restrict__ alpha,
    int alpha_bf16, const uint8_t* __restrict__ q,
    const bf16* __restrict__ es, const bf16* __restrict__ em,
    float* __restrict__ y, int O, int K, long long row0) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[32];
  // stage: start
  const int nb = K / QK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int8_t* xq = reinterpret_cast<int8_t*>(smem);
  float* dx = reinterpret_cast<float*>(smem + K);
  float* xs = dx + nb;
  float* xf = xs + nb;  // the staging's rows, then the scales
  float* af = xf + K;
  bf16* sc = reinterpret_cast<bf16*>(xf) + (size_t)warp * 2 * NR * 2 * nb;
  const Walk walk(q, es, em, K);
  // this warp's groups of NR rows, dealt in turn
  const mt_i8::Deal deal{(long long)blockIdx.x * NWARPS + warp,
                         (long long)gridDim.x * NWARPS, NR, O};
  const int ngroups = deal.groups();
  auto rows_of = [=](int g, long long(&rows)[NR]) {
    const int o = deal.first(g), n = deal.count(g);
#pragma unroll
    for (int r = 0; r < NR; ++r) rows[r] = row0 + o + (r < n ? r : 0);
    return n;
  };
  // the fold of the group's segments so far: k-segment the sum of their
  // warp sums, split-spread the lane's sum of their partials
  float v[NR];
  auto chunk_done = [&](int g, int c, const float(&acc)[NR][1], int n) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (KSEG) {
        if (c == 0) v[r] = 0.f;
        v[r] += mt_warp_sum(acc[r][0]);
      } else {
        v[r] = c == 0 ? acc[r][0] : v[r] + acc[r][0];
      }
    }
    if (c == walk.chunks - 1) {
      const int o = deal.first(g);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (r < n) {
          const float out = KSEG ? v[r] : mt_warp_sum(v[r]);
          if (lane == 0) y[o + r] = out;
        }
      }
    }
  };
  // x and alpha asked for first, then the first two units' weights, in
  // flight while the block stages x; their scales after (the staging's
  // rows share their memory)
  if (alpha != nullptr) mt_i8::load_row(alpha, alpha_bf16, K, af);
  mt_i8::load_row(x, x_bf16, K, xf);
  Walk::Buf a, b;
  long long r0[NR], r1[NR];
  int n0, n1;
  const int primed =
      walk.prime(a, b, 2, ngroups, rows_of, r0, n0, r1, n1, lane, nullptr);
  mt_i8::stage_rows(x, x_bf16, alpha, alpha_bf16, K, 1, xq, dx, xs, xf, af,
                    red);
  walk.prime_scales(primed, r0, n0, r1, n1, lane, sc);
  // stage: activation staged
  walk.walk<true>(a, b, primed, ngroups, rows_of, chunk_done, xq, dx, xs, 1,
                  lane, sc);
  // stage: end
}

// One launch: a one-wave grid (queried once per form, at its first
// call's shared memory), capped at one group a warp.
template <bool KSEG>
int run(const void* x, int x_bf16, const void* alpha, int alpha_bf16, int K,
        const void* q, const void* es, const void* em, void* y, int O,
        long long row0, void* stream) {
  const int K2 = K / 2;
  const int nsegs = (K2 + SEG_COLS - 1) / SEG_COLS;
  if (K % QK || K2 % 512 || nsegs < 1 || nsegs > MAX_SEGS || O < 1 ||
      (reinterpret_cast<uintptr_t>(es) & 15) ||
      (reinterpret_cast<uintptr_t>(em) & 15))
    return cudaErrorInvalidValue;
  auto* kernel = &split_kernel<KSEG>;
  const size_t smem = smem_bytes(K, alpha != nullptr);
  static int wave = 0;
  static cudaError_t query = cudaSuccess;
  static std::once_flag once;
  std::call_once(once, [&] {
    query = mt_i8::one_wave(reinterpret_cast<const void*>(kernel), THREADS,
                            smem, &wave);
  });
  if (query != cudaSuccess) return query;
  int blocks = wave;
  const int need = ((O + NR - 1) / NR + NWARPS - 1) / NWARPS;
  if (blocks > need) blocks = need;
  kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x, x_bf16, alpha, alpha_bf16, static_cast<const uint8_t*>(q),
      static_cast<const bf16*>(es), static_cast<const bf16*>(em),
      static_cast<float*>(y), O, K, row0);
  return cudaGetLastError();
}

}  // namespace

MT_ERROR_STRING_FN

// x [1, K] (f32 or bf16), alpha [K] or null; q [.., O, K/2] planar q4_k
// nibbles and es/em [.., O, K/32] bf16 (16-byte aligned), the whole
// (stacked) weight; y [O] f32; row0 the first row of the selected layer.
// One launch; returns its CUDA error.
extern "C" int mt_int8_kseg(const void* x, int x_bf16, const void* alpha,
                            int alpha_bf16, int K, const void* q,
                            const void* es, const void* em, void* y, int O,
                            long long row0, void* stream) {
  return run<true>(x, x_bf16, alpha, alpha_bf16, K, q, es, em, y, O, row0,
                   stream);
}

// The split-spread form: the same operands.
extern "C" int mt_int8_split(const void* x, int x_bf16, const void* alpha,
                             int alpha_bf16, int K, const void* q,
                             const void* es, const void* em, void* y, int O,
                             long long row0, void* stream) {
  return run<false>(x, x_bf16, alpha, alpha_bf16, K, q, es, em, y, O, row0,
                    stream);
}
