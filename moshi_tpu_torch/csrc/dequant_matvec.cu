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
// Design (dequant_tile.cuh): a grid of about one wave (at most the SMs
// times the blocks that fit on one, never more than the output rows
// need) times the groups of 1, 4 or 8 activation rows.  Each block issues
// its first weight loads, then stages and norms its group once (a
// lane-major tile layout in shared memory, in f32 where 8 rows fit, else
// bf16; every row's norm reduced at once in stage_rows' shape; all of a
// thread's loads issued before their first use), then each warp walks
// output tiles of R weight rows (4, or 2 at one activation row; half
// that where the wider tiles would leave half a wave idle), loading one
// step ahead and the next tile's first step before its warp sums.  Per
// step a lane reads 16 bytes of each of its R rows, dequantizes them as
// bf16 pairs and reads each staged word once (conflict-free) for all R
// rows.  Every output keeps dequant_dot.cuh's f32 sum order, so the
// results are those of its stage_rows / row_dot / row_result bit for
// bit.
#include "dequant_tile.cuh"

namespace {

using dqt::THREADS;
using dqt::WARPS;

// Dynamic shared memory a block may take on sm_90: 227 KB less the
// norm's reduction slots.
constexpr size_t SMEM_MAX = 232448 - dqt::MAXG * WARPS * sizeof(float);

template <bool XF>
struct Staged {  // the staged activation's element type
  using T = bf16;
};
template <>
struct Staged<true> {
  using T = float;
};

template <int FMT, int G, int R, bool XF>
__global__ void __launch_bounds__(THREADS, 1)
    dequant_matvec_kernel(const void* __restrict__ x, int x_bf16,
                          const void* __restrict__ alpha, int alpha_bf16,
                          int M, int K, const uint8_t* __restrict__ q,
                          const uint16_t* __restrict__ s1,
                          const uint16_t* __restrict__ s2,
                          float* __restrict__ y, int O, long long row0) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[G * WARPS];
  const int rs = dqt::row_stride(FMT, K), n = dqt::walked(FMT, K);
  using SX = typename Staged<XF>::T;
  SX* xs = reinterpret_cast<SX*>(smem);
  float* bsum = reinterpret_cast<float*>(smem + (size_t)G * rs * sizeof(SX));
  const int m0 = blockIdx.y * G, mg = min(G, M - m0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nsteps = (n + dqt::STEP - 1) / dqt::STEP;
  const int ntiles = (O + R - 1) / R, stride = gridDim.x * WARPS;

  dqt::Step<R> buf;  // the weights of the lane's next step
  long long rows[R];
  auto start_tile = [&](int tile) {  // its rows, and its first step
#pragma unroll
    for (int r = 0; r < R; ++r) rows[r] = row0 + min(tile * R + r, O - 1);
    if (lane * 16 < n) dqt::load_step<FMT, R>(buf, q, s1, rows, K, lane * 16);
  };

  int tile = blockIdx.x * WARPS + warp;
  if (tile < ntiles) start_tile(tile);
  dqt::stage<FMT, G>(x, x_bf16, alpha, alpha_bf16, m0, mg, K, xs, bsum, red);
  const SX* xl = xs + lane * 4;
  const SX* xh = xl + (FMT == dqt::FMT_Q80 ? 0 : dqt::region(FMT, K));

  for (; tile < ntiles; tile += stride) {
    float acc[R][G];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int m = 0; m < G; ++m) acc[r][m] = 0.f;
    for (int t = 0; t < nsteps; ++t) {
      const int c = lane * 16 + t * dqt::STEP;
      if (c < n) {
        const dqt::Step<R> cur = buf;
        if (c + dqt::STEP < n)
          dqt::load_step<FMT, R>(buf, q, s1, rows, K, c + dqt::STEP);
        dqt::dot_step<FMT, G, R>(cur, xl + t * dqt::STEP,
                                 xh + t * dqt::STEP, rs, acc);
      }
    }
    const int o0 = tile * R;
    float am[R][G];
    if (FMT == dqt::FMT_Q4K) dqt::min_term<R, G>(s2, rows, K, bsum, am);
    if (tile + stride < ntiles) start_tile(tile + stride);
    // lane l holds output (r, m) = (j / G, j % G), j = l / (32 / (R G))
    float v = dqt::warp_sums<R * G>(reinterpret_cast<float(&)[R * G]>(acc));
    if (FMT == dqt::FMT_Q4K)
      v -= dqt::warp_sums<R * G>(reinterpret_cast<float(&)[R * G]>(am));
    constexpr int per = 32 / (R * G);
    const int j = lane / per, r = j / G, m = j % G;
    if (lane % per == 0 && m < mg && o0 + r < O)
      y[(long long)(m0 + m) * O + o0 + r] = v;
  }
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

// One call's operands.
struct Call {
  const void* x;
  int x_bf16;
  const void* alpha;
  int alpha_bf16, M, K;
  const void* q;
  const void* s1;
  const void* s2;
  void* y;
  int O;
  long long row0;
  cudaStream_t st;
};

template <int FMT, int G, int R, bool XF>
cudaError_t launch(const Call& a) {
  const size_t smem = dqt::smem_bytes(FMT, G, a.K, XF);
  auto kernel = dequant_matvec_kernel<FMT, G, R, XF>;
  cudaError_t err = dq::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int need = ((a.O + R - 1) / R + WARPS - 1) / WARPS;
  const dim3 grid(min(need, per_sm * sm_count()), (a.M + G - 1) / G);
  kernel<<<grid, THREADS, smem, a.st>>>(
      a.x, a.x_bf16, a.alpha, a.alpha_bf16, a.M, a.K,
      static_cast<const uint8_t*>(a.q), static_cast<const uint16_t*>(a.s1),
      static_cast<const uint16_t*>(a.s2), static_cast<float*>(a.y), a.O,
      a.row0);
  return cudaGetLastError();
}

// Weight rows per warp: 4 (2 at one staged row), so that each staged word
// serves several rows, or half that where the wider tiles would leave
// more than half of one wave's warps without a row.  A group of 8 rows is
// staged in f32 where that fits.
template <int FMT, int G, bool XF>
cudaError_t launch_r(const Call& a) {
  constexpr int RB = G == 1 ? 2 : 4;
  if ((a.O + RB - 1) / RB >= WARPS * sm_count() / 2)
    return launch<FMT, G, RB, XF>(a);
  return launch<FMT, G, RB / 2, XF>(a);
}

template <int FMT, int G>
cudaError_t launch_g(const Call& a) {
  if (G == dqt::MAXG && dqt::smem_bytes(FMT, G, a.K, true) <= SMEM_MAX)
    return launch_r<FMT, G, G == dqt::MAXG>(a);
  return launch_r<FMT, G, false>(a);
}

// Rows staged per block: 1, 4 or 8, the least that holds min(M, 8),
// smaller while its staging does not fit (the rows' groups change no
// output's arithmetic).
int group_rows(int fmt, int M, int K) {
  int g = M == 1 ? 1 : M <= 4 ? 4 : dqt::MAXG;
  while (g > 1 && dqt::smem_bytes(fmt, g, K, false) > SMEM_MAX)
    g = g == dqt::MAXG ? 4 : 1;
  return g;
}

template <int FMT>
cudaError_t launch_fmt(const Call& a) {
  switch (group_rows(FMT, a.M, a.K)) {
    case 1:
      return launch_g<FMT, 1>(a);
    case 4:
      return launch_g<FMT, 4>(a);
    default:
      return launch_g<FMT, 8>(a);
  }
}

int dispatch(const Call& a, int fmt) {
  if (a.M < 1 || a.O < 1 || a.K % dq::QK) return cudaErrorInvalidValue;
  switch (fmt) {
    case dq::FMT_Q4K:
      return launch_fmt<dq::FMT_Q4K>(a);
    case dq::FMT_Q40:
      return launch_fmt<dq::FMT_Q40>(a);
    case dq::FMT_Q80:
      return launch_fmt<dq::FMT_Q80>(a);
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
