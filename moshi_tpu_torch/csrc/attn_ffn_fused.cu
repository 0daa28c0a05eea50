// K5: attention out_proj + residual + rms-norm2 + GLU linear_in, one row,
// in one cooperative launch.
//
// Replaces moshi_tpu/quant/pallas_fused.py attn_ffn_fused_i8 (kernel body
// _mk_fused_kernel):
//
//   o     = Wout[layer] . q8(attn)                     (no norm)
//   h_mid = f32(hcur) + o                              (written out, f32)
//   n2    = rms_norm(h_mid, eps 1e-8) * alpha2[layer]
//   g     = silu(Wg . q8(n2)) * (Wv . q8(n2))          (gate rows [0, H),
//                                                      value rows [H, 2H))
//
// with q8 the per-32-block int8 activation quantization and the row dots
// and scale epilogues of K1 (int8_dot.cuh), so each half is K1's
// arithmetic; h_mid stays f32 between the two.  Each weight group, the
// out_proj and the fused linear_in, is in its own format and storage
// (packed nibbles, or unpacked int8 as K1 takes it: the Pallas kernel's
// per-group packed flag), one template instance per pair.
//
// The Pallas kernel ran its grid in order on one core, carrying the
// quantized rows and o in VMEM scratch from step to step.  Hopper blocks
// run in no order, and the norm needs every row of o.  So: one
// cooperative launch of one block an SM (the grid queried once per
// instance), the out_proj rows and the GLU outputs dealt to the warps a
// group at a time in turn (at each step the warps read neighbouring
// rows):
//   1. each block quantizes the attn row into its shared memory;
//   2. the warps' out_proj rows, a group of NR at a time, a chunk of
//      loads in flight ahead of the arithmetic (int8_dot.cuh RowWalk; the
//      first two chunks issued during stage 1, after its row); lane 0
//      writes h_mid[o] to global memory;
//   3. grid.sync() (asking L2 for each warp's first GLU rows before it
//      measured 3 us slower a layer in a frame's order of calls);
//   4. each block (once an SM) reads h_mid (L2) into shared memory, takes
//      the norm with the sum in the order of 256 lanes (every block sums in
//      the same order, so every block forms the same n2) and quantizes n2
//      into shared memory;
//   5. the warps' GLU outputs, a gate and value row pair a group, with the
//      silu * value epilogue.
// Each output's sum keeps the order of one warp a row (RowWalk).
//
// Bound on the H100: bytes (the two weight streams of the layer over
// 3.35 TB/s; at one row every weight byte is used for 2-4 integer ops).
// No tensor cores, no TMA.
#include <cooperative_groups.h>

#include <mutex>

#include "int8_dot.cuh"

namespace cg = cooperative_groups;

namespace {

using mt_i8::FMT_Q40;
using mt_i8::FMT_Q4K;
using mt_i8::FMT_Q80;
using mt_i8::QK;

// Tuning: threads of the one block an SM, and weight rows a warp's group
// holds in flight (out_proj rows; the GLU takes them as gate/value pairs).
// Measured slower in a frame's order of calls: 1024 threads with half the
// loads a chunk (with one or two out_proj units issued in stage 1), and
// GLU groups of two pairs.
constexpr int THREADS = 512;
constexpr int NR = 2;
constexpr int NWARPS = THREADS / 32;
constexpr int NORM_LANES = 256;   // the norm's sum: 256 lanes' order

// Dynamic shared memory: xq [K] int8, dx [K/32], xs [K/32], h [K] f32 (the
// attn row, then h_mid), alpha [K] f32, and each warp's scale staging (two
// groups of NR rows of 2 * K/32 bf16).
size_t smem_bytes(int K) {
  const size_t nb = K / QK;
  return (size_t)K + 2 * nb * sizeof(float) + 2 * (size_t)K * sizeof(float) +
         (size_t)NWARPS * 2 * NR * 2 * nb * sizeof(bf16);
}

// A weight group's format and storage from its C format code (int8_dot.cuh:
// 0-2 the formats, 3 and 4 q4_k and q4_0 unpacked).
__host__ __device__ constexpr int fmt_of(int code) {
  return code >= mt_i8::CODE_Q4K_I8 ? code - mt_i8::CODE_Q4K_I8 : code;
}
__host__ __device__ constexpr bool packed_of(int code) {
  return code == FMT_Q4K || code == FMT_Q40;
}

template <int CO, int CG>
__global__ void __launch_bounds__(THREADS, 1) fused_kernel(
    const void* __restrict__ attn, int attn_bf16,
    const void* __restrict__ hcur, int h_bf16,
    const void* __restrict__ alpha, int alpha_bf16, int K, int H,
    const uint8_t* __restrict__ oq, const bf16* __restrict__ os1,
    const bf16* __restrict__ os2, long long orow0,
    const uint8_t* __restrict__ gq, const bf16* __restrict__ gs1,
    const bf16* __restrict__ gs2, long long grow0, float* __restrict__ g,
    float* h_mid) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[32];
  // stage: start
  constexpr int FO = fmt_of(CO), FG = fmt_of(CG);
  constexpr bool PO = packed_of(CO), PG = packed_of(CG);
  constexpr int PAIRS = NR / 2;   // GLU outputs a group
  using OutWalk = mt_i8::RowWalk<FO, PO, NR, 1>;
  using GluWalk = mt_i8::RowWalk<FG, PG, NR, 1>;
  const int nb = K / QK;
  int8_t* xq = reinterpret_cast<int8_t*>(smem);
  float* dx = reinterpret_cast<float*>(smem + K);
  float* xs = dx + nb;
  float* hs = xs + nb;
  float* as = hs + K;
  bf16* sc = reinterpret_cast<bf16*>(as + K) + (size_t)(threadIdx.x >> 5) *
                                                   2 * NR * 2 * nb;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long nw = (long long)gridDim.x * NWARPS;
  const long long gw = (long long)blockIdx.x * NWARPS + warp;
  const mt_i8::Deal odeal{gw, nw, NR, K}, gdeal{gw, nw, PAIRS, H};
  const OutWalk owalk(oq, os1, FO == FMT_Q4K ? os2 : nullptr, K);
  const GluWalk gwalk(gq, gs1, FG == FMT_Q4K ? gs2 : nullptr, K);
  // the out_proj rows of group j; how many are valid
  auto out_rows = [=](int j, long long(&rows)[NR]) {
    const int o = odeal.first(j), n = odeal.count(j);
#pragma unroll
    for (int u = 0; u < NR; ++u) rows[u] = orow0 + o + (u < n ? u : 0);
    return n;
  };
  auto out_done = [=](int j, const float(&out)[NR][1], int n) {
    if (lane != 0) return;
    const int o = odeal.first(j);
#pragma unroll
    for (int u = 0; u < NR; ++u)
      if (u < n) h_mid[o + u] = mt_load(hcur, o + u, h_bf16) + out[u][0];
  };
  // the gate and value rows of GLU group j, side by side
  auto glu_rows = [=](int j, long long(&rows)[NR]) {
    const int o = gdeal.first(j), n = gdeal.count(j);
#pragma unroll
    for (int u = 0; u < PAIRS; ++u) {
      const long long ou = o + (u < n ? u : 0);
      rows[2 * u] = grow0 + ou;
      rows[2 * u + 1] = grow0 + H + ou;
    }
    return 2 * n;
  };
  auto glu_done = [=](int j, const float(&out)[NR][1], int n) {
    if (lane != 0) return;
    const int o = gdeal.first(j);
#pragma unroll
    for (int u = 0; u < PAIRS; ++u) {
      if (2 * u < n) {
        const float gate = out[2 * u][0], val = out[2 * u + 1][0];
        g[o + u] = gate * (1.f / (1.f + expf(-gate))) * val;
      }
    }
  };
  const int ogroups = odeal.groups(), ggroups = gdeal.groups();
  long long r0[NR], r1[NR];
  int n0, n1;

  // 1. the attn row, quantized without a norm (and alpha staged for 4);
  //    the rows asked for first, then the first two out_proj units, in
  //    flight while the block quantizes
  mt_i8::load_row(attn, attn_bf16, K, hs);
  mt_i8::load_row(alpha, alpha_bf16, K, as);
  typename OutWalk::Buf oa, obuf;
  const int oprimed = owalk.prime(oa, obuf, 2, ogroups, out_rows, r0, n0, r1,
                                  n1, lane, sc);
  __syncthreads();
  mt_i8::quant_row(hs, 1.f, nullptr, K, xq, dx, xs);
  __syncthreads();
  // stage: attn quantized

  // 2. out_proj rows and the residual
  owalk.walk(oa, obuf, oprimed, ogroups, out_rows, out_done, xq, dx, xs, 1,
             lane, sc);
  // stage: out_proj done
  __threadfence();
  cg::this_grid().sync();
  // stage: synced

  // 4. norm2 of h_mid and its quantization (read through L2: other SMs
  //    wrote it); the sum of squares in the order of NORM_LANES lanes.
  //    (GLU loads issued here would hold back this stage's own: a warp's
  //    memory instructions wait behind its outstanding loads.)
  mt_i8::load_row(h_mid, 0, K, hs);
  __syncthreads();
  float acc = 0.f;
  if (threadIdx.x < NORM_LANES) {
    for (int i = threadIdx.x; i < K; i += NORM_LANES) {
      const float v = hs[i];
      acc += v * v;
    }
  }
  acc = mt_warp_sum(acc);
  if (lane == 0 && warp < NORM_LANES / 32) red[warp] = acc;
  __syncthreads();
  acc = mt_warp_sum(lane < NORM_LANES / 32 ? red[lane] : 0.f);
  const float rn = 1.f / sqrtf(acc / (float)K + 1e-8f);
  mt_i8::quant_row(hs, rn, as, K, xq, dx, xs);
  __syncthreads();
  // stage: n2 quantized

  // 5. GLU rows: silu(gate) * value
  typename GluWalk::Buf ga, gbuf;
  gwalk.walk(ga, gbuf, 0, ggroups, glu_rows, glu_done, xq, dx, xs, 1, lane,
             sc);
  // stage: end
}

// One cooperative launch of one block an SM.  Whether a block of THREADS
// fits an SM at this shared memory, the SM count and the opt-in to the
// largest dynamic shared memory are asked once for this instance.
template <int CO, int CG>
cudaError_t launch(void** args, int K, cudaStream_t st) {
  const void* fn = reinterpret_cast<const void*>(&fused_kernel<CO, CG>);
  const size_t smem = smem_bytes(K);
  static int blocks = 0;
  static cudaError_t query = cudaSuccess;
  static std::once_flag once;
  std::call_once(once, [&] {
    int dev = 0, optin = 0, per_sm = 0;
    cudaFuncAttributes attr;
    query = cudaGetDevice(&dev);
    if (query == cudaSuccess)
      query = cudaDeviceGetAttribute(&blocks, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (query == cudaSuccess)
      query = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (query == cudaSuccess) query = cudaFuncGetAttributes(&attr, fn);
    if (query == cudaSuccess)
      query = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
          optin - (int)attr.sharedSizeBytes);
    if (query == cudaSuccess)
      query = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                            THREADS, smem);
    if (query == cudaSuccess && per_sm < 1)
      query = cudaErrorCooperativeLaunchTooLarge;
  });
  if (query != cudaSuccess) return query;
  return cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(THREADS), args,
                                     smem, st);
}

template <int CO>
cudaError_t launch_g(int gfmt, void** args, int K, cudaStream_t st) {
  switch (gfmt) {
    case 0: return launch<CO, 0>(args, K, st);
    case 1: return launch<CO, 1>(args, K, st);
    case 2: return launch<CO, 2>(args, K, st);
    case 3: return launch<CO, 3>(args, K, st);
    case 4: return launch<CO, 4>(args, K, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

MT_ERROR_STRING_FN

// attn [K] (f32 or bf16), hcur [K] (f32 or bf16), alpha [K] (the layer's
// norm2 row); the out_proj weight (q/s1/s2, format code ofmt) is addressed
// from row orow0 = layer * K, the fused linear_in (format code gfmt) from
// row grow0 = layer * 2H; the codes are int8_dot.cuh's (3 and 4 unpacked
// storage); the scales 16-byte aligned.  Writes g [H] and h_mid [K]
// (f32).  Returns the launch's CUDA error (a refused cooperative launch
// included).
extern "C" int mt_attn_ffn_fused(const void* attn, int attn_bf16,
                                 const void* hcur, int h_bf16,
                                 const void* alpha, int alpha_bf16, int K,
                                 int H, const void* oq, const void* os1,
                                 const void* os2, int ofmt, long long orow0,
                                 const void* gq, const void* gs1,
                                 const void* gs2, int gfmt, long long grow0,
                                 void* g, void* h_mid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % (8 * QK)) return cudaErrorInvalidValue;
  const uint8_t* oqp = static_cast<const uint8_t*>(oq);
  const bf16* os1p = static_cast<const bf16*>(os1);
  const bf16* os2p = static_cast<const bf16*>(os2);
  const uint8_t* gqp = static_cast<const uint8_t*>(gq);
  const bf16* gs1p = static_cast<const bf16*>(gs1);
  const bf16* gs2p = static_cast<const bf16*>(gs2);
  float* gp = static_cast<float*>(g);
  float* hp = static_cast<float*>(h_mid);
  void* args[] = {&attn, &attn_bf16, &hcur, &h_bf16, &alpha, &alpha_bf16,
                  &K,    &H,         &oqp,  &os1p,   &os2p,  &orow0,
                  &gqp,  &gs1p,      &gs2p, &grow0,  &gp,    &hp};
  cudaError_t err;
  switch (ofmt) {
    case 0: err = launch_g<0>(gfmt, args, K, st); break;
    case 1: err = launch_g<1>(gfmt, args, K, st); break;
    case 2: err = launch_g<2>(gfmt, args, K, st); break;
    case 3: err = launch_g<3>(gfmt, args, K, st); break;
    case 4: err = launch_g<4>(gfmt, args, K, st); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  return err;
}
