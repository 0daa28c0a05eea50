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
// cooperative launch (cudaLaunchCooperativeKernel), the grid sized to
// what can be co-resident (occupancy x SMs, capped at the rows' need),
// rows walked grid-stride:
//   1. each block quantizes the attn row into its shared memory;
//   2. one warp per out_proj row; lane 0 writes h_mid[o] to global memory;
//   3. grid.sync();
//   4. each block reads h_mid (L2) into shared memory once, takes the
//      norm (every block sums in the same order, so every block forms the
//      same n2) and quantizes n2 into shared memory;
//   5. one warp per GLU row pair, with the silu * value epilogue.
//
// Bound on the H100: bytes (the two packed weight streams of the layer
// over 3.35 TB/s; at one row every weight byte is used for 2-4 integer
// ops).  Simple first: no tensor cores, no TMA; each block re-reads the
// attn row and h_mid from L2 instead of one block broadcasting them.
#include <cooperative_groups.h>

#include "int8_dot.cuh"

namespace cg = cooperative_groups;

namespace {

using mt_i8::FMT_Q40;
using mt_i8::FMT_Q4K;
using mt_i8::FMT_Q80;
using mt_i8::QK;
using mt_i8::row_dot;

constexpr int THREADS = 256;

// Dynamic shared memory: xq [K] int8, dx [K/32], xs [K/32], h [K] f32.
size_t smem_bytes(int K) {
  return (size_t)K + 2 * (size_t)(K / QK) * sizeof(float) +
         (size_t)K * sizeof(float);
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
__global__ void __launch_bounds__(THREADS) fused_kernel(
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
  const int nb = K / QK;
  int8_t* xq = reinterpret_cast<int8_t*>(smem);
  float* dx = reinterpret_cast<float*>(smem + K);
  float* xs = dx + nb;
  float* hs = xs + nb;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int gwarp = blockIdx.x * nwarps + warp;
  const int gwarps = gridDim.x * nwarps;

  // 1. the attn row, quantized without a norm
  for (int b = warp; b < nb; b += nwarps) {
    const int i = b * QK + lane;
    mt_i8::quant_block(mt_load(attn, i, attn_bf16), i, b, lane, xq, dx, xs);
  }
  __syncthreads();

  constexpr int FO = fmt_of(CO), FG = fmt_of(CG);
  constexpr bool PO = packed_of(CO), PG = packed_of(CG);

  // 2. out_proj rows and the residual
  const long long obytes = mt_i8::row_bytes<FO, PO>(K);
  for (int o = gwarp; o < K; o += gwarps) {
    const long long r = orow0 + o;
    const float v = row_dot<FO, PO>(oq + r * obytes, os1 + r * nb,
                                    FO == FMT_Q4K ? os2 + r * nb : nullptr,
                                    xq, dx, xs, K, lane);
    if (lane == 0) h_mid[o] = mt_load(hcur, o, h_bf16) + v;
  }
  __threadfence();
  cg::this_grid().sync();

  // 4. norm2 of h_mid and its quantization (read through L2: other SMs
  //    wrote it)
  float acc = 0.f;
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    const float v = __ldcg(h_mid + i);
    hs[i] = v;
    acc += v * v;
  }
  acc = mt_block_sum(acc, red);  // syncs the block: hs is complete
  const float rn = 1.f / sqrtf(acc / (float)K + 1e-8f);
  for (int b = warp; b < nb; b += nwarps) {
    const int i = b * QK + lane;
    const float v = hs[i] * rn * mt_load(alpha, i, alpha_bf16);
    mt_i8::quant_block(v, i, b, lane, xq, dx, xs);
  }
  __syncthreads();

  // 5. GLU rows: silu(gate) * value
  const long long gbytes = mt_i8::row_bytes<FG, PG>(K);
  for (int o = gwarp; o < H; o += gwarps) {
    long long r = grow0 + o;
    const float gate = row_dot<FG, PG>(gq + r * gbytes, gs1 + r * nb,
                                       FG == FMT_Q4K ? gs2 + r * nb : nullptr,
                                       xq, dx, xs, K, lane);
    r = grow0 + H + o;
    const float val = row_dot<FG, PG>(gq + r * gbytes, gs1 + r * nb,
                                      FG == FMT_Q4K ? gs2 + r * nb : nullptr,
                                      xq, dx, xs, K, lane);
    if (lane == 0) g[o] = gate * (1.f / (1.f + expf(-gate))) * val;
  }
}

template <int CO, int CG>
cudaError_t launch(void** args, int K, int H, cudaStream_t st) {
  const void* fn = reinterpret_cast<const void*>(&fused_kernel<CO, CG>);
  const size_t smem = smem_bytes(K);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int warps = THREADS / 32;
  const int rows = K > H ? K : H;
  int blocks = (rows + warps - 1) / warps;
  if (blocks > per_sm * sms) blocks = per_sm * sms;
  return cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(THREADS), args,
                                     smem, st);
}

template <int CO>
cudaError_t launch_g(int gfmt, void** args, int K, int H, cudaStream_t st) {
  switch (gfmt) {
    case 0: return launch<CO, 0>(args, K, H, st);
    case 1: return launch<CO, 1>(args, K, H, st);
    case 2: return launch<CO, 2>(args, K, H, st);
    case 3: return launch<CO, 3>(args, K, H, st);
    case 4: return launch<CO, 4>(args, K, H, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

MT_ERROR_STRING_FN

// attn [K] (f32 or bf16), hcur [K] (f32 or bf16), alpha [K] (the layer's
// norm2 row); the out_proj weight (q/s1/s2, format code ofmt) is addressed
// from row orow0 = layer * K, the fused linear_in (format code gfmt) from
// row grow0 = layer * 2H; the codes are int8_dot.cuh's (3 and 4 unpacked
// storage).  Writes g [H] and h_mid [K] (f32).  Returns the
// launch's CUDA error (a refused cooperative launch included).
extern "C" int mt_attn_ffn_fused(const void* attn, int attn_bf16,
                                 const void* hcur, int h_bf16,
                                 const void* alpha, int alpha_bf16, int K,
                                 int H, const void* oq, const void* os1,
                                 const void* os2, int ofmt, long long orow0,
                                 const void* gq, const void* gs1,
                                 const void* gs2, int gfmt, long long grow0,
                                 void* g, void* h_mid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
    case 0: err = launch_g<0>(gfmt, args, K, H, st); break;
    case 1: err = launch_g<1>(gfmt, args, K, H, st); break;
    case 2: err = launch_g<2>(gfmt, args, K, H, st); break;
    case 3: err = launch_g<3>(gfmt, args, K, H, st); break;
    case 4: err = launch_g<4>(gfmt, args, K, H, st); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  return err;
}
