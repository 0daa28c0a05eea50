// K13: the whole q4_k temporal stack for one frame (B = 1, T = 1) in one
// cooperative launch.
//
// Replaces moshi_tpu/nn/pallas_temporal.py temporal_full_step (kernel
// body _temporal_kernel).  Per layer, the hidden state h carried in f32:
//
//   xn = rms_norm(h) * n1[l];  q, k, v = W_qkv . xn
//   q, k = rope(q), rope(k)       interleaved pairs, x*cos + swap(x)*sin_m
//   attention of q over the current token and the ring (before the write)
//   h2 = h + W_out . attn
//   hv = silu(W_g . xn2) * (W_v . xn2),  xn2 = rms_norm(h2) * n2[l]
//   h  = h2 + W_lout . hv
//
// Every product is the dequant arithmetic of dequant_dot.cuh (the Pallas
// kernel's _q4k_dot): bf16(xn) against bf16(q * es), f32 sums, minus the
// f32 32-block sums of xn times em.
//
// The attention follows the Pallas kernel's online softmax exactly: the
// seed is the current token (m = s0, l = 1, acc = the f32 v row, s0 the
// head sums of bf16(k * q) of the f32 rope'd rows); the ring is walked in
// chunks of `chunk` slots; a slot's score is the head sum of the bf16
// products bf16(k_j) * bf16(q), each rounded to bf16, summed in f32;
// slot j is valid iff delta < context, offset - delta >= 0, j < cap and
// j != r (r = offset % cap, delta = r - j, + cap if j > r); per chunk
// m_new = max(m, chunk max), corr = exp(m - m_new), l = l * corr +
// sum(p), acc = acc * corr + sum(bf16(bf16(p) * v)).  The chunk sets where
// p is rounded, so it is part of the numerics.
//
// The Pallas grid walked (layer, stage) in order on one core, carrying h,
// the softmax state and the projections in VMEM scratch.  Here the stages
// are separated by grid syncs of one cooperative launch (the grid sized
// to what can be co-resident, as K5); every block keeps its own copy of
// h in shared memory, updated identically by every block, and whatever
// one block writes for others (the projections, the scores, the per-chunk
// softmax parts) goes through global scratch, read back through L2
// (__ldcg).  Per layer:
//   S1 rms1 and the qkv rows (one warp per row)            grid sync
//   S2 rope; the seed s0 and k_new/v_new (block 0); one warp per ring
//      slot scores every head                               grid sync
//   S3 one block per (head, chunk): its running max (the seed and the
//      maxima of the chunks up to it), p, sum(p), sum(bf16(p) * v)
//                                                           grid sync
//   S4 every block folds the chunks in order (corr, l, acc) into attn;
//      the out_proj rows                                     grid sync
//   S5 the residual, rms2, the GLU row pairs                grid sync
//   S6 linear_out rows                                      grid sync,
//      then the residual.
// Folding the chunks in S4 from per-chunk maxima gives the same m_new,
// corr and p as the sequential walk: m_new of chunk c is the maximum of
// the seed and of the chunks up to c.
//
// The rings are bf16 or float8_e4m3fn (a template parameter, as in
// decode_attention.cu).  The Pallas kernel widens each fp8 ring chunk to
// bf16 (exact) before the same arithmetic, and writes its k/v rows cast
// to the rings' dtype (XLA's convert: NaN past 464).  Here a 16-byte load
// of an fp8 ring row holds 16 values, widened by value
// (RingElem<fp8>::widen), and each lane keeps the two 8-value partial
// sums a bf16 lane pair would, reduced over the same tree, so the scores,
// and h, equal the bf16 instance's on the rings widened; the rows are
// written by mt_fp8_e4m3, that rule.  The bf16 instance's loops are as
// they were (if constexpr).
//
// Bound on the H100: bytes (every weight of the 32 layers once, 3.6 GB at
// the 7B, and the ring's valid rows).  Simple first: no tensor cores, no
// TMA, every block stages each activation from L2, and 6 grid syncs per
// layer.
#include <cooperative_groups.h>

#include <type_traits>

#include "dequant_dot.cuh"
#include "fp8.cuh"

namespace cg = cooperative_groups;

namespace {

using dq::FMT_Q4K;
using dq::QK;

constexpr int THREADS = 256;
constexpr float NEG = -1e9f;

struct Args {
  const void* h;
  int h_bf16;
  const void* kc;   // the ring element type is the kernel's template
  const void* vc;
  const int* offset;
  const float* cos;
  const float* sin;
  dq::Weight qkv, out, glu, lout;   // q4_k
  const void* n1;
  int n1_bf16;
  const void* n2;
  int n2_bf16;
  float* h_out;
  void* k_new;
  void* v_new;
  float* scratch;
  int dd, heads, hidden, cap, cap_pad, context, chunk, nlayers;
  float scale;   // hd^-0.5, rounded to f32 by the caller
};

// x*cos + pairswap(x)*sin_m at lane i of a head-major f32 row that other
// blocks wrote (read through L2); no fused multiply-add, as the reference
// multiplies and adds apart.
__device__ __forceinline__ float rope_l2(const float* x, int i, int hd,
                                         const float* cs, const float* sn) {
  const int p = (i % hd) >> 1;
  const bool even = (i & 1) == 0;
  const float sw = __ldcg(x + (even ? i + 1 : i - 1));
  const float sm = even ? -sn[p] : sn[p];
  return __fadd_rn(__fmul_rn(__ldcg(x + i), cs[p]), __fmul_rn(sw, sm));
}

// One ring value widened to f32, and an f32 row value in the ring's type
// (fp8 by mt_fp8_e4m3, XLA's rule).
__device__ __forceinline__ float ring_value(bf16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float ring_value(fp8 x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x, __NV_E4M3)));
}
template <typename T>
__device__ __forceinline__ T ring_cast(float x) {
  if constexpr (std::is_same_v<T, fp8>)
    return mt_fp8_e4m3(x);
  else
    return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) temporal_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[32];
  cg::grid_group grid = cg::this_grid();
  const int dd = a.dd, H = a.heads, hd = dd / H, hidden = a.hidden;
  const int cap = a.cap, cap_pad = a.cap_pad, chunk = a.chunk;
  const int nch = cap_pad / chunk;
  const int kmax = hidden > dd ? hidden : dd;
  float* hs = reinterpret_cast<float*>(smem);            // h [dd]
  float* as = hs + dd;                                   // q / attn [dd]
  float* ps = as + dd;                                   // p [chunk]
  float* red2 = ps + chunk;                              // [THREADS]
  bf16* xb = reinterpret_cast<bf16*>(red2 + THREADS);    // [kmax]
  float* bsum = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(xb) + dq::xb_bytes(1, kmax));
  // global scratch (f32)
  float* qkv = a.scratch;                                // [3dd]
  float* sc = qkv + 3 * dd;                              // [H, cap_pad]
  float* s0 = sc + (long long)H * cap_pad;               // [H]
  float* mpart = s0 + H;                                 // [H, nch]
  float* lpart = mpart + H * nch;                        // [H, nch]
  float* pvpart = lpart + H * nch;                       // [nch, dd]
  float* ov = pvpart + (long long)nch * dd;              // [dd]
  float* hv = ov + dd;                                   // [hidden]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = THREADS / 32;
  const int gwarp = blockIdx.x * nwarps + warp, gwarps = gridDim.x * nwarps;
  const float scale = a.scale;
  const int off = *a.offset;
  const int r = off % cap;
  const T* kc = static_cast<const T*>(a.kc);
  const T* vc = static_cast<const T*>(a.vc);
  T* k_new = static_cast<T*>(a.k_new);
  T* v_new = static_cast<T*>(a.v_new);

  for (int i = tid; i < dd; i += THREADS) hs[i] = mt_load(a.h, i, a.h_bf16);
  __syncthreads();

  for (int l = 0; l < a.nlayers; ++l) {
    const long long lrow = l;
    // ---- S1: rms1 and the qkv rows -------------------------------------
    dq::stage_rows<FMT_Q4K>(hs, 0, dq::row_of(a.n1, a.n1_bf16, l, dd),
                            a.n1_bf16, 0, 1, dd, xb, bsum, red);
    for (int o = gwarp; o < 3 * dd; o += gwarps) {
      const float v =
          dq::row_dot1<FMT_Q4K>(a.qkv, lrow * 3 * dd + o, dd, xb, bsum);
      if (lane == 0) qkv[o] = v;
    }
    __threadfence();
    grid.sync();

    // ---- S2: rope, the seed, the scores ---------------------------------
    for (int i = tid; i < dd; i += THREADS)
      as[i] = rope_l2(qkv, i, hd, a.cos, a.sin);
    __syncthreads();
    if (blockIdx.x == 0) {
      // k_new / v_new, and the seed: head sums of bf16(k * q), f32 product
      for (int hh = warp; hh < H; hh += nwarps) {
        float s = 0.f;
        for (int e = lane; e < hd; e += 32) {
          const int i = hh * hd + e;
          const float kr = rope_l2(qkv + dd, i, hd, a.cos, a.sin);
          k_new[(long long)l * dd + i] = ring_cast<T>(kr);
          v_new[(long long)l * dd + i] =
              ring_cast<T>(__ldcg(qkv + 2 * dd + i));
          s += mt_bf16_round(__fmul_rn(kr, as[i]));
        }
        s = mt_warp_sum(s);
        if (lane == 0) s0[hh] = s * scale;
      }
    }
    {
      const T* kl = kc + (long long)l * cap_pad * dd;
      for (int j = gwarp; j < cap_pad; j += gwarps) {
        const int delta = j > r ? r - j + cap : r - j;
        const bool ok = j < cap && j != r && delta < a.context &&
                        off - delta >= 0;
        if (!ok) {
          for (int hh = lane; hh < H; hh += 32)
            sc[(long long)hh * cap_pad + j] = NEG;
          continue;
        }
        const T* krow = kl + (long long)j * dd;
        if constexpr (std::is_same_v<T, fp8>) {
          // 16 values a lane from one 16-byte load, as two 8-value partial
          // sums: the lane pair (2t, 2t + 1) of the bf16 instance is one
          // lane here, so its tree's last level is the sum of the two
          const int lph = hd / 16;         // lanes per head
          for (int base0 = 0; base0 < dd; base0 += 512) {
            const int base = base0 + lane * 16;  // whole heads leave together
            const bool act = base < dd;
            float sa = 0.f, sb = 0.f;  // values [base, +8) and [+8, +16)
            if (act) {
              float kv[16];
              RingElem<fp8>::widen(
                  *reinterpret_cast<const uint4*>(krow + base), kv);
#pragma unroll
              for (int e = 0; e < 8; ++e) {
                sa += mt_bf16_round(kv[e] * mt_bf16_round(as[base + e]));
                sb += mt_bf16_round(kv[8 + e] *
                                    mt_bf16_round(as[base + 8 + e]));
              }
            }
            for (int o = lph >> 1; o > 0; o >>= 1) {
              sa += __shfl_xor_sync(MT_FULL_MASK, sa, o);
              sb += __shfl_xor_sync(MT_FULL_MASK, sb, o);
            }
            if (act && (lane % lph) == 0)
              sc[(long long)(base / hd) * cap_pad + j] = (sa + sb) * scale;
          }
        } else {
          const int lph = hd / 8;          // lanes per head, 8 values each
          for (int base = lane * 8; base < dd; base += 256) {
            const uint4 raw = *reinterpret_cast<const uint4*>(krow + base);
            const bf16* kv = reinterpret_cast<const bf16*>(&raw);
            float s = 0.f;
#pragma unroll
            for (int e = 0; e < 8; ++e)
              s += mt_bf16_round(__bfloat162float(kv[e]) *
                                 mt_bf16_round(as[base + e]));
            for (int o = lph >> 1; o > 0; o >>= 1)
              s += __shfl_xor_sync(MT_FULL_MASK, s, o);
            if ((lane % lph) == 0)
              sc[(long long)(base / hd) * cap_pad + j] = s * scale;
          }
        }
      }
    }
    __threadfence();
    grid.sync();

    // ---- S3: per (head, chunk): running max, p, sum(p), sum(p * v) ------
    for (int item = blockIdx.x; item < H * nch; item += gridDim.x) {
      const int hh = item / nch, c = item % nch, c0 = c * chunk;
      const float* srow = sc + (long long)hh * cap_pad;
      float mx = NEG;
      for (int j = tid; j < c0 + chunk; j += THREADS)
        mx = fmaxf(mx, __ldcg(srow + j));
      mx = mt_block_max(mx, red, NEG);
      const float mc = fmaxf(__ldcg(s0 + hh), mx);
      float ls = 0.f;
      for (int j = tid; j < chunk; j += THREADS) {
        const float p = expf(__ldcg(srow + c0 + j) - mc);
        ps[j] = p;
        ls += p;
      }
      ls = mt_block_sum(ls, red);   // also the barrier after ps
      const int ng = THREADS / hd, d = tid % hd, g = tid / hd;
      const T* vl = vc + ((long long)l * cap_pad + c0) * dd + hh * hd + d;
      float acc = 0.f;
      for (int j = g; j < chunk; j += ng) {
        const float p = ps[j];
        if (p != 0.f)
          acc += mt_bf16_round(mt_bf16_round(p) *
                               ring_value(vl[(long long)j * dd]));
      }
      red2[tid] = acc;
      __syncthreads();
      if (tid < hd) {
        float s = 0.f;
        for (int gg = 0; gg < ng; ++gg) s += red2[gg * hd + tid];
        pvpart[(long long)c * dd + hh * hd + tid] = s;
      }
      if (tid == 0) {
        mpart[hh * nch + c] = mc;
        lpart[hh * nch + c] = ls;
      }
      __syncthreads();
    }
    __threadfence();
    grid.sync();

    // ---- S4: fold the chunks into attn; out_proj --------------------------
    for (int i = tid; i < dd; i += THREADS) {
      const int hh = i / hd;
      float m = __ldcg(s0 + hh), ls = 1.f, acc = __ldcg(qkv + 2 * dd + i);
      for (int c = 0; c < nch; ++c) {
        const float mc = __ldcg(mpart + hh * nch + c);
        const float corr = expf(m - mc);
        ls = __fadd_rn(__fmul_rn(ls, corr), __ldcg(lpart + hh * nch + c));
        acc = __fadd_rn(__fmul_rn(acc, corr),
                        __ldcg(pvpart + (long long)c * dd + i));
        m = mc;
      }
      as[i] = acc / ls;
    }
    __syncthreads();
    dq::stage_rows<FMT_Q4K>(as, 0, nullptr, 0, 0, 1, dd, xb, bsum, red);
    for (int o = gwarp; o < dd; o += gwarps) {
      const float v = dq::row_dot1<FMT_Q4K>(a.out, lrow * dd + o, dd, xb, bsum);
      if (lane == 0) ov[o] = v;
    }
    __threadfence();
    grid.sync();

    // ---- S5: residual, rms2, GLU ---------------------------------------
    for (int i = tid; i < dd; i += THREADS) hs[i] = hs[i] + __ldcg(ov + i);
    __syncthreads();
    dq::stage_rows<FMT_Q4K>(hs, 0, dq::row_of(a.n2, a.n2_bf16, l, dd),
                            a.n2_bf16, 0, 1, dd, xb, bsum, red);
    for (int o = gwarp; o < hidden; o += gwarps) {
      const long long g0 = lrow * 2 * hidden;
      const float gt = dq::row_dot1<FMT_Q4K>(a.glu, g0 + o, dd, xb, bsum);
      const float vl =
          dq::row_dot1<FMT_Q4K>(a.glu, g0 + hidden + o, dd, xb, bsum);
      if (lane == 0)
        hv[o] = __fmul_rn(__fmul_rn(gt, 1.f / (1.f + expf(-gt))), vl);
    }
    __threadfence();
    grid.sync();

    // ---- S6: linear_out, residual --------------------------------------
    dq::stage_row_l2(hv, hidden, xb, bsum);
    for (int o = gwarp; o < dd; o += gwarps) {
      const float v =
          dq::row_dot1<FMT_Q4K>(a.lout, lrow * dd + o, hidden, xb, bsum);
      if (lane == 0) ov[o] = v;
    }
    __threadfence();
    grid.sync();
    for (int i = tid; i < dd; i += THREADS) hs[i] = hs[i] + __ldcg(ov + i);
    __syncthreads();
  }
  if (blockIdx.x == 0)
    for (int i = tid; i < dd; i += THREADS) a.h_out[i] = hs[i];
}

size_t smem_bytes(int dd, int hidden, int chunk) {
  const int kmax = hidden > dd ? hidden : dd;
  return (size_t)(2 * dd + chunk + THREADS) * sizeof(float) +
         dq::xb_bytes(1, kmax) + (size_t)(kmax / QK) * sizeof(float);
}

}  // namespace

MT_ERROR_STRING_FN

// h [dd] (f32 or bf16); kc/vc [L, cap_pad, dd] bf16, or float8_e4m3fn
// with fp8 set (read only); offset [1] int32 on the device; cos/sin
// [hd/2] f32; the four stacked q4_k weights as (q, es, em); n1/n2 [L, dd];
// h_out [dd] f32, k_new/v_new [L, dd] in the rings' type; scratch f32 of
// 3dd + H*cap_pad + H + 2*H*nch + nch*dd + dd + hidden; scale = hd^-0.5.
// Returns the launch's CUDA error.
extern "C" int mt_temporal_full_step(
    const void* h, int h_bf16, const void* kc, const void* vc,
    const void* offset, const void* cos, const void* sin, const void* qkv_q,
    const void* qkv_es, const void* qkv_em, const void* out_q,
    const void* out_es, const void* out_em, const void* glu_q,
    const void* glu_es, const void* glu_em, const void* lo_q,
    const void* lo_es, const void* lo_em, const void* n1, int n1_bf16,
    const void* n2, int n2_bf16, void* h_out, void* k_new, void* v_new,
    void* scratch, int dd, int heads, int hidden, int cap, int cap_pad,
    int context, int chunk, int nlayers, float scale, int fp8_rings,
    void* stream) {
  Args a;
  a.h = h;
  a.h_bf16 = h_bf16;
  a.kc = kc;
  a.vc = vc;
  a.offset = static_cast<const int*>(offset);
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  auto w = [](const void* q, const void* es, const void* em) {
    return dq::Weight{static_cast<const uint8_t*>(q),
                      static_cast<const bf16*>(es),
                      static_cast<const bf16*>(em)};
  };
  a.qkv = w(qkv_q, qkv_es, qkv_em);
  a.out = w(out_q, out_es, out_em);
  a.glu = w(glu_q, glu_es, glu_em);
  a.lout = w(lo_q, lo_es, lo_em);
  a.n1 = n1;
  a.n1_bf16 = n1_bf16;
  a.n2 = n2;
  a.n2_bf16 = n2_bf16;
  a.h_out = static_cast<float*>(h_out);
  a.k_new = k_new;
  a.v_new = v_new;
  a.scratch = static_cast<float*>(scratch);
  a.dd = dd;
  a.heads = heads;
  a.hidden = hidden;
  a.cap = cap;
  a.cap_pad = cap_pad;
  a.context = context;
  a.chunk = chunk;
  a.nlayers = nlayers;
  a.scale = scale;
  if (dd % 256 || hidden % QK || chunk > 1024 ||
      cap_pad % chunk || (THREADS % (dd / heads)) || (dd / heads) % 16)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* fn =
      fp8_rings ? reinterpret_cast<const void*>(&temporal_kernel<fp8>)
                : reinterpret_cast<const void*>(&temporal_kernel<bf16>);
  const size_t smem = smem_bytes(dd, hidden, chunk);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(per_sm * sms), dim3(THREADS),
                                    args, smem, st);
  if (err == cudaSuccess) err = cudaGetLastError();
  return err;
}
