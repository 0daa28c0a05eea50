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
// Every product is the dequant arithmetic of dequant_tile.cuh (the Pallas
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
// softmax parts, attn) goes through global scratch, read back through L2
// (__ldcg).  Per layer:
//   S1 rms1 and the qkv rows (R_QKV rows a warp)           grid sync
//   S2 rope; the seed s0 and k_new/v_new (one warp per head); one warp
//      per ring slot scores every head                      grid sync
//   S3 one block per (head, chunk): its running max (the seed and the
//      maxima of the chunks up to it), p, sum(p), sum(bf16(p) * v); the
//      last of a head's blocks to arrive folds the head's chunks in
//      order (corr, l, acc) into attn                       grid sync
//   S4 the out_proj rows of attn (R_OUT a warp)             grid sync
//   S5 the residual, rms2, the GLU row pairs (R_GLU / 2)    grid sync
//   S6 linear_out rows (R_LOUT a warp)                      grid sync,
//      then the residual.
// Folding the chunks from per-chunk maxima gives the same m_new, corr and
// p as the sequential walk: m_new of chunk c is the maximum of the seed
// and of the chunks up to c.
//
// The rings are bf16 or float8_e4m3fn (a template parameter, as in
// decode_attention.cu).  The Pallas kernel widens each fp8 ring chunk to
// bf16 (exact) before the same arithmetic, and writes its k/v rows cast
// to the rings' dtype (XLA's convert: NaN past 464).  Here a 16-byte load
// of an fp8 ring row holds 16 values, widened by value
// (RingElem<fp8>::widen), and each lane keeps the two 8-value partial
// sums a bf16 lane pair would, reduced over the same tree, so the scores,
// and h, equal the bf16 instance's on the rings widened; the rows are
// written by mt_fp8_e4m3, that rule.
//
// What bounds it on the H100, and the design (PERF.md has the stage split
// before and after, from temporal_ab.py --stages):
// - The products (3.6 GB of q4_k weights a frame at the 7B) take
//   dequant_tile.cuh's warp tile (stage_row, warp_rows): each block
//   stages the stage's activation row once in the tile layout, its bf16
//   values in f32, so that a lane reads its four columns of a word in one
//   conflict-free LDS.128 (the first form read each as a scalar bf16,
//   lanes 32 bytes apart: 8-way bank conflicts, which held the products
//   near 0.44 TB/s); each staged word serves R weight rows, a 4-bit
//   weight pair is dequantized in one bf16x2 multiply, and q4_k's em
//   scales load with each step's weights.  Every output's f32 sums keep
//   the order dequant_tile.cuh's header states, bit for bit.  What bounds
//   them now is the arithmetic that keeps that order (unpacking bf16
//   pairs, one f32 add chain a row) in the 16 warps an SM holds at 128
//   registers a thread: deeper prefetch, of registers or through a
//   shared-memory ring, did not help.
// - The fold, which every block once repeated for all dim columns from
//   L2 (about 2.7 ms a frame), runs once per head, in the last of its
//   chunks' blocks to arrive (an arrival counter per head, zeroed at the
//   start and by each fold).
// - Wherever a thread reads values that other blocks wrote (the
//   projections for rope, the residual, the fold's chunk parts, attn and
//   the GLU's output for staging, a slot's k row), it issues a batch of
//   loads before it uses any; S3 brings a chunk's v rows into shared
//   memory by cp.async, a piece ahead, and skips a chunk whose sum p is 0.
// - Six grid syncs a layer: 192 syncs of this grid alone take 0.3 ms,
//   under a tenth of the step (PERF.md), so none is cut.
#include <cooperative_groups.h>

#include <type_traits>

#include "dequant_tile.cuh"
#include "fp8.cuh"

namespace cg = cooperative_groups;

namespace {

using dq::FMT_Q4K;
using dq::QK;

constexpr int THREADS = dqt::THREADS;
constexpr float NEG = -1e9f;

// Tuning, each chosen on the card at the 7B: the weight rows per warp of
// each product stage (qkv 3 dim rows, out_proj dim, the GLU's hidden gate
// and value pairs, linear_out dim rows at K = hidden), the blocks each SM
// must hold at once (the register budget's divisor: 3 spilled), and the
// loads a thread keeps in flight where it reads a row from L2 (ROW_U),
// folds a head's chunks (FOLD_U chunks' parts at once) or scores a ring
// slot (KEY_U blocks of its k row, 16 bytes a lane).  Fewer registers won
// over more rows or loads in flight at every stage.
constexpr int R_QKV = 2;
constexpr int R_OUT = 2;
constexpr int R_GLU = 2;
constexpr int R_LOUT = 2;
constexpr int MIN_BLOCKS = 2;
constexpr int ROW_U = 8;
constexpr int FOLD_U = 4;
constexpr int KEY_U = 4;

// Floats of h, q, p and the reduction slots at the start of the
// dynamic shared memory, rounded up to 4 so that the staged row behind
// them is 16-byte aligned.
__host__ __device__ inline int head_floats(int dd, int chunk) {
  return (2 * dd + chunk + THREADS + 3) / 4 * 4;
}

// Bytes of the staged activation row (its bf16 values in f32, in the
// tile layout, for the wider of K = dim and K = hidden).
__host__ __device__ inline size_t staged_bytes(int dd, int hidden) {
  const int rd = dqt::row_stride(FMT_Q4K, dd);
  const int rh = dqt::row_stride(FMT_Q4K, hidden);
  return (size_t)(rd > rh ? rd : rh) * sizeof(float);
}

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

// x*cos + pairswap(x)*sin_m at lane i, given x[i] and its pair partner
// sw; no fused multiply-add, as the reference multiplies and adds apart.
__device__ __forceinline__ float rope_at(float x, float sw, int i, int hd,
                                         const float* cs, const float* sn) {
  const int p = (i % hd) >> 1;
  const float sm = (i & 1) == 0 ? -sn[p] : sn[p];
  return __fadd_rn(__fmul_rn(x, cs[p]), __fmul_rn(sw, sm));
}

// The pair partner of lane i of a head-major row.
__device__ __forceinline__ int pair_of(int i) {
  return (i & 1) == 0 ? i + 1 : i - 1;
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
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    temporal_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[32];
  __shared__ bool last_block;
  cg::grid_group grid = cg::this_grid();
  const int dd = a.dd, H = a.heads, hd = dd / H, hidden = a.hidden;
  const int cap = a.cap, cap_pad = a.cap_pad, chunk = a.chunk;
  const int nch = cap_pad / chunk;
  float* hs = reinterpret_cast<float*>(smem);            // h [dd]
  float* as = hs + dd;                                   // rope'd q [dd]
  float* ps = as + dd;                                   // p [chunk]
  float* red2 = ps + chunk;                              // [THREADS]
  float* xs = hs + head_floats(dd, chunk);   // the staged row
  float* bsum = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(xs) + staged_bytes(dd, hidden));
  // S3's buffer of v rows (two pieces of a chunk): the staged row, which
  // no other stage uses while S3 runs
  T* vbuf = reinterpret_cast<T*>(xs);
  const int vbuf_bytes = (int)staged_bytes(dd, hidden);
  // global scratch (f32)
  float* qkv = a.scratch;                                // [3dd]
  float* sc = qkv + 3 * dd;                              // [H, cap_pad]
  float* s0 = sc + (long long)H * cap_pad;               // [H]
  float* mpart = s0 + H;                                 // [H, nch]
  float* lpart = mpart + H * nch;                        // [H, nch]
  float* pvpart = lpart + H * nch;                       // [nch, dd]
  float* ov = pvpart + (long long)nch * dd;              // [dd]
  float* hv = ov + dd;                                   // [hidden]
  float* attn = hv + hidden;                             // [dd]
  unsigned* arrived = reinterpret_cast<unsigned*>(attn + dd);  // [H]

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
  const auto from_hs = [&](int i) { return hs[i]; };
  const auto from_attn = [&](int i) { return __ldcg(attn + i); };
  const auto from_hv = [&](int i) { return __ldcg(hv + i); };
  const float* no_alpha = nullptr;
  // hs normalized by layer l's norm n (f32 or bf16) and staged
  const auto stage_norm = [&](const void* n, int n_bf16, int l) {
    if (n_bf16)
      dqt::stage_row(from_hs, static_cast<const uint16_t*>(n) +
                                  (long long)l * dd,
                     dd, xs, bsum, red);
    else
      dqt::stage_row(from_hs, static_cast<const float*>(n) +
                                  (long long)l * dd,
                     dd, xs, bsum, red);
  };
  // h += y (y [dd] written by other blocks), ROW_U loads in flight
  const auto residual = [&](const float* y) {
    for (int i0 = tid; i0 < dd; i0 += ROW_U * THREADS) {
      float v[ROW_U];
#pragma unroll
      for (int u = 0; u < ROW_U; ++u) {
        const int i = i0 + u * THREADS;
        v[u] = i < dd ? __ldcg(y + i) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < ROW_U; ++u) {
        const int i = i0 + u * THREADS;
        if (i < dd) hs[i] = hs[i] + v[u];
      }
    }
  };

  for (int i = tid; i < dd; i += THREADS) hs[i] = mt_load(a.h, i, a.h_bf16);
  if (blockIdx.x == 0)   // S3's arrival counters; each layer leaves them 0
    for (int i = tid; i < H; i += THREADS) arrived[i] = 0;
  __syncthreads();

  for (int l = 0; l < a.nlayers; ++l) {
    const long long lrow = l;
    // ---- S1: rms1 and the qkv rows -------------------------------------
    dqt::warp_rows<R_QKV, false>(
        a.qkv, lrow * 3 * dd, 3 * dd, dd, xs, bsum, gwarp, gwarps,
        [&] { stage_norm(a.n1, a.n1_bf16, l); },
        [&](int o, float v, float) { qkv[o] = v; });
    __threadfence();
    grid.sync();

    // ---- S2: rope, the seed, the scores ---------------------------------
    for (int i0 = tid; i0 < dd; i0 += ROW_U * THREADS) {
      float x[ROW_U], sw[ROW_U];
#pragma unroll
      for (int u = 0; u < ROW_U; ++u) {
        const int i = i0 + u * THREADS;
        if (i < dd) {
          x[u] = __ldcg(qkv + i);
          sw[u] = __ldcg(qkv + pair_of(i));
        }
      }
#pragma unroll
      for (int u = 0; u < ROW_U; ++u) {
        const int i = i0 + u * THREADS;
        if (i < dd) as[i] = rope_at(x[u], sw[u], i, hd, a.cos, a.sin);
      }
    }
    __syncthreads();
    // k_new / v_new, and the seed: head sums of bf16(k * q), f32 product;
    // one warp per head across the grid
    for (int hh = gwarp; hh < H; hh += gwarps) {
      constexpr int E = 8;   // hd / 32 at most
      float kx[E], ksw[E], vx[E];
#pragma unroll
      for (int u = 0; u < E; ++u) {
        const int e = lane + 32 * u, i = hh * hd + e;
        if (e < hd) {
          kx[u] = __ldcg(qkv + dd + i);
          ksw[u] = __ldcg(qkv + dd + pair_of(i));
          vx[u] = __ldcg(qkv + 2 * dd + i);
        }
      }
      float s = 0.f;
#pragma unroll
      for (int u = 0; u < E; ++u) {
        const int e = lane + 32 * u, i = hh * hd + e;
        if (e < hd) {
          const float kr = rope_at(kx[u], ksw[u], i, hd, a.cos, a.sin);
          k_new[(long long)l * dd + i] = ring_cast<T>(kr);
          v_new[(long long)l * dd + i] = ring_cast<T>(vx[u]);
          s += mt_bf16_round(__fmul_rn(kr, as[i]));
        }
      }
      s = mt_warp_sum(s);
      if (lane == 0) s0[hh] = s * scale;
    }
    {
      // one warp per ring slot; its k row read in blocks of 32 x 16
      // bytes, each whole heads (lane L's 16 bytes, its products summed in
      // order, then the head's lanes by the butterfly), KEY_U blocks'
      // loads in flight at once
      const T* kl = kc + (long long)l * cap_pad * dd;
      constexpr int VPL = 16 / sizeof(T);          // values a lane
      constexpr int BLK = 32 * VPL;                // values a block
      const int lph = hd / (std::is_same_v<T, fp8> ? 16 : 8);  // lanes a head
      const int nblk = (dd + BLK - 1) / BLK;
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
        for (int k0 = 0; k0 < nblk; k0 += KEY_U) {
          uint4 raw[KEY_U];
#pragma unroll
          for (int u = 0; u < KEY_U; ++u) {
            const int base = (k0 + u) * BLK + lane * VPL;
            if (k0 + u < nblk && base < dd)
              raw[u] = *reinterpret_cast<const uint4*>(krow + base);
          }
#pragma unroll
          for (int u = 0; u < KEY_U; ++u) {
            if (k0 + u >= nblk) break;
            const int base = (k0 + u) * BLK + lane * VPL;
            const bool act = base < dd;    // whole heads leave together
            float* dst = sc + (long long)(base / hd) * cap_pad + j;
            if constexpr (std::is_same_v<T, fp8>) {
              // 16 values a lane from one 16-byte load, as two 8-value
              // partial sums: the lane pair (2t, 2t + 1) of the bf16
              // instance is one lane here, so its tree's last level is the
              // sum of the two
              float sa = 0.f, sb = 0.f;    // values [base, +8), [+8, +16)
              if (act) {
                float kv[16];
                RingElem<fp8>::widen(raw[u], kv);
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
              if (act && (lane % lph) == 0) *dst = (sa + sb) * scale;
            } else {
              const bf16* kv = reinterpret_cast<const bf16*>(&raw[u]);
              float s = 0.f;
#pragma unroll
              for (int e = 0; e < 8; ++e)
                s += mt_bf16_round(__bfloat162float(kv[e]) *
                                   mt_bf16_round(as[base + e]));
              for (int o = lph >> 1; o > 0; o >>= 1)
                s += __shfl_xor_sync(MT_FULL_MASK, s, o);
              if ((lane % lph) == 0) *dst = s * scale;
            }
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
#pragma unroll 4
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
      // thread (g, d) sums bf16(bf16(p_j) * v_j[d]) over the slots
      // j = g, g + ng, ... in order, skipping p = 0.  The chunk's v rows
      // come into shared memory a piece of psl slots at a time (cp.async,
      // the next piece in flight while this one is summed; rows with p = 0
      // are not read)
      const int ng = THREADS / hd, d = tid % hd, g = tid / hd;
      const int rowv = hd * (int)sizeof(T) / 16;   // 16-byte vectors a row
      const int psl = vbuf_bytes / 2 / (hd * (int)sizeof(T)) / ng * ng;
      const T* vrow0 = vc + ((long long)l * cap_pad + c0) * dd + hh * hd;
      // this thread's 16-byte vector of a row, and its rows of a piece
      const int k16 = (tid % rowv) * (16 / (int)sizeof(T));
      const auto fetch = [&](int j0, T* buf) {
        const int jn = min(psl, chunk - j0);
        for (int jj = tid / rowv; jj < jn; jj += THREADS / rowv)
          if (ps[j0 + jj] != 0.f)
            mt_cp_async16(buf + jj * hd + k16,
                          vrow0 + (long long)(j0 + jj) * dd + k16);
        mt_cp_async_commit();
      };
      T* vb[2] = {vbuf, vbuf + psl * hd};
      float acc = 0.f;
      // sum p = 0: every p is 0 and no slot is weighed (nothing to load)
      const int jend = ls != 0.f ? chunk : 0;
      if (jend) fetch(0, vb[0]);
      for (int j0 = 0, k = 0; j0 < jend; j0 += psl, k ^= 1) {
        if (j0 + psl < jend) {
          fetch(j0 + psl, vb[k ^ 1]);
          mt_cp_async_wait<1>();
        } else {
          mt_cp_async_wait<0>();
        }
        __syncthreads();
        const int jn = min(psl, chunk - j0);
        for (int jj = g; jj < jn; jj += ng) {
          const float p = ps[j0 + jj];
          if (p != 0.f)
            acc += mt_bf16_round(mt_bf16_round(p) *
                                 ring_value(vb[k][jj * hd + d]));
        }
        __syncthreads();   // the buffer is refilled next
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
      // the last of the head's nch blocks to arrive folds its chunks:
      // each column's walk over them in order, FOLD_U chunks' parts in
      // flight at once, into attn; and leaves the counter 0
      __threadfence();
      __syncthreads();
      if (tid == 0)
        last_block = atomicAdd(arrived + hh, 1u) == (unsigned)(nch - 1);
      __syncthreads();
      if (last_block) {
        __threadfence();
        for (int e = tid; e < hd; e += THREADS) {
          const int i = hh * hd + e;
          float m = __ldcg(s0 + hh), lsum = 1.f;
          float acc2 = __ldcg(qkv + 2 * dd + i);
          for (int cb = 0; cb < nch; cb += FOLD_U) {
            float mc2[FOLD_U], lp[FOLD_U], pv[FOLD_U];
#pragma unroll
            for (int u = 0; u < FOLD_U; ++u) {
              if (cb + u < nch) {
                mc2[u] = __ldcg(mpart + hh * nch + cb + u);
                lp[u] = __ldcg(lpart + hh * nch + cb + u);
                pv[u] = __ldcg(pvpart + (long long)(cb + u) * dd + i);
              }
            }
#pragma unroll
            for (int u = 0; u < FOLD_U; ++u) {
              if (cb + u < nch) {
                const float corr = expf(m - mc2[u]);
                lsum = __fadd_rn(__fmul_rn(lsum, corr), lp[u]);
                acc2 = __fadd_rn(__fmul_rn(acc2, corr), pv[u]);
                m = mc2[u];
              }
            }
          }
          attn[i] = acc2 / lsum;
        }
        if (tid == 0) arrived[hh] = 0;
      }
      __syncthreads();
    }
    __threadfence();
    grid.sync();

    // ---- S4: out_proj of attn ---------------------------------------------
    dqt::warp_rows<R_OUT, false>(
        a.out, lrow * dd, dd, dd, xs, bsum, gwarp, gwarps,
        [&] { dqt::stage_row(from_attn, no_alpha, dd, xs, bsum, red); },
        [&](int o, float v, float) { ov[o] = v; });
    __threadfence();
    grid.sync();

    // ---- S5: residual, rms2, GLU ---------------------------------------
    dqt::warp_rows<R_GLU, true>(
        a.glu, lrow * 2 * hidden, hidden, dd, xs, bsum, gwarp, gwarps,
        [&] {
          residual(ov);
          __syncthreads();
          stage_norm(a.n2, a.n2_bf16, l);
        },
        [&](int o, float gt, float vl) {
          hv[o] = __fmul_rn(__fmul_rn(gt, 1.f / (1.f + expf(-gt))), vl);
        });
    __threadfence();
    grid.sync();

    // ---- S6: linear_out, residual --------------------------------------
    dqt::warp_rows<R_LOUT, false>(
        a.lout, lrow * dd, dd, hidden, xs, bsum, gwarp, gwarps,
        [&] { dqt::stage_row(from_hv, no_alpha, hidden, xs, bsum, red); },
        [&](int o, float v, float) { ov[o] = v; });
    __threadfence();
    grid.sync();
    residual(ov);
    __syncthreads();
  }
  if (blockIdx.x == 0)
    for (int i = tid; i < dd; i += THREADS) a.h_out[i] = hs[i];
}

size_t smem_bytes(int dd, int hidden, int chunk) {
  const int kmax = hidden > dd ? hidden : dd;
  return (size_t)head_floats(dd, chunk) * sizeof(float) +
         staged_bytes(dd, hidden) + (size_t)(kmax / QK) * sizeof(float);
}

// The kernel instance, its dynamic shared memory and its cooperative
// grid: as many blocks as can be co-resident.
cudaError_t grid_of(int dd, int hidden, int chunk, int fp8_rings,
                    const void** fn, size_t* smem, int* blocks) {
  *fn = fp8_rings ? reinterpret_cast<const void*>(&temporal_kernel<fp8>)
                  : reinterpret_cast<const void*>(&temporal_kernel<bf16>);
  *smem = smem_bytes(dd, hidden, chunk);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, *fn, THREADS,
                                                      *smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

}  // namespace

MT_ERROR_STRING_FN

// The blocks of K13's grid at these shapes, or minus the CUDA error.
extern "C" int mt_temporal_grid_blocks(int dd, int hidden, int chunk,
                                       int fp8_rings) {
  const void* fn;
  size_t smem;
  int blocks = 0;
  const cudaError_t err = grid_of(dd, hidden, chunk, fp8_rings, &fn, &smem,
                                  &blocks);
  return err == cudaSuccess ? blocks : -(int)err;
}

// h [dd] (f32 or bf16); kc/vc [L, cap_pad, dd] bf16, or float8_e4m3fn
// with fp8 set (read only); offset [1] int32 on the device; cos/sin
// [hd/2] f32; the four stacked q4_k weights as (q, es, em); n1/n2 [L, dd];
// h_out [dd] f32, k_new/v_new [L, dd] in the rings' type; scratch f32 of
// 3dd + H*cap_pad + H + 2*H*nch + nch*dd + dd + hidden + dd + H; scale =
// hd^-0.5.
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
  const void* fn;
  size_t smem;
  int blocks = 0;
  cudaError_t err = grid_of(dd, hidden, chunk, fp8_rings, &fn, &smem,
                            &blocks);
  if (err != cudaSuccess) return err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(THREADS), args,
                                    smem, st);
  if (err == cudaSuccess) err = cudaGetLastError();
  return err;
}
