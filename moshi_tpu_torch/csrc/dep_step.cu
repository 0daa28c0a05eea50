// K14: the depformer megakernels (q4_k, B = 1), one layer body for two
// entries.
//
// mt_dep_full_step replaces moshi_tpu/nn/pallas_depformer.py dep_full_step
// (kernel body _dep_step_kernel; dep_layer_step, _dep_layer_kernel, is the
// same arithmetic at one layer): every layer of one depformer step in one
// cooperative launch.  mt_dep_frame_step replaces dep_frame_step
// (_dep_frame_kernel): all dep_q steps of a frame in one launch, each
// step's token embedding, layers, q4_k logits and sampling, the token fed
// to the next step's embedding on the card.
//
// One layer (_dep_step_kernel / _dep_layer_body), the hidden state h in
// f32, the products the dequant arithmetic of dequant_dot.cuh (q4_k:
// bf16(xn) . bf16(q * es) - xs . em; a q4_0 linear_out: bf16((q - 8) * d)):
//
//   xn = rms_norm(h) * n1[l];  q, k, v = W_qkv . xn
//   ring[cb] = bf16(k), bf16(v)                  (where cb < cap)
//   s_j = hd^-0.5 * sum_head bf16(k_j) * bf16(q), j <= cb, products exact
//   p = exp(s - max) / sum;  attn = sum_j bf16(p_j) * v_j, products exact
//   h2 = h + W_out . attn
//   hv = silu(W_g . xn2) * (W_v . xn2),  xn2 = rms_norm(h2) * n2[l]
//   h  = h2 + W_lout . hv
//
// The ring is read after the write, so the current row enters in bf16;
// here it is taken from the f32 projection, rounded (the same value),
// while block 0 writes it.  Slots j > cb are masked in the reference and
// weigh exactly 0, so they are not read.
//
// The frame: step s adds to h_in[s] the text embedding (s = 0) or the
// low-rank embedding of the previous token, emb[s][prev] . lr_w[s]^T in
// f32; after the layers, logits = the q4_k dequant product of the step's
// linear (not K1's int8 arithmetic); block 0 samples: at temp 0 the
// first-index argmax, else scaled = logits * (1/temp), the k-th largest
// by 30 bisection steps on [min, max] (keep mid where count(v >= mid) >=
// k), then the first-index argmax of scaled + noise over scaled >= thr
// (-1e9 elsewhere).
//
// The Pallas grids ran in order on one core, the rings in VMEM.  Here
// every stage that needs all of the previous one's output is behind a
// grid sync of one cooperative launch; every block keeps h in shared
// memory (all update it identically) and computes the tiny attention (at
// most 64 ring slots) itself; the projections and logits are one warp per
// row.  Per layer 4 grid syncs; per frame step 2 more (the embedding, the
// sampled token).
//
// Bound on the H100: bytes (the depformer's weights, 13 MB per step at
// the 7B); at one row the grid syncs, not the bytes, set the time.
// Simple first: no tensor cores, no TMA.
#include <cooperative_groups.h>

#include "dequant_dot.cuh"

namespace cg = cooperative_groups;

namespace {

using dq::FMT_Q40;
using dq::FMT_Q4K;
using dq::QK;

constexpr int THREADS = 256;
constexpr int MAXCAP = 64;
constexpr float NEG = -1e9f;

struct Args {
  // layer weights (stacked; a layer is addressed by its flat index)
  dq::Weight qkv, out, glu, lout, lin;
  const void* n1;
  int n1_bf16;
  const void* n2;
  int n2_bf16;
  bf16* kr;          // rings [L, cap, dd]
  bf16* vr;
  float* scratch;
  int dd, heads, hidden, cap, nlayers;
  float scale;       // hd^-0.5
  // the step form
  const void* h;
  int h_bf16;
  int cb;
  float* h_out;
  // the frame form
  const float* h_in;       // [dep_q, dd]
  const void* text_emb;
  int text_bf16;
  const void* emb;         // [dep_q, card + 1, lr]
  int emb_bf16;
  const void* lr_w;        // [dep_q, dd, lr]
  int lr_bf16;
  const float* noise;      // [dep_q, card]
  int* tokens;             // [dep_q]
  float* logits_out;       // [dep_q, card] or null
  int dep_q, card, lr, topk;   // topk 0: greedy
  float inv_temp;
};

struct Smem {
  float* hs;     // h [dd]
  float* as;     // q (bf16 values), then attn [dd]
  float* sp;     // scores / p [heads, MAXCAP]
  bf16* xb;      // staged row [kmax]
  float* bsum;   // its 32-block sums
  float* red;    // [32]
};

// One depformer layer on s.hs: weights of flat layer wl, norms of layer l,
// the layer's rings kr/vr [cap, dd], step cb.
template <int LF>
__device__ void dep_layer(const Args& a, cg::grid_group& grid, const Smem& s,
                          int l, long long wl, int cb, bf16* kr, bf16* vr) {
  const int dd = a.dd, H = a.heads, hd = dd / H, hidden = a.hidden;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = THREADS / 32;
  const int gwarp = blockIdx.x * nwarps + warp, gwarps = gridDim.x * nwarps;
  float* qkv = a.scratch;          // [3dd]
  float* ov = qkv + 3 * dd;        // [dd]
  float* hv = ov + dd;             // [hidden]

  // qkv with the fused rms norm1
  dq::stage_rows<FMT_Q4K>(s.hs, 0, dq::row_of(a.n1, a.n1_bf16, l, dd),
                          a.n1_bf16, 0, 1, dd, s.xb, s.bsum, s.red);
  for (int o = gwarp; o < 3 * dd; o += gwarps) {
    const float v =
        dq::row_dot1<FMT_Q4K>(a.qkv, wl * 3 * dd + o, dd, s.xb, s.bsum);
    if (lane == 0) qkv[o] = v;
  }
  __threadfence();
  grid.sync();

  // ring write (block 0) and the attention (every block, over j <= cb)
  const bool write = cb < a.cap;
  if (write && blockIdx.x == 0)
    for (int i = tid; i < dd; i += THREADS) {
      kr[(long long)cb * dd + i] = __float2bfloat16_rn(__ldcg(qkv + dd + i));
      vr[(long long)cb * dd + i] =
          __float2bfloat16_rn(__ldcg(qkv + 2 * dd + i));
    }
  const int nv = cb + 1 < a.cap ? cb + 1 : a.cap;
  for (int i = tid; i < dd; i += THREADS)
    s.as[i] = mt_bf16_round(__ldcg(qkv + i));
  __syncthreads();
  for (int pair = warp; pair < H * nv; pair += nwarps) {
    const int hh = pair / nv, j = pair % nv;
    float acc = 0.f;
    for (int e = lane; e < hd; e += 32) {
      const int i = hh * hd + e;
      const float kv =
          (write && j == cb)
              ? mt_bf16_round(__ldcg(qkv + dd + i))
              : __bfloat162float(__ldcg(kr + (long long)j * dd + i));
      acc += kv * s.as[i];
    }
    acc = mt_warp_sum(acc);
    if (lane == 0) s.sp[hh * MAXCAP + j] = acc * a.scale;
  }
  __syncthreads();
  if (tid < H) {
    float* row = s.sp + tid * MAXCAP;
    float m = row[0];
    for (int j = 1; j < nv; ++j) m = fmaxf(m, row[j]);
    float sum = 0.f;
    for (int j = 0; j < nv; ++j) {
      row[j] = expf(row[j] - m);
      sum += row[j];
    }
    for (int j = 0; j < nv; ++j) row[j] = mt_bf16_round(row[j] / sum);
  }
  __syncthreads();
  for (int i = tid; i < dd; i += THREADS) {
    const float* p = s.sp + (i / hd) * MAXCAP;
    float acc = 0.f;
    for (int j = 0; j < nv; ++j) {
      const float vv =
          (write && j == cb)
              ? mt_bf16_round(__ldcg(qkv + 2 * dd + i))
              : __bfloat162float(__ldcg(vr + (long long)j * dd + i));
      acc += p[j] * vv;
    }
    s.as[i] = acc;
  }
  __syncthreads();

  // out_proj, then the residual
  dq::stage_rows<FMT_Q4K>(s.as, 0, nullptr, 0, 0, 1, dd, s.xb, s.bsum, s.red);
  for (int o = gwarp; o < dd; o += gwarps) {
    const float v = dq::row_dot1<FMT_Q4K>(a.out, wl * dd + o, dd, s.xb, s.bsum);
    if (lane == 0) ov[o] = v;
  }
  __threadfence();
  grid.sync();
  for (int i = tid; i < dd; i += THREADS) s.hs[i] = s.hs[i] + __ldcg(ov + i);
  __syncthreads();

  // GLU with the fused rms norm2
  dq::stage_rows<FMT_Q4K>(s.hs, 0, dq::row_of(a.n2, a.n2_bf16, l, dd),
                          a.n2_bf16, 0, 1, dd, s.xb, s.bsum, s.red);
  for (int o = gwarp; o < hidden; o += gwarps) {
    const long long g0 = wl * 2 * hidden;
    const float gt = dq::row_dot1<FMT_Q4K>(a.glu, g0 + o, dd, s.xb, s.bsum);
    const float vl =
        dq::row_dot1<FMT_Q4K>(a.glu, g0 + hidden + o, dd, s.xb, s.bsum);
    if (lane == 0)
      hv[o] = __fmul_rn(__fmul_rn(gt, 1.f / (1.f + expf(-gt))), vl);
  }
  __threadfence();
  grid.sync();

  // linear_out, then the residual
  dq::stage_row_l2(hv, hidden, s.xb, s.bsum);
  for (int o = gwarp; o < dd; o += gwarps) {
    const float v = dq::row_dot1<LF>(a.lout, wl * dd + o, hidden, s.xb, s.bsum);
    if (lane == 0) ov[o] = v;
  }
  __threadfence();
  grid.sync();
  for (int i = tid; i < dd; i += THREADS) s.hs[i] = s.hs[i] + __ldcg(ov + i);
  __syncthreads();
}

__device__ Smem carve(unsigned char* smem, float* red, int dd, int hidden) {
  const int kmax = hidden > dd ? hidden : dd;
  Smem s;
  s.hs = reinterpret_cast<float*>(smem);
  s.as = s.hs + dd;
  s.sp = s.as + dd;
  s.xb = reinterpret_cast<bf16*>(s.sp + 32 * MAXCAP);
  s.bsum = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(s.xb) +
                                    dq::xb_bytes(1, kmax));
  s.red = red;
  return s;
}

template <int LF>
__global__ void __launch_bounds__(THREADS) dep_step_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[32];
  cg::grid_group grid = cg::this_grid();
  const Smem s = carve(smem, red, a.dd, a.hidden);
  for (int i = threadIdx.x; i < a.dd; i += THREADS)
    s.hs[i] = mt_load(a.h, i, a.h_bf16);
  __syncthreads();
  for (int l = 0; l < a.nlayers; ++l)
    dep_layer<LF>(a, grid, s, l, l, a.cb, a.kr + (long long)l * a.cap * a.dd,
                  a.vr + (long long)l * a.cap * a.dd);
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < a.dd; i += THREADS) a.h_out[i] = s.hs[i];
}

// Block 0's sampler over logits [card] (global, read through L2); returns
// the token to every thread of the block.
__device__ int sample(const Args& a, const float* logits, const float* noise,
                      float* red, int* redi) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int card = a.card;
  const bool greedy = a.topk == 0;
  float lo = 0.f, hi = 0.f, thr = 0.f;
  if (!greedy) {
    float mn = 3.4e38f, mx = -3.4e38f;
    for (int i = tid; i < card; i += THREADS) {
      const float v = __fmul_rn(__ldcg(logits + i), a.inv_temp);
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
    }
    mx = mt_block_max(mx, red, -3.4e38f);
    mn = -mt_block_max(-mn, red, -3.4e38f);
    lo = mn;
    hi = mx;
    for (int it = 0; it < 30; ++it) {
      const float mid = 0.5f * (lo + hi);
      int cnt = 0;
      for (int i = tid; i < card; i += THREADS)
        cnt += __fmul_rn(__ldcg(logits + i), a.inv_temp) >= mid;
      cnt = mt_warp_sum_i(cnt);
      if (lane == 0) redi[warp] = cnt;
      __syncthreads();
      cnt = 0;
      for (int w = 0; w < THREADS / 32; ++w) cnt += redi[w];
      __syncthreads();
      if (cnt >= a.topk) lo = mid; else hi = mid;
    }
    thr = lo;
  }
  // first-index argmax
  float best = -3.4e38f;
  int bi = 1 << 30;
  for (int i = tid; i < card; i += THREADS) {
    float v = __ldcg(logits + i);
    if (!greedy) {
      const float sv = __fmul_rn(v, a.inv_temp);
      v = sv >= thr ? __fadd_rn(sv, noise[i]) : NEG;
    }
    if (v > best) {  // i rises, so the first index of a tie stays
      best = v;
      bi = i;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(MT_FULL_MASK, best, o);
    const int oi = __shfl_xor_sync(MT_FULL_MASK, bi, o);
    if (ov > best || (ov == best && oi < bi)) {
      best = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    red[warp] = best;
    redi[warp] = bi;
  }
  __syncthreads();
  best = red[0];
  bi = redi[0];
  for (int w = 1; w < THREADS / 32; ++w)
    if (red[w] > best || (red[w] == best && redi[w] < bi)) {
      best = red[w];
      bi = redi[w];
    }
  __syncthreads();
  return bi;
}

template <int LF>
__global__ void __launch_bounds__(THREADS) dep_frame_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[32];
  __shared__ int redi[32];
  cg::grid_group grid = cg::this_grid();
  const Smem s = carve(smem, red, a.dd, a.hidden);
  const int dd = a.dd, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = THREADS / 32;
  const int gwarp = blockIdx.x * nwarps + warp, gwarps = gridDim.x * nwarps;
  float* h0 = a.scratch + 4 * dd + a.hidden;        // [dd]
  float* logits = h0 + dd;                          // [card]
  int* prev = reinterpret_cast<int*>(logits + a.card);
  const long long ring = (long long)a.cap * dd;

  for (int st = 0; st < a.dep_q; ++st) {
    // the step's input: h_in + the token embedding
    if (st == 0) {
      for (int i = tid; i < dd; i += THREADS)
        s.hs[i] = a.h_in[i] + mt_load(a.text_emb, i, a.text_bf16);
    } else {
      const int tok = __ldcg(prev);
      const long long erow = ((long long)st * (a.card + 1) + tok) * a.lr;
      for (int o = gwarp; o < dd; o += gwarps) {
        const long long wrow = ((long long)st * dd + o) * a.lr;
        float acc = 0.f;
        for (int t = lane; t < a.lr; t += 32)
          acc += mt_load(a.emb, erow + t, a.emb_bf16) *
                 mt_load(a.lr_w, wrow + t, a.lr_bf16);
        acc = mt_warp_sum(acc);
        if (lane == 0) h0[o] = a.h_in[(long long)st * dd + o] + acc;
      }
      __threadfence();
      grid.sync();
      for (int i = tid; i < dd; i += THREADS) s.hs[i] = __ldcg(h0 + i);
    }
    __syncthreads();
    for (int l = 0; l < a.nlayers; ++l)
      dep_layer<LF>(a, grid, s, l, (long long)st * a.nlayers + l, st,
                    a.kr + l * ring, a.vr + l * ring);
    // the logits
    dq::stage_rows<FMT_Q4K>(s.hs, 0, nullptr, 0, 0, 1, dd, s.xb, s.bsum,
                            s.red);
    for (int o = gwarp; o < a.card; o += gwarps) {
      const float v = dq::row_dot1<FMT_Q4K>(
          a.lin, (long long)st * a.card + o, dd, s.xb, s.bsum);
      if (lane == 0) {
        logits[o] = v;
        if (a.logits_out) a.logits_out[(long long)st * a.card + o] = v;
      }
    }
    __threadfence();
    grid.sync();
    if (blockIdx.x == 0) {
      const int tok = sample(a, logits, a.noise + (long long)st * a.card,
                             red, redi);
      if (tid == 0) {
        a.tokens[st] = tok;
        *prev = tok;
      }
      __threadfence();
    }
    grid.sync();
  }
}

size_t smem_bytes(int dd, int hidden) {
  const int kmax = hidden > dd ? hidden : dd;
  return (size_t)(2 * dd + 32 * MAXCAP) * sizeof(float) +
         dq::xb_bytes(1, kmax) + (size_t)(kmax / QK) * sizeof(float);
}

cudaError_t launch(const void* fn, Args& a, cudaStream_t st, int rows) {
  const size_t smem = smem_bytes(a.dd, a.hidden);
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
  const int warps = THREADS / 32;
  int blocks = (rows + warps - 1) / warps;
  if (blocks > per_sm * sms) blocks = per_sm * sms;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(THREADS), args,
                                    smem, st);
  if (err == cudaSuccess) err = cudaGetLastError();
  return err;
}

bool dims_ok(int dd, int heads, int hidden, int cap) {
  return dd % 256 == 0 && heads >= 1 && heads <= 32 && dd % heads == 0 &&
         hidden % 64 == 0 && cap >= 1 && cap <= MAXCAP;
}

dq::Weight qw(const void* q, const void* s1, const void* s2) {
  return dq::Weight{static_cast<const uint8_t*>(q),
                    static_cast<const bf16*>(s1),
                    static_cast<const bf16*>(s2)};
}

}  // namespace

MT_ERROR_STRING_FN

// One depformer step, every layer: h [dd] (f32 or bf16); rings kr/vr
// [L, cap, dd] bf16, written in place at row cb (where cb < cap); the
// stacked [L, ...] weights qkv/out/glu (q4_k: q, es, em) and lout (q4_k,
// or q4_0 with s2 null: lfmt 0 or 1); n1/n2 [L, dd]; h_out [dd] f32;
// scratch f32 of 4dd + hidden.  Returns the launch's CUDA error.
extern "C" int mt_dep_full_step(
    const void* h, int h_bf16, void* kr, void* vr, int cb, const void* qq,
    const void* qs1, const void* qs2, const void* oq, const void* os1,
    const void* os2, const void* gq, const void* gs1, const void* gs2,
    const void* lq, const void* ls1, const void* ls2, int lfmt,
    const void* n1, int n1_bf16, const void* n2, int n2_bf16, void* h_out,
    void* scratch, int dd, int heads, int hidden, int cap, int nlayers,
    float scale, void* stream) {
  if (!dims_ok(dd, heads, hidden, cap) || cb < 0) return cudaErrorInvalidValue;
  Args a = {};
  a.qkv = qw(qq, qs1, qs2);
  a.out = qw(oq, os1, os2);
  a.glu = qw(gq, gs1, gs2);
  a.lout = qw(lq, ls1, ls2);
  a.n1 = n1;
  a.n1_bf16 = n1_bf16;
  a.n2 = n2;
  a.n2_bf16 = n2_bf16;
  a.kr = static_cast<bf16*>(kr);
  a.vr = static_cast<bf16*>(vr);
  a.scratch = static_cast<float*>(scratch);
  a.dd = dd;
  a.heads = heads;
  a.hidden = hidden;
  a.cap = cap;
  a.nlayers = nlayers;
  a.scale = scale;
  a.h = h;
  a.h_bf16 = h_bf16;
  a.cb = cb;
  a.h_out = static_cast<float*>(h_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = hidden > 3 * dd ? hidden : 3 * dd;
  switch (lfmt) {
    case 0:
      return launch(reinterpret_cast<const void*>(&dep_step_kernel<FMT_Q4K>),
                    a, st, rows);
    case 1:
      return launch(reinterpret_cast<const void*>(&dep_step_kernel<FMT_Q40>),
                    a, st, rows);
    default: return cudaErrorInvalidValue;
  }
}

// One depformer frame, all dep_q steps: h_in [dep_q, dd] f32; text_emb
// [dd]; emb [dep_q, card + 1, lr] (row 0 unused) and lr_w [dep_q, dd, lr]
// (f32 or bf16); the per-step stacked [dep_q, L, ...] layer weights as in
// mt_dep_full_step and the q4_k linears [dep_q, card, dd]; noise
// [dep_q, card] f32; tokens [dep_q] int32 out, and each step's logits
// into logits_out [dep_q, card] f32 where it is not null (a check's
// view of the sampler's input); rings bf16 [2, L, cap, dd]
// and scratch f32 of 5dd + hidden + card + 1, both scratch; topk the
// number of values kept (0: greedy); inv_temp = 1 / temp.
extern "C" int mt_dep_frame_step(
    const void* h_in, const void* text_emb, int text_bf16, const void* emb,
    int emb_bf16, const void* lr_w, int lr_bf16, const void* qq,
    const void* qs1, const void* qs2, const void* oq, const void* os1,
    const void* os2, const void* gq, const void* gs1, const void* gs2,
    const void* lq, const void* ls1, const void* ls2, const void* nq,
    const void* ns1, const void* ns2, int lfmt, const void* n1, int n1_bf16,
    const void* n2, int n2_bf16, const void* noise, void* tokens,
    void* logits_out, void* rings, void* scratch, int dd, int heads,
    int hidden, int cap, int nlayers, int dep_q, int card, int lr,
    int topk, float scale, float inv_temp, void* stream) {
  if (!dims_ok(dd, heads, hidden, cap) || cap < dep_q || card % 32 ||
      lr < 1 || topk < 0)
    return cudaErrorInvalidValue;
  Args a = {};
  a.qkv = qw(qq, qs1, qs2);
  a.out = qw(oq, os1, os2);
  a.glu = qw(gq, gs1, gs2);
  a.lout = qw(lq, ls1, ls2);
  a.lin = qw(nq, ns1, ns2);
  a.n1 = n1;
  a.n1_bf16 = n1_bf16;
  a.n2 = n2;
  a.n2_bf16 = n2_bf16;
  a.kr = static_cast<bf16*>(rings);
  a.vr = a.kr + (long long)nlayers * cap * dd;
  a.scratch = static_cast<float*>(scratch);
  a.dd = dd;
  a.heads = heads;
  a.hidden = hidden;
  a.cap = cap;
  a.nlayers = nlayers;
  a.scale = scale;
  a.h_in = static_cast<const float*>(h_in);
  a.text_emb = text_emb;
  a.text_bf16 = text_bf16;
  a.emb = emb;
  a.emb_bf16 = emb_bf16;
  a.lr_w = lr_w;
  a.lr_bf16 = lr_bf16;
  a.noise = static_cast<const float*>(noise);
  a.tokens = static_cast<int*>(tokens);
  a.logits_out = static_cast<float*>(logits_out);
  a.dep_q = dep_q;
  a.card = card;
  a.lr = lr;
  a.topk = topk;
  a.inv_temp = inv_temp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rows = hidden > 3 * dd ? hidden : 3 * dd;
  if (card > rows) rows = card;
  switch (lfmt) {
    case 0:
      return launch(reinterpret_cast<const void*>(&dep_frame_kernel<FMT_Q4K>),
                    a, st, rows);
    case 1:
      return launch(reinterpret_cast<const void*>(&dep_frame_kernel<FMT_Q40>),
                    a, st, rows);
    default: return cudaErrorInvalidValue;
  }
}
