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
// f32, the products the Pallas kernels' dequant arithmetic (q4_k:
// bf16(xn) . bf16(q * es) - xs . em, xs the f32 32-block sums of xn; a
// q4_0 linear_out: bf16((q - 8) * d), no min term):
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
// grid sync of one cooperative launch: per layer 4 (qkv; the attention
// and out_proj; the GLU; linear_out), per frame step 2 more (the logits,
// the sampled token) and one for each step's embedding, 215 a frame at
// the 7B.  Every block keeps h in shared memory (all update it
// identically) and computes the tiny attention (at most 64 ring slots)
// itself.
//
// What bounds it on the H100, and the design (PERF.md has the stage split
// before and after, from depformer_ab.py --stages):
// - The bytes: 62.8 MB of weights a step at the 7B (6 layers of qkv 1.97,
//   out_proj 0.66 and the GLU 5.41 MB of q4_k, linear_out 2.43 MB of
//   q4_0), 0.019 ms at 3.35 TB/s; a frame's logits add 10.5 MB.  A stage
//   moves a few MB, under 2 µs of the card's bandwidth, but takes 7-10
//   µs: the blocks run in step, and what sets a stage's time is the chain
//   in each block of 8 warps, one latency after another (the sync, the
//   residual's loads from L2, the norm's block reductions, the staging,
//   the tiles' loads and arithmetic, the outputs' stores).
// - The products take dequant_tile.cuh's warp tile (stage_row, warp_rows;
//   the GLU's gate and value rows in one tile), as K13's do, each output's
//   f32 sums in the order dequant_tile.cuh's header states.  One or two
//   rows a warp (R_*), the tiles spread warp-major over the blocks, so
//   that every SM has its share of each stage's rows.
// - Each stage's grid sync sits in warp_rows' sync callback: the warp's
//   rows of the stage are fixed by the tile mapping, so L2 is asked for
//   their weights before the sync and the registers load them after it;
//   the layer's norm row, the ring rows written by earlier steps (by
//   cp.async) and the next step's embedding tables (while block 0
//   samples) go out before their syncs too; a residual's loads and
//   linear_out's activation row (by cp.async) go out beside the weights'.
// - The grid is one block an SM (BLOCKS_SM: 255 registers a thread and no
//   spills; two blocks an SM ran slower), its size queried once per
//   kernel and shared-memory size.
// - The attention's scores are a warp per head with every slot's sum
//   formed at once (warp_sums), its softmax from registers where the ring
//   fits one batch; the sampler reads its logits once into registers, one
//   block reduction per bisection count.
#include <cooperative_groups.h>

#include <mutex>

#include "dequant_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using dq::FMT_Q40;
using dq::FMT_Q4K;
using dq::QK;

constexpr int THREADS = dqt::THREADS;
constexpr int WARPS = THREADS / 32;
constexpr int MAXCAP = 64;
constexpr int MAXCARD = 32 * THREADS;   // the sampler's registers
constexpr float NEG = -1e9f;

// Tuning, chosen on the card at the 7B depformer: the weight rows per warp
// of each product stage (qkv 3 dd rows, out_proj dd, the GLU's hidden gate
// and value pairs, linear_out dd rows at K = hidden, the logits card
// rows), the blocks an SM holds (the register budget's divisor, and the
// grid is that many blocks on every SM), the ring slots a block holds in
// shared memory at once (KV_SLOTS: a ring of at most that many valid
// slots is read in one batch, before the grid sync) and the loads a
// thread keeps in flight where it reads a row from L2 (ROW_U).
constexpr int R_QKV = 1;
constexpr int R_OUT = 1;
constexpr int R_GLU = 4;
constexpr int R_LOUT = 1;
constexpr int R_LOGITS = 1;
constexpr int BLOCKS_SM = 1;
constexpr int KV_SLOTS = 8;
constexpr int ROW_U = 4;
static_assert(KV_SLOTS <= 32 && (KV_SLOTS & (KV_SLOTS - 1)) == 0,
              "KV_SLOTS: a power of two up to 32");

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
  bf16* kcur;    // the current k and v rows, rounded [dd] each
  bf16* vcur;
  bf16* kbuf;    // ring rows [KV_SLOTS, dd] each; in linear_out's stage,
  bf16* vbuf;    // its activation row hv [hidden] f32 from kbuf on
  float* nrm;    // a layer's norm row [dd] (f32, or bf16 in its first half)
  float* xs;     // the staged row (tile layout, bf16 values in f32)
  float* bsum;   // its 32-block sums
  float* red;    // [32]
};

// Bytes of the staged row, for the wider of K = dd and K = hidden.
__host__ __device__ inline size_t staged_bytes(int dd, int hidden) {
  const int rd = dqt::row_stride(FMT_Q4K, dd);
  const int rh = dqt::row_stride(FMT_Q4K, hidden);
  return (size_t)(rd > rh ? rd : rh) * sizeof(float);
}

// Bytes of the ring rows' buffers, which hold hv in linear_out's stage.
__host__ __device__ inline size_t kv_bytes(int dd, int hidden) {
  const size_t kv = (size_t)2 * KV_SLOTS * dd * sizeof(bf16);
  const size_t hv = (size_t)hidden * sizeof(float);
  return kv > hv ? kv : hv;
}

size_t smem_bytes(int dd, int hidden) {
  const int kmax = hidden > dd ? hidden : dd;
  return (size_t)(3 * dd + 32 * MAXCAP) * sizeof(float) +
         (size_t)2 * dd * sizeof(bf16) + kv_bytes(dd, hidden) +
         staged_bytes(dd, hidden) + (size_t)(kmax / QK) * sizeof(float);
}

__device__ Smem carve(unsigned char* smem, float* red, int dd, int hidden) {
  Smem s;
  s.hs = reinterpret_cast<float*>(smem);
  s.as = s.hs + dd;
  s.sp = s.as + dd;
  s.kcur = reinterpret_cast<bf16*>(s.sp + 32 * MAXCAP);
  s.vcur = s.kcur + dd;
  s.kbuf = s.vcur + dd;
  s.vbuf = s.kbuf + KV_SLOTS * dd;
  s.nrm = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(s.kbuf) +
                                   kv_bytes(dd, hidden));
  s.xs = s.nrm + dd;
  s.bsum = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(s.xs) +
                                    staged_bytes(dd, hidden));
  s.red = red;
  return s;
}

// h += y (y [dd] written by other blocks) in two parts, so that the
// loads are in flight beside the weights': the loads of a thread's first
// ROW_U elements, then the adds (and the rest of y, where dd is wider).
__device__ __forceinline__ void residual_load(const float* y, int dd,
                                              float (&v)[ROW_U]) {
#pragma unroll
  for (int u = 0; u < ROW_U; ++u) {
    const int i = threadIdx.x + u * THREADS;
    v[u] = i < dd ? __ldcg(y + i) : 0.f;
  }
}
__device__ __forceinline__ void residual_add(float* hs, const float* y,
                                             int dd, const float (&v)[ROW_U]) {
#pragma unroll
  for (int u = 0; u < ROW_U; ++u) {
    const int i = threadIdx.x + u * THREADS;
    if (i < dd) hs[i] = hs[i] + v[u];
  }
  for (int i = threadIdx.x + ROW_U * THREADS; i < dd; i += THREADS)
    hs[i] = hs[i] + __ldcg(y + i);
}
// Row l of a stacked [L, dd] norm (f32 or bf16) into s.nrm by cp.async,
// one group: it is constant, so it goes out before the grid sync.
__device__ __forceinline__ void fetch_norm(const Smem& s, const void* n,
                                           int n_bf16, int l, int dd) {
  const int bytes = dd * (n_bf16 ? 2 : 4);
  const char* row = static_cast<const char*>(n) + (long long)l * bytes;
  for (int b = threadIdx.x * 16; b < bytes; b += THREADS * 16)
    mt_cp_async16(reinterpret_cast<char*>(s.nrm) + b, row + b);
  mt_cp_async_commit();
}

// hs normalized by the norm row fetch_norm brought (f32 or bf16) and
// staged; it waits for the row and for every thread's h first.
__device__ __forceinline__ void stage_norm(const Smem& s, int n_bf16,
                                           int dd) {
  mt_cp_async_wait<0>();
  __syncthreads();
  const float* hs = s.hs;
  const auto from_hs = [&](int i) { return hs[i]; };
  if (n_bf16) {
    const uint16_t* nb = reinterpret_cast<const uint16_t*>(s.nrm);
    dqt::stage_row(
        from_hs, [&](int i) { return __uint_as_float((uint32_t)nb[i] << 16); },
        dd, s.xs, s.bsum, s.red);
  } else {
    const float* nf = s.nrm;
    dqt::stage_row(from_hs, [&](int i) { return nf[i]; }, dd, s.xs, s.bsum,
                   s.red);
  }
}

// Ring rows [j0, j0 + n) of ring [cap, dd] into buf [n, dd] by cp.async,
// one group, row skip (the row being written, if any) left out.
__device__ __forceinline__ void fetch_rows(const bf16* ring, bf16* buf,
                                           int j0, int n, int skip, int dd) {
  const int vec = dd / 8;   // 16-byte pieces of a row
  for (int idx = threadIdx.x; idx < n * vec; idx += THREADS) {
    const int jj = idx / vec, c = (idx - jj * vec) * 8;
    if (j0 + jj != skip)
      mt_cp_async16(buf + (long long)jj * dd + c,
                    ring + (long long)(j0 + jj) * dd + c);
  }
  mt_cp_async_commit();
}

// The attention, in two parts around the grid sync that ends the qkv
// stage.  Before it: the ring rows already written (all but row cb, or
// every slot where cb >= cap) go out to shared memory by cp.async.  After
// it: q, the current k/v rows (block 0 writes them to the ring), the
// scores, the softmax and p.v into s.as.  Rings of more than KV_SLOTS
// valid slots are walked in pieces of KV_SLOTS slots, k then v.  Every
// thread of every block calls both.
struct Att {
  int nv, skip;   // valid slots; the slot written (cb), or -1
  bool one;       // k and v in one batch
};

__device__ __forceinline__ Att attention_fetch(const Args& a, int cb,
                                               const bf16* kr,
                                               const bf16* vr,
                                               const Smem& s) {
  Att t;
  t.nv = cb + 1 < a.cap ? cb + 1 : a.cap;
  t.skip = cb < a.cap ? cb : -1;
  t.one = t.nv <= KV_SLOTS;
  fetch_rows(kr, s.kbuf, 0, t.one ? t.nv : KV_SLOTS, t.skip, a.dd);
  if (t.one) fetch_rows(vr, s.vbuf, 0, t.nv, t.skip, a.dd);
  return t;
}

__device__ __forceinline__ void attention(const Args& a, const Smem& s,
                                          const Att& t, int cb, bf16* kr,
                                          bf16* vr) {
  constexpr int E = 8;   // head elements a lane holds (head dim <= 256)
  const int dd = a.dd, H = a.heads, hd = dd / H, hshift = __ffs(hd) - 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* qkv = a.scratch;
  const int nv = t.nv, skip = t.skip;
  const bool write = skip >= 0;
  for (int i0 = tid; i0 < dd; i0 += ROW_U * THREADS) {
    float q[ROW_U], k[ROW_U], v[ROW_U];
#pragma unroll
    for (int u = 0; u < ROW_U; ++u) {
      const int i = i0 + u * THREADS;
      if (i < dd) {
        q[u] = __ldcg(qkv + i);
        if (write) {
          k[u] = __ldcg(qkv + dd + i);
          v[u] = __ldcg(qkv + 2 * dd + i);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < ROW_U; ++u) {
      const int i = i0 + u * THREADS;
      if (i < dd) {
        s.as[i] = mt_bf16_round(q[u]);
        if (write) {
          const bf16 kb = __float2bfloat16_rn(k[u]);
          const bf16 vb = __float2bfloat16_rn(v[u]);
          s.kcur[i] = kb;
          s.vcur[i] = vb;
          if (blockIdx.x == 0) {
            kr[(long long)cb * dd + i] = kb;
            vr[(long long)cb * dd + i] = vb;
          }
        }
      }
    }
  }

  // the scores: one warp per head, a piece's slots at once; lane partials
  // over the head's elements e = lane, lane + 32, ..., then each slot's
  // butterfly (warp_sums: every slot's sum in mt_warp_sum's pairs)
  constexpr int PER = 32 / KV_SLOTS;   // lanes that end with one slot's sum
  for (int j0 = 0; j0 < nv; j0 += KV_SLOTS) {
    const int n = nv - j0 < KV_SLOTS ? nv - j0 : KV_SLOTS;
    if (j0 > 0) fetch_rows(kr, s.kbuf, j0, n, skip, dd);
    mt_cp_async_wait<0>();
    __syncthreads();
    for (int hh = warp; hh < H; hh += WARPS) {
      float qv[E];
#pragma unroll
      for (int u = 0; u < E; ++u)
        qv[u] = lane + 32 * u < hd ? s.as[hh * hd + lane + 32 * u] : 0.f;
      float part[KV_SLOTS];
#pragma unroll
      for (int jj = 0; jj < KV_SLOTS; ++jj) {
        float acc = 0.f;
        if (jj < n) {
          const bf16* krow = (j0 + jj == skip ? s.kcur : s.kbuf + jj * dd) +
                             hh * hd + lane;
#pragma unroll
          for (int u = 0; u < E; ++u)
            if (lane + 32 * u < hd)
              acc += __bfloat162float(krow[32 * u]) * qv[u];
        }
        part[jj] = acc;
      }
      const float sum = dqt::warp_sums<KV_SLOTS>(part);
      if (t.one) {
        // every slot is here: the softmax from registers, every lane
        // alike (the max and the sum over the slots in order), each lane
        // that holds a slot's score writing its p
        float sc[KV_SLOTS], e[KV_SLOTS];
#pragma unroll
        for (int j = 0; j < KV_SLOTS; ++j)
          sc[j] = __shfl_sync(MT_FULL_MASK, sum, j * PER) * a.scale;
        float m = sc[0], tot = 0.f, mine = 0.f;
#pragma unroll
        for (int j = 1; j < KV_SLOTS; ++j)
          if (j < nv) m = fmaxf(m, sc[j]);
#pragma unroll
        for (int j = 0; j < KV_SLOTS; ++j) {
          e[j] = j < nv ? expf(sc[j] - m) : 0.f;
          if (j < nv) tot += e[j];
          if (j == lane / PER) mine = e[j];
        }
        if (lane % PER == 0 && lane / PER < nv)
          s.sp[hh * MAXCAP + lane / PER] = mt_bf16_round(mine / tot);
      } else if (lane % PER == 0 && lane / PER < n) {
        s.sp[hh * MAXCAP + j0 + lane / PER] = sum * a.scale;
      }
    }
    __syncthreads();
  }
  // the softmax of a ring walked in pieces, one warp per head: the max
  // and the sum over the slots in order (every lane alike), exp and the
  // division a lane per slot
  constexpr int JL = MAXCAP / 32;   // slots a lane holds
  for (int hh = warp; hh < H && !t.one; hh += WARPS) {
    float* row = s.sp + hh * MAXCAP;
    float m = row[0];
    for (int j = 1; j < nv; ++j) m = fmaxf(m, row[j]);
    float e[JL];
#pragma unroll
    for (int u = 0; u < JL; ++u) {
      const int j = lane + 32 * u;
      e[u] = j < nv ? expf(row[j] - m) : 0.f;
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < JL; ++u)
      if (lane + 32 * u < nv) row[lane + 32 * u] = e[u];
    __syncwarp();
    float sum = 0.f;
    for (int j = 0; j < nv; ++j) sum += row[j];
    __syncwarp();
#pragma unroll
    for (int u = 0; u < JL; ++u)
      if (lane + 32 * u < nv) row[lane + 32 * u] = mt_bf16_round(e[u] / sum);
  }
  if (!t.one) __syncthreads();
  // p.v: thread i sums over the slots in order, ROW_U of its i at once
  for (int j0 = 0; j0 < nv; j0 += KV_SLOTS) {
    const int n = nv - j0 < KV_SLOTS ? nv - j0 : KV_SLOTS;
    if (!t.one) {
      fetch_rows(vr, s.vbuf, j0, n, skip, dd);
      mt_cp_async_wait<0>();
      __syncthreads();
    }
    for (int i0 = tid; i0 < dd; i0 += ROW_U * THREADS) {
      float acc[ROW_U];
#pragma unroll
      for (int u = 0; u < ROW_U; ++u) {
        const int i = i0 + u * THREADS;
        acc[u] = j0 == 0 || i >= dd ? 0.f : s.as[i];
      }
#pragma unroll
      for (int jj = 0; jj < KV_SLOTS; ++jj) {
        if (jj < n) {
#pragma unroll
          for (int u = 0; u < ROW_U; ++u) {
            const int i = i0 + u * THREADS;
            if (i < dd) {
              const float p = s.sp[(i >> hshift) * MAXCAP + j0 + jj];
              const float vv = __bfloat162float(
                  j0 + jj == skip ? s.vcur[i] : s.vbuf[jj * dd + i]);
              acc[u] += p * vv;
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < ROW_U; ++u)
        if (i0 + u * THREADS < dd) s.as[i0 + u * THREADS] = acc[u];
    }
    __syncthreads();
  }
}

// One depformer layer on s.hs: weights of flat layer wl, norms of layer l,
// the layer's rings kr/vr [cap, dd], step cb.  pre(0, rv) and pre(1, rv)
// bring h up to date for the qkv stage, around its first weight loads:
// pre(0) waits for what h needs (a grid sync, or none for h's first
// value) and may start the loads of a residual into rv, pre(1) writes h
// (the residual added, or h's first value).  The layer ends with
// linear_out's products in ov; the caller's next stage syncs and adds
// them.
template <int LF, typename Pre>
__device__ __forceinline__ void dep_layer(const Args& a, cg::grid_group& grid,
                                          const Smem& s, int l, long long wl,
                                          int cb, bf16* kr, bf16* vr,
                                          Pre pre) {
  const int dd = a.dd, hidden = a.hidden;
  const int gwarp = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  const int gwarps = gridDim.x * WARPS;
  float* qkv = a.scratch;          // [3dd]
  float* ov = qkv + 3 * dd;        // [dd]
  float* hv = ov + dd;             // [hidden]
  const float* no_alpha = nullptr;
  const float* as = s.as;
  const auto from_as = [&](int i) { return as[i]; };

  float rv[ROW_U];   // a residual's loads

  // qkv with the fused rms norm1
  dqt::warp_rows<R_QKV, false>(
      a.qkv, wl * 3 * dd, 3 * dd, dd, s.xs, s.bsum, gwarp, gwarps,
      [&] {
        pre(1, rv);
        stage_norm(s, a.n1_bf16, dd);
      },
      [&](int o, float v, float) { qkv[o] = v; },
      [&] {
        fetch_norm(s, a.n1, a.n1_bf16, l, dd);
        pre(0, rv);
      });
  // the attention (every block), then out_proj
  Att att;
  dqt::warp_rows<R_OUT, false>(
      a.out, wl * dd, dd, dd, s.xs, s.bsum, gwarp, gwarps,
      [&] {
        attention(a, s, att, cb, kr, vr);
        dqt::stage_row(from_as, no_alpha, dd, s.xs, s.bsum, s.red);
      },
      [&](int o, float v, float) { ov[o] = v; },
      [&] {
        att = attention_fetch(a, cb, kr, vr, s);
        grid.sync();
      });
  // the residual, then the GLU with the fused rms norm2
  dqt::warp_rows<R_GLU, true>(
      a.glu, wl * 2 * hidden, hidden, dd, s.xs, s.bsum, gwarp, gwarps,
      [&] {
        residual_add(s.hs, ov, dd, rv);
        stage_norm(s, a.n2_bf16, dd);
      },
      [&](int o, float gt, float vl) {
        hv[o] = __fmul_rn(__fmul_rn(gt, 1.f / (1.f + expf(-gt))), vl);
      },
      [&] {
        fetch_norm(s, a.n2, a.n2_bf16, l, dd);
        grid.sync();
        residual_load(ov, dd, rv);
      });
  // linear_out; hv comes into shared memory by cp.async in one batch
  // (the ring rows' buffers are free)
  float* hvs = reinterpret_cast<float*>(s.kbuf);
  const auto from_hvs = [&](int i) { return hvs[i]; };
  dqt::warp_rows<R_LOUT, false, LF>(
      a.lout, wl * dd, dd, hidden, s.xs, s.bsum, gwarp, gwarps,
      [&] {
        mt_cp_async_wait<0>();
        __syncthreads();
        dqt::stage_row(from_hvs, no_alpha, hidden, s.xs, s.bsum, s.red);
      },
      [&](int o, float v, float) { ov[o] = v; },
      [&] {
        grid.sync();
        for (int i = threadIdx.x * 4; i < hidden; i += THREADS * 4)
          mt_cp_async16(hvs + i, hv + i);
        mt_cp_async_commit();
      });
}

template <int LF>
__global__ void __launch_bounds__(THREADS, BLOCKS_SM) dep_step_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[32];
  cg::grid_group grid = cg::this_grid();
  const Smem s = carve(smem, red, a.dd, a.hidden);
  const float* ov = a.scratch + 3 * a.dd;
  for (int l = 0; l < a.nlayers; ++l)
    dep_layer<LF>(a, grid, s, l, l, a.cb, a.kr + (long long)l * a.cap * a.dd,
                  a.vr + (long long)l * a.cap * a.dd,
                  [&](int phase, float (&rv)[ROW_U]) {
                    if (phase == 0) {
                      if (l > 0) {
                        grid.sync();
                        residual_load(ov, a.dd, rv);
                      }
                    } else if (l == 0) {
                      for (int i = threadIdx.x; i < a.dd; i += THREADS)
                        s.hs[i] = mt_load(a.h, i, a.h_bf16);
                    } else {
                      residual_add(s.hs, ov, a.dd, rv);
                    }
                  });
  grid.sync();
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < a.dd; i += THREADS)
      a.h_out[i] = s.hs[i] + __ldcg(ov + i);
}

// Block 0's sampler over logits [card] (global, read through L2, once:
// thread t holds logits t + THREADS u, u < V); returns the token to every
// thread of the block.  redi holds 2 WARPS ints.
template <int V>
__device__ int sample(const Args& a, const float* logits, const float* noise,
                      float* red, int* redi) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int card = a.card;
  const bool greedy = a.topk == 0;
  // the logits, scaled by 1 / temp where sampling
  float v[V];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int i = tid + u * THREADS;
    v[u] = i < card ? __ldcg(logits + i) : 0.f;
  }
  float thr = 0.f;
  if (!greedy) {
    float mn = 3.4e38f, mx = -3.4e38f;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      if (tid + u * THREADS < card) {
        v[u] = __fmul_rn(v[u], a.inv_temp);
        mn = fminf(mn, v[u]);
        mx = fmaxf(mx, v[u]);
      }
    }
    mx = mt_block_max(mx, red, -3.4e38f);
    mn = -mt_block_max(-mn, red, -3.4e38f);
    float lo = mn, hi = mx;
    for (int it = 0; it < 30; ++it) {
      const float mid = 0.5f * (lo + hi);
      int cnt = 0;
#pragma unroll
      for (int u = 0; u < V; ++u)
        cnt += tid + u * THREADS < card && v[u] >= mid;
      cnt = __reduce_add_sync(MT_FULL_MASK, cnt);
      // two slot sets in turn: one barrier a count
      int* slot = redi + (it & 1) * WARPS;
      if (lane == 0) slot[warp] = cnt;
      __syncthreads();
      cnt = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) cnt += slot[w];
      if (cnt >= a.topk) lo = mid; else hi = mid;
    }
    thr = lo;
  }
  // first-index argmax
  float best = -3.4e38f;
  int bi = 1 << 30;
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int i = tid + u * THREADS;
    if (i < card) {
      float x = v[u];
      if (!greedy) x = x >= thr ? __fadd_rn(x, noise[i]) : NEG;
      if (x > best) {  // i rises, so the first index of a tie stays
        best = x;
        bi = i;
      }
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
  for (int w = 1; w < WARPS; ++w)
    if (red[w] > best || (red[w] == best && redi[w] < bi)) {
      best = red[w];
      bi = redi[w];
    }
  __syncthreads();
  return bi;
}

// Step st's token: the grid sync after its logits, block 0 samples and
// publishes it, and a grid sync.
__device__ __forceinline__ void sample_step(const Args& a,
                                            cg::grid_group& grid, int st,
                                            float* red, int* redi) {
  const float* logits = a.scratch + 5 * a.dd + a.hidden;
  int* prev = reinterpret_cast<int*>(a.scratch + 5 * a.dd + a.hidden +
                                     a.card);
  grid.sync();
  if (blockIdx.x == 0) {
    const float* noise = a.noise + (long long)st * a.card;
    const int nv = (a.card + THREADS - 1) / THREADS;
    const int tok = nv <= 8    ? sample<8>(a, logits, noise, red, redi)
                    : nv <= 16 ? sample<16>(a, logits, noise, red, redi)
                               : sample<32>(a, logits, noise, red, redi);
    if (threadIdx.x == 0) {
      a.tokens[st] = tok;
      *prev = tok;
    }
  }
  grid.sync();
}

template <int LF>
__global__ void __launch_bounds__(THREADS, BLOCKS_SM)
    dep_frame_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[32];
  __shared__ int redi[2 * WARPS];
  cg::grid_group grid = cg::this_grid();
  const Smem s = carve(smem, red, a.dd, a.hidden);
  const int dd = a.dd, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gwarp = warp * gridDim.x + blockIdx.x;
  const int gwarps = gridDim.x * WARPS;
  const float* ov = a.scratch + 3 * dd;
  float* h0 = a.scratch + 4 * dd + a.hidden;        // [dd]
  float* logits = h0 + dd;                          // [card]
  const int* prev = reinterpret_cast<const int*>(logits + a.card);
  const long long ring = (long long)a.cap * dd;
  const int esize = a.emb_bf16 ? 2 : 4, lsize = a.lr_bf16 ? 2 : 4;
  const float* no_alpha = nullptr;
  const float* hs = s.hs;
  const auto from_hs = [&](int i) { return hs[i]; };

  for (int st = 0; st < a.dep_q; ++st) {
    for (int l = 0; l < a.nlayers; ++l)
      dep_layer<LF>(a, grid, s, l, (long long)st * a.nlayers + l, st,
                    a.kr + l * ring, a.vr + l * ring,
                    [&](int phase, float (&rv)[ROW_U]) {
        if (phase == 0) {
          if (l > 0) {
            grid.sync();
            residual_load(ov, dd, rv);
          } else if (st > 0) {   // the previous step's token, its embedding
            sample_step(a, grid, st - 1, s.red, redi);
            const int tok = __ldcg(prev);
            const long long erow =
                ((long long)st * (a.card + 1) + tok) * a.lr;
            for (int o = gwarp; o < dd; o += gwarps) {
              const long long wrow = ((long long)st * dd + o) * a.lr;
              float acc = 0.f;
              for (int t = lane; t < a.lr; t += 32)
                acc += mt_load(a.emb, erow + t, a.emb_bf16) *
                       mt_load(a.lr_w, wrow + t, a.lr_bf16);
              acc = mt_warp_sum(acc);
              if (lane == 0) h0[o] = a.h_in[(long long)st * dd + o] + acc;
            }
            grid.sync();
          }
        } else if (l > 0) {
          residual_add(s.hs, ov, dd, rv);
        } else if (st == 0) {   // h_in + the text embedding
          for (int i = tid; i < dd; i += THREADS)
            s.hs[i] = a.h_in[i] + mt_load(a.text_emb, i, a.text_bf16);
        } else {
          for (int i = tid; i < dd; i += THREADS) s.hs[i] = __ldcg(h0 + i);
        }
      });
    // the logits; while block 0 samples, L2 fetches the next step's
    // embedding table and each warp's lr_w row
    float rv[ROW_U];
    dqt::warp_rows<R_LOGITS, false>(
        a.lin, (long long)st * a.card, a.card, dd, s.xs, s.bsum, gwarp,
        gwarps,
        [&] {
          residual_add(s.hs, ov, dd, rv);
          __syncthreads();
          dqt::stage_row(from_hs, no_alpha, dd, s.xs, s.bsum, s.red);
          if (st + 1 < a.dep_q) {
            const long long tb = (long long)(a.card + 1) * a.lr * esize;
            const char* et = static_cast<const char*>(a.emb) +
                             (long long)(st + 1) * tb;
            for (long long b = ((long long)gwarp * 32 + lane) * 128; b < tb;
                 b += (long long)gwarps * 32 * 128)
              mt_prefetch_l2(et + b);
            const char* lw = static_cast<const char*>(a.lr_w) +
                             (long long)(st + 1) * dd * a.lr * lsize;
            for (int o = gwarp; o < dd; o += gwarps)
              for (int b = lane * 128; b < a.lr * lsize; b += 32 * 128)
                mt_prefetch_l2(lw + (long long)o * a.lr * lsize + b);
          }
        },
        [&](int o, float v, float) {
          logits[o] = v;
          if (a.logits_out) a.logits_out[(long long)st * a.card + o] = v;
        },
        [&] {
          grid.sync();
          residual_load(ov, dd, rv);
        });
  }
  sample_step(a, grid, a.dep_q - 1, s.red, redi);
}

// The grid of a kernel instance (BLOCKS_SM blocks on every SM, fewer if
// fewer fit), its dynamic shared memory limit raised once: one query per
// (device, kernel, shared-memory size), kept for the process.
cudaError_t grid_of(const void* fn, size_t smem, int* blocks) {
  struct Entry {
    int dev;
    const void* fn;
    size_t smem;
    int blocks;
  };
  static std::mutex mu;
  static Entry cache[16];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (cache[i].dev == dev && cache[i].fn == fn && cache[i].smem == smem) {
      *blocks = cache[i].blocks;
      return cudaSuccess;
    }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = (per_sm < BLOCKS_SM ? per_sm : BLOCKS_SM) * sms;
  if (used < 16) cache[used++] = Entry{dev, fn, smem, *blocks};
  return cudaSuccess;
}

const void* kernel_of(bool frame, int lfmt) {
  if (frame)
    return lfmt ? reinterpret_cast<const void*>(&dep_frame_kernel<FMT_Q40>)
                : reinterpret_cast<const void*>(&dep_frame_kernel<FMT_Q4K>);
  return lfmt ? reinterpret_cast<const void*>(&dep_step_kernel<FMT_Q40>)
              : reinterpret_cast<const void*>(&dep_step_kernel<FMT_Q4K>);
}

cudaError_t launch(bool frame, int lfmt, Args& a, cudaStream_t st) {
  if (lfmt != 0 && lfmt != 1) return cudaErrorInvalidValue;
  const void* fn = kernel_of(frame, lfmt);
  const size_t smem = smem_bytes(a.dd, a.hidden);
  int blocks = 0;
  cudaError_t err = grid_of(fn, smem, &blocks);
  if (err != cudaSuccess) return err;
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

// The blocks of K14's grid at these shapes (frame: K14c's kernel, else
// K14a's; lfmt as below), or minus the CUDA error.
extern "C" int mt_dep_grid_blocks(int dd, int hidden, int frame, int lfmt) {
  if (lfmt != 0 && lfmt != 1) return -(int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t err =
      grid_of(kernel_of(frame != 0, lfmt), smem_bytes(dd, hidden), &blocks);
  return err == cudaSuccess ? blocks : -(int)err;
}

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
  return launch(false, lfmt, a, static_cast<cudaStream_t>(stream));
}

// One depformer frame, all dep_q steps: h_in [dep_q, dd] f32; text_emb
// [dd]; emb [dep_q, card + 1, lr] (row 0 unused) and lr_w [dep_q, dd, lr]
// (f32 or bf16); the per-step stacked [dep_q, L, ...] layer weights as in
// mt_dep_full_step and the q4_k linears [dep_q, card, dd]; noise
// [dep_q, card] f32; tokens [dep_q] int32 out, and each step's logits
// into logits_out [dep_q, card] f32 where it is not null (a check's
// view of the sampler's input); rings bf16 [2, L, cap, dd] and scratch
// f32 of 5dd + hidden + card + 1, both scratch; topk the number of values
// kept (0: greedy); inv_temp = 1 / temp.
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
      card > MAXCARD || lr < 1 || topk < 0)
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
  return launch(true, lfmt, a, static_cast<cudaStream_t>(stream));
}
