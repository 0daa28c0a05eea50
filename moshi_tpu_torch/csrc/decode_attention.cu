// K3, K9 and K10: one-query decode attention over a KV ring, read in place.
//
// K3 replaces moshi_tpu/nn/pallas_attention.py decode_attention_stacked
// (kernel body _decode_attn_kernel_stacked); K9 replaces decode_attention
// (kernel body _decode_attn_kernel); K10 replaces decode_attention_stacked's
// MXU form (MOSHI_TPU_ATTN_MXU=1, kernel body
// _decode_attn_kernel_stacked_mxu).  For session b and head h:
//
//   K3 (pre-write, seeded): rings k/v [L, B, cap, H, hd] bf16 hold
//   positions up to last = offset - 1; the current token's k/v come in
//   separately and seed the online softmax: m = s_cur, l = 1, acc = v_cur.
//   Slot j is valid iff delta = (last - j) mod cap satisfies
//   delta < context - 1 and last - delta >= 0.  The ring is walked in
//   chunks that divide cap (the Pallas grid's chunk_for(cap)).
//
//   K9 (post-write, unseeded): rings k/v [B, cap, H, hd] bf16 already hold
//   the current token at slot offset % cap (last = offset); the softmax
//   starts at m = -1e9, l = 0, acc = 0.  Slot j is valid iff
//   delta < context and last - delta >= 0.  The chunk is min(256, cap);
//   the Pallas wrapper padded the ring to a chunk multiple and masked the
//   padded slots, so the last chunk here stops at cap.
//
//   Masked scores are -1e9.
//   s_j = sum_d k_j[d] * q[d] * hd^-0.5  (bf16 inputs, products exact in
//   f32, f32 sums)
//   per chunk of the ring, in order:
//     m' = max(m, max_j s_j); p_j = exp(s_j - m'); l = l e^(m-m') + sum p
//     acc = acc e^(m-m') + sum_j bf16(p_j) * v_j   (p rounded to bf16 as
//     the Pallas kernel casts it; products exact in f32)
//   out = acc / l  (f32 [B, H, hd])
//
//   K10 is K3 with three roundings of its own, each a compile-time switch
//   (MXU) that leaves K3's and K9's code as it was:
//     the scores take the query pre-scaled and rounded to bf16:
//       s_j = sum_d k_j[d] * bf16(q[d] * hd^-0.5)  (no scale after the sum;
//       the seed's score keeps K3's form, scaled after the sum);
//     each chunk's weighted values are rounded to bf16 once:
//       acc = acc e^(m-m') + bf16(sum_j bf16(p_j) * v_j);
//     the chunk is the wrapper's chunk_for_mxu(cap) (200 at cap 3000).
//   The TPU kernel formed all heads' scores in one contraction with a
//   block-diagonal spread of q and folded p.v back with a 0/1 matrix; both
//   only feed its matrix unit (the fold is exact), so here each block keeps
//   to its own head and does H times less work.
//
// One kernel, split_kernel, serves all three.  Within a chunk every
// thread owns one slot: its score is a sequential sum over its k row
// against q in shared memory; in the value pass thread (g, c) sums column
// group c (one 16-byte load) over every G-th slot of the chunk, and the G
// partial sums meet in shared memory in order.
//
// B * H * ceil(cap / chunk) blocks from one launch, each (session, head)'s
// blocks taking its chunks.  The chunk order is numerics (p, and K10's
// p.v, round against the walk's running max), and the running max before
// chunk c is the max of exact values: K3's seed score (K9: -1e9) and the
// maxima of the valid chunks before c, each the same block max of the
// same scores as in the walk.  Which chunks hold a valid slot follows from
// the offset alone (live_chunks), so a head's blocks beyond its count of
// live chunks return at once, as the walk skips the rest.  (Skipping is
// exact for K9 too: after a valid chunk a masked one would leave (m, l,
// acc) as they were, p = exp(-1e9 - m) = 0; before the first valid one
// the Pallas kernel gives p = exp(0) = 1 on every slot, but the first
// valid chunk multiplies that state by corr = exp(-1e9 - m') = 0 and so
// wipes it exactly; a valid chunk always exists, the current token's.)
// With one live chunk its block runs the walk's one step and writes out.
// With several, each block takes the live chunk of its ticket's rank,
// publishes the chunk's maximum as soon as its score pass is summed up,
// waits for the earlier live chunks' (at cap 3000 at most 11 for K3, 14
// for K10; K9 at most 2 on the stt-1b's 750 slots), takes the running max
// in the walk's order (fmaxf(m, max_c), m from the seed on), and forms
// exactly the walk's p, corr = e^(m-m'), sum p and chunk p.v for its
// chunk.  The last of the head's blocks to arrive replays the walk's
// state updates over the live chunks in order:
//   l = l corr + sum p;  acc = acc corr + p.v;  out = acc / l
// from the seed (K9: l = 0, acc = 0).  Every output equals the
// one-block-per-head walk's bit for bit.  A block waits only on blocks
// that are already running: its rank is a ticket taken from a
// per-(session, head) counter when it starts (decoupled look-back), not
// its blockIdx.  The maxima, the tickets, the arrival counters and the
// per-chunk parts live in a workspace that the wrapper allocates once per
// device (the sync region zeroed); the tickets and counters wrap back to
// zero (atomicInc) and the folding block clears the head's states, so
// every call leaves the sync region as it found it and launches nothing
// else.  A ring of one chunk (the depformer's) takes the ONE instance,
// which never touches the workspace.
//
// K9's chunk, min(256, cap), need not divide cap: its last chunk holds
// cap - c0 slots (238 of the stt-1b's 750, 244 of the TTS ring's 500),
// and the slots past cap, which the Pallas wrapper padded and masked, are
// neither read nor weighed (p = 0 there in the walk as here).
//
// Bound on the H100: bytes (the valid k and v rows of one layer: 49 MB on
// the 7B temporal ring when full, 6.1 MB on the stt-1b's 750-slot ring).
// A walk of one block per (session, head) ran 32 blocks at B = 1 on the
// 7B (16 for K9 on the stt-1b) with one chunk's loads in flight each, so
// load latency, not bytes, set its pace.  Split, 384 (K3), 480 (K10) or
// 48 (K9 on the stt-1b) blocks read the ring at once; the score pass
// reads k coalesced, staged through shared memory (chunk_score_staged: one
// row per thread had a warp's load touch 32 lines), the first batch of v
// rows loads while the block waits, and the rest follow V_BATCH at a
// time.  K9 at B = 1 still leaves most of the 132 SMs idle (48 blocks on
// the stt-1b, 32 on the TTS ring): a chunk spread over a thread-block
// cluster is the next step (ROADMAP B).
//
// fp8 rings (float8_e4m3fn, LMConfig.kv_dtype): the ring element type KT
// is a template parameter.  The Pallas bodies widen each ring chunk with
// .astype(bf16), which is exact for e4m3, then run the bf16 arithmetic;
// here a 16-byte load holds 16 e4m3 values (8 bf16), each widened exactly
// to f32 (RingElem<fp8>::widen), and the same arithmetic runs in the same
// chunk order (q, cur_k and cur_v stay bf16).  The bf16 instances keep
// their loops as they were (if constexpr): routed through the widening
// helper, K9's bf16 instance compiled slower.  The value pass's column
// groups are 16 wide, so G = 256 / (hd / 16) slot groups.  K3 and K9 take
// fp8 rings (entries mt_decode_attention_fp8 / mt_decode_attention4_fp8);
// K10 takes bf16 rings only, as the JAX package's _use_mxu_attn.  An fp8
// instance reads half the ring bytes of its bf16 form.
#include "fp8.cuh"

namespace {

constexpr float NEG = -1e9f;
constexpr int THREADS = 256;
constexpr int MAX_CHUNK = THREADS;   // one slot per thread in the score pass

// Split kernel tuning, each chosen on the card (see PERF.md): the
// value pass's v rows loaded per batch (a batch's loads all in flight
// before its products; 16 spilled), the blocks each SM must hold at once
// (the register budget's divisor: K10's 480 blocks at cap 3000 fit one
// wave at 4, K3's 384 at 3, where K3 ran faster), and K10's k rounds in
// flight (K3 keeps all of them in flight; all of K10's spill at 4 blocks
// per SM).
constexpr int V_BATCH = 8;
constexpr int MIN_BLOCKS = 3;
constexpr int MIN_BLOCKS_MXU = 4;
constexpr int K_AHEAD_MXU = 2;

// A live chunk's state in the workspace: 0 until its block publishes its
// maximum, then PUBLISHED with the maximum's bits in the low 32 bits.
constexpr unsigned long long PUBLISHED = 1ull << 32;

// The shared memory of one block.
template <int HD, bool MXU, typename KT>
struct Smem {
  static constexpr int VEC = RingElem<KT>::PER16;  // ring values per load
  static constexpr int G = THREADS / (HD / VEC);  // value pass slot groups
  float qs[HD];
  float qsc[MXU ? HD : 1];  // K10: bf16(q * scale)
  float sp[MAX_CHUNK];      // bf16-rounded probabilities
  float part[G * HD];
  float red[32];
};

// The workspace of a split launch over BH (session, head) pairs of nch
// chunks, in two regions that the wrapper's launch_plan sizes: the sync
// region, zero between calls (every call leaves the bytes it used zeroed,
// so calls of any shape can share it), and the parts, written before they
// are read.
struct Workspace {
  unsigned* tickets;            // [BH] chunk tickets, wrap to 0
  unsigned* arrivals;           // [BH] blocks done, wrap to 0
  unsigned long long* states;   // [BH, nch] 0 or PUBLISHED | max
  float* parts;                 // [BH, nch, HD + 4]: p.v, corr, sum p
};

__device__ __forceinline__ Workspace workspace_at(void* sync, void* parts,
                                                  int bh_count) {
  Workspace w;
  w.tickets = static_cast<unsigned*>(sync);
  w.arrivals = w.tickets + bh_count;
  w.states = reinterpret_cast<unsigned long long*>(w.arrivals + bh_count);
  w.parts = static_cast<float*>(parts);
  return w;
}

constexpr long long sync_bytes(long long bh_count, long long nch) {
  return 8 * bh_count + 8 * bh_count * nch;
}

constexpr long long parts_bytes(long long bh_count, long long nch, int hd) {
  return 4 * bh_count * nch * (hd + 4);
}

// Is slot i (this thread's) of the chunk at c0 (n slots) in the window?
__device__ __forceinline__ bool chunk_slot_valid(int c0, int n, int rmod,
                                                 int cap, int window,
                                                 int last,
                                                 int i = threadIdx.x) {
  if (i >= n) return false;
  const int slot = c0 + i;
  const int delta = slot > rmod ? rmod - slot + cap : rmod - slot;
  return delta < window && last - delta >= 0;
}

// The chunks of one session's ring that hold a valid slot.  The valid
// slots are the span = min(window, last + 1, cap) slots that end at slot
// rmod, cyclically (delta = 0 .. span - 1), so the live chunks are one run
// [lo, hi], or, where the span wraps past slot 0, two: [0, hi] and
// [lo, nch - 1].  Every block derives them from the offset alone; a chunk
// is live exactly where chunk_slot_valid holds for one of its slots.  The
// blocks of a head take the live chunks by rank.
struct LiveChunks {
  int lo, hi, count;
  bool wrapped;
  // the live chunk of rank j (0 .. count - 1) in the walk's order
  __device__ __forceinline__ int nth(int j) const {
    return wrapped ? (j <= hi ? j : lo + j - hi - 1) : lo + j;
  }
};

__device__ __forceinline__ LiveChunks live_chunks(int rmod, int last,
                                                  int window, int cap,
                                                  int chunk, int nch) {
  const int span = (int)min(min((long long)window, (long long)last + 1),
                            (long long)cap);
  if (span <= 0) return {1, 0, 0, false};
  const int first = rmod - span + 1;
  if (span < cap && first >= 0)
    return {first / chunk, rmod / chunk, rmod / chunk - first / chunk + 1,
            false};
  const int hi = rmod / chunk, lo = (first + cap) / chunk;
  if (span >= cap || lo <= hi) return {0, nch - 1, nch, false};
  return {lo, hi, hi + 1 + nch - lo, true};
}

// This thread's slot's score, NEG where it is masked.
template <int HD, bool MXU, typename KT>
__device__ __forceinline__ float chunk_score(
    bool valid, const KT* kbase, long long slot_stride, int c0,
    const Smem<HD, MXU, KT>& sh, float scale) {
  constexpr int VEC = Smem<HD, MXU, KT>::VEC;
  float s = NEG;
  if (valid) {
    const uint4* kp = reinterpret_cast<const uint4*>(
        kbase + (long long)(c0 + threadIdx.x) * slot_stride);
    float dot = 0.f;
    if constexpr (sizeof(KT) == 2) {  // bf16: the loop as it was
#pragma unroll
      for (int v = 0; v < HD / 8; ++v) {
        const uint4 w = kp[v];
        const bf16* e = reinterpret_cast<const bf16*>(&w);
#pragma unroll
        for (int t = 0; t < 8; ++t)
          dot += __bfloat162float(e[t]) * (MXU ? sh.qsc : sh.qs)[v * 8 + t];
      }
    } else {
#pragma unroll
      for (int v = 0; v < HD / VEC; ++v) {
        float e[VEC];
        RingElem<KT>::widen(kp[v], e);
#pragma unroll
        for (int t = 0; t < VEC; ++t) dot += e[t] * sh.qs[v * VEC + t];
      }
    }
    s = MXU ? dot : dot * scale;
  }
  return s;
}

// The split kernel's score pass: the same per-slot sums in the same order,
// the k rows read coalesced.  Warp w's 32 slots (32 w + lane, as in
// chunk_score) are read in ROUNDS rounds of P 16-byte pieces per row: each
// load instruction of a round covers 32 / P whole row pieces of P * 16
// contiguous bytes (8 lines at P = 4, where one row per lane touched 32),
// the warp stages the round in shared memory, and each lane adds its own
// row's pieces to its sum in order.  AHEAD rounds are in flight; the
// block's barrier that publishes q follows their loads.
template <int HD, bool MXU, typename KT>
struct KStage {
  static constexpr int PIECES = HD * (int)sizeof(KT) / 16;  // per row
  static constexpr int P = PIECES < 4 ? PIECES : 4;         // per round
  static constexpr int ROUNDS = PIECES / P;
  static constexpr int RPI = 32 / P;  // rows per load instruction
  static constexpr int AHEAD =
      MXU && K_AHEAD_MXU < ROUNDS ? K_AHEAD_MXU : ROUNDS;
  static constexpr int WARP_PIECES = 32 * (P + 1);  // one padded round
};

template <int HD, bool MXU, typename KT>
__device__ __forceinline__ float chunk_score_staged(
    bool valid, const KT* kbase, long long slot_stride, int c0, int n,
    int rmod, int cap, int window, int last, const Smem<HD, MXU, KT>& sh,
    uint4* stage, float scale) {
  using K = KStage<HD, MXU, KT>;
  constexpr int P = K::P, ROUNDS = K::ROUNDS, RPI = K::RPI;
  constexpr int VEC = Smem<HD, MXU, KT>::VEC;  // values per piece
  const int lane = threadIdx.x & 31;
  const int row0 = threadIdx.x & ~31;  // the warp's first slot
  uint4* mine = stage + (threadIdx.x >> 5) * K::WARP_PIECES;
  // the rows this lane loads (one per instruction of a round), if valid
  const KT* src[P];
  bool ok[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int row = row0 + i * RPI + lane / P;
    ok[i] = chunk_slot_valid(c0, n, rmod, cap, window, last, row);
    src[i] = kbase + (long long)(c0 + row) * slot_stride +
             (lane % P) * VEC;
  }
  uint4 w[K::AHEAD][P];
#pragma unroll
  for (int r = 0; r < K::AHEAD; ++r)
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (ok[i])
        w[r][i] = *reinterpret_cast<const uint4*>(src[i] + r * P * VEC);
  __syncthreads();  // publishes the caller's q, with the k rows in flight
  float dot = 0.f;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    __syncwarp();  // the round before is read
#pragma unroll
    for (int i = 0; i < P; ++i)
      mine[(i * RPI + lane / P) * (P + 1) + lane % P] = w[r % K::AHEAD][i];
    if (r + K::AHEAD < ROUNDS) {
#pragma unroll
      for (int i = 0; i < P; ++i)
        if (ok[i])
          w[r % K::AHEAD][i] = *reinterpret_cast<const uint4*>(
              src[i] + (r + K::AHEAD) * P * VEC);
    }
    __syncwarp();
    if (valid) {
#pragma unroll
      for (int pc = 0; pc < P; ++pc) {
        const uint4 x = mine[lane * (P + 1) + pc];
        const int v = r * P + pc;
        if constexpr (sizeof(KT) == 2) {
          const bf16* e = reinterpret_cast<const bf16*>(&x);
#pragma unroll
          for (int t = 0; t < 8; ++t)
            dot += __bfloat162float(e[t]) * (MXU ? sh.qsc : sh.qs)[v * 8 + t];
        } else {
          float e[VEC];
          RingElem<KT>::widen(x, e);
#pragma unroll
          for (int t = 0; t < VEC; ++t) dot += e[t] * sh.qs[v * VEC + t];
        }
      }
    }
  }
  return valid ? (MXU ? dot : __fmul_rn(dot, scale)) : NEG;
}

// p = exp(s - m_new) of this thread's slot (0 past the chunk's n slots),
// its bf16 rounding stored for the value pass.
template <int HD, bool MXU, typename KT>
__device__ __forceinline__ float chunk_weight(float s, float m_new, int n,
                                              Smem<HD, MXU, KT>& sh) {
  float p = 0.f;
  if (threadIdx.x < n) {
    p = expf(s - m_new);
    sh.sp[threadIdx.x] = mt_bf16_round(p);
  }
  return p;
}

// The end of the value pass: thread (g, col)'s sums a over its slots
// meet in shared memory, and thread d < HD gets the G slot groups' partial
// sums for dim d added in order (bf16-rounded for K10); 0 elsewhere.
template <int HD, bool MXU, typename KT>
__device__ __forceinline__ float chunk_part_sum(const float* a,
                                                Smem<HD, MXU, KT>& sh) {
  constexpr int VEC = Smem<HD, MXU, KT>::VEC, G = Smem<HD, MXU, KT>::G;
  const int tid = threadIdx.x;
  const int col = (tid % (HD / VEC)) * VEC, g = tid / (HD / VEC);
#pragma unroll
  for (int t = 0; t < VEC; ++t) sh.part[g * HD + col + t] = a[t];
  __syncthreads();
  float sum = 0.f;
  if (tid < HD) {
#pragma unroll
    for (int gg = 0; gg < G; ++gg) sum += sh.part[gg * HD + tid];
  }
  return MXU ? mt_bf16_round(sum) : sum;
}

// The split kernel's value pass: the same products and sums in the same
// order, its v rows loaded V_BATCH at a time (all of a batch in flight
// before its products), the first batch before the block waits.
template <int HD, bool MXU, typename KT>
struct ValueRows {
  static constexpr int VEC = Smem<HD, MXU, KT>::VEC;
  static constexpr int G = Smem<HD, MXU, KT>::G;
  static constexpr int ROWS = (MAX_CHUNK + G - 1) / G;  // rows a thread
  static constexpr int BATCH = ROWS < V_BATCH ? ROWS : V_BATCH;
  uint4 w[BATCH];

  __device__ __forceinline__ void load(const KT* vbase, long long stride,
                                       int c0, int n, int i0) {
    const int tid = threadIdx.x;
    const int col = (tid % (HD / VEC)) * VEC, g = tid / (HD / VEC);
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int j = g + (i0 + i) * G;
      if (j < n)
        w[i] = *reinterpret_cast<const uint4*>(
            vbase + (long long)(c0 + j) * stride + col);
    }
  }

  __device__ __forceinline__ void add(float* a, const float* sp, int n,
                                      int i0) const {
    const int g = threadIdx.x / (HD / VEC);
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int j = g + (i0 + i) * G;
      if (j < n) {
        const float pj = sp[j];
        float e[VEC];
        RingElem<KT>::widen(w[i], e);
#pragma unroll
        for (int t = 0; t < VEC; ++t) a[t] += pj * e[t];
      }
    }
  }
};

// The walk's state updates, rounded as the walks' compiled code rounded
// them: each one fused multiply-add (found bit for bit against K3's walk,
// where a separate product and sum for either differs, and K9's).
__device__ __forceinline__ float fold_l(float l, float corr, float psum) {
  return __fmaf_rn(l, corr, psum);
}

__device__ __forceinline__ float fold_acc(float acc, float corr, float pv) {
  return __fmaf_rn(acc, corr, pv);
}

__device__ __forceinline__ unsigned long long load_state(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// atomicInc with release and acquire semantics at device scope: the
// block's writes before a barrier and this call are seen by the block
// that reads the count after them (with a barrier after its own call).
__device__ __forceinline__ unsigned arrive(unsigned* p, unsigned limit) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(limit)
               : "memory");
  return old;
}

// K3, K10 and K9 (POST): one block per (session, head, chunk) of nch
// chunks; ONE (nch 1: the depformer's rings, a K9 ring of at most one
// chunk) compiles the workspace's code out.  K9 has no current k/v (ck and
// cv unused) and no seed: its walk starts at m = -1e9, l = 0, acc = 0.
template <int HD, bool MXU, typename KT, bool ONE, bool POST>
__global__ void __launch_bounds__(
    THREADS, MXU && !ONE ? MIN_BLOCKS_MXU : MIN_BLOCKS) split_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ ck,
    const bf16* __restrict__ cv, const KT* __restrict__ kr,
    const KT* __restrict__ vr, const int* __restrict__ offset,
    float* __restrict__ out, int B, int H, int cap, int context, int chunk,
    int nch, long long layer_off, float scale, void* sync, void* parts) {
  static_assert(!(MXU && sizeof(KT) == 1), "K10 takes bf16 rings only");
  static_assert(!(MXU && POST), "K10 is K3's form");
  constexpr int FOLD = THREADS * 8 / HD;  // chunks per round of the fold
  static_assert(FOLD * HD <= Smem<HD, MXU, KT>::G * HD, "fold staging");
  __shared__ Smem<HD, MXU, KT> sh;
  __shared__ float prior_max[THREADS];
  __shared__ float fold_corr[FOLD], fold_sum[FOLD];
  __shared__ unsigned ticket, arrived;
  __shared__ uint4 kstage[ONE ? 1
                             : THREADS / 32 *
                                   KStage<HD, MXU, KT>::WARP_PIECES];
  const int bh_count = B * H;
  const int bh = blockIdx.x % bh_count, b = bh / H, h = bh % H;
  const int rank = blockIdx.x / bh_count;  // among this head's blocks
  const int tid = threadIdx.x;
  // q and the current k/v: a head's first block (always live, if any is)
  // loads them with the offset, the others once they know they are live
  float qv = 0.f, cur = 0.f, cur_v = 0.f;
  const auto load_row = [&] {
    if (tid < HD) {
      qv = __bfloat162float(q[(long long)bh * HD + tid]);
      if constexpr (!POST) {
        cur = __bfloat162float(ck[(long long)bh * HD + tid]);
        cur_v = __bfloat162float(cv[(long long)bh * HD + tid]);
      }
    }
  };
  if (rank == 0) load_row();
  // K3 reads the ring before this step's write, K9 after it
  const int last = POST ? offset[b] : offset[b] - 1;
  const int window = POST ? context : context - 1;
  int rmod = last % cap;
  if (rmod < 0) rmod += cap;
  const LiveChunks live = live_chunks(rmod, last, window, cap, chunk, nch);
  // the walk's state before its first chunk: K3's seed, K9's zeros
  const float l0 = POST ? 0.f : 1.f;
  if (live.count == 0) {  // no valid slot: the walk's first state, acc / l
    if (rank == 0 && tid < HD)
      out[(long long)bh * HD + tid] = POST ? __fdiv_rn(0.f, l0) : cur_v;
    return;
  }
  if (rank >= live.count) return;  // a head's blocks beyond its live chunks
  if (rank > 0) load_row();
  // With several live chunks the blocks meet in the workspace, and a block
  // waits on others, so it takes its chunk from a ticket (the blocks before
  // it in its head are running); with one, its block runs the walk alone.
  const bool split = !ONE && live.count > 1;
  const Workspace w =
      split ? workspace_at(sync, parts, bh_count) : Workspace{};
  const long long chunk_row = (long long)bh * nch;  // this head's states
  if (split) {
    if (tid == 0) ticket = atomicInc(&w.tickets[bh], live.count - 1);
    __syncthreads();
  }
  const int c = live.nth(split ? (int)ticket : 0);
  if (tid < HD) sh.qs[tid] = qv;
  if (MXU && tid < HD) sh.qsc[tid] = mt_bf16_round(qv * scale);
  const long long slot_stride = (long long)H * HD;
  const long long base = layer_off + (long long)b * cap * slot_stride +
                         (long long)h * HD;
  const KT* kbase = kr + base;
  const KT* vbase = vr + base;
  const int c0 = c * chunk, n = min(chunk, cap - c0);
  const bool valid = chunk_slot_valid(c0, n, rmod, cap, window, last);
  float s;  // one chunk (the depformer's 8 slots) reads its rows plainly
  if constexpr (ONE) {
    __syncthreads();
    s = chunk_score<HD, MXU, KT>(valid, kbase, slot_stride, c0, sh, scale);
  } else
    s = chunk_score_staged<HD, MXU, KT>(valid, kbase, slot_stride, c0, n,
                                        rmod, cap, window, last, sh, kstage,
                                        scale);
  const float cmax = mt_block_max(s, sh.red, NEG);
  if (split && tid == 0)
    atomicExch(&w.states[chunk_row + c], PUBLISHED | __float_as_uint(cmax));
  // the first batch of v rows loads while the block waits
  ValueRows<HD, MXU, KT> vrows;
  vrows.load(vbase, slot_stride, c0, n, 0);
  // the seed's score, the walk's first running max (a rounded product, as
  // the walk's, whose every use was past a branch); K9's is -1e9
  float m = NEG;
  if constexpr (!POST)
    m = __fmul_rn(mt_block_sum(tid < HD ? cur * sh.qs[tid] : 0.f, sh.red),
                  scale);
  if (split) {
    // the walk's running max before chunk c, from the earlier live
    // chunks' published maxima (ranks 0 .. ticket - 1), in the walk's order
    for (int r0 = 0; r0 < (int)ticket; r0 += THREADS) {
      const int j = r0 + tid;
      if (j < (int)ticket) {
        unsigned long long st;
        while ((st = load_state(&w.states[chunk_row + live.nth(j)])) == 0)
          __nanosleep(32);
        prior_max[tid] = __uint_as_float((unsigned)st);
      }
      __syncthreads();
      const int cnt = min(THREADS, (int)ticket - r0);
      for (int j2 = 0; j2 < cnt; ++j2) m = fmaxf(m, prior_max[j2]);
      __syncthreads();
    }
  }
  const float m_new = fmaxf(m, cmax);
  const float corr = expf(m - m_new);
  const float p = chunk_weight(s, m_new, n, sh);
  const float psum = mt_block_sum(p, sh.red);  // its barriers publish sp
  float a[ValueRows<HD, MXU, KT>::VEC] = {};
#pragma unroll
  for (int i0 = 0; i0 < vrows.ROWS; i0 += vrows.BATCH) {
    if (i0 > 0) vrows.load(vbase, slot_stride, c0, n, i0);
    vrows.add(a, sh.sp, n, i0);
  }
  const float pv = chunk_part_sum(a, sh);
  if (!split) {  // the walk's one live chunk: its first state, then this
    if (tid < HD)
      out[(long long)bh * HD + tid] =
          fold_acc(cur_v, corr, pv) / fold_l(l0, corr, psum);
    return;
  }

  float* rec = w.parts + (chunk_row + c) * (HD + 4);
  if (tid < HD) rec[tid] = pv;
  if (tid == 0) {
    rec[HD] = corr;
    rec[HD + 1] = psum;
  }
  __syncthreads();
  if (tid == 0) arrived = arrive(&w.arrivals[bh], live.count - 1);
  __syncthreads();
  if (arrived != (unsigned)(live.count - 1)) return;

  // The last block of this (session, head): every live chunk has published
  // its parts.  Replay the walk's updates in its order, over the live
  // chunks by rank (the walk skips the rest).
  float l = l0, acc = cur_v;
  for (int r0 = 0; r0 < live.count; r0 += FOLD) {
    const int cnt = min(FOLD, live.count - r0);
    if (tid < cnt) {
      const long long i = chunk_row + live.nth(r0 + tid);
      fold_corr[tid] = __ldcg(w.parts + i * (HD + 4) + HD);
      fold_sum[tid] = __ldcg(w.parts + i * (HD + 4) + HD + 1);
      w.states[i] = 0;  // every live block of the head has read it
    }
    for (int e = tid; e < cnt * HD; e += THREADS)
      sh.part[e] = __ldcg(
          w.parts + (chunk_row + live.nth(r0 + e / HD)) * (HD + 4) + e % HD);
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      l = fold_l(l, fold_corr[j], fold_sum[j]);
      if (tid < HD) acc = fold_acc(acc, fold_corr[j], sh.part[j * HD + tid]);
    }
    __syncthreads();
  }
  if (tid < HD) out[(long long)bh * HD + tid] = acc / l;
}

// Launch one of the split kernels at hd 32, 64 or 128.  K3's and K10's
// chunk divides cap; K9's (POST) need not, its last chunk cut at cap.
template <bool MXU, typename KT, bool POST = false>
int launch_split(const void* q, const void* cur_k, const void* cur_v,
                 const void* k_ring, const void* v_ring, const void* offset,
                 void* out, int B, int H, int hd, int cap, int context,
                 int chunk, int layer, float scale, void* sync,
                 long long sync_len, void* parts, long long parts_len,
                 void* stream) {
  if (chunk < 1 || chunk > MAX_CHUNK || (!POST && cap % chunk))
    return cudaErrorInvalidValue;
  const int nch = (cap + chunk - 1) / chunk;
  const long long heads = (long long)B * H;
  if (nch > 1 && (sync == nullptr || parts == nullptr ||
                  sync_len < sync_bytes(heads, nch) ||
                  parts_len < parts_bytes(heads, nch, hd)))
    return cudaErrorInvalidValue;
  const long long layer_off = (long long)layer * B * cap * H * hd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * H * nch), block(THREADS);
#define MT_SPLIT_ARGS                                                       \
  static_cast<const bf16*>(q), static_cast<const bf16*>(cur_k),             \
      static_cast<const bf16*>(cur_v), static_cast<const KT*>(k_ring),      \
      static_cast<const KT*>(v_ring), static_cast<const int*>(offset),      \
      static_cast<float*>(out), B, H, cap, context, chunk, nch, layer_off,  \
      scale, sync, parts
#define MT_SPLIT_LAUNCH(HD_)                                                \
  if (nch == 1)                                                             \
    split_kernel<HD_, MXU, KT, true, POST>                                  \
        <<<grid, block, 0, st>>>(MT_SPLIT_ARGS);                            \
  else                                                                      \
    split_kernel<HD_, MXU, KT, false, POST>                                 \
        <<<grid, block, 0, st>>>(MT_SPLIT_ARGS)
  switch (hd) {
    case 32:
      MT_SPLIT_LAUNCH(32);
      break;
    case 64:
      MT_SPLIT_LAUNCH(64);
      break;
    case 128:
      MT_SPLIT_LAUNCH(128);
      break;
    default:
      return cudaErrorInvalidValue;
  }
#undef MT_SPLIT_LAUNCH
#undef MT_SPLIT_ARGS
  return cudaGetLastError();
}

}  // namespace

MT_ERROR_STRING_FN

// K3: q/cur_k/cur_v [B, H, hd] bf16; k_ring/v_ring [L, B, cap, H, hd] bf16
// before this step's write; offset [B] int32 on the device; out [B, H, hd]
// f32; scale hd^-0.5; chunk divides cap; sync (zero, sync_len bytes) and
// parts (parts_len bytes) the workspace, unused at one chunk.
extern "C" int mt_decode_attention(const void* q, const void* cur_k,
                                   const void* cur_v, const void* k_ring,
                                   const void* v_ring, const void* offset,
                                   void* out, int B, int H, int hd, int cap,
                                   int context, int chunk, int layer,
                                   float scale, void* sync,
                                   long long sync_len, void* parts,
                                   long long parts_len, void* stream) {
  return launch_split<false, bf16>(q, cur_k, cur_v, k_ring, v_ring, offset,
                                   out, B, H, hd, cap, context, chunk, layer,
                                   scale, sync, sync_len, parts, parts_len,
                                   stream);
}

// K10: K3's operands, ring and workspace; chunk is chunk_for_mxu(cap),
// which divides cap.
extern "C" int mt_decode_attention_mxu(const void* q, const void* cur_k,
                                       const void* cur_v, const void* k_ring,
                                       const void* v_ring, const void* offset,
                                       void* out, int B, int H, int hd,
                                       int cap, int context, int chunk,
                                       int layer, float scale, void* sync,
                                       long long sync_len, void* parts,
                                       long long parts_len, void* stream) {
  return launch_split<true, bf16>(q, cur_k, cur_v, k_ring, v_ring, offset,
                                  out, B, H, hd, cap, context, chunk, layer,
                                  scale, sync, sync_len, parts, parts_len,
                                  stream);
}

// K9: q [B, H, hd] bf16; k_ring/v_ring [B, cap, H, hd] bf16 after this
// step's write; offset [B] int32 on the device; out [B, H, hd] f32; scale
// hd^-0.5; chunk min(256, cap), the last chunk cut at cap; sync and parts
// K3's workspace, sized for ceil(cap / chunk) chunks, unused at one.
extern "C" int mt_decode_attention4(const void* q, const void* k_ring,
                                    const void* v_ring, const void* offset,
                                    void* out, int B, int H, int hd, int cap,
                                    int context, int chunk, float scale,
                                    void* sync, long long sync_len,
                                    void* parts, long long parts_len,
                                    void* stream) {
  return launch_split<false, bf16, true>(
      q, nullptr, nullptr, k_ring, v_ring, offset, out, B, H, hd, cap,
      context, chunk, 0, scale, sync, sync_len, parts, parts_len, stream);
}

// K3 on fp8 rings: K3's operands (q, cur_k, cur_v bf16) and workspace, with
// k_ring/v_ring [L, B, cap, H, hd] e4m3.
extern "C" int mt_decode_attention_fp8(const void* q, const void* cur_k,
                                       const void* cur_v, const void* k_ring,
                                       const void* v_ring, const void* offset,
                                       void* out, int B, int H, int hd,
                                       int cap, int context, int chunk,
                                       int layer, float scale, void* sync,
                                       long long sync_len, void* parts,
                                       long long parts_len, void* stream) {
  return launch_split<false, fp8>(q, cur_k, cur_v, k_ring, v_ring, offset,
                                  out, B, H, hd, cap, context, chunk, layer,
                                  scale, sync, sync_len, parts, parts_len,
                                  stream);
}

// K9 on fp8 rings: K9's operands and workspace with k_ring/v_ring
// [B, cap, H, hd] e4m3.
extern "C" int mt_decode_attention4_fp8(const void* q, const void* k_ring,
                                        const void* v_ring,
                                        const void* offset, void* out, int B,
                                        int H, int hd, int cap, int context,
                                        int chunk, float scale, void* sync,
                                        long long sync_len, void* parts,
                                        long long parts_len, void* stream) {
  return launch_split<false, fp8, true>(
      q, nullptr, nullptr, k_ring, v_ring, offset, out, B, H, hd, cap,
      context, chunk, 0, scale, sync, sync_len, parts, parts_len, stream);
}
