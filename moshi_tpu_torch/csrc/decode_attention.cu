// K3, K9 and K10: one-query decode attention over a KV ring, read in place.
//
// K3 replaces moshi_tpu/nn/pallas_attention.py decode_attention_stacked
// (kernel body _decode_attn_kernel_stacked); K9 replaces decode_attention
// (kernel body _decode_attn_kernel); K10 replaces decode_attention_stacked's
// MXU form (MOSHI_TPU_ATTN_MXU=1, kernel body
// _decode_attn_kernel_stacked_mxu).  One template serves all three: POST =
// false is K3, POST = true is K9, MXU = true (with POST false) is K10.  For
// session b and head h:
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
//   that leaves K3's and K9's code as it was:
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
// The Pallas grid walked the chunks in order and carried (m, l, acc) in
// scratch; here one block per (session, head) walks them in a loop, so
// the online softmax stays block-local and follows the same chunk order
// (the bf16 rounding of p depends on the running max, so the chunking is
// part of the function).  A chunk with no valid slot is skipped after one
// vote.  After a valid chunk it would leave (m, l, acc) exactly as they
// were (p = exp(-1e9 - m) = 0).  For K9, a fully masked chunk BEFORE the
// first valid one gives the Pallas kernel p = exp(0) = 1 on every slot,
// but the first valid chunk multiplies that state by
// corr = exp(-1e9 - m') = 0 and so wipes it exactly; a valid chunk always
// exists (the current token's slot), so skipping is exact in both forms.
// An early-session ring costs the chunks it uses.
//
// Bound on the H100: bytes (the valid k and v rows of one layer: 49 MB on
// the 7B temporal ring when full, 6.1 MB on the stt-1b's 750-slot ring).
// Only B*H blocks run (32 at B=1 on the 7B, 16 on the stt-1b), so each
// block keeps many loads in flight: in the score pass every thread owns
// one slot and reads its whole k row with 16-byte loads against q in
// shared memory; in the value pass thread (g, c) sums the 8 elements of
// column group c (one 16-byte load) over every G-th slot of the chunk,
// and the G partial sums meet in shared memory.  Splitting the ring across
// blocks would fill the card but round p against another running max;
// that is a later change with its own tolerance.
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

template <int HD, bool POST, bool MXU, typename KT>
__global__ void __launch_bounds__(THREADS) decode_attn_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ ck,
    const bf16* __restrict__ cv, const KT* __restrict__ kr,
    const KT* __restrict__ vr, const int* __restrict__ offset,
    float* __restrict__ out, int H, int cap, int context, int chunk,
    long long layer_off, float scale) {
  static_assert(!(MXU && sizeof(KT) == 1), "K10 takes bf16 rings only");
  constexpr int VEC = RingElem<KT>::PER16;  // ring values per 16-byte load
  constexpr int G = THREADS / (HD / VEC);  // slot groups in the value pass
  __shared__ float qs[HD];
  __shared__ float qsc[MXU ? HD : 1];  // K10: bf16(q * scale)
  __shared__ float sp[MAX_CHUNK];      // bf16-rounded probabilities
  __shared__ float part[G * HD];
  __shared__ float red[32];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int last = POST ? offset[b] : offset[b] - 1;
  const int window = POST ? context : context - 1;
  int rmod = last % cap;
  if (rmod < 0) rmod += cap;

  if (tid < HD) qs[tid] = __bfloat162float(q[(long long)bh * HD + tid]);
  if (MXU && tid < HD)
    qsc[tid] = mt_bf16_round(__bfloat162float(q[(long long)bh * HD + tid]) *
                             scale);
  float m, l, acc;
  if (POST) {
    __syncthreads();
    m = NEG;
    l = 0.f;
    acc = 0.f;
  } else {
    const float cur =
        tid < HD ? __bfloat162float(ck[(long long)bh * HD + tid]) : 0.f;
    __syncthreads();
    m = mt_block_sum(tid < HD ? cur * qs[tid] : 0.f, red) * scale;
    l = 1.f;
    acc = tid < HD ? __bfloat162float(cv[(long long)bh * HD + tid]) : 0.f;
  }

  const long long slot_stride = (long long)H * HD;
  const long long base = layer_off + (long long)b * cap * slot_stride +
                         (long long)h * HD;
  const KT* kbase = kr + base;
  const KT* vbase = vr + base;
  const int col = (tid % (HD / VEC)) * VEC, g = tid / (HD / VEC);

  for (int c0 = 0; c0 < cap; c0 += chunk) {
    const int n = min(chunk, cap - c0);  // slots of this chunk in the ring
    bool valid = false;
    if (tid < n) {
      const int slot = c0 + tid;
      const int delta = slot > rmod ? rmod - slot + cap : rmod - slot;
      valid = delta < window && last - delta >= 0;
    }
    if (!__syncthreads_or(valid)) continue;  // all masked: nothing changes

    float s = NEG;
    if (valid) {
      const uint4* kp = reinterpret_cast<const uint4*>(
          kbase + (long long)(c0 + tid) * slot_stride);
      float dot = 0.f;
      if constexpr (sizeof(KT) == 2) {  // bf16: the loop as it was
#pragma unroll
        for (int v = 0; v < HD / 8; ++v) {
          const uint4 w = kp[v];
          const bf16* e = reinterpret_cast<const bf16*>(&w);
#pragma unroll
          for (int t = 0; t < 8; ++t)
            dot += __bfloat162float(e[t]) * (MXU ? qsc : qs)[v * 8 + t];
        }
      } else {
#pragma unroll
        for (int v = 0; v < HD / VEC; ++v) {
          float e[VEC];
          RingElem<KT>::widen(kp[v], e);
#pragma unroll
          for (int t = 0; t < VEC; ++t) dot += e[t] * qs[v * VEC + t];
        }
      }
      s = MXU ? dot : dot * scale;
    }
    const float m_new = fmaxf(m, mt_block_max(s, red, NEG));
    const float corr = expf(m - m_new);
    float p = 0.f;
    if (tid < n) {
      p = expf(s - m_new);
      sp[tid] = mt_bf16_round(p);
    }
    l = l * corr + mt_block_sum(p, red);  // its barriers also publish sp

    float a[VEC] = {};
    if constexpr (sizeof(KT) == 2) {  // bf16: the loop as it was
#pragma unroll 2
      for (int j = g; j < n; j += G) {
        const float pj = sp[j];
        const uint4 w = *reinterpret_cast<const uint4*>(
            vbase + (long long)(c0 + j) * slot_stride + col);
        const bf16* e = reinterpret_cast<const bf16*>(&w);
#pragma unroll
        for (int t = 0; t < VEC; ++t) a[t] += pj * __bfloat162float(e[t]);
      }
    } else {
#pragma unroll 2
      for (int j = g; j < n; j += G) {
        const float pj = sp[j];
        float e[VEC];
        RingElem<KT>::widen(*reinterpret_cast<const uint4*>(
                                vbase + (long long)(c0 + j) * slot_stride +
                                col),
                            e);
#pragma unroll
        for (int t = 0; t < VEC; ++t) a[t] += pj * e[t];
      }
    }
#pragma unroll
    for (int t = 0; t < VEC; ++t) part[g * HD + col + t] = a[t];
    __syncthreads();
    if (tid < HD) {
      float sum = 0.f;
#pragma unroll
      for (int gg = 0; gg < G; ++gg) sum += part[gg * HD + tid];
      acc = acc * corr + (MXU ? mt_bf16_round(sum) : sum);
    }
    m = m_new;
    __syncthreads();  // sp and part are rewritten by the next chunk
  }
  if (tid < HD) out[(long long)bh * HD + tid] = acc / l;
}

template <bool POST, bool MXU, typename KT = bf16>
int launch(const void* q, const void* cur_k, const void* cur_v,
           const void* k_ring, const void* v_ring, const void* offset,
           void* out, int B, int H, int hd, int cap, int context, int chunk,
           long long layer_off, float scale, void* stream) {
  if (chunk < 1 || chunk > MAX_CHUNK) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * H), block(THREADS);
#define MT_ATTN_ARGS                                                        \
  static_cast<const bf16*>(q), static_cast<const bf16*>(cur_k),             \
      static_cast<const bf16*>(cur_v), static_cast<const KT*>(k_ring),      \
      static_cast<const KT*>(v_ring), static_cast<const int*>(offset),      \
      static_cast<float*>(out), H, cap, context, chunk, layer_off, scale
  switch (hd) {
    case 32:
      decode_attn_kernel<32, POST, MXU, KT>
          <<<grid, block, 0, st>>>(MT_ATTN_ARGS);
      break;
    case 64:
      decode_attn_kernel<64, POST, MXU, KT>
          <<<grid, block, 0, st>>>(MT_ATTN_ARGS);
      break;
    case 128:
      decode_attn_kernel<128, POST, MXU, KT>
          <<<grid, block, 0, st>>>(MT_ATTN_ARGS);
      break;
    default:
      return cudaErrorInvalidValue;
  }
#undef MT_ATTN_ARGS
  return cudaGetLastError();
}

}  // namespace

MT_ERROR_STRING_FN

// K3: q/cur_k/cur_v [B, H, hd] bf16; k_ring/v_ring [L, B, cap, H, hd] bf16
// before this step's write; offset [B] int32 on the device; out [B, H, hd]
// f32; scale hd^-0.5; chunk divides cap.
extern "C" int mt_decode_attention(const void* q, const void* cur_k,
                                   const void* cur_v, const void* k_ring,
                                   const void* v_ring, const void* offset,
                                   void* out, int B, int H, int hd, int cap,
                                   int context, int chunk, int layer,
                                   float scale, void* stream) {
  if (chunk < 1 || cap % chunk) return cudaErrorInvalidValue;
  const long long layer_off = (long long)layer * B * cap * H * hd;
  return launch<false, false>(q, cur_k, cur_v, k_ring, v_ring, offset, out,
                              B, H, hd, cap, context, chunk, layer_off, scale,
                              stream);
}

// K10: K3's operands and ring; chunk is chunk_for_mxu(cap), which divides
// cap.
extern "C" int mt_decode_attention_mxu(const void* q, const void* cur_k,
                                       const void* cur_v, const void* k_ring,
                                       const void* v_ring, const void* offset,
                                       void* out, int B, int H, int hd,
                                       int cap, int context, int chunk,
                                       int layer, float scale, void* stream) {
  if (chunk < 1 || cap % chunk) return cudaErrorInvalidValue;
  const long long layer_off = (long long)layer * B * cap * H * hd;
  return launch<false, true>(q, cur_k, cur_v, k_ring, v_ring, offset, out, B,
                             H, hd, cap, context, chunk, layer_off, scale,
                             stream);
}

// K9: q [B, H, hd] bf16; k_ring/v_ring [B, cap, H, hd] bf16 after this
// step's write; offset [B] int32 on the device; out [B, H, hd] f32; scale
// hd^-0.5; chunk min(256, cap), the last chunk cut at cap.
extern "C" int mt_decode_attention4(const void* q, const void* k_ring,
                                    const void* v_ring, const void* offset,
                                    void* out, int B, int H, int hd, int cap,
                                    int context, int chunk, float scale,
                                    void* stream) {
  return launch<true, false>(q, nullptr, nullptr, k_ring, v_ring, offset,
                             out, B, H, hd, cap, context, chunk, 0, scale,
                             stream);
}

// K3 on fp8 rings: K3's operands (q, cur_k, cur_v bf16) with k_ring/v_ring
// [L, B, cap, H, hd] e4m3.
extern "C" int mt_decode_attention_fp8(const void* q, const void* cur_k,
                                       const void* cur_v, const void* k_ring,
                                       const void* v_ring, const void* offset,
                                       void* out, int B, int H, int hd,
                                       int cap, int context, int chunk,
                                       int layer, float scale, void* stream) {
  if (chunk < 1 || cap % chunk) return cudaErrorInvalidValue;
  const long long layer_off = (long long)layer * B * cap * H * hd;
  return launch<false, false, fp8>(q, cur_k, cur_v, k_ring, v_ring, offset,
                                   out, B, H, hd, cap, context, chunk,
                                   layer_off, scale, stream);
}

// K9 on fp8 rings: K9's operands with k_ring/v_ring [B, cap, H, hd] e4m3.
extern "C" int mt_decode_attention4_fp8(const void* q, const void* k_ring,
                                        const void* v_ring,
                                        const void* offset, void* out, int B,
                                        int H, int hd, int cap, int context,
                                        int chunk, float scale,
                                        void* stream) {
  return launch<true, false, fp8>(q, nullptr, nullptr, k_ring, v_ring,
                                  offset, out, B, H, hd, cap, context, chunk,
                                  0, scale, stream);
}
