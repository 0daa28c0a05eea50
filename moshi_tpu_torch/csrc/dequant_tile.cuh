// The dequant matvec's device code for the H100, shared by K2 and K6
// (dequant_matvec.cu), the dequant GLU, K7 and K8 (glu_matvec.cu), and
// the megakernels' products, K13 (temporal_step.cu) and K14 (dep_step.cu):
// stage_row and warp_rows, one staged row, its warps across a cooperative
// grid.  A block stages its group of activation rows once, in a
// lane-major tile layout, and each warp walks R weight rows at a time
// against them (the GLU: R / 2 gate rows and their R / 2 value rows).
//
// The arithmetic is that of moshi_tpu/quant/pallas_matmul.py's
// f32-dequant kernel bodies (_q8_kernel, _q4_0_kernel, _q4_k_kernel and
// the GLU's _q8_dot / _q4k_dot):
//
//   xn = rms_norm(x) * alpha          (optional, eps 1e-8, f32)
//   w  = bf16( (q - 8) * d )          q4_0, unsigned planar nibbles
//      = bf16( q * es )               q4_k, minus sum_b xs[b] * em[b]
//      = bf16( q * d )                q8_0, natural int8
//   y  = sum_k bf16(xn)[k] * w[k]     products exact in f32, f32 sums
//
// with xs[b] the 32-block sums of the f32 xn (q4_k's min term).  Every
// output's f32 sums are formed in one fixed order, the port's first
// kernels', to which every redesign is held bit for bit:
//
// - the norm's sum of squares: thread t of 256 sums x[i]^2 over i = t,
//   t + 256, ... in order, then mt_block_sum's shape (one warp sum, then
//   the 8 warp sums in lanes 0-7 of one more); r = 1 / sqrt(ss / K +
//   1e-8) and xn = x * r * alpha;
// - each 32-block sum of xn by mt_warp_sum's butterfly over its lanes;
// - lane L of a warp owns the packed columns c = 16 L + 512 t of a row,
//   t ascending (the low lanes take one more step where the walked width
//   is not a multiple of 512); within one, j = 0..15 in order, 4-bit:
//   acc += x[c + j] * w_lo + x[K/2 + c + j] * w_hi, q8_0: acc += x * w;
// - q4_k's min term on even lanes, once per step, a sum of its own:
//   accmin += bsum[bl] * em_lo + bsum[bh] * em_hi;
// - then mt_warp_sum's butterfly of each, the min term subtracted last.
//
// How the code gets there: the staged rows are laid out so that the 32
// lanes' four columns of one (row, step, 4-byte word) are contiguous (one
// conflict-free LDS.64 for bf16, LDS.128 for f32), every staged word
// serves R weight rows, the min term is summed after the products or
// beside them, the warp sums are transposed (warp_sums: the same pairs,
// fewer shuffles), and a 4-bit element is dequantized as a bf16 pair:
// (0x4300 | n) is 128 + n, minus 128 (136 for q4_0) is exact, and
// mul.rn.bf16x2 by the scale is the exact product rounded once to nearest
// even, the bits of bf16((float)n * s).
#pragma once

#include <type_traits>

#include "dequant_dot.cuh"

namespace dqt {

using dq::FMT_Q40;
using dq::FMT_Q4K;
using dq::FMT_Q80;
using dq::QK;

constexpr int THREADS = 256;   // a block: the norm's reduction shape
constexpr int WARPS = THREADS / 32;
constexpr int STEP = 512;      // packed columns of one warp step
constexpr int MAXG = 8;        // activation rows one block stages

// Packed columns a warp walks per row: K/2 for the 4-bit formats (byte j
// holds columns j and K/2 + j), K for q8_0.
__host__ __device__ inline int walked(int fmt, int K) {
  return fmt == FMT_Q80 ? K : K / 2;
}

// Columns of one staged region (the walked width in whole steps); a
// 4-bit row stages two, the low and the high half.
__host__ __device__ inline int region(int fmt, int K) {
  return (walked(fmt, K) + STEP - 1) / STEP * STEP;
}

// Elements of one staged row.
__host__ __device__ inline int row_stride(int fmt, int K) {
  return (fmt == FMT_Q80 ? 1 : 2) * region(fmt, K);
}

// Dynamic shared memory of a block that stages g rows, as bf16 or, with
// xf, as the same values in f32 (which the products then read without
// unpacking).
inline size_t smem_bytes(int fmt, int g, int K, bool xf) {
  return (size_t)g * row_stride(fmt, K) * (xf ? 4 : 2) +
         (fmt == FMT_Q4K ? (size_t)g * (K / QK) * sizeof(float) : 0);
}

// A staged activation element: bf16, or its value in f32.
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void put(float* p, float v) {
  *p = __bfloat162float(__float2bfloat16_rn(v));
}

// Four staged elements (8 or 16 contiguous bytes) as f32.
__device__ __forceinline__ void get4(const bf16* p, float (&v)[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(a.x << 16);
  v[1] = __uint_as_float(a.x & 0xffff0000u);
  v[2] = __uint_as_float(a.y << 16);
  v[3] = __uint_as_float(a.y & 0xffff0000u);
}
__device__ __forceinline__ void get4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

// Where column p of a region sits: its step (p / 512), then the 4-byte
// word of the lane's 16 columns ((p / 4) % 4), then the lane
// ((p / 16) % 32), then the column within the word.
__device__ __forceinline__ int tile_pos(int p) {
  return (p & ~(STEP - 1)) | (((p >> 2) & 3) << 7) |
         (((p >> 4) & 31) << 2) | (p & 3);
}

// An activation or norm element as f32, read through the read-only
// path: f32 as it is, bf16 as its 16 bits shifted up (exactly its value).
__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const uint16_t* p) {
  return __uint_as_float((uint32_t)__ldg(p) << 16);
}

// The N sums over the warp of a lane's N values (N a power of two up to
// 32), lane l ending with sum l / (32 / N): at each xor distance o (16,
// 8, 4, 2, 1) a lane keeps half of its partials and adds its partner's
// of the same half while more than one remains, then adds its partner's
// one partial.  Every sum pairs the lanes' partials as mt_warp_sum's
// butterfly does, so it has the same bits, and 32 sums take 31 shuffles,
// not 160.
template <int N>
__device__ __forceinline__ float warp_sums(float (&v)[N]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int n = N * o / 16;   // partials left before this distance
    if (n > 1) {
      const bool upper = lane & o;
#pragma unroll
      for (int k = 0; k < N / 2; ++k) {
        if (k < n / 2) {
          const float keep = upper ? v[k + n / 2] : v[k];
          const float send = upper ? v[k] : v[k + n / 2];
          v[k] = keep + __shfl_xor_sync(MT_FULL_MASK, send, o);
        }
      }
    } else {
      v[0] += __shfl_xor_sync(MT_FULL_MASK, v[0], o);
    }
  }
  return v[0];
}

// Stage rows [m0, m0 + mg) of x [M, K] into xs [G, row_stride] (bf16,
// normalized with alpha if given, rows mg..G-1 zero) and, for q4_k, their
// 32-block sums of the f32 values into bsum [G, K/32], every row's norm
// reduced at once.  Each thread issues the loads of U of its strides (or
// 32-blocks) for all G rows before it uses any, so that a block waits for
// a few round trips to L2, not one per row and block.  red holds G * WARPS floats.  All THREADS threads
// call it; it ends with a barrier.
template <int FMT, int G, typename XT, typename AT, typename SX>
__device__ __forceinline__ void stage_t(const XT* __restrict__ x,
                                        const AT* __restrict__ alpha, int m0,
                                        int mg, int K, SX* __restrict__ xs,
                                        float* __restrict__ bsum,
                                        float* red) {
  constexpr int U = 32 / G;   // U * G = 32: one batch, 32 block sums
  const int nb = K / QK, rs = row_stride(FMT, K);
  const int half = walked(FMT, K), hoff = region(FMT, K);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // every load reads a valid address, so that none waits on a branch:
  // the rows past mg read row mg - 1, the columns past K column K - 1,
  // and both are then replaced by 0
  long long row[G];
  float r[G];
#pragma unroll
  for (int m = 0; m < G; ++m) {
    row[m] = (long long)(m0 + min(m, mg - 1)) * K;
    r[m] = 1.f;
  }
  if (alpha != nullptr) {
    float acc[G];
#pragma unroll
    for (int m = 0; m < G; ++m) acc[m] = 0.f;
    for (int i0 = threadIdx.x; i0 < K; i0 += U * THREADS) {
      float v[U][G];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * THREADS;
#pragma unroll
        for (int m = 0; m < G; ++m) {
          const float t = load_f32(x + row[m] + min(i, K - 1));
          v[u][m] = i < K && m < mg ? t : 0.f;
        }
      }

      // past K, v is 0 and adds an exact +0 to a sum that is not -0
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int m = 0; m < G; ++m) acc[m] += v[u][m] * v[u][m];
    }
#pragma unroll
    for (int m = 0; m < G; ++m) {
      const float s = mt_warp_sum(acc[m]);
      if (lane == 0) red[m * WARPS + warp] = s;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < G; ++m) {
      float s = lane < WARPS ? red[m * WARPS + lane] : 0.f;
      s = mt_warp_sum(s);
      r[m] = 1.f / sqrtf(s / (float)K + 1e-8f);
    }
  }
  for (int b0 = warp; b0 < nb; b0 += U * WARPS) {
    float v[U][G], a[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = (b0 + u * WARPS) * QK + lane;
      const bool in = i < K;
#pragma unroll
      for (int m = 0; m < G; ++m) {
        const float t = load_f32(x + row[m] + min(i, K - 1));
        v[u][m] = in && m < mg ? t : 0.f;
      }
      a[u] = alpha != nullptr ? load_f32(alpha + min(i, K - 1)) : 1.f;
    }
    float sums[32];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int b = b0 + u * WARPS, i = b * QK + lane;
      const int pos = i < half ? tile_pos(i) : hoff + tile_pos(i - half);
#pragma unroll
      for (int m = 0; m < G; ++m) {
        float vm = v[u][m];
        if (alpha != nullptr && m < mg) vm = vm * r[m] * a[u];
        if (b < nb) put(xs + m * rs + pos, vm);
        sums[u * G + m] = vm;
      }
    }
    if (FMT == FMT_Q4K) {   // lane l: the sum of block b0 + (l / G) * WARPS
      const float s = warp_sums<32>(sums);
      const int b = b0 + lane / G * WARPS;
      if (b < nb) bsum[lane % G * nb + b] = s;
    }
  }
  __syncthreads();
}

// stage_t for the activation's and alpha's element types (f32 or bf16),
// so that no load in its loops waits on a type test.
template <int FMT, int G, typename SX>
__device__ __forceinline__ void stage(const void* x, int x_bf16,
                                      const void* alpha, int alpha_bf16,
                                      int m0, int mg, int K, SX* xs,
                                      float* bsum, float* red) {
  const uint16_t* xb = static_cast<const uint16_t*>(x);
  const float* xf = static_cast<const float*>(x);
  const uint16_t* ab = static_cast<const uint16_t*>(alpha);
  const float* af = static_cast<const float*>(alpha);
  if (x_bf16 && alpha_bf16)
    stage_t<FMT, G>(xb, ab, m0, mg, K, xs, bsum, red);
  else if (x_bf16)
    stage_t<FMT, G>(xb, af, m0, mg, K, xs, bsum, red);
  else if (alpha_bf16)
    stage_t<FMT, G>(xf, ab, m0, mg, K, xs, bsum, red);
  else
    stage_t<FMT, G>(xf, af, m0, mg, K, xs, bsum, red);
}

// One warp step's weight operands for R rows: each lane's 16 packed bytes
// and the bf16 bits of its blocks' scales (d or es of the low block | of
// the high block << 16; q8_0 only the low).
template <int R>
struct Step {
  uint4 w[R];
  uint32_t s[R];
};

// Load the step at packed column c of rows row[0..R) of the flat
// [rows, ...] view of the whole (stacked) weight.
template <int FMT, int R>
__device__ __forceinline__ void load_step(Step<R>& st,
                                          const uint8_t* __restrict__ q,
                                          const uint16_t* __restrict__ s1,
                                          const long long (&row)[R], int K,
                                          int c) {
  const int nb = K / QK, n = walked(FMT, K);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    st.w[r] = __ldg(reinterpret_cast<const uint4*>(q + row[r] * n + c));
    const uint16_t* srow = s1 + row[r] * nb;
    if (FMT == FMT_Q80) {
      st.s[r] = __ldg(srow + c / QK);
    } else {
      const int bl = c / QK, bh = (n + c) / QK;
      st.s[r] = __ldg(srow + bl) | (uint32_t)__ldg(srow + bh) << 16;
    }
  }
}

__device__ __forceinline__ float bf_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float bf_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

__device__ __forceinline__ uint32_t bf2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Word w of a 4-bit row (4 packed bytes): its low nibbles, 4 columns of
// the low half, and its high nibbles, the same columns of the high half,
// each (n - bias) * scale rounded once to bf16; bias is 0x4300 (128) or
// 0x4308 (136, q4_0's zero point) as a bf16 pair, the scales bf16 pairs.
__device__ __forceinline__ void dequant_word(uint32_t w, uint32_t slo,
                                             uint32_t shi, uint32_t bias,
                                             float (&lo)[4], float (&hi)[4]) {
  const uint32_t nl = w & 0x0f0f0f0fu, nh = (w >> 4) & 0x0f0f0f0fu;
  const uint32_t l01 = bf2_mul(bf2_sub(__byte_perm(nl, 0x43u, 0x4140), bias),
                               slo);
  const uint32_t l23 = bf2_mul(bf2_sub(__byte_perm(nl, 0x43u, 0x4342), bias),
                               slo);
  const uint32_t h01 = bf2_mul(bf2_sub(__byte_perm(nh, 0x43u, 0x4140), bias),
                               shi);
  const uint32_t h23 = bf2_mul(bf2_sub(__byte_perm(nh, 0x43u, 0x4342), bias),
                               shi);
  lo[0] = bf_lo(l01);
  lo[1] = bf_hi(l01);
  lo[2] = bf_lo(l23);
  lo[3] = bf_hi(l23);
  hi[0] = bf_lo(h01);
  hi[1] = bf_hi(h01);
  hi[2] = bf_lo(h23);
  hi[3] = bf_hi(h23);
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One step of R weight rows against the G staged rows: xl points at the
// lane's first column of this step in staged row 0 (xs + 512 t + 4 L),
// xh the same in the high region; rs is the staged row stride.  The loop
// over the lane's four words stays rolled: unrolled, one step is some
// 2,400 instructions, and the kernel then ran up to twice as long on some
// calls, by which path of its staging had run before (the instruction
// cache, as far as a run can tell: the rolled loop runs every call alike
// and the slowest ones up to 45% faster).
template <int FMT, int G, int R, typename SX>
__device__ __forceinline__ void dot_step(const Step<R>& st, const SX* xl,
                                         const SX* xh, int rs,
                                         float (&acc)[R][G]) {
  if (FMT == FMT_Q80) {
#pragma unroll 1   // rolled: see the note above
    for (int wi = 0; wi < 4; ++wi) {
      float w[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const uint32_t v = word_of(st.w[r], wi);
        const float d = bf_lo(st.s[r]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[r][i] = mt_bf16_round((float)(int8_t)(v >> (8 * i)) * d);
      }
#pragma unroll
      for (int m = 0; m < G; ++m) {
        float xa[4];
        get4(xl + m * rs + wi * 128, xa);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r][m] += xa[i] * w[r][i];
      }
    }
    return;
  }
  const uint32_t bias = FMT == FMT_Q40 ? 0x43084308u : 0x43004300u;
  uint32_t slo[R], shi[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    slo[r] = __byte_perm(st.s[r], 0, 0x1010);
    shi[r] = __byte_perm(st.s[r], 0, 0x3232);
  }
#pragma unroll 1   // rolled: see the note above
  for (int wi = 0; wi < 4; ++wi) {
    float wl[R][4], wh[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
      dequant_word(word_of(st.w[r], wi), slo[r], shi[r], bias, wl[r], wh[r]);
#pragma unroll
    for (int m = 0; m < G; ++m) {
      float xa[4], xb[4];
      get4(xl + m * rs + wi * 128, xa);
      get4(xh + m * rs + wi * 128, xb);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[r][m] += xa[i] * wl[r][i] + xb[i] * wh[r][i];
    }
  }
}

// q4_k's min term of weight rows row[0..R) against the G staged rows,
// the lane's partials: on even lanes (one per 32-block), step by step,
// am[r][m] += bsum[bl] * em[bl] + bsum[bh] * em[bh].  It is summed apart
// from the products, so it runs after them.
template <int R, int G>
__device__ __forceinline__ void min_term(const uint16_t* __restrict__ s2,
                                         const long long (&row)[R], int K,
                                         const float* bsum,
                                         float (&am)[R][G]) {
  const int nb = K / QK, n = K / 2;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < G; ++m) am[r][m] = 0.f;
  if (threadIdx.x & 1) return;
  for (int c = (threadIdx.x & 31) * 16; c < n; c += STEP) {
    const int bl = c / QK, bh = (n + c) / QK;
    float elo[R], ehi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      elo[r] = bf_lo(__ldg(s2 + row[r] * nb + bl));
      ehi[r] = bf_lo(__ldg(s2 + row[r] * nb + bh));
    }
#pragma unroll
    for (int m = 0; m < G; ++m) {
      const float xsl = bsum[m * nb + bl], xsh = bsum[m * nb + bh];
#pragma unroll
      for (int r = 0; r < R; ++r) am[r][m] += xsl * elo[r] + xsh * ehi[r];
    }
  }
}


// stage_row's alpha: a pointer (f32, or bf16 as its bits, uint16_t; null
// for none), or a function of the element index.
template <typename T>
__device__ __forceinline__ bool has_alpha(const T* a) {
  return a != nullptr;
}
template <typename F>
__device__ __forceinline__ bool has_alpha(const F&) {
  return true;
}
template <typename T>
__device__ __forceinline__ float alpha_at(const T* a, int i) {
  return load_f32(a + i);
}
template <typename F>
__device__ __forceinline__ float alpha_at(const F& a, int i) {
  return a(i);
}

// One 4-bit activation row for the megakernels' products (K13,
// temporal_step.cu; K14, dep_step.cu): element i of a row of K values
// (x(i), f32) staged at its tile position in xs (row_stride(FMT_Q4K, K)
// elements; bf16, or its bf16 value in f32), its 32-block sums of the f32
// values in bsum.  The arithmetic of stage_t for one row: with alpha (see
// has_alpha), the sum of squares in the block's threads at stride
// blockDim.x by mt_block_sum, r = 1 / sqrt(ss / K + 1e-8), v * r * alpha;
// each 32-block's sum in mt_warp_sum's pairs.  Each thread reads U of its
// elements (or a warp U of its 32-blocks, with their alpha) before it uses
// any, so that the loads are in flight together (x and alpha are template
// parameters, so that no load waits on a type test), and the warp's U
// block sums are formed together (warp_sums: the same bits, fewer
// shuffles).  Every thread of the block calls it; it ends with a barrier.
template <typename X, typename A, typename SX>
__device__ __forceinline__ void stage_row(X x, A alpha, int K, SX* xs,
                                          float* bsum, float* red) {
  constexpr int U = 8;
  const int nb = K / QK, half = K / 2, hoff = region(FMT_Q4K, K);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float r = 1.f;
  if (has_alpha(alpha)) {
    float acc = 0.f;
    for (int i0 = threadIdx.x; i0 < K; i0 += U * blockDim.x) {
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * blockDim.x;
        v[u] = i < K ? x(i) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i0 + u * blockDim.x < K) acc += v[u] * v[u];
    }
    acc = mt_block_sum(acc, red);
    r = 1.f / sqrtf(acc / (float)K + 1e-8f);
  }
  for (int b0 = warp; b0 < nb; b0 += U * nwarps) {
    float v[U], av[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int b = b0 + u * nwarps;
      v[u] = b < nb ? x(b * QK + lane) : 0.f;
      av[u] = has_alpha(alpha) && b < nb ? alpha_at(alpha, b * QK + lane)
                                         : 1.f;
    }
    float sums[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int b = b0 + u * nwarps, i = b * QK + lane;
      sums[u] = 0.f;
      if (b < nb) {
        float vi = v[u];
        if (has_alpha(alpha)) vi = vi * r * av[u];
        put(xs + (i < half ? tile_pos(i) : hoff + tile_pos(i - half)), vi);
        sums[u] = vi;
      }
    }
    // lane l: the sum of block b0 + (l / (32 / U)) * nwarps
    const float s = warp_sums<U>(sums);
    const int b = b0 + lane / (32 / U) * nwarps;
    if (lane % (32 / U) == 0 && b < nb) bsum[b] = s;
  }
  __syncthreads();
}

// warp_rows' default wait before its first loads: none.
struct NoSync {
  __device__ void operator()() const {}
};

// The products of output rows [0, O) of a 4-bit weight (FMT: q4_k, or
// q4_0 with no min term; its rows row0 + o of the flat [rows, K / 2]
// view; with GLU, gate rows row0 + o and value rows row0 + O + o) against
// one row that stage_row stages (bf16, or its values in f32: SX), R
// weight rows a warp (GLU: R / 2 gate rows and their value rows), each
// output's sums in tile_kernel's order.  Warp w0 of nw (across a
// cooperative grid) takes tiles w0, w0 + nw, ...  Unlike tile_kernel, a
// lane loads q4_k's em scales with each step's weights, one step ahead,
// and adds the min term step by step beside the products (a sum of its
// own, in min_term's order), so that no pass waits on its loads alone.
// The warp loads its first tile's first step, then the block stages the
// row (stage(): every thread of the block calls it, with or without a
// tile), so that the weights' first loads overlap the staging.  With sync
// (every thread calls it too, before stage(); a grid sync, say), L2 is
// asked for every step of the warp's tiles before it and the first step
// is loaded after it, so that no register waits on a load across it.
// out(o, v, u) is called by one lane per output: v the product of row o
// (the gate's with GLU), u that of its value row (0 without GLU).
template <int R, bool GLU, int FMT = FMT_Q4K, typename SX, typename Stage,
          typename Out, typename Sync = NoSync>
__device__ __forceinline__ void warp_rows(const dq::Weight& wt,
                                          long long row0, int O, int K,
                                          const SX* xs, const float* bsum,
                                          int w0, int nw, Stage stage,
                                          Out out, Sync sync = Sync()) {
  static_assert(FMT == FMT_Q4K || FMT == FMT_Q40, "a 4-bit format");
  constexpr bool MIN = FMT == FMT_Q4K;   // the min term
  constexpr bool SPLIT = !std::is_same<Sync, NoSync>::value;
  constexpr int P = GLU ? R / 2 : R;   // outputs per tile
  const uint8_t* q = wt.q;
  const uint16_t* s1 = reinterpret_cast<const uint16_t*>(wt.s1);
  const uint16_t* s2 = reinterpret_cast<const uint16_t*>(wt.s2);
  const int lane = threadIdx.x & 31;
  const bool even = (lane & 1) == 0;   // the min term's lanes
  const int n = K / 2, nb = K / QK, rs = row_stride(FMT_Q4K, K);
  const int nsteps = (n + STEP - 1) / STEP, ntiles = (O + P - 1) / P;
  struct Ops {          // one step's operands
    Step<R> w;
    uint32_t em[R];     // em of the low block | of the high block << 16
  };
  long long rows[R];
  const auto load = [&](Ops& o, int c) {
    load_step<FMT, R>(o.w, q, s1, rows, K, c);
    if (MIN && even) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        o.em[r] = __ldg(s2 + rows[r] * nb + c / QK) |
                  (uint32_t)__ldg(s2 + rows[r] * nb + (n + c) / QK) << 16;
    }
  };
  Ops buf;   // the lane's next step
  // a tile's rows, each clamped to the last row of its own half
  const auto set_rows = [&](int tile) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      rows[r] = GLU ? row0 + (r < P ? 0 : O) + min(tile * P + r % P, O - 1)
                    : row0 + min(tile * R + r, O - 1);
  };
  // a tile's rows and its first step
  const auto start_tile = [&](int tile) {
    set_rows(tile);
    if (lane * 16 < n) load(buf, lane * 16);
  };
  int tile = w0;
  if (SPLIT) {   // L2 is asked for every step of the warp's tiles
    for (int t = tile; t < ntiles; t += nw) {
      set_rows(t);
#pragma unroll
      for (int r = 0; r < R; ++r)
        for (int c = lane * 16; c < n; c += STEP) {
          mt_prefetch_l2(q + rows[r] * n + c);
          mt_prefetch_l2(s1 + rows[r] * nb + c / QK);
          mt_prefetch_l2(s1 + rows[r] * nb + (n + c) / QK);
          if (MIN) {
            mt_prefetch_l2(s2 + rows[r] * nb + c / QK);
            mt_prefetch_l2(s2 + rows[r] * nb + (n + c) / QK);
          }
        }
    }
    sync();
  }
  if (tile < ntiles) start_tile(tile);
  stage();
  const SX* xl = xs + lane * 4;
  const SX* xh = xl + region(FMT_Q4K, K);
  for (; tile < ntiles; tile += nw) {
    float acc[R][1], am[R][1];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][0] = am[r][0] = 0.f;
    for (int t = 0; t < nsteps; ++t) {
      const int c = lane * 16 + t * STEP;
      if (c < n) {
        const Ops cur = buf;
        if (c + STEP < n) load(buf, c + STEP);
        dot_step<FMT, 1, R>(cur.w, xl + t * STEP, xh + t * STEP, rs, acc);
        if (MIN && even) {   // am += bsum[bl] * em[bl] + bsum[bh] * em[bh]
          const float xsl = bsum[c / QK], xsh = bsum[(n + c) / QK];
#pragma unroll
          for (int r = 0; r < R; ++r)
            am[r][0] += xsl * bf_lo(cur.em[r]) + xsh * bf_hi(cur.em[r]);
        }
      }
    }
    const int o0 = tile * P;
    if (tile + nw < ntiles) start_tile(tile + nw);
    // lane l holds row l / (32 / R)'s sum
    float v = warp_sums<R>(reinterpret_cast<float(&)[R]>(acc));
    if (MIN) v -= warp_sums<R>(reinterpret_cast<float(&)[R]>(am));
    constexpr int per = 32 / R;
    const int r = lane / per;
    if (GLU) {   // lane l < 16 holds gate r, lane l + 16 its value
      const float u = __shfl_down_sync(MT_FULL_MASK, v, 16);
      if (lane < 16 && lane % per == 0 && o0 + r < O) out(o0 + r, v, u);
    } else if (lane % per == 0 && o0 + r < O) {
      out(o0 + r, v, 0.f);
    }
  }
}


// The kernel and its launch.  K2 and K6 (GLU false): output o is the
// product of weight row row0 + o, of O.  K7 and K8 (GLU true): output o
// of H = O is silu(g) * v, g the product of gate row row0 + o and v of
// value row row0 + H + o.  Unnamed: each library (one per .cu) keeps its
// own instances.
namespace {

// Dynamic shared memory a block may take on sm_90: 227 KB less the
// norm's reduction slots.
constexpr size_t SMEM_MAX = 232448 - MAXG * WARPS * sizeof(float);

template <bool XF>
struct Staged {  // the staged activation's element type
  using T = bf16;
};
template <>
struct Staged<true> {
  using T = float;
};

template <int FMT, int G, int R, bool XF, bool GLU>
__global__ void __launch_bounds__(THREADS, 1)
    tile_kernel(const void* __restrict__ x, int x_bf16,
                const void* __restrict__ alpha, int alpha_bf16, int M, int K,
                const uint8_t* __restrict__ q,
                const uint16_t* __restrict__ s1,
                const uint16_t* __restrict__ s2, float* __restrict__ y, int O,
                long long row0) {
  constexpr int P = GLU ? R / 2 : R;   // outputs per tile
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[G * WARPS];
  const int rs = row_stride(FMT, K), n = walked(FMT, K);
  using SX = typename Staged<XF>::T;
  SX* xs = reinterpret_cast<SX*>(smem);
  float* bsum = reinterpret_cast<float*>(smem + (size_t)G * rs * sizeof(SX));
  const int m0 = blockIdx.y * G, mg = min(G, M - m0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nsteps = (n + STEP - 1) / STEP;
  const int ntiles = (O + P - 1) / P, stride = gridDim.x * WARPS;

  Step<R> buf;  // the weights of the lane's next step
  long long rows[R];
  // a tile's rows, each clamped to the last row of its own half (the
  // GLU's value rows are rows O..2O-1 of the layer), and its first step
  auto start_tile = [&](int tile) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      rows[r] = GLU ? row0 + (r < P ? 0 : O) + min(tile * P + r % P, O - 1)
                    : row0 + min(tile * R + r, O - 1);
    if (lane * 16 < n) load_step<FMT, R>(buf, q, s1, rows, K, lane * 16);
  };

  int tile = blockIdx.x * WARPS + warp;
  if (tile < ntiles) start_tile(tile);
  stage<FMT, G>(x, x_bf16, alpha, alpha_bf16, m0, mg, K, xs, bsum, red);
  const SX* xl = xs + lane * 4;
  const SX* xh = xl + (FMT == FMT_Q80 ? 0 : region(FMT, K));

  for (; tile < ntiles; tile += stride) {
    float acc[R][G];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int m = 0; m < G; ++m) acc[r][m] = 0.f;
    for (int t = 0; t < nsteps; ++t) {
      const int c = lane * 16 + t * STEP;
      if (c < n) {
        const Step<R> cur = buf;
        if (c + STEP < n) load_step<FMT, R>(buf, q, s1, rows, K, c + STEP);
        dot_step<FMT, G, R>(cur, xl + t * STEP, xh + t * STEP, rs, acc);
      }
    }
    const int o0 = tile * P;
    float am[R][G];
    if (FMT == FMT_Q4K) min_term<R, G>(s2, rows, K, bsum, am);
    if (tile + stride < ntiles) start_tile(tile + stride);
    // lane l holds row r's sum at staged row m, (r, m) = (j / G, j % G),
    // j = l / (32 / (R G))
    float v = warp_sums<R * G>(reinterpret_cast<float(&)[R * G]>(acc));
    if (FMT == FMT_Q4K)
      v -= warp_sums<R * G>(reinterpret_cast<float(&)[R * G]>(am));
    constexpr int per = 32 / (R * G);
    const int j = lane / per, r = j / G, m = j % G;
    if (GLU) {
      // lane l < 16 holds gate (r, m), lane l + 16 its value (r + P, m);
      // the Pallas kernel's _silu, with expf (no fast-math flag)
      const float u = __shfl_down_sync(MT_FULL_MASK, v, 16);
      if (lane < 16 && lane % per == 0 && m < mg && o0 + r < O)
        y[(long long)(m0 + m) * O + o0 + r] =
            v * (1.f / (1.f + expf(-v))) * u;
    } else if (lane % per == 0 && m < mg && o0 + r < O) {
      y[(long long)(m0 + m) * O + o0 + r] = v;
    }
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

// One call's operands (O: the output width, H for the GLU).
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

// A grid of about one wave: at most the SMs times the blocks that fit on
// one, never more than the output tiles need; times the row groups.
template <int FMT, int G, int R, bool XF, bool GLU>
cudaError_t launch(const Call& a) {
  constexpr int P = GLU ? R / 2 : R;
  const size_t smem = smem_bytes(FMT, G, a.K, XF);
  auto kernel = tile_kernel<FMT, G, R, XF, GLU>;
  cudaError_t err = dq::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int need = ((a.O + P - 1) / P + WARPS - 1) / WARPS;
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
// more than half of one wave's warps without a tile; the GLU's tiles keep
// at least one gate and one value row.  A group of 8 rows is staged in
// f32 where that fits.
template <int FMT, int G, bool XF, bool GLU>
cudaError_t launch_r(const Call& a) {
  constexpr int RB = G == 1 ? 2 : 4, RN = GLU && RB == 2 ? 2 : RB / 2;
  constexpr int PB = GLU ? RB / 2 : RB;
  if ((a.O + PB - 1) / PB >= WARPS * sm_count() / 2)
    return launch<FMT, G, RB, XF, GLU>(a);
  return launch<FMT, G, RN, XF, GLU>(a);
}

template <int FMT, int G, bool GLU>
cudaError_t launch_g(const Call& a) {
  if (G == MAXG && smem_bytes(FMT, G, a.K, true) <= SMEM_MAX)
    return launch_r<FMT, G, G == MAXG, GLU>(a);
  return launch_r<FMT, G, false, GLU>(a);
}

// Rows staged per block: 1, 4 or 8, the least that holds min(M, 8),
// smaller while its staging does not fit (the rows' groups change no
// output's arithmetic).
int group_rows(int fmt, int M, int K) {
  int g = M == 1 ? 1 : M <= 4 ? 4 : MAXG;
  while (g > 1 && smem_bytes(fmt, g, K, false) > SMEM_MAX)
    g = g == MAXG ? 4 : 1;
  return g;
}

template <int FMT, bool GLU>
cudaError_t launch_fmt(const Call& a) {
  if (a.M < 1 || a.O < 1 || a.K % QK) return cudaErrorInvalidValue;
  switch (group_rows(FMT, a.M, a.K)) {
    case 1:
      return launch_g<FMT, 1, GLU>(a);
    case 4:
      return launch_g<FMT, 4, GLU>(a);
    default:
      return launch_g<FMT, 8, GLU>(a);
  }
}

}  // namespace

}  // namespace dqt
