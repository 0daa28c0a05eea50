// The int8-activation pieces shared by K1 (int8_matvec.cu), K5
// (attn_ffn_fused.cu) and K12 (split_matvec.cu): the per-32-block
// activation quantization, staged in shared memory by each block, and the
// integer dots of weight rows with it, scales applied per block.
//
// Weights are planar-packed nibbles (q4_k, q4_0: byte j of a row holds
// w[j] in its low and w[j+K/2] in its high nibble, unsigned) or natural
// int8 (q8_0; and q4_k / q4_0 in unpacked storage, PACKED false: byte j
// holds w[j], q4_k 0..15, q4_0 signed with its -8 zero point folded in).
// Scales are bf16 [rows, K/32] (es/em for q4_k, d otherwise).
#pragma once

#include "common.cuh"

namespace mt_i8 {

constexpr int QK = 32;
constexpr int FMT_Q4K = 0, FMT_Q40 = 1, FMT_Q80 = 2;

__device__ __forceinline__ int dp4a_nibbles(unsigned w, int shift, int a,
                                            int acc) {
  return __dp4a((int)((w >> shift) & 0x0F0F0F0Fu), a, acc);
}

// QB 32-blocks of the activation at once, one element of each per lane
// of a warp (blocks b0 .. b0 + QB - 1; those at nb or beyond are left
// alone), each into xq, dx and xs: the block scale dx = amax * (1/127)
// (1 when amax is 0; the product, not the quotient, as XLA computes the
// JAX kernel's amax / 127), xq = rint(v/dx) (divide, then round half to
// even), and xs = dx * sum(xq) of the QUANTIZED values.  The QB blocks'
// shuffle chains are interleaved (amax and the integer sum are exact
// whatever the order).
template <int QB>
__device__ __forceinline__ void quant_blocks(const float (&v)[QB], int b0,
                                             int nb, int lane, int8_t* xq,
                                             float* dx, float* xs) {
  float amax[QB], d[QB];
  int q[QB];
#pragma unroll
  for (int j = 0; j < QB; ++j) amax[j] = fabsf(v[j]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < QB; ++j)
      amax[j] = fmaxf(amax[j], __shfl_xor_sync(MT_FULL_MASK, amax[j], o));
#pragma unroll
  for (int j = 0; j < QB; ++j) {
    d[j] = amax[j] > 0.f ? amax[j] * (1.f / 127.f) : 1.f;
    q[j] = __float2int_rn(v[j] / d[j]);
    if (b0 + j < nb) xq[(b0 + j) * QK + lane] = (int8_t)q[j];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < QB; ++j) q[j] += __shfl_xor_sync(MT_FULL_MASK, q[j], o);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < QB; ++j) {
      if (b0 + j < nb) {
        dx[b0 + j] = d[j];
        xs[b0 + j] = (float)q[j] * d[j];
      }
    }
  }
}

// 32-blocks a warp quantizes at once in the staging below.
constexpr int QBLOCKS = 4;

// src [K] (f32 or bf16, in global memory) into dst [K] f32 in shared
// memory by the whole block, 16 bytes a load where src is 16-byte aligned
// (K a multiple of 8); through L2 (src may have been written by other SMs
// in this launch).  No barrier.
__device__ __forceinline__ void load_row(const void* __restrict__ src,
                                         int is_bf16, int K, float* dst) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    if (is_bf16) {
      const uint4* s = static_cast<const uint4*>(src);
      for (int j = threadIdx.x; j < K / 8; j += blockDim.x) {
        const uint4 u = __ldcg(s + j);
        const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[8 * j + e] = __bfloat162float(h[e]);
      }
    } else {
      const float4* s = static_cast<const float4*>(src);
      for (int j = threadIdx.x; j < K / 4; j += blockDim.x)
        reinterpret_cast<float4*>(dst)[j] = __ldcg(s + j);
    }
  } else {
    for (int i = threadIdx.x; i < K; i += blockDim.x)
      dst[i] = is_bf16 ? __bfloat162float(static_cast<const bf16*>(src)[i])
                       : __ldcg(static_cast<const float*>(src) + i);
  }
}

// v [K] f32 in shared memory (times r and a [K], also in shared memory,
// where a is given: (v * r) * a) quantized per 32-block into xq, dx, xs
// by the whole block, QBLOCKS blocks a warp at a time.  No barrier.
__device__ __forceinline__ void quant_row(const float* v, float r,
                                          const float* a, int K, int8_t* xq,
                                          float* dx, float* xs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nb = K / QK;
  for (int b0 = warp * QBLOCKS; b0 < nb; b0 += nwarps * QBLOCKS) {
    float vals[QBLOCKS];
#pragma unroll
    for (int j = 0; j < QBLOCKS; ++j) {
      const int i = (b0 + j) * QK + lane;
      vals[j] = 0.f;
      if (b0 + j < nb) vals[j] = a != nullptr ? v[i] * r * a[i] : v[i];
    }
    quant_blocks<QBLOCKS>(vals, b0, nb, lane, xq, dx, xs);
  }
}

// The activation rows of K1, staged in shared memory by a whole block:
// row r of x [M, K] (f32 or bf16), optionally rms-normed with alpha (eps
// 1e-8), quantized per 32-block into xq [M, K] (16-byte aligned), dx and
// xs [M, K/32].  Each row is first copied to xf [K] f32 in shared memory;
// the caller has already issued row 0's copy (load_row) and, where alpha
// is given, alpha's into af [K] f32, so that they are in flight ahead of
// anything else it issues.  The norm's sum takes one order whatever the
// block size (a multiple of 32 dividing 1024): thread t plays threads t,
// t + blockDim.x, ... of 1024, each striding K by 1024, and the 32 warp
// sums are added by one warp sum; so xq, dx and xs have the same bits in
// every block and every kernel that stages them.  Ends with a
// __syncthreads.
__device__ __forceinline__ void stage_rows(
    const void* __restrict__ x, int x_bf16, const void* __restrict__ alpha,
    int alpha_bf16, int K, int M, int8_t* xq, float* dx, float* xs,
    float* xf, float* af, float* red) {
  const int lane = threadIdx.x & 31;
  const int nb = K / QK;
  for (int row = 0; row < M; ++row) {
    if (row > 0)
      load_row(static_cast<const char*>(x) +
                   (size_t)row * K * (x_bf16 ? sizeof(bf16) : sizeof(float)),
               x_bf16, K, xf);
    __syncthreads();
    float r = 1.f;
    if (alpha != nullptr) {
      for (int vt = threadIdx.x; vt < 1024; vt += blockDim.x) {
        float acc = 0.f;
        for (int i = vt; i < K; i += 1024) {
          const float v = xf[i];
          acc += v * v;
        }
        acc = mt_warp_sum(acc);
        if (lane == 0) red[vt >> 5] = acc;
      }
      __syncthreads();
      const float acc = mt_warp_sum(red[lane]);
      r = 1.f / sqrtf(acc / (float)K + 1e-8f);
    }
    quant_row(xf, r, alpha != nullptr ? af : nullptr, K,
              xq + (size_t)row * K, dx + row * nb, xs + row * nb);
    __syncthreads();  // xf and red are written again for the next row
  }
}

// Bytes of one weight row of K values: K / 2 for packed nibbles, K for
// int8 values.
template <int FMT, bool PACKED>
__host__ __device__ constexpr long long row_bytes(int K) {
  return (FMT == FMT_Q80 || !PACKED) ? K : K / 2;
}

// 16-byte weight loads a lane issues for each weight row of a group at a
// time (a chunk): the packed and q8_0 walks take one a step, unpacked
// 4-bit storage two (the low and the high half's values).
constexpr int CHUNK_LOADS = 4;

constexpr int MAXM = 8;

// The outputs [0, n) in groups of `size`, dealt to warp gw of nw in turn:
// the warp's group j starts at output (j * nw + gw) * size, so that at
// each step the warps read neighbouring rows.
struct Deal {
  long long gw, nw;
  int size, n;
  __device__ int groups() const {
    const long long total = (n + size - 1) / size;
    return gw < total ? (int)((total - gw + nw - 1) / nw) : 0;
  }
  __device__ int first(int j) const { return (int)((j * nw + gw) * size); }
  __device__ int count(int j) const {
    const int o = first(j);
    return n - o < size ? n - o : size;
  }
};

// The dots of groups of up to NR weight rows of one weight (q, s1, s2 with
// nb = K/32 bf16 scales a row) with MR quantized activation rows at once
// (xq/dx/xs in shared memory, as stage_rows leaves them; row i at
// xq + i*K, dx/xs + i*K/32), scales applied per 32-block:
//
//   sum_b  es[b] * dx[b] * P[b]  -  em[b] * xs[b]     (q4_k, either storage)
//   sum_b  d[b] * (dx[b] * P[b]  -  8 * xs[b])        (q4_0 packed)
//   sum_b  d[b] * dx[b] * P[b]                        (q8_0, q4_0 unpacked)
//
// with P[b] the integer dot over block b.  One warp walks a sequence of
// units, a unit being one chunk (CHUNK_LOADS 16-byte loads a lane) of
// every row of a group: `issue` starts a unit's loads into registers (and,
// at a group's first chunk, copies the group's scales 16 bytes at a time
// into the warp's staging area `sc`, 2 * nb bf16 a row: s1, then s2), and
// `consume` runs its steps, as row by row before: a 16-byte load per lane
// (32 nibbles, or 16 int8 values), __dp4a on nibble words masked to
// 0x0F0F0F0F (or on the int8 words), the per-block partial finished by
// one shuffle between the two lanes that share a 32-block, whose even lane
// then adds the block's scaled terms, in block order, with the same
// expressions.  `walk` keeps the next unit's loads in flight while a unit
// is consumed, and hands each group's warp sums to its caller.  So each
// output is the same sum in the same order whatever NR, MR and the groups
// are.  MR is 1, or MAXM with only the first m rows computed.
template <int FMT, bool PACKED, int NR, int MR>
struct RowWalk {
  static constexpr bool FOUR = FMT != FMT_Q80;  // two halves a step
  static constexpr bool TWO = FOUR && !PACKED;  // two loads a step
  // a chunk's loads a lane: at 8 activation rows half, to leave registers
  // for the rows' sums
  static constexpr int LOADS = MR == 1 ? CHUNK_LOADS : CHUNK_LOADS / 2;
  static constexpr int STEPS = TWO ? LOADS / 2 : LOADS;
  struct Buf {
    uint4 w[NR][STEPS];
    uint4 wh[NR][TWO ? STEPS : 1];
  };
  const uint8_t* __restrict__ q;
  const bf16* __restrict__ s1;
  const bf16* __restrict__ s2;
  int K, nb, span, chunks;
  long long rbytes;

  __device__ RowWalk(const uint8_t* q_, const bf16* s1_, const bf16* s2_,
                     int K_)
      : q(q_), s1(s1_), s2(s2_), K(K_), nb(K_ / QK),
        span(FOUR ? K_ / 2 : K_),
        chunks((span + STEPS * 512 - 1) / (STEPS * 512)),
        rbytes(row_bytes<FMT, PACKED>(K_)) {}

  // the staging area of group g's scales (two groups' worth alternate)
  __device__ bf16* scales(bf16* sc, int g) const {
    return sc + (size_t)(g & 1) * NR * 2 * nb;
  }

  // Copy the scales of the group of rows[0..nrows) into `sg` (16-byte
  // asynchronous copies; the caller commits them).
  __device__ __forceinline__ void copy_scales(const long long (&rows)[NR],
                                              int nrows, int lane,
                                              bf16* sg) const {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (r < nrows) {
        for (int v = lane; v < nb / 8; v += 32) {
          mt_cp_async16(sg + 2 * r * nb + v * 8, s1 + rows[r] * nb + v * 8);
          if (FMT == FMT_Q4K)
            mt_cp_async16(sg + (2 * r + 1) * nb + v * 8,
                          s2 + rows[r] * nb + v * 8);
        }
      }
    }
  }

  // One 16-byte weight load, read once: not kept in L1, L2 asked for the
  // 256-byte line pair.
  static __device__ __forceinline__ uint4 load16(const uint8_t* p) {
    uint4 r;
    asm volatile(
        "ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, "
        "[%4];"
        : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
        : "l"(p));
    return r;
  }

  // Issue the first min(units, most) units of a walk (most <= 2; unit 0
  // into a, unit 1 into b), with their scales where sc is given (else the
  // caller copies them, prime_scales).  Returns how many.  rows0/rows1,
  // n0/n1 receive their groups' rows.
  template <class RowsOf>
  __device__ __forceinline__ int prime(Buf& a, Buf& b, int most,
                                       int ngroups, RowsOf rows_of,
                                       long long (&rows0)[NR], int& n0,
                                       long long (&rows1)[NR], int& n1,
                                       int lane, bf16* sc) const {
    const int units = ngroups * chunks;
    const int primed = units < most ? units : most;
    n0 = primed > 0 ? rows_of(0, rows0) : 0;
    n1 = primed > 1 ? rows_of(1 / chunks, rows1) : 0;
    if (primed > 0)
      issue(a, rows0, n0, 0, lane, sc != nullptr ? scales(sc, 0) : nullptr);
    if (primed > 1)
      issue(b, rows1, n1, 1 % chunks, lane,
            sc != nullptr ? scales(sc, 1 / chunks) : nullptr);
    return primed;
  }
  // The scales of the primed units' groups, copied and committed (the
  // caller does this after landing: the buffer may share their memory).
  __device__ __forceinline__ void prime_scales(int primed,
                                               const long long (&rows0)[NR],
                                               int n0,
                                               const long long (&rows1)[NR],
                                               int n1, int lane,
                                               bf16* sc) const {
    if (primed > 0) copy_scales(rows0, n0, lane, scales(sc, 0));
    if (primed > 1 && chunks == 1) copy_scales(rows1, n1, lane, scales(sc, 1));
    mt_cp_async_commit();
  }

  // Start chunk c of the group of rows[0..nrows); at c == 0 also copy its
  // scales into `sg` where given.  Commits one cp.async group (empty but
  // for those scales).
  __device__ __forceinline__ void issue(Buf& b, const long long (&rows)[NR],
                                        int nrows, int c, int lane,
                                        bf16* sg) const {
    if (c == 0 && sg != nullptr) copy_scales(rows, nrows, lane, sg);
    mt_cp_async_commit();
    const int base0 = c * STEPS * 512;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
#pragma unroll
      for (int j = 0; j < STEPS; ++j) {
        const int col = base0 + j * 512 + lane * 16;
        b.w[r][j] = make_uint4(0u, 0u, 0u, 0u);
        if (TWO) b.wh[r][TWO ? j : 0] = b.w[r][j];
        if (r < nrows && col < span) {
          const uint8_t* qr = q + rows[r] * rbytes;
          b.w[r][j] = load16(qr + col);
          if (TWO) b.wh[r][TWO ? j : 0] = load16(qr + span + col);
        }
      }
    }
  }

  // The steps of chunk c into acc (its scales in `sg`, landed).
  __device__ __forceinline__ void consume(const Buf& b, int c,
                                          const int8_t* xq, const float* dx,
                                          const float* xs, int m, int lane,
                                          const bf16* sg,
                                          float (&acc)[NR][MR]) const {
    const int act_rows = MR == 1 ? 1 : m;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const bf16* sr1 = sg + 2 * r * nb;
      const bf16* sr2 = sr1 + nb;
#pragma unroll
      for (int j = 0; j < STEPS; ++j) {
        const int base = c * STEPS * 512 + j * 512;
        if (base >= span) break;   // the row's steps end here (all lanes)
        const int col = base + lane * 16;
        const bool act = col < span;
        const bool lead = act && (lane & 1) == 0;  // lanes 2i, 2i+1 share
        if (FMT == FMT_Q80) {
          const int bk = col / QK;
          const uint4 wv = b.w[r][j];
#pragma unroll
          for (int i = 0; i < MR; ++i) {
            if (i < act_rows) {
              int p = 0;
              if (act) {
                const int4 a = *reinterpret_cast<const int4*>(
                    xq + (long long)i * K + col);
                p = __dp4a((int)wv.x, a.x, p);
                p = __dp4a((int)wv.y, a.y, p);
                p = __dp4a((int)wv.z, a.z, p);
                p = __dp4a((int)wv.w, a.w, p);
              }
              p += __shfl_xor_sync(MT_FULL_MASK, p, 1);
              if (lead) {
                const float s = __bfloat162float(sr1[bk]);
                acc[r][i] += s * ((float)p * dx[i * nb + bk]);
              }
            }
          }
        } else {
          const int bl = col / QK, bh = (span + col) / QK;
          const uint4 wl = b.w[r][j];
          const uint4 wu = TWO ? b.wh[r][TWO ? j : 0] : b.w[r][j];
#pragma unroll
          for (int i = 0; i < MR; ++i) {
            if (i < act_rows) {
              int plo = 0, phi = 0;
              if (act) {
                const int8_t* xr = xq + (long long)i * K;
                const int4 al = *reinterpret_cast<const int4*>(xr + col);
                const int4 ah =
                    *reinterpret_cast<const int4*>(xr + span + col);
                if (PACKED) {
                  plo = dp4a_nibbles(wl.x, 0, al.x, plo);
                  plo = dp4a_nibbles(wl.y, 0, al.y, plo);
                  plo = dp4a_nibbles(wl.z, 0, al.z, plo);
                  plo = dp4a_nibbles(wl.w, 0, al.w, plo);
                  phi = dp4a_nibbles(wl.x, 4, ah.x, phi);
                  phi = dp4a_nibbles(wl.y, 4, ah.y, phi);
                  phi = dp4a_nibbles(wl.z, 4, ah.z, phi);
                  phi = dp4a_nibbles(wl.w, 4, ah.w, phi);
                } else {
                  plo = __dp4a((int)wl.x, al.x, plo);
                  plo = __dp4a((int)wl.y, al.y, plo);
                  plo = __dp4a((int)wl.z, al.z, plo);
                  plo = __dp4a((int)wl.w, al.w, plo);
                  phi = __dp4a((int)wu.x, ah.x, phi);
                  phi = __dp4a((int)wu.y, ah.y, phi);
                  phi = __dp4a((int)wu.z, ah.z, phi);
                  phi = __dp4a((int)wu.w, ah.w, phi);
                }
              }
              plo += __shfl_xor_sync(MT_FULL_MASK, plo, 1);
              phi += __shfl_xor_sync(MT_FULL_MASK, phi, 1);
              if (lead) {
                const float sl = __bfloat162float(sr1[bl]);
                const float sh = __bfloat162float(sr1[bh]);
                const float* dr = dx + i * nb;
                const float* sr = xs + i * nb;
                if (FMT == FMT_Q4K) {
                  const float ml = __bfloat162float(sr2[bl]);
                  const float mh = __bfloat162float(sr2[bh]);
                  acc[r][i] += sl * ((float)plo * dr[bl]) - ml * sr[bl];
                  acc[r][i] += sh * ((float)phi * dr[bh]) - mh * sr[bh];
                } else if (PACKED) {
                  acc[r][i] += sl * ((float)plo * dr[bl] - 8.f * sr[bl]);
                  acc[r][i] += sh * ((float)phi * dr[bh] - 8.f * sr[bh]);
                } else {  // the zero point is in the values
                  acc[r][i] += sl * ((float)plo * dr[bl]);
                  acc[r][i] += sh * ((float)phi * dr[bh]);
                }
              }
            }
          }
        }
      }
    }
  }

  // Walk groups [0, ngroups): rows_of(g, rows) fills group g's rows and
  // returns how many are valid; done(g, out, nrows) receives its results
  // (out[r][i]: weight row r, activation row i, warp-summed, on every
  // lane).  With CHUNKS, done(g, c, acc, nrows) receives instead each
  // chunk c's lane partials (acc[r][i], not warp-summed; the sums start
  // again at every chunk).  One unit's loads are in flight while the one
  // before it is consumed.  The caller may have issued the first `primed`
  // units (0 to 2; unit 0 into a, unit 1 into b, with their scales, all
  // committed) before staging its activation.  sc: the warp's staging
  // area for two groups' scales.
  template <bool CHUNKS = false, class RowsOf, class Done>
  __device__ __forceinline__ void walk(Buf& a, Buf& b, int primed,
                                       int ngroups, RowsOf rows_of,
                                       Done done, const int8_t* xq,
                                       const float* dx, const float* xs,
                                       int m, int lane, bf16* sc) const {
    const int units = ngroups * chunks;
    if (units == 0) return;
    long long ra[NR], rb[NR];
    int na = rows_of(0, ra);
    int nb_rows = units > 1 ? rows_of(1 / chunks, rb) : 0;
    if (primed < 1) issue(a, ra, na, 0, lane, scales(sc, 0));
    int issued = primed < 1 ? 1 : primed;   // units issued so far
    float acc[NR][MR];
    auto step = [&](const Buf& buf, int u, int n) {
      const int g = u / chunks, c = u - g * chunks;
      if (CHUNKS || c == 0) {
#pragma unroll
        for (int r = 0; r < NR; ++r)
#pragma unroll
          for (int i = 0; i < MR; ++i) acc[r][i] = 0.f;
      }
      consume(buf, c, xq, dx, xs, m, lane, scales(sc, g), acc);
      if constexpr (CHUNKS) {
        done(g, c, acc, n);
      } else if (c == chunks - 1) {
        float out[NR][MR];
#pragma unroll
        for (int r = 0; r < NR; ++r)
#pragma unroll
          for (int i = 0; i < MR; ++i)
            out[r][i] = (MR == 1 || i < m) ? mt_warp_sum(acc[r][i]) : 0.f;
        done(g, out, n);
      }
      __syncwarp();   // the scales read, before a later group's copy
    };
    // before a unit is consumed the next one is issued (if it was not
    // yet) and its scale copies may stay pending; all older ones land
    for (int u = 0; u < units; u += 2) {
      if (u + 1 < units && issued <= u + 1) {
        nb_rows = rows_of((u + 1) / chunks, rb);
        issue(b, rb, nb_rows, (u + 1) % chunks, lane,
              scales(sc, (u + 1) / chunks));
        issued = u + 2;
        mt_cp_async_wait<1>();
      } else {
        mt_cp_async_wait<0>();
      }
      __syncwarp();
      step(a, u, na);
      if (u + 1 >= units) break;
      if (u + 2 < units) {
        na = rows_of((u + 2) / chunks, ra);
        issue(a, ra, na, (u + 2) % chunks, lane,
              scales(sc, (u + 2) / chunks));
        issued = u + 3;
        mt_cp_async_wait<1>();
      } else {
        mt_cp_async_wait<0>();
      }
      __syncwarp();
      step(b, u + 1, nb_rows);
    }
  }
};

// A one-wave grid of kernel fn: the blocks an SM holds at `threads`
// threads and `smem` bytes of dynamic shared memory, with the largest
// dynamic shared memory the card allows opted into, times the SMs.
inline cudaError_t one_wave(const void* fn, int threads, size_t smem,
                            int* blocks) {
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)attr.sharedSizeBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                        smem);
  if (err == cudaSuccess && per_sm * sms < 1) err = cudaErrorInvalidValue;
  *blocks = per_sm * sms;
  return err;
}

// The C interface's format codes: 0-2 the formats (FMT_*) in their own
// storage (q4 packed), 3 and 4 q4_k and q4_0 in unpacked int8 storage.
constexpr int CODE_Q4K_I8 = 3, CODE_Q40_I8 = 4;

}  // namespace mt_i8
