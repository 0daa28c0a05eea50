// K12: K1's q4_k matvec at one activation row, split over K in segments.
//
// Replaces moshi_tpu/quant/pallas_matmul_int8.py qmatmul_i8's two opt-in
// forms for packed q4_k weights at m = 1 with more than 128 blocks and
// K/2 a multiple of 512 (the 7B temporal linear_out, K = 11264):
//   the k-segment form (MOSHI_TPU_KSEG=1; _mk_kernel_kseg, _prep_kseg),
//   entry mt_int8_kseg, and the split-spread form
//   (MOSHI_TPU_SPLIT_SPREAD=1; _mk_kernel_split, _prep_pair), entry
//   mt_int8_split.
//
// The function is K1's (int8_matvec.cu): the row x quantized per 32-block
// (the same prep kernel), P[o,b] the integer dot of weight row o with xq
// over block b, and per block the term es[o,b]*(dx[b]*P[o,b]) - em[o,b]*xs[b].
// The planar packing puts lo block b and hi block K/64 + b in the same
// packed bytes, so segment s, packed columns [s*2048, (s+1)*2048), owns
// 64 lo and 64 hi blocks (128 lanes of the TPU kernels' seg-major order;
// the last segment may be short) and every packed byte belongs to one
// segment.  The two forms differ only in the order of the f32 sum:
//   k-segment: each segment's terms summed, then the segments added in
//     order into 0: y = ((0 + y_0) + y_1) + ...;
//   split-spread: one sum over all of the row's terms at once.
//
// Bound on the H100: bytes, as K1 (the packed nibbles and the bf16 es/em
// once: 28.8 MB per 7B linear_out, 8.6 us at 3.35 TB/s).  Design: a
// split-K matvec.  One warp per (output row, segment) forms the segment's
// block dots with __dp4a on 16-byte loads, as K1's RowWalk does, and its
// terms; a block holds ROWS rows times all their segments, so the
// segments of a row meet in shared memory and no second launch folds
// them.  The k-segment form warp-sums each segment and one thread per row
// adds the segments in order; the split-spread form adds each lane's
// segment partials lane by lane and warp-sums the row once.  At K = 11264
// that is 3 warps per row, 3x K1's, each with a third of the row.  The
// TPU kernels gathered es/em into seg-major order outside the kernel;
// here each lane reads its blocks' scales in place, [O, K/32], as K1 does.
#include "int8_dot.cuh"

namespace {

using mt_i8::QK;

constexpr int SEG_COLS = 2048;  // packed columns per segment (128 blocks)
constexpr int ROWS = 4;         // output rows per block
constexpr int MAX_SEGS = 8;     // ROWS * MAX_SEGS warps = 1024 threads

template <bool KSEG>
__global__ void split_kernel(const uint8_t* __restrict__ q,
                             const bf16* __restrict__ es,
                             const bf16* __restrict__ em,
                             const int8_t* __restrict__ xq,
                             const float* __restrict__ dx,
                             const float* __restrict__ xs,
                             float* __restrict__ y, int O, int K, int nsegs,
                             long long row0) {
  __shared__ float part[ROWS][MAX_SEGS][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = warp / nsegs, s = warp % nsegs;
  const int o = blockIdx.x * ROWS + r;
  const int K2 = K / 2, nb = K / QK;
  float acc = 0.f;  // the terms of this lane's blocks (even lanes)
  if (o < O) {
    const long long row = row0 + o;
    const uint8_t* qrow = q + row * K2;
    const bf16* esr = es + row * nb;
    const bf16* emr = em + row * nb;
    const int c_end = min((s + 1) * SEG_COLS, K2);  // K2 % 512 == 0
#pragma unroll 4
    for (int base = s * SEG_COLS; base < c_end; base += 512) {
      const int c = base + lane * 16;
      const int bl = c / QK, bh = (K2 + c) / QK;
      const uint4 w = *reinterpret_cast<const uint4*>(qrow + c);
      const int4 al = *reinterpret_cast<const int4*>(xq + c);
      const int4 ah = *reinterpret_cast<const int4*>(xq + K2 + c);
      int plo = 0, phi = 0;
      plo = mt_i8::dp4a_nibbles(w.x, 0, al.x, plo);
      plo = mt_i8::dp4a_nibbles(w.y, 0, al.y, plo);
      plo = mt_i8::dp4a_nibbles(w.z, 0, al.z, plo);
      plo = mt_i8::dp4a_nibbles(w.w, 0, al.w, plo);
      phi = mt_i8::dp4a_nibbles(w.x, 4, ah.x, phi);
      phi = mt_i8::dp4a_nibbles(w.y, 4, ah.y, phi);
      phi = mt_i8::dp4a_nibbles(w.z, 4, ah.z, phi);
      phi = mt_i8::dp4a_nibbles(w.w, 4, ah.w, phi);
      // lanes 2i and 2i+1 share a 32-block; the even one takes its terms
      plo += __shfl_xor_sync(MT_FULL_MASK, plo, 1);
      phi += __shfl_xor_sync(MT_FULL_MASK, phi, 1);
      if ((lane & 1) == 0) {
        acc += __bfloat162float(esr[bl]) * ((float)plo * dx[bl]) -
               __bfloat162float(emr[bl]) * xs[bl];
        acc += __bfloat162float(esr[bh]) * ((float)phi * dx[bh]) -
               __bfloat162float(emr[bh]) * xs[bh];
      }
    }
  }
  if (KSEG) {
    const float ys = mt_warp_sum(acc);
    if (lane == 0) part[r][s][0] = ys;
  } else {
    part[r][s][lane] = acc;
  }
  __syncthreads();
  if (KSEG) {
    if (threadIdx.x < ROWS && blockIdx.x * ROWS + threadIdx.x < O) {
      float v = 0.f;
      for (int t = 0; t < nsegs; ++t) v += part[threadIdx.x][t][0];
      y[blockIdx.x * ROWS + threadIdx.x] = v;
    }
  } else if (s == 0 && o < O) {
    float v = part[r][0][lane];
    for (int t = 1; t < nsegs; ++t) v += part[r][t][lane];
    v = mt_warp_sum(v);
    if (lane == 0) y[o] = v;
  }
}

template <bool KSEG>
int run(const void* x, int x_bf16, const void* alpha, int alpha_bf16, int K,
        void* xq, void* dx, void* xs, const void* q, const void* es,
        const void* em, void* y, int O, long long row0, void* stream,
        int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  const int K2 = K / 2;
  const int nsegs = (K2 + SEG_COLS - 1) / SEG_COLS;
  if (K % QK || K2 % 512 || nsegs < 1 || nsegs > MAX_SEGS || O < 1)
    return cudaErrorInvalidValue;
  mt_i8::prep_kernel<<<1, 1024, 0, st>>>(x, x_bf16, alpha, alpha_bf16, K,
                                         static_cast<int8_t*>(xq),
                                         static_cast<float*>(dx),
                                         static_cast<float*>(xs));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  *launched = 1;
  const dim3 grid((O + ROWS - 1) / ROWS), block(32 * ROWS * nsegs);
  split_kernel<KSEG><<<grid, block, 0, st>>>(
      static_cast<const uint8_t*>(q), static_cast<const bf16*>(es),
      static_cast<const bf16*>(em), static_cast<const int8_t*>(xq),
      static_cast<const float*>(dx), static_cast<const float*>(xs),
      static_cast<float*>(y), O, K, nsegs, row0);
  err = cudaGetLastError();
  if (err == cudaSuccess) *launched = 2;
  return err;
}

}  // namespace

MT_ERROR_STRING_FN

// x [1, K] (f32 or bf16), alpha [K] or null; scratch xq [K] i8, dx/xs
// [K/32] f32; q [.., O, K/2] planar q4_k nibbles and es/em [.., O, K/32]
// bf16, the whole (stacked) weight; y [O] f32; row0 the first row of the
// selected layer.  *launched receives the number of kernels launched (2
// on success: the prep, then the split matvec).
extern "C" int mt_int8_kseg(const void* x, int x_bf16, const void* alpha,
                            int alpha_bf16, int K, void* xq, void* dx,
                            void* xs, const void* q, const void* es,
                            const void* em, void* y, int O, long long row0,
                            void* stream, int* launched) {
  return run<true>(x, x_bf16, alpha, alpha_bf16, K, xq, dx, xs, q, es, em, y,
                   O, row0, stream, launched);
}

// The split-spread form: the same operands.
extern "C" int mt_int8_split(const void* x, int x_bf16, const void* alpha,
                             int alpha_bf16, int K, void* xq, void* dx,
                             void* xs, const void* q, const void* es,
                             const void* em, void* y, int O, long long row0,
                             void* stream, int* launched) {
  return run<false>(x, x_bf16, alpha, alpha_bf16, K, xq, dx, xs, q, es, em,
                    y, O, row0, stream, launched);
}
