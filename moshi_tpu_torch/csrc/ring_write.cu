// K4 and K11: in-place slot writes into KV rings, one launch a call.
//
// K4 replaces moshi_tpu/nn/pallas_ring.py ring_write_stacked (kernel body
// _write_kernel): ks/vs [L, B, H, hd] are written into k/v rings
// [L, B, cap, H, hd].  K11 replaces ring_write (kernel body _write_kernel4):
// a layer's rows [B, H, hd] go into its 4-D rings [B, cap, H, hd], k and v
// in one launch (the function ring_insert computes twice at T = 1), or
// into one ring.  Both are ring_write_kernel: (layer, session) lb = l * B +
// b writes its row into ring row (lb * cap + slot) and reads it at
// lb * stride (K4's rows are contiguous, stride = row; K11's are where the
// projection and the rope left them, each session's row contiguous but the
// sessions `stride` apart, so no copy is made first).  The Pallas calls
// aliased their outputs to the ring inputs so that only the written blocks
// moved; PyTorch tensors are mutable, so this kernel writes into the
// existing ring tensors in place and returns nothing.
//
// The slot is taken inside, from the position the caller holds (int32 or
// int64, the IDX template): the floor mod of pos[b] by cap, as
// torch.remainder and JAX's % give it; a slot already in [0, cap) is its
// own floor mod.  So nothing is launched before the write: no slot
// arithmetic, no index cast, no row copy, no row cast.
//
// Rows are converted in the write: f32 rows into a bf16 ring by
// __float2bfloat16_rn (the cvt.rn.bf16.f32 that PyTorch's .to(bf16) on the
// card and XLA's convert take), bf16 rows into a bf16 ring as their bits,
// f32 or bf16 rows into a float8_e4m3fn ring by mt_fp8_e4m3 (XLA's rule:
// NaN above 464).
//
// Grid: (ceil(vectors / threads), L * B) blocks; each thread owns one
// 16-byte vector of the ring row (8 bf16 or 16 e4m3 values) in k and the
// same one in v.  It issues the position's load and both rows' loads
// before either store, so a write is one memory round trip; every vector
// of the call is in flight at once.  Bound on the H100: bytes (the rows
// read once, the ring rows written once: 24 KB for a layer's k and v at
// the stt-1b shapes from f32 rows, 1 MB per frame for the 7B's K4), far
// below what a launch itself costs.
#include <type_traits>

#include "fp8.cuh"

namespace {

constexpr int THREADS = 256;

// The floor mod of a position by cap, in [0, cap).
template <typename IDX>
__device__ __forceinline__ long long floor_slot(IDX p, int cap) {
  const IDX r = p % static_cast<IDX>(cap);
  return r < 0 ? r + cap : r;
}

__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// One thread's piece of a row: the N values of one 16-byte ring vector,
// held as the WORDS 16-byte words they occupy in the row (S: the row's
// type, R: the ring's).
template <typename S, typename R>
struct RowVec {
  static constexpr int N = 16 / static_cast<int>(sizeof(R));
  static constexpr int WORDS = N * static_cast<int>(sizeof(S)) / 16;
  uint4 w[WORDS];

  __device__ __forceinline__ void load(const S* src) {
#pragma unroll
    for (int q = 0; q < WORDS; ++q)
      w[q] = reinterpret_cast<const uint4*>(src)[q];
  }

  // value t of the N, widened exactly to f32
  __device__ __forceinline__ float value(int t) const {
    const uint4& v = w[t / (16 / sizeof(S))];
    if constexpr (std::is_same<S, float>::value) {
      const int k = t % 4;
      return __uint_as_float(k == 0   ? v.x
                             : k == 1 ? v.y
                             : k == 2 ? v.z
                                      : v.w);
    } else {
      const int k = t % 8;
      const unsigned u = (k / 2 == 0 ? v.x : k / 2 == 1 ? v.y
                          : k / 2 == 2 ? v.z : v.w);
      return __uint_as_float(k % 2 ? u & 0xFFFF0000u : u << 16);
    }
  }

  // the 16-byte ring vector these values convert to
  __device__ __forceinline__ uint4 ring_vector() const {
    if constexpr (std::is_same<S, R>::value) {
      return w[0];
    } else if constexpr (std::is_same<R, bf16>::value) {
      unsigned o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        o[q] = bf16_bits(value(2 * q)) | (bf16_bits(value(2 * q + 1)) << 16);
      return make_uint4(o[0], o[1], o[2], o[3]);
    } else {
      unsigned o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        o[q] = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          o[q] |= static_cast<unsigned>(mt_fp8_e4m3(value(4 * q + t)))
                  << (8 * t);
      }
      return make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
};

template <typename IDX, typename S, typename R, bool PAIR>
__global__ void __launch_bounds__(THREADS)
    ring_write_kernel(R* __restrict__ kr, R* __restrict__ vr,
                      const S* __restrict__ ks, const S* __restrict__ vs,
                      long long k_stride, long long v_stride,
                      const IDX* __restrict__ pos, int B, int cap, int row) {
  using V = RowVec<S, R>;
  const int lb = blockIdx.y, b = lb % B;
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) * V::N;
  if (i >= row) return;
  const IDX p = pos[b];
  V k, v;
  k.load(ks + lb * k_stride + i);
  if (PAIR) v.load(vs + lb * v_stride + i);
  const long long dst = ((long long)lb * cap + floor_slot(p, cap)) * row + i;
  *reinterpret_cast<uint4*>(kr + dst) = k.ring_vector();
  if (PAIR) *reinterpret_cast<uint4*>(vr + dst) = v.ring_vector();
}

template <typename IDX, typename S, typename R>
int launch(void* k_ring, void* v_ring, const void* k_rows, const void* v_rows,
           long long k_stride, long long v_stride, const void* pos, int L,
           int B, int cap, int row, cudaStream_t st) {
  const int vecs = row / RowVec<S, R>::N;
  const int threads = vecs < THREADS ? (vecs + 31) / 32 * 32 : THREADS;
  const dim3 grid((vecs + threads - 1) / threads, L * B);
  R* kr = static_cast<R*>(k_ring);
  R* vr = static_cast<R*>(v_ring);
  const S* kx = static_cast<const S*>(k_rows);
  const S* vx = static_cast<const S*>(v_rows);
  const IDX* p = static_cast<const IDX*>(pos);
  if (v_ring)
    ring_write_kernel<IDX, S, R, true><<<grid, threads, 0, st>>>(
        kr, vr, kx, vx, k_stride, v_stride, p, B, cap, row);
  else
    ring_write_kernel<IDX, S, R, false><<<grid, threads, 0, st>>>(
        kr, nullptr, kx, nullptr, k_stride, 0, p, B, cap, row);
  return cudaGetLastError();
}

template <typename IDX>
int launch_types(void* k_ring, void* v_ring, const void* k_rows,
                 const void* v_rows, long long k_stride, long long v_stride,
                 const void* pos, int L, int B, int cap, int row,
                 int ring_fp8, int rows_f32, cudaStream_t st) {
  if (ring_fp8)
    return rows_f32
               ? launch<IDX, float, fp8>(k_ring, v_ring, k_rows, v_rows,
                                         k_stride, v_stride, pos, L, B, cap,
                                         row, st)
               : launch<IDX, bf16, fp8>(k_ring, v_ring, k_rows, v_rows,
                                        k_stride, v_stride, pos, L, B, cap,
                                        row, st);
  return rows_f32 ? launch<IDX, float, bf16>(k_ring, v_ring, k_rows, v_rows,
                                             k_stride, v_stride, pos, L, B,
                                             cap, row, st)
                  : launch<IDX, bf16, bf16>(k_ring, v_ring, k_rows, v_rows,
                                            k_stride, v_stride, pos, L, B,
                                            cap, row, st);
}

}  // namespace

MT_ERROR_STRING_FN

// K4 and K11.  k_ring/v_ring [L, B, cap, row] bf16 or e4m3 (ring_fp8),
// written in place; v_ring null writes k_ring alone.  k_rows/v_rows: the
// row of (layer l, session b) at (l * B + b) * stride, `row` contiguous
// f32 (rows_f32) or bf16 values.  pos [B] int32, or int64 (pos_i64): the
// slot is pos[b] floor-mod cap.  The wrappers (nn/ring.py) pass rows of a
// multiple of 8 values (bf16 ring) or 16 (fp8 ring), tensors and strides
// 16-byte aligned, and raise otherwise.
extern "C" int mt_ring_write_rows(void* k_ring, void* v_ring,
                                  const void* k_rows, const void* v_rows,
                                  long long k_stride, long long v_stride,
                                  const void* pos, int pos_i64, int L, int B,
                                  int cap, int row, int ring_fp8,
                                  int rows_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pos_i64)
    return launch_types<long long>(k_ring, v_ring, k_rows, v_rows, k_stride,
                                   v_stride, pos, L, B, cap, row, ring_fp8,
                                   rows_f32, st);
  return launch_types<int>(k_ring, v_ring, k_rows, v_rows, k_stride,
                           v_stride, pos, L, B, cap, row, ring_fp8, rows_f32,
                           st);
}
