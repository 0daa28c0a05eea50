// K4 and K11: in-place slot writes into KV rings.
//
// K4 replaces moshi_tpu/nn/pallas_ring.py ring_write_stacked (kernel body
// _write_kernel): ks/vs [L, B, H, hd] are written into k/v rings
// [L, B, cap, H, hd] at slot[b].  K11 replaces ring_write (kernel body
// _write_kernel4): values [B, H, hd] go into one ring [B, cap, H, hd] at
// slot[b]; it is K4's function with L = 1 and a single ring, so it runs
// the same kernel (PAIR = false) through its own C entry, mt_ring_write4.
// The Pallas calls aliased their outputs to the ring inputs so that only
// the written blocks moved; PyTorch tensors are mutable, so this kernel
// writes into the existing ring tensors in place and returns nothing.
//
// Bound on the H100: bytes (read the rows once, write the same number of
// bytes into the rings; 1 MB per frame on the 7B temporal stack, 8 KB per
// K11 call at the stt-1b shapes, where the launch itself costs more than
// the copy).  One block per (layer, session) copies its H*hd bf16 values
// with 16-byte accesses.
//
// fp8 rings (float8_e4m3fn): the Pallas wrappers cast the rows to the
// ring's dtype before the aliased copy (XLA's convert: NaN above 464);
// here the conversion is inside the write (mt_fp8_e4m3, that rule), from
// f32 rows (the stacked decode's) or bf16 rows, each thread converting 16
// consecutive values (16-byte loads, one 16-byte store; rows of a
// multiple of 16 values, as every head dim of the port gives).  It writes
// half the ring bytes of the bf16 copy (and reads f32 rows: 1.5 MB per
// 7B frame in all).
#include "fp8.cuh"

namespace {

template <bool PAIR>
__global__ void ring_write_kernel(bf16* __restrict__ kr, bf16* __restrict__ vr,
                                  const bf16* __restrict__ ks,
                                  const bf16* __restrict__ vs,
                                  const int* __restrict__ slot, int B,
                                  int cap, int row) {
  const int lb = blockIdx.x, b = lb % B;
  const long long src = (long long)lb * row;
  const long long dst = ((long long)lb * cap + slot[b]) * row;
  if (row % 8 == 0) {  // 16-byte vectors
    const uint4* k4 = reinterpret_cast<const uint4*>(ks + src);
    uint4* kd = reinterpret_cast<uint4*>(kr + dst);
    for (int i = threadIdx.x; i < row / 8; i += blockDim.x) {
      kd[i] = k4[i];
      if (PAIR)
        reinterpret_cast<uint4*>(vr + dst)[i] =
            reinterpret_cast<const uint4*>(vs + src)[i];
    }
  } else {
    for (int i = threadIdx.x; i < row; i += blockDim.x) {
      kr[dst + i] = ks[src + i];
      if (PAIR) vr[dst + i] = vs[src + i];
    }
  }
}

// 16 consecutive row values, read with 16-byte loads (src 16-value
// aligned: the caller's row is a multiple of 16).
__device__ __forceinline__ void load16(const float* src, float* f) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(src)[q];
    f[4 * q] = v.x;
    f[4 * q + 1] = v.y;
    f[4 * q + 2] = v.z;
    f[4 * q + 3] = v.w;
  }
}
__device__ __forceinline__ void load16(const bf16* src, float* f) {
  RingElem<bf16>::widen(reinterpret_cast<const uint4*>(src)[0], f);
  RingElem<bf16>::widen(reinterpret_cast<const uint4*>(src)[1], f + 8);
}

// 16 row values converted into one 16-byte store.
template <typename S>
__device__ __forceinline__ void convert16(fp8* dst, const S* src) {
  float f[16];
  load16(src, f);
  union {
    uint4 v;
    fp8 e[16];
  } out;
#pragma unroll
  for (int t = 0; t < 16; ++t) out.e[t] = mt_fp8_e4m3(f[t]);
  *reinterpret_cast<uint4*>(dst) = out.v;
}

// One block per (layer, session), 16 values a thread: the wrappers
// (nn/ring.py) pass rows of a multiple of 16 values on 16-byte aligned
// tensors and raise otherwise.
template <typename S, bool PAIR>
__global__ void ring_write_fp8_kernel(fp8* __restrict__ kr,
                                      fp8* __restrict__ vr,
                                      const S* __restrict__ ks,
                                      const S* __restrict__ vs,
                                      const int* __restrict__ slot, int B,
                                      int cap, int row) {
  const int lb = blockIdx.x, b = lb % B;
  const long long src = (long long)lb * row;
  const long long dst = ((long long)lb * cap + slot[b]) * row;
  for (int i = threadIdx.x * 16; i < row; i += blockDim.x * 16) {
    convert16(kr + dst + i, ks + src + i);
    if (PAIR) convert16(vr + dst + i, vs + src + i);
  }
}

template <bool PAIR>
int launch_fp8(void* k_ring, void* v_ring, const void* ks, const void* vs,
               const void* slot, int blocks, int B, int cap, int row,
               int src_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fp8* kr = static_cast<fp8*>(k_ring);
  fp8* vr = static_cast<fp8*>(v_ring);
  const int* s = static_cast<const int*>(slot);
  if (src_bf16)
    ring_write_fp8_kernel<bf16, PAIR><<<blocks, 256, 0, st>>>(
        kr, vr, static_cast<const bf16*>(ks), static_cast<const bf16*>(vs),
        s, B, cap, row);
  else
    ring_write_fp8_kernel<float, PAIR><<<blocks, 256, 0, st>>>(
        kr, vr, static_cast<const float*>(ks), static_cast<const float*>(vs),
        s, B, cap, row);
  return cudaGetLastError();
}

}  // namespace

MT_ERROR_STRING_FN

// K4: k_ring/v_ring [L, B, cap, H*hd] bf16 (written in place); ks/vs
// [L, B, H*hd] bf16; slot [B] int32 on the device, each in [0, cap).
extern "C" int mt_ring_write(void* k_ring, void* v_ring, const void* ks,
                             const void* vs, const void* slot, int L, int B,
                             int cap, int row, void* stream) {
  ring_write_kernel<true>
      <<<L * B, 256, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<bf16*>(k_ring), static_cast<bf16*>(v_ring),
          static_cast<const bf16*>(ks), static_cast<const bf16*>(vs),
          static_cast<const int*>(slot), B, cap, row);
  return cudaGetLastError();
}

// K11: ring [B, cap, H*hd] bf16 (written in place); values [B, H*hd] bf16;
// slot [B] int32 on the device, each in [0, cap).
extern "C" int mt_ring_write4(void* ring, const void* values,
                              const void* slot, int B, int cap, int row,
                              void* stream) {
  ring_write_kernel<false>
      <<<B, 256, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<bf16*>(ring), nullptr,
          static_cast<const bf16*>(values), nullptr,
          static_cast<const int*>(slot), B, cap, row);
  return cudaGetLastError();
}

// K4 on fp8 rings: k_ring/v_ring [L, B, cap, H*hd] e4m3 (written in
// place); ks/vs [L, B, H*hd] f32 (src_bf16 = 0) or bf16 (1); slot [B]
// int32 on the device, each in [0, cap).
extern "C" int mt_ring_write_fp8(void* k_ring, void* v_ring, const void* ks,
                                 const void* vs, const void* slot, int L,
                                 int B, int cap, int row, int src_bf16,
                                 void* stream) {
  return launch_fp8<true>(k_ring, v_ring, ks, vs, slot, L * B, B, cap, row,
                          src_bf16, stream);
}

// K11 on an fp8 ring: ring [B, cap, H*hd] e4m3 (written in place); values
// [B, H*hd] f32 (src_bf16 = 0) or bf16 (1); slot [B] int32 on the device.
extern "C" int mt_ring_write4_fp8(void* ring, const void* values,
                                  const void* slot, int B, int cap, int row,
                                  int src_bf16, void* stream) {
  return launch_fp8<false>(ring, nullptr, values, nullptr, slot, B, B, cap,
                           row, src_bf16, stream);
}
