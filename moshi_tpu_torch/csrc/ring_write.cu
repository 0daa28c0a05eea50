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
#include "common.cuh"

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
