// K4: in-place slot write into stacked KV rings.
//
// Replaces moshi_tpu/nn/pallas_ring.py ring_write_stacked (kernel body
// _write_kernel): ks/vs [L, B, H, hd] are written into k/v rings
// [L, B, cap, H, hd] at slot[b].  The Pallas call aliased its outputs to
// the ring inputs so that only the written blocks moved; PyTorch tensors
// are mutable, so this kernel writes into the existing ring tensors in
// place and returns nothing.
//
// Bound on the H100: bytes (read ks/vs once, write the same number of
// bytes into the rings; 1 MB per frame on the 7B temporal stack).  One
// block per (layer, session) copies its H*hd bf16 values with 16-byte
// accesses.
#include "common.cuh"

namespace {

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
    const uint4* v4 = reinterpret_cast<const uint4*>(vs + src);
    uint4* kd = reinterpret_cast<uint4*>(kr + dst);
    uint4* vd = reinterpret_cast<uint4*>(vr + dst);
    for (int i = threadIdx.x; i < row / 8; i += blockDim.x) {
      kd[i] = k4[i];
      vd[i] = v4[i];
    }
  } else {
    for (int i = threadIdx.x; i < row; i += blockDim.x) {
      kr[dst + i] = ks[src + i];
      vr[dst + i] = vs[src + i];
    }
  }
}

}  // namespace

MT_ERROR_STRING_FN

// k_ring/v_ring [L, B, cap, H*hd] bf16 (written in place); ks/vs
// [L, B, H*hd] bf16; slot [B] int32 on the device, each in [0, cap).
extern "C" int mt_ring_write(void* k_ring, void* v_ring, const void* ks,
                             const void* vs, const void* slot, int L, int B,
                             int cap, int row, void* stream) {
  ring_write_kernel<<<L * B, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<bf16*>(k_ring), static_cast<bf16*>(v_ring),
      static_cast<const bf16*>(ks), static_cast<const bf16*>(vs),
      static_cast<const int*>(slot), B, cap, row);
  return cudaGetLastError();
}
