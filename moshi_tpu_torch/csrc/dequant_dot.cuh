// What the dequant kernels share: the block size, the format codes, a
// block-quantized weight's pointers and the shared-memory limit.  The
// device code is dequant_tile.cuh's (K2, K6, K7, K8 in dequant_matvec.cu
// and glu_matvec.cu; the megakernels K13, temporal_step.cu, and K14,
// dep_step.cu); it states the arithmetic and each output's sum order.
#pragma once

#include "common.cuh"

namespace dq {

constexpr int QK = 32;
constexpr int FMT_Q4K = 0, FMT_Q40 = 1, FMT_Q80 = 2;

// A block-quantized weight: its packed values and bf16 scales (es and em
// for q4_k; d and null for q4_0 and q8_0), rows addressed in the flat
// [rows, ...] view of the whole (stacked) weight.
struct Weight {
  const uint8_t* q;
  const bf16* s1;
  const bf16* s2;
};

// Raise a block's dynamic shared memory limit where it needs more than
// the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace dq
