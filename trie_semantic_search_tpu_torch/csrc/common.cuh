// Shared definitions of the port's Hopper kernels.
//
// Every kernel here is launched through a plain C function (extern "C")
// that takes raw device pointers and the caller's CUDA stream and returns
// the cudaError_t of its launches; trie_semantic_search_tpu_torch/ops/
// scan_kernels.py binds them with ctypes.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Threads per block of the two int8 scans: thread l owns lane l, the lane
// family row % 128 of the TPU kernels.
constexpr int TSS_LANES = 128;

__device__ __forceinline__ float tss_neg_inf() {
  return __int_as_float(0xff800000);
}

// int8 x int8 dot of one 16-byte group: four __dp4a, exact in int32.
__device__ __forceinline__ int tss_dot16(int4 a, int4 b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  acc = __dp4a(a.w, b.w, acc);
  return acc;
}
