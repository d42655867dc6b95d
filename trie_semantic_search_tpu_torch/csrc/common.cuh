// Shared definitions of the port's Hopper kernels.
//
// Every kernel here is launched through a plain C function (extern "C")
// that takes raw device pointers and the caller's CUDA stream and returns
// the cudaError_t of its launches; trie_semantic_search_tpu_torch/ops/
// scan_kernels.py binds them with ctypes.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (header only; no libcuda link)
#include <cuda_runtime.h>

#include <cstdint>

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

// ---------------------------------------------------------------------------
// PTX helpers: shared addresses, mbarriers, TMA copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t tss_smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void tss_mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void tss_mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tss_mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// A TMA box into shared memory, its bytes counted on `bar` (coordinates
// innermost first, in elements).
__device__ __forceinline__ void tss_tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                                uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------------------
// TMA tensor maps (host side)
// ---------------------------------------------------------------------------

using TssEncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                    const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                    const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                    CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
inline TssEncodeTiled tss_encode_tiled() {
  static TssEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<TssEncodeTiled>(p);
  }
  return fn;
}

// A tensor map: `rank` dims innermost first, strides (bytes) of dims 1..,
// box in elements; zeros past every edge.
inline bool tss_make_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* ptr,
                         const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                         CUtensorMapSwizzle swizzle) {
  TssEncodeTiled fn = tss_encode_tiled();
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn != nullptr &&
         fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
