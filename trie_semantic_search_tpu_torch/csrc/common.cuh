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

// A 1-D TMA box into shared memory, its bytes counted on `bar`.
__device__ __forceinline__ void tss_tma_load_1d(uint32_t dst, const CUtensorMap* map,
                                                uint32_t bar, int x) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2}], [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(bar)
      : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed (the
// loop inside the asm, so the compiler sees no divergent branch).
__device__ __forceinline__ void tss_mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma: int8 products on the tensor cores (m64n64k32 .s32.s8.s8), both
// operands K-major in shared memory in the 128B swizzle layout TMA writes
// ---------------------------------------------------------------------------

// Shared-memory descriptor of a K-major operand in the 128B swizzle layout:
// rows of 128 bytes, 8-row groups 1024 bytes apart. Advancing the start
// address by 32 bytes steps one k32 slice along K.
__device__ __forceinline__ uint64_t tss_sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Named barriers (id 0 is __syncthreads).
__device__ __forceinline__ void tss_named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void tss_named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void tss_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void tss_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void tss_wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving accumulator accesses across the
// asynchronous products.
__device__ __forceinline__ void tss_fence_regs(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 32] . B[64 x 32]^T, int8 operands in shared
// memory, int32 accumulators; `accumulate` = 0 overwrites D.
__device__ __forceinline__ void tss_mma_64x64x32(int (&d)[32], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// One 64 x 64 product over ceil(D / 32) k32 steps into `acc`, committed
// (the caller waits): A's 64 rows at `a`, B's 64 rows at `b`, each split
// along K into 128-byte boxes A_BOX and B_BOX bytes apart.
template <int A_BOX, int B_BOX>
__device__ __forceinline__ void tss_wgmma_issue(int (&acc)[32], uint32_t a, uint32_t b,
                                                int ksteps) {
  tss_wgmma_fence();
  tss_fence_regs(acc);
  for (int k = 0; k < ksteps; ++k) {
    const uint32_t in_box = (k & 3) * 32;
    tss_mma_64x64x32(acc, tss_sw128_desc(a + (k >> 2) * A_BOX + in_box),
                     tss_sw128_desc(b + (k >> 2) * B_BOX + in_box), k > 0);
  }
  tss_wgmma_commit();
}

// The scorers' half of a hand-off through NBUF score buffers of BUF_WORDS
// words (named barriers bar..bar+NBUF-1: written, bar+NBUF..bar+2 NBUF-1:
// read, each over THREADS scorers and readers). Once the readers have read the step that
// used buffer it % NBUF before, warp `warp` of the scorers writes its 16
// rows of the raw 64 x 64 int32 tile (rows 16 warp + lane / 4 and 8 more,
// SROW words apart; columns 8 j + 2 (lane % 4) and the next) and the
// scorers copy `col_bytes` bytes of `cols` behind the ROWS rows of
// products, 8 bytes a thread; then the buffer is signalled written.
template <int NBUF, int SROW, int BUF_WORDS, int ROWS, int THREADS>
__device__ __forceinline__ void tss_dump_step(const int (&acc)[32], int* __restrict__ sbuf,
                                              const unsigned char* cols, int col_bytes, int it,
                                              int warp, int lane, int bar = 1) {
  if (it >= NBUF) tss_named_bar_sync(bar + NBUF + it % NBUF, THREADS);
  int* buf = sbuf + (it % NBUF) * BUF_WORDS;
  int* out = buf + (16 * warp + lane / 4) * SROW + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<int2*>(out + 8 * h * SROW + 8 * j) =
          make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  const int t = 32 * warp + lane;
  if (t * 8 < col_bytes)
    reinterpret_cast<int2*>(buf + ROWS * SROW)[t] = reinterpret_cast<const int2*>(cols)[t];
  tss_named_bar_arrive(bar + it % NBUF, THREADS);
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
