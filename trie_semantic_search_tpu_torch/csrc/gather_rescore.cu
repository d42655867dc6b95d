// Gather-rescore of ANN candidates against the bf16 corpus.
//
// Replaces: trie_semantic_search_tpu/ops/pallas_scan.py,
// _make_gather_gang_kernel and its wrapper pallas_gather_rescore
// (:636-809, pallas_call at :796).
//
// What it computes: out[b, c] = sum_d bf16(queries[b, d]) * row[d] in f32,
// with row = corpus row idx[b, c] (clamped into [0, total)), the corpus held
// as a tuple of row segments. Every product of two bf16 values is exact in
// f32, so only the order of the f32 sum differs from the plain version.
//
// What bounds it on an H100: bytes, and scattered ones. B*C rows of D bf16
// (768 bytes at D=384) at random places in a multi-GB corpus, two flops per
// element read: the floor is B*C*D*2 bytes over the memory rate.
//
// Design: one warp per candidate row; each lane reads bf16 pairs at a
// 128-byte warp stride, and a shuffle tree sums the lanes. The TPU kernel's
// A-row aligned group DMAs and its 2 GiB segment rule (Mosaic addressing
// limits) are not needed here: a candidate's segment is found by walking
// the segment row counts.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int MAX_SEGS = 16;

struct Segments {
  const __nv_bfloat16* ptr[MAX_SEGS];
  long long rows[MAX_SEGS];
  int n;
};

__global__ void gather_rescore(const float* __restrict__ queries,
                               Segments segs,
                               const int32_t* __restrict__ idx,
                               float* __restrict__ out, int B, int C, int D,
                               long long total) {
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)B * C) return;
  const int b = (int)(warp / C);
  long long r = idx[warp];
  r = r < 0 ? 0 : (r >= total ? total - 1 : r);
  int s = 0;
  long long base = 0;
  while (s < segs.n - 1 && r >= base + segs.rows[s]) {
    base += segs.rows[s];
    ++s;
  }
  const __nv_bfloat162* row =
      reinterpret_cast<const __nv_bfloat162*>(segs.ptr[s] + (r - base) * D);
  const float2* q = reinterpret_cast<const float2*>(queries + (size_t)b * D);
  float acc = 0.0f;
  for (int d2 = lane; d2 < D / 2; d2 += 32) {
    const float2 rv = __bfloat1622float2(row[d2]);
    const float2 qv = q[d2];
    acc = fmaf(__bfloat162float(__float2bfloat16_rn(qv.x)), rv.x, acc);
    acc = fmaf(__bfloat162float(__float2bfloat16_rn(qv.y)), rv.y, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[warp] = acc;
}

}  // namespace

// seg_ptrs/seg_rows: host arrays of n_segs device pointers and row counts.
extern "C" int tss_gather_rescore(const float* queries,
                                  const long long* seg_ptrs,
                                  const long long* seg_rows, int n_segs,
                                  const int32_t* idx, float* out, int B, int C,
                                  int D, void* stream) {
  if (n_segs < 1 || n_segs > MAX_SEGS || D % 2) return (int)cudaErrorInvalidValue;
  Segments segs;
  long long total = 0;
  for (int i = 0; i < n_segs; ++i) {
    segs.ptr[i] = reinterpret_cast<const __nv_bfloat16*>(seg_ptrs[i]);
    segs.rows[i] = seg_rows[i];
    total += seg_rows[i];
  }
  segs.n = n_segs;
  const long long warps = (long long)B * C;
  if (warps == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (warps * 32 + threads - 1) / threads;
  gather_rescore<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      queries, segs, idx, out, B, C, D, total);
  return (int)cudaGetLastError();
}
