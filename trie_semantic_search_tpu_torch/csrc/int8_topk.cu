// Unfiltered int8 corpus scan with an exact top-k per query.
//
// Replaces: trie_semantic_search_tpu/ops/pallas_scan.py, _scan_kernel and
// its wrapper pallas_int8_topk (:73-187, pallas_call at :160), the kernel
// behind the public op fused_int8_topk (:899-911).
//
// What it computes, for every query b and corpus row r:
//   s = float(int32 dot(q8[b], corpus[r])) * q_scale[b] * row_scale[r]
// (that multiply order, each product rounded to f32), and per query the k
// best rows by (score desc, row asc), floats compared with '>' and '>=' so
// that +0.0 and -0.0 tie and the lower row wins, as in the TPU kernel's
// rounds of max -> first position -> mask out. (lax.top_k, behind
// xla_int8_topk, ranks +0.0 above -0.0 instead: the two JAX paths differ
// there, and fused_int8_topk on the accelerator returns the kernel's
// order, which this follows.) The TPU kernel writes each round's maximum,
// which is +0.0 for a zero score whenever a row at or after the selected
// one scores +0.0; the merge reproduces that from the last +0.0 row seen.
// Any N: the ragged edge of the corpus is masked here (the TPU kernel's
// N % TILE_N rule was a tiling constraint).
//
// What bounds it on an H100: bytes. At B=256 over 5,242,880 x 384 int8
// rows the corpus and its scales are 2.03 GB, read once: 0.61 ms at
// 3.35 TB/s, against 1.03e12 int8 operations (0.52 ms at 1,979 TOP/s).
// This first version runs the products as __dp4a on the CUDA cores, as
// fused_scan.cu does, so it is bound by integer issue rate, well above
// that floor; a tensor-core (wgmma int8) version is later work.
//
// Design, as the TPU kernel's: the [B, N] scores never reach device
// memory. One block of 256 threads per (8-query tile, row range): each
// thread scores one row of a 256-row chunk against the 8 queries (16-byte
// row loads, queries in shared memory), the scores go through shared
// memory, and warp w keeps query w's sorted top-k in registers (lane l
// holds positions l, l+32, l+64, l+96), inserting the chunk's rows that
// beat its k-th score in ascending row order. A second kernel merges the
// per-range lists in range order with the same insert, so equal scores
// keep the lower row. Query tiles vary fastest in the grid so that
// neighbouring blocks read the same rows out of L2.
#include "common.cuh"

namespace {

constexpr int QB = 8;              // queries per block, one warp each
constexpr int THREADS = QB * 32;   // rows per chunk, one per thread
constexpr int MAX_K = 128;         // longest list (the engine's top k bucket)
constexpr int SLOTS = MAX_K / 32;  // list positions per lane
constexpr unsigned FULL = 0xffffffffu;

// A warp's sorted list: lane l holds positions g*32 + l, g < SLOTS.
struct WarpList {
  float v[SLOTS];
  int i[SLOTS];
};

__device__ __forceinline__ void list_init(WarpList& L) {
#pragma unroll
  for (int g = 0; g < SLOTS; ++g) {
    L.v[g] = tss_neg_inf();
    L.i[g] = -1;
  }
}

// The k-th score of the list (what a candidate must beat to enter).
__device__ __forceinline__ float list_last(const WarpList& L, int k) {
  const int t = k - 1;
  float x = L.v[0];
#pragma unroll
  for (int g = 1; g < SLOTS; ++g)
    if (g == t / 32) x = L.v[g];
  return __shfl_sync(FULL, x, t % 32);
}

// Insert (s, r) after every entry scoring >= s: those came earlier, from
// lower rows, so equal scores keep the lower row. The k-th entry drops off.
__device__ __forceinline__ void list_insert(WarpList& L, int k, float s, int r) {
  const int lane = threadIdx.x & 31;
  int pos = 0;
#pragma unroll
  for (int g = 0; g < SLOTS; ++g)
    pos += __popc(__ballot_sync(FULL, g * 32 + lane < k && L.v[g] >= s));
  float pv[SLOTS];
  int pi[SLOTS];
#pragma unroll
  for (int g = 0; g < SLOTS; ++g) {
    // position t takes position t-1's entry: the lane below, or lane 31 of
    // the group below for lane 0
    float uv = __shfl_up_sync(FULL, L.v[g], 1);
    int ui = __shfl_up_sync(FULL, L.i[g], 1);
    const float wv = __shfl_sync(FULL, L.v[g > 0 ? g - 1 : 0], 31);
    const int wi = __shfl_sync(FULL, L.i[g > 0 ? g - 1 : 0], 31);
    if (lane == 0) {
      uv = wv;
      ui = wi;
    }
    pv[g] = uv;
    pi[g] = ui;
  }
#pragma unroll
  for (int g = 0; g < SLOTS; ++g) {
    const int t = g * 32 + lane;
    if (t > pos) {
      L.v[g] = pv[g];
      L.i[g] = pi[g];
    } else if (t == pos) {
      L.v[g] = s;
      L.i[g] = r;
    }
  }
}

// Offer 32 candidates (one per lane, ascending rows) to the list.
__device__ __forceinline__ void list_offer(WarpList& L, int k, float& thr,
                                           float s, int r) {
  unsigned m = __ballot_sync(FULL, s > thr);
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float cs = __shfl_sync(FULL, s, src);
    const int cr = __shfl_sync(FULL, r, src);
    if (cs > thr) {
      list_insert(L, k, cs, cr);
      thr = list_last(L, k);
    }
  }
}

__global__ void __launch_bounds__(THREADS) int8_topk_ranges(
    const int8_t* __restrict__ q8, const float* __restrict__ qscale,
    const int8_t* __restrict__ corpus, const float* __restrict__ cscale,
    float* __restrict__ part_v, int32_t* __restrict__ part_i,
    int32_t* __restrict__ part_z, int B, int D, int N, int k,
    int rows_per_range) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dw = D / 16;
  int4* qs = reinterpret_cast<int4*>(smem);                // [QB][dw]
  float* sc = reinterpret_cast<float*>(smem + QB * D);      // [QB][THREADS]
  int* zs = reinterpret_cast<int*>(sc + QB * THREADS);     // [QB]

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int b0 = blockIdx.x * QB;
  const int nq = min(QB, B - b0);
  const int range = blockIdx.y;
  const int r0 = range * rows_per_range;
  const int r1 = min(r0 + rows_per_range, N);

  for (int x = tid; x < QB * dw; x += THREADS) {
    const int q = x / dw, c = x % dw;
    qs[x] = q < nq
        ? reinterpret_cast<const int4*>(q8 + (size_t)(b0 + q) * D)[c]
        : make_int4(0, 0, 0, 0);
  }
  if (tid < QB) zs[tid] = -1;
  float qsc[QB];
#pragma unroll
  for (int q = 0; q < QB; ++q) qsc[q] = q < nq ? qscale[b0 + q] : 0.0f;
  int zlast[QB];  // this thread's last row scoring exactly +0.0, per query
#pragma unroll
  for (int q = 0; q < QB; ++q) zlast[q] = -1;
  WarpList L;
  list_init(L);
  float thr = tss_neg_inf();
  __syncthreads();

  for (int base = r0; base < r1; base += THREADS) {
    const int row = base + tid;
    if (row < r1) {
      const int4* rp = reinterpret_cast<const int4*>(corpus + (size_t)row * D);
      int acc[QB];
#pragma unroll
      for (int q = 0; q < QB; ++q) acc[q] = 0;
      for (int c = 0; c < dw; ++c) {
        const int4 r = __ldg(rp + c);
#pragma unroll
        for (int q = 0; q < QB; ++q) acc[q] = tss_dot16(r, qs[q * dw + c], acc[q]);
      }
      const float rs = cscale[row];
#pragma unroll
      for (int q = 0; q < QB; ++q) {
        const float s = __fmul_rn(__fmul_rn(__int2float_rn(acc[q]), qsc[q]), rs);
        if (__float_as_int(s) == 0) zlast[q] = row;
        sc[q * THREADS + tid] = s;
      }
    } else {
#pragma unroll
      for (int q = 0; q < QB; ++q) sc[q * THREADS + tid] = tss_neg_inf();
    }
    __syncthreads();
    if (w < nq) {
      for (int c = 0; c < THREADS / 32; ++c)
        list_offer(L, k, thr, sc[w * THREADS + c * 32 + lane], base + c * 32 + lane);
    }
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < QB; ++q)
    if (zlast[q] >= 0) atomicMax(&zs[q], zlast[q]);
  __syncthreads();
  if (tid < nq) part_z[(size_t)range * B + b0 + tid] = zs[tid];
  if (w < nq) {
    const size_t o = ((size_t)range * B + b0 + w) * k;
#pragma unroll
    for (int g = 0; g < SLOTS; ++g) {
      const int t = g * 32 + lane;
      if (t < k) {
        part_v[o + t] = L.v[g];
        part_i[o + t] = L.i[g];
      }
    }
  }
}

// One warp per query: merge the per-range lists in range order (= ascending
// rows) with the same insert, then give zero scores the TPU kernel's sign.
__global__ void int8_topk_merge(const float* __restrict__ part_v,
                                const int32_t* __restrict__ part_i,
                                const int32_t* __restrict__ part_z,
                                float* __restrict__ out_v,
                                int32_t* __restrict__ out_i, int B, int k,
                                int n_ranges) {
  const int b = blockIdx.x, lane = threadIdx.x;
  WarpList L;
  list_init(L);
  float thr = tss_neg_inf();
  int zmax = -1;
  for (int c = 0; c < n_ranges; ++c) {
    zmax = max(zmax, part_z[(size_t)c * B + b]);
    const size_t o = ((size_t)c * B + b) * k;
    for (int g = 0; g * 32 < k; ++g) {
      const int t = g * 32 + lane;
      const float s = t < k ? part_v[o + t] : tss_neg_inf();
      const int r = t < k ? part_i[o + t] : -1;
      // each range list is sorted: once a group cannot enter, nor can the rest
      if (!__any_sync(FULL, s > thr)) break;
      list_offer(L, k, thr, s, r);
    }
  }
#pragma unroll
  for (int g = 0; g < SLOTS; ++g) {
    const int t = g * 32 + lane;
    if (t < k) {
      float v = L.v[g];
      if (v == 0.0f && L.i[g] <= zmax) v = 0.0f;  // -0.0 -> +0.0
      out_v[(size_t)b * k + t] = v;
      out_i[(size_t)b * k + t] = L.i[g];
    }
  }
}

}  // namespace

// part_v/part_i: [n_ranges, B, k] and part_z: [n_ranges, B] scratch;
// out_v/out_i: [B, k]. Rows [c * rows_per_range, (c+1) * rows_per_range)
// form range c; n_ranges * rows_per_range must cover N.
extern "C" int tss_int8_topk(const int8_t* q8, const float* qscale,
                             const int8_t* corpus, const float* cscale,
                             float* part_v, int32_t* part_i, int32_t* part_z,
                             float* out_v, int32_t* out_i, int B, int D, int N,
                             int k, int n_ranges, int rows_per_range,
                             void* stream) {
  if (B < 1 || N < 1 || k < 1 || k > MAX_K || k > N || D < 16 || D % 16 ||
      n_ranges < 1 || n_ranges > 65535 || rows_per_range < 1 ||
      (long long)n_ranges * rows_per_range < N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)QB * D + (size_t)QB * THREADS * 4 + QB * 4;
  cudaError_t err = cudaFuncSetAttribute(
      int8_topk_ranges, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + QB - 1) / QB, n_ranges);
  int8_topk_ranges<<<grid, THREADS, smem, st>>>(q8, qscale, corpus, cscale,
                                                part_v, part_i, part_z, B, D,
                                                N, k, rows_per_range);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int8_topk_merge<<<B, 32, 0, st>>>(part_v, part_i, part_z, out_v, out_i, B,
                                    k, n_ranges);
  return (int)cudaGetLastError();
}
