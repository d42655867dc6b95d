// Fused filtered int8 scan with a running top-T per lane.
//
// Replaces: trie_semantic_search_tpu/ops/pallas_scan.py, _fused_scan_kernel
// and its wrapper pallas_fused_topk (:206-444, pallas_call at :393).
//
// What it computes, for every query b and corpus row r of one call:
//   s = float(int32 dot(q8[b], corpus[r])) * q_scale[b] * row_scale[r]
// (that multiply order, each product rounded to f32), kept only when
// s >= min_sim[b], the court bit is set (word cword[r], bit pattern
// cbit[r], int32 two's complement) and the f32 date lies in [lo, hi].
// For each lane l = r % 128 it keeps the T best kept rows by (score desc,
// row asc): a strict '>' bubble insert over rows taken in ascending order,
// as the TPU kernel does. Dead slots stay (-inf, -1).
//
// What bounds it on an H100: the int8 products. A 256-query batch against
// one 163,840-row slab is 16.1 G multiply-adds; the slab itself is 63 MB.
// The TPU kernel runs them on the MXU; this first version runs them as
// __dp4a (4 products per instruction, exact in int32) on the CUDA cores,
// so it is bound by integer issue rate, well above the tensor-core bound.
// A wgmma int8 version is later work.
//
// Design: one block of 128 threads per (8-query tile, row range). Thread l
// reads its own rows (16-byte loads) and keeps each query's lane list in
// shared memory; the 8 queries sit in shared memory and are read as
// broadcasts. The top-T per lane is associative, so a second kernel merges
// the per-range lists in range order without changing the result. Query
// tiles vary fastest in the grid so that neighbouring blocks read the same
// rows out of L2.
#include "common.cuh"

namespace {

constexpr int QB = 8;       // queries per block
constexpr int MAX_T = 64;   // longest lane list the merge keeps in registers

__global__ void fused_scan_ranges(
    const int8_t* __restrict__ q8, const float* __restrict__ qscale,
    const int32_t* __restrict__ qwords, const float* __restrict__ qdlo,
    const float* __restrict__ qdhi, const float* __restrict__ qmins,
    const int8_t* __restrict__ corpus, const float* __restrict__ cscale,
    const int32_t* __restrict__ cword, const int32_t* __restrict__ cbit,
    const float* __restrict__ cdate, float* __restrict__ part_v,
    int32_t* __restrict__ part_i, int B, int D, int N, int W, int use_date,
    int T, int rows_per_range) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dw = D / 16;
  int4* qs = reinterpret_cast<int4*>(smem);                 // [QB][dw]
  float* lv = reinterpret_cast<float*>(smem + QB * D);      // [QB][T][128]
  int32_t* li = reinterpret_cast<int32_t*>(lv + QB * T * TSS_LANES);

  const int lane = threadIdx.x;
  const int b0 = blockIdx.x * QB;
  const int nq = min(QB, B - b0);
  const int range = blockIdx.y;

  for (int x = lane; x < QB * dw; x += TSS_LANES) {
    const int q = x / dw, c = x % dw;
    qs[x] = q < nq
        ? reinterpret_cast<const int4*>(q8 + (size_t)(b0 + q) * D)[c]
        : make_int4(0, 0, 0, 0);
  }
  for (int x = 0; x < QB * T; ++x) {
    lv[x * TSS_LANES + lane] = tss_neg_inf();
    li[x * TSS_LANES + lane] = -1;
  }
  __syncthreads();

  const int nj = N / TSS_LANES;
  const int j0 = range * rows_per_range;
  const int j1 = min(j0 + rows_per_range, nj);
  for (int j = j0; j < j1; ++j) {
    const long long row = (long long)j * TSS_LANES + lane;
    const int4* rp = reinterpret_cast<const int4*>(corpus + row * D);
    int acc[QB];
#pragma unroll
    for (int q = 0; q < QB; ++q) acc[q] = 0;
    for (int c = 0; c < dw; ++c) {
      const int4 r = __ldg(rp + c);
#pragma unroll
      for (int q = 0; q < QB; ++q) acc[q] = tss_dot16(r, qs[q * dw + c], acc[q]);
    }
    const float rs = cscale[row];
    const int cw = W ? cword[row] : 0;
    const int cb = W ? cbit[row] : 0;
    const float dt = use_date ? cdate[row] : 0.0f;
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      if (q >= nq) break;
      const int b = b0 + q;
      float s = __fmul_rn(__fmul_rn(__int2float_rn(acc[q]), qscale[b]), rs);
      bool keep = s >= qmins[b];
      if (W) keep = keep && cw >= 0 && cw < W && (qwords[(size_t)b * W + cw] & cb) != 0;
      if (use_date) keep = keep && dt >= qdlo[b] && dt <= qdhi[b];
      if (!keep) continue;  // a -inf score never enters a list
      float* v = lv + q * T * TSS_LANES + lane;
      int32_t* ix = li + q * T * TSS_LANES + lane;
      if (!(s > v[(T - 1) * TSS_LANES])) continue;
      int r = (int)row;
      for (int t = 0; t < T; ++t) {
        const float cur = v[t * TSS_LANES];
        if (s > cur) {
          const int ci = ix[t * TSS_LANES];
          v[t * TSS_LANES] = s;
          ix[t * TSS_LANES] = r;
          s = cur;
          r = ci;
        }
      }
    }
  }

  for (int q = 0; q < nq; ++q) {
    for (int t = 0; t < T; ++t) {
      const size_t o = (((size_t)range * B + b0 + q) * T + t) * TSS_LANES + lane;
      part_v[o] = lv[(q * T + t) * TSS_LANES + lane];
      part_i[o] = li[(q * T + t) * TSS_LANES + lane];
    }
  }
}

// Merge the per-range lane lists in range order (= ascending rows), with
// the same strict '>' insert: ties keep the earlier, lower row.
__global__ void fused_scan_merge(const float* __restrict__ part_v,
                                 const int32_t* __restrict__ part_i,
                                 float* __restrict__ out_v,
                                 int32_t* __restrict__ out_i, int B, int T,
                                 int n_ranges) {
  const int b = blockIdx.x, lane = threadIdx.x;
  float v[MAX_T];
  int ix[MAX_T];
  for (int t = 0; t < T; ++t) {
    v[t] = tss_neg_inf();
    ix[t] = -1;
  }
  for (int c = 0; c < n_ranges; ++c) {
    for (int u = 0; u < T; ++u) {
      const size_t o = (((size_t)c * B + b) * T + u) * TSS_LANES + lane;
      float s = part_v[o];
      // each range list is sorted, so the rest of it cannot enter either
      if (!(s > v[T - 1])) break;
      int r = part_i[o];
      for (int t = 0; t < T; ++t) {
        if (s > v[t]) {
          const float cv = v[t];
          const int ci = ix[t];
          v[t] = s;
          ix[t] = r;
          s = cv;
          r = ci;
        }
      }
    }
  }
  for (int t = 0; t < T; ++t) {
    out_v[((size_t)b * T + t) * TSS_LANES + lane] = v[t];
    out_i[((size_t)b * T + t) * TSS_LANES + lane] = ix[t];
  }
}

}  // namespace

// Shared memory one block of fused_scan_ranges needs.
extern "C" size_t tss_fused_scan_smem_bytes(int D, int T) {
  return (size_t)QB * D + (size_t)QB * T * TSS_LANES * 8;
}

// part_v/part_i: [n_ranges, B, T, 128] scratch; out_v/out_i: [B, T*128]
// with element (b, t*128 + l) the t-th best row of lane l.
extern "C" int tss_fused_scan(
    const int8_t* q8, const float* qscale, const int32_t* qwords,
    const float* qdlo, const float* qdhi, const float* qmins,
    const int8_t* corpus, const float* cscale, const int32_t* cword,
    const int32_t* cbit, const float* cdate, float* part_v, int32_t* part_i,
    float* out_v, int32_t* out_i, int B, int D, int N, int W, int use_date,
    int T, int n_ranges, int rows_per_range, void* stream) {
  if (T < 1 || T > MAX_T || D % 16 || N % TSS_LANES) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = tss_fused_scan_smem_bytes(D, T);
  cudaError_t err = cudaFuncSetAttribute(
      fused_scan_ranges, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + QB - 1) / QB, n_ranges);
  fused_scan_ranges<<<grid, TSS_LANES, smem, st>>>(
      q8, qscale, qwords, qdlo, qdhi, qmins, corpus, cscale, cword, cbit,
      cdate, part_v, part_i, B, D, N, W, use_date, T, rows_per_range);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_scan_merge<<<B, TSS_LANES, 0, st>>>(part_v, part_i, out_v, out_i, B,
                                           T, n_ranges);
  return (int)cudaGetLastError();
}
