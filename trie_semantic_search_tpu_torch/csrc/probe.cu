// Partitioned-ANN probe scan: one query against one probed partition block.
//
// Replaces: trie_semantic_search_tpu/ops/pallas_scan.py, _probe_kernel and
// its wrapper pallas_probe_candidates (:447-626, pallas_call at :601).
//
// What it computes, for query b and its p-th probed partition P = top_p[b,p]:
// the int8 dot of q8[b] with each of the partition's m slots, scored
// float(acc) * q_scale[b] * slot_scale (that order), masked to -inf unless
// the court word/bit matches, the int32 date lies in [lo, hi], the slot is
// not padding (row >= 0) and the score reaches min_sim. Over the m/128
// sub-blocks each lane keeps its best two (strict '>', ties to the lower
// sub-block), with the TPU kernel's exact update rule, so the slot ids of
// dead entries match too. Output: [B, NP, 2, 128] values and slots.
//
// What bounds it on an H100: bytes. Each (query, probe) reads one
// 1024 x 384 int8 block (384 KiB) and does 393 K multiply-adds on it, about
// one operation per byte — far below the card's int8 ridge point, so the
// floor is B * NP * m * D bytes over the memory rate.
//
// Design: one block of 128 threads per (probe, query); thread l scores the
// slots j*128 + l with 16-byte row loads and __dp4a against the query held
// in shared memory. The TPU kernel's whole-batch MXU product and one-hot
// row pick (a workaround for Mosaic's missing dynamic sublane indexing) are
// not carried over: each block reads exactly the one query it scores.
#include "common.cuh"

namespace {

__global__ void probe_candidates(
    const int8_t* __restrict__ q8, const float* __restrict__ qscale,
    const int32_t* __restrict__ top_p, const int8_t* __restrict__ part_int8,
    const float* __restrict__ pscale, const int32_t* __restrict__ prows,
    const int32_t* __restrict__ pcword, const int32_t* __restrict__ pcbit,
    const int32_t* __restrict__ pdate, const int32_t* __restrict__ qwords,
    const int32_t* __restrict__ dlo, const int32_t* __restrict__ dhi,
    const float* __restrict__ mins, float* __restrict__ out_v,
    int32_t* __restrict__ out_s, int NP, int P, int m, int D, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* qs = reinterpret_cast<int4*>(smem);
  const int pi = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  const int dw = D / 16;
  for (int x = lane; x < dw; x += TSS_LANES)
    qs[x] = reinterpret_cast<const int4*>(q8 + (size_t)b * D)[x];
  __syncthreads();

  const int pid = min(max(top_p[(size_t)b * NP + pi], 0), P - 1);
  const float qsc = qscale[b], qmin = mins[b];
  const int lo = dlo[b], hi = dhi[b];
  const int nb = m / TSS_LANES;
  float v1 = tss_neg_inf(), v2 = tss_neg_inf();
  int j1 = 0, j2 = 0;
  for (int j = 0; j < nb; ++j) {
    const size_t slot = (size_t)pid * m + (size_t)j * TSS_LANES + lane;
    const int4* rp = reinterpret_cast<const int4*>(part_int8 + slot * D);
    int acc = 0;
    for (int c = 0; c < dw; ++c) acc = tss_dot16(__ldg(rp + c), qs[c], acc);
    float s = __fmul_rn(__fmul_rn(__int2float_rn(acc), qsc), pscale[slot]);
    const int cw = pcword[slot];
    const bool court_ok =
        cw >= 0 && cw < W && (qwords[(size_t)b * W + cw] & pcbit[slot]) != 0;
    const int dt = pdate[slot];
    const bool keep = court_ok && dt >= lo && dt <= hi && prows[slot] >= 0 &&
                      s >= qmin;
    if (!keep) s = tss_neg_inf();
    if (j == 0) {
      v1 = s;
      continue;
    }
    // the loser of the slot-1 contest competes for slot 2
    const bool gt1 = s > v1;
    const float c2v = gt1 ? v1 : s;
    const int c2j = gt1 ? j1 : j;
    if (gt1) {
      v1 = s;
      j1 = j;
    }
    if (c2v > v2) {
      v2 = c2v;
      j2 = c2j;
    }
  }
  const size_t o = ((size_t)b * NP + pi) * 2 * TSS_LANES + lane;
  out_v[o] = v1;
  out_v[o + TSS_LANES] = v2;
  out_s[o] = j1 * TSS_LANES + lane;
  out_s[o + TSS_LANES] = j2 * TSS_LANES + lane;
}

}  // namespace

extern "C" int tss_probe_candidates(
    const int8_t* q8, const float* qscale, const int32_t* top_p,
    const int8_t* part_int8, const float* pscale, const int32_t* prows,
    const int32_t* pcword, const int32_t* pcbit, const int32_t* pdate,
    const int32_t* qwords, const int32_t* dlo, const int32_t* dhi,
    const float* mins, float* out_v, int32_t* out_s, int B, int NP, int P,
    int m, int D, int W, void* stream) {
  if (D % 16 || m % TSS_LANES || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(NP, B);
  probe_candidates<<<grid, TSS_LANES, D, st>>>(
      q8, qscale, top_p, part_int8, pscale, prows, pcword, pcbit, pdate,
      qwords, dlo, dhi, mins, out_v, out_s, NP, P, m, D, W);
  return (int)cudaGetLastError();
}
