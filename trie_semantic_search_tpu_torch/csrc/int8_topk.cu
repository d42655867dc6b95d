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
//
// Both variants split the rows into ranges, keep one sorted list per
// (query, range) and never write the [B, N] scores to device memory; a
// second kernel, int8_topk_merge, merges each query's range lists in range
// order (= ascending rows) with the same insert, so equal scores keep the
// lower row. Query tiles vary fastest in the grid, so the blocks that read
// one row range run side by side and share its reads in L2. A warp keeps a
// list of k <= 128 in registers (lane l holds positions l, l+32, ...) and
// inserts a candidate after every entry scoring >= it; candidates arrive
// in ascending row order within a range.
//
// Two variants. The caller picks one by D and k (int8_topk_variant in
// ops/scan_kernels.py), explicitly and never as a fallback:
//
// * tss_int8_topk (int8_topk_wgmma), D % 32 == 0 and D <= 512: the
//   products on the int8 tensor cores (wgmma m64n64k32 .s32.s8.s8, the
//   mainloop of fused_scan.cu, its helpers in common.cuh). A block owns
//   128 queries (two scorer warpgroups; 64 when B <= 64, k > 32 or
//   D > 384, where the lists or the stages need the room) and one row
//   range, one block per SM: with B <= 256 two blocks read a range, so
//   device memory delivers the corpus once and L2 twice. Roles, 800
//   threads (672 with one warpgroup):
//   - loader (one warp): the query tile once, then 128-row tiles of the
//     range and their 128 row scales through a ring of 2-4 stages with 2-D
//     and 1-D TMA (128B swizzle; rows past N read 0);
//   - scorers: each warpgroup multiplies its 64 queries by 64 rows of the
//     stage per step (ceil(D / 32) k32 products) and writes the raw int32
//     tile, with the step's 64 row scales, into one of its two score
//     buffers (its own named barriers, so the warpgroups never wait on
//     each other's hand-off);
//   - list updaters (16 warps, 8 per scorer warpgroup when there are
//     two): each keeps the lists of QN / 16 queries and reads their 64
//     scores of a step in row order (lanes = rows), scales them, records
//     the last +0.0 row for the merge (every row, rejected or not; rows
//     past N score NaN and never count), and votes each list's scores
//     against its entry bound: the list's k-th score, or the bound found
//     from the scores every range publishes for the query, where higher
//     (published_bound). Only lists with a candidate branch to the
//     insert.
//   What holds it above its bound, from ablation builds: the score
//   hand-off through shared memory (its stores compete with wgmma's
//   operand reads, its barriers add latency), the votes, then the inserts
//   (PERF.md).
// * tss_int8_topk_dp4a (int8_topk_dp4a), any D % 16 == 0: the products as
//   __dp4a on the CUDA cores, bound by their issue rate. One block of 256
//   threads per (8-query tile, row range): each thread scores one row of a
//   256-row chunk against the 8 queries (16-byte row loads, queries in
//   shared memory), the scores go through shared memory, and warp w
//   inserts the chunk's rows that beat query w's k-th score.
#include "common.cuh"

namespace {

constexpr int QB = 8;              // dp4a variant: queries per block, one warp each
constexpr int THREADS = QB * 32;   // dp4a variant: rows per chunk, one per thread
constexpr int MAX_K = 128;         // longest list (the engine's top k bucket)
constexpr int SLOTS = MAX_K / 32;  // list positions per lane
constexpr unsigned FULL = 0xffffffffu;

// A warp's sorted list: lane l holds positions g*32 + l, g < S.
template <int S>
struct WarpList {
  float v[S];
  int i[S];
};

template <int S>
__device__ __forceinline__ void list_init(WarpList<S>& L) {
#pragma unroll
  for (int g = 0; g < S; ++g) {
    L.v[g] = tss_neg_inf();
    L.i[g] = -1;
  }
}

// The k-th score of the list (what a candidate must beat to enter).
template <int S>
__device__ __forceinline__ float list_last(const WarpList<S>& L, int k) {
  const int t = k - 1;
  float x = L.v[0];
#pragma unroll
  for (int g = 1; g < S; ++g)
    if (g == t / 32) x = L.v[g];
  return __shfl_sync(FULL, x, t % 32);
}

// Insert (s, r) after every entry scoring >= s: those came earlier, from
// lower rows, so equal scores keep the lower row. The k-th entry drops off.
template <int S>
__device__ __forceinline__ void list_insert(WarpList<S>& L, int k, float s, int r) {
  const int lane = threadIdx.x & 31;
  int pos = 0;
#pragma unroll
  for (int g = 0; g < S; ++g)
    pos += __popc(__ballot_sync(FULL, g * 32 + lane < k && L.v[g] >= s));
  float pv[S];
  int pi[S];
#pragma unroll
  for (int g = 0; g < S; ++g) {
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
  for (int g = 0; g < S; ++g) {
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

// Offer 32 candidates (one per lane, ascending rows) to the list. `thr` is
// what a candidate must beat: the list's k-th score, or `bound` where that
// is higher (the wgmma variant's bound from the other ranges).
template <int S>
__device__ __forceinline__ void list_offer(WarpList<S>& L, int k, float& thr,
                                           float s, int r, float bound = tss_neg_inf()) {
  unsigned m = __ballot_sync(FULL, s > thr);
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float cs = __shfl_sync(FULL, s, src);
    const int cr = __shfl_sync(FULL, r, src);
    if (cs > thr) {
      list_insert(L, k, cs, cr);
      thr = fmaxf(list_last(L, k), bound);
    }
  }
}

// ---------------------------------------------------------------------------
// dp4a variant
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) int8_topk_dp4a(
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
  WarpList<SLOTS> L;
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
  WarpList<SLOTS> L;
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

// ---------------------------------------------------------------------------
// wgmma variant
// ---------------------------------------------------------------------------

// Ablation builds, for measurement only (chip_smoke.py --only
// int8-ablations; the library builds 0): 6 keeps only the loads, 5 the
// loads and the products, 8 adds the hand-off's stores, 7 its barriers
// instead, 1 both (no list work), 3 everything but the inserts.
#ifndef TSS_INT8_TOPK_ABLATE
#define TSS_INT8_TOPK_ABLATE 0
#endif

constexpr int WG_ROWS = 128;              // corpus rows per TMA tile
constexpr int WG_STEP = 64;               // rows per score step (wgmma N)
constexpr int KBOX = 128;                 // bytes of K per TMA box (the 128B swizzle span)
constexpr int TILE_BOX = WG_ROWS * KBOX;  // one K box of a tile
constexpr int STEP_BOX = WG_STEP * KBOX;  // 64 rows (or queries) of one K box
constexpr int SCALE_BYTES = WG_ROWS * 4;  // a tile's row scales
constexpr int UPD_WARPS = 16;             // list updater warps
constexpr int WG_NBUF = 2;                // score buffers of each scorer warpgroup
constexpr int SROW = WG_STEP + 8;         // words per query row of a score buffer (padded)
constexpr int WG_MAX_STAGES = 4;
constexpr int WG_MAX_D = 512;             // widest row two ring stages hold
constexpr int SMEM_LIMIT = 232448;

// A block of QW scorer warpgroups: 64 QW queries, a list per query.
template <int QW>
struct WgShape {
  static constexpr int QN = 64 * QW;
  static constexpr int SCORERS = 128 * QW;
  static constexpr int UPDATERS = 32 * UPD_WARPS;
  static constexpr int THREADS = SCORERS + 32 + UPDATERS;
  static constexpr int QPW = QN / UPD_WARPS;                 // lists per updater warp
  // each scorer warpgroup hands its products to its own UPD_WARPS / QW
  // updater warps through its own NBUF buffers and named barriers, so the
  // two warpgroups' products and hand-offs overlap
  static constexpr int BUF_WORDS = 64 * SROW + WG_STEP;      // 64 queries' products, 64 row scales
  static constexpr int BAR_THREADS = 128 + UPDATERS / QW;    // over each score buffer barrier
};

// Ring stages that fit beside the query tile and the score buffers (0: the
// width does not fit two).
__host__ __device__ inline int wg_stages(int D, int qw) {
  const int kb = (D + KBOX - 1) / KBOX;
  const int qn = 64 * qw;
  const int fixed = 1024 /* alignment */ + 256 /* barriers */ + kb * qn * KBOX +
                    qw * WG_NBUF * (64 * SROW + WG_STEP) * 4 + 2 * qn * 4 /* query scales, bounds */;
  const int s = (SMEM_LIMIT - fixed) / (kb * TILE_BOX + SCALE_BYTES);
  return s < 2 ? 0 : (s > WG_MAX_STAGES ? WG_MAX_STAGES : s);
}

__host__ __device__ inline size_t wg_smem_bytes(int D, int qw, int stages) {
  const int kb = (D + KBOX - 1) / KBOX;
  const int qn = 64 * qw;
  return 1024 + 256 + (size_t)kb * qn * KBOX + (size_t)qw * WG_NBUF * (64 * SROW + WG_STEP) * 4 +
         2 * qn * 4 + (size_t)stages * (kb * TILE_BOX + SCALE_BYTES);
}

// Published scores a lane reads for one query (ranges x n_pub <= 32 times
// that): more for the longer lists, whose bound gains more from them.
template <int S>
__host__ __device__ constexpr int pub_per_lane() {
  return S == 1 ? 8 : 16;
}

// Order-preserving key of a float (a larger float has a larger key), and
// the float just below a key's (keys above that of -inf).
constexpr unsigned KEY_NEG_INF = 0x007fffffu;
__device__ __forceinline__ unsigned float_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_below(unsigned key) {
  unsigned b = key - 1;
  if (b == 0x7fffffffu) b = 0x7ffffffeu;  // below +-0.0: the negative denormal
  return __uint_as_float((b & 0x80000000u) ? (b & 0x7fffffffu) : ~b);
}

// A bound below which no score of query b reaches the merged list: every
// range keeps its list's first n_pub scores in part_v[range][b][0, n_pub)
// (-inf until it has them; a range publishes as its list improves and
// writes its whole list there at its end). Each value read, at whatever
// time, is the score of a distinct row, and at least as many rows score
// as high, so the k-th largest of them is at most the final k-th score.
// Found on the top 16 bits of the keys (rounded down, so still at most
// that) by a radix select over the warp; returned as the float just below
// it (-inf while fewer than k scores are published), so that a score
// beats the bound exactly when it is at least the k-th largest.
template <int PPL>
__device__ __forceinline__ float published_bound(const float* part_v, int b, int B, int k,
                                                 int n_ranges, int n_pub, int lane) {
  const int n = min(n_ranges * n_pub, 32 * PPL);
  unsigned key[PPL];
#pragma unroll
  for (int v = 0; v < PPL; ++v) {
    const int i = lane + 32 * v;
    const int c = i / n_pub;
    key[v] = i < n ? float_key(__ldcg(part_v + ((size_t)c * B + b) * k + (i - c * n_pub))) >> 16
                   : 0u;
  }
  unsigned prefix = 0;
  int need = k;
  for (int bit = 15; bit >= 0; --bit) {
    const unsigned cand = (prefix | (1u << bit)) >> bit;
    int cnt = 0;
#pragma unroll
    for (int v = 0; v < PPL; ++v) cnt += (key[v] >> bit) == cand;
    cnt = __reduce_add_sync(FULL, cnt);
    if (cnt >= need)
      prefix |= 1u << bit;
    else
      need -= cnt;
  }
  return (prefix << 16) > KEY_NEG_INF ? key_below(prefix << 16) : tss_neg_inf();
}

// Scorer warpgroups per block for this shape, 0 where the variant does not
// take it: two (128 queries) for lists of one slot per lane when the
// stages fit, else one.
inline int wg_warpgroups(int B, int D, int k) {
  if (D < 32 || D % 32 || D > WG_MAX_D || k < 1 || k > MAX_K) return 0;
  if (B > 64 && k <= 32 && wg_stages(D, 2) >= 2) return 2;
  return wg_stages(D, 1) >= 2 ? 1 : 0;
}

template <int QW, int S>
__global__ void __launch_bounds__(WgShape<QW>::THREADS, 1) int8_topk_wgmma(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap cmap,
    const __grid_constant__ CUtensorMap smap, const float* __restrict__ qscale,
    float* __restrict__ part_v, int32_t* __restrict__ part_i, int32_t* __restrict__ part_z,
    int B, int D, int N, int k, int n_ranges, int rows_per_range, int n_pub, int stages) {
  using Sh = WgShape<QW>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = tss_smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int kb = (D + KBOX - 1) / KBOX;
  const int ksteps = D / 32;
  const uint32_t tile_bytes = kb * TILE_BOX;
  const uint32_t q_base = base;                                // [kb][QN queries][128 B]
  const uint32_t c_base = q_base + kb * Sh::QN * KBOX;         // [stages][kb][128 rows][128 B]
  const uint32_t s_base = c_base + stages * tile_bytes;        // [stages][128 row scales]
  const uint32_t f_base = s_base + stages * SCALE_BYTES;       // [QW][NBUF] products, scales
  const uint32_t u_base = f_base + QW * WG_NBUF * Sh::BUF_WORDS * 4;  // [QN] query scales, bounds
  const uint32_t bars = u_base + 2 * Sh::QN * 4;                 // full[s], empty[s], query
  const uint32_t qbar = bars + 16 * stages;
  const unsigned char* scales_generic = smem_raw + (s_base - raw);
  int* sbuf = reinterpret_cast<int*>(smem_raw + (f_base - raw));
  float* uq = reinterpret_cast<float*>(smem_raw + (u_base - raw));
  float* ub = uq + Sh::QN;

  const int tid = threadIdx.x;
  // the role broadcast from lane 0, so the compiler sees it warp-uniform
  // and keeps the wgmma code on a convergent path
  const int role = __shfl_sync(FULL, tid < Sh::SCORERS ? 0 : tid < Sh::SCORERS + 32 ? 1 : 2, 0);
  const int b0 = blockIdx.x * Sh::QN;
  const int range = blockIdx.y;
  const int r0 = range * rows_per_range;
  const int r1 = min(r0 + rows_per_range, N);
  const int ntiles = (r1 - r0 + WG_ROWS - 1) / WG_ROWS;
  const int nsteps = ntiles * (WG_ROWS / WG_STEP);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      tss_mbar_init(bars + 8 * s, 1);                              // full: the loader + bytes
      tss_mbar_init(bars + 8 * (stages + s), Sh::SCORERS / 32);    // empty: one per scorer warp
    }
    tss_mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (role == 1) {
    // loader: the query tile once, then the range's tiles and row scales
    if (tid == Sh::SCORERS) {
      tss_mbar_expect_tx(qbar, kb * Sh::QN * KBOX);
      for (int c = 0; c < kb; ++c)
        tss_tma_load_2d(q_base + c * Sh::QN * KBOX, &qmap, qbar, c * KBOX, b0);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % stages;
        if (it >= stages) tss_mbar_wait(bars + 8 * (stages + s), ((it / stages) & 1) ^ 1);
        const uint32_t full = bars + 8 * s;
        const int row = r0 + it * WG_ROWS;
        tss_mbar_expect_tx(full, tile_bytes + SCALE_BYTES);
        for (int c = 0; c < kb; ++c)
          tss_tma_load_2d(c_base + s * tile_bytes + c * TILE_BOX, &cmap, full, c * KBOX, row);
        tss_tma_load_1d(s_base + s * SCALE_BYTES, &smap, full, row);
      }
    }
    return;
  }

  const int warp = tid / 32;
  const int lane = tid % 32;
  if (role == 2) {
    // list updaters: warp u keeps the lists of block queries u * QPW + j.
    // Per step it scales each list's 64 products (rows 32 h + lane) and
    // notes the last +0.0 row, all without a branch, and votes them
    // against the list's entry bound; only lists with a candidate take a
    // branch, which scales the scores again and offers them in row order.
    // The entry bound is the list's k-th score or, where higher, the one
    // published_bound finds from every range's published scores: a row
    // scoring below it cannot reach the merged list. (Query scales and
    // found bounds live in shared memory, uq / ub[q0 + j], so the
    // registers hold only each list, its entry bound and its last +0.0 row.)
#if TSS_INT8_TOPK_ABLATE == 5 || TSS_INT8_TOPK_ABLATE == 6 || TSS_INT8_TOPK_ABLATE == 8
    return;
#endif
    constexpr int QPW = Sh::QPW;
    const int q0 = (warp - Sh::SCORERS / 32 - 1) * QPW;
    const int* my_buf = sbuf + (q0 / 64) * WG_NBUF * Sh::BUF_WORDS;  // its warpgroup's buffers
    const int bar = 1 + 2 * WG_NBUF * (q0 / 64);
    float thr[QPW];
    int zl[QPW];
    WarpList<S> L[QPW];
#pragma unroll
    for (int j = 0; j < QPW; ++j) {
      const int b = b0 + q0 + j;
      thr[j] = b < B ? tss_neg_inf() : __int_as_float(0x7f800000);  // past the batch: none enter
      zl[j] = -1;
      list_init(L[j]);
    }
    if (lane < QPW) {
      const int b = b0 + q0 + lane;
      uq[q0 + lane] = b < B ? qscale[b] : 0.0f;
      ub[q0 + lane] = tss_neg_inf();
    }
    __syncwarp();
    for (int st = 0; st < nsteps; ++st) {
      if (st >= 2 && (st & (st - 1)) == 0) {  // steps 2, 4, 8, ...: fold in the other ranges
#pragma unroll 1
        for (int j = 0; j < QPW; ++j) {
          const int b = b0 + q0 + j;
          if (b >= B) break;  // warp-uniform
          const float pj =
              published_bound<pub_per_lane<S>()>(part_v, b, B, k, n_ranges, n_pub, lane);
          const float bj = fmaxf(ub[q0 + j], pj);
          ub[q0 + j] = bj;  // the same value from every lane
#pragma unroll
          for (int i = 0; i < QPW; ++i)
            if (i == j) thr[i] = fmaxf(thr[i], bj);
        }
      }
      const int buf = st % WG_NBUF;
      tss_named_bar_sync(bar + buf, Sh::BAR_THREADS);  // the step's products written
      const int* a = my_buf + buf * Sh::BUF_WORDS + (q0 % 64) * SROW + lane;
      const float* rsc = reinterpret_cast<const float*>(my_buf + buf * Sh::BUF_WORDS + 64 * SROW);
      // rows past N (TMA read zeros) score NaN: no '>' or '== +0.0' holds
      const int row = r0 + st * WG_STEP + lane;
      const float rs0 = row < r1 ? rsc[lane] : __int_as_float(0x7fffffff);
      const float rs1 = row + 32 < r1 ? rsc[32 + lane] : __int_as_float(0x7fffffff);
      unsigned hit = 0;
#if TSS_INT8_TOPK_ABLATE != 1 && TSS_INT8_TOPK_ABLATE != 7
#pragma unroll
      for (int j = 0; j < QPW; ++j) {
        const float qs = uq[q0 + j];
        const float x0 = __fmul_rn(__fmul_rn(__int2float_rn(a[j * SROW]), qs), rs0);
        const float x1 = __fmul_rn(__fmul_rn(__int2float_rn(a[j * SROW + 32]), qs), rs1);
        zl[j] = __float_as_int(x0) == 0 ? row : zl[j];
        zl[j] = __float_as_int(x1) == 0 ? row + 32 : zl[j];
        hit |= (__any_sync(FULL, fmaxf(x0, x1) > thr[j]) ? 1u : 0u) << j;
      }
#endif
#if TSS_INT8_TOPK_ABLATE == 3
      hit = k > MAX_K ? hit : 0u;
#endif
      // the lists with a candidate, one at a time (list j copied out of
      // and back into the unrolled arrays by selects)
#pragma unroll 1
      for (int j = 0; hit; ++j, hit >>= 1) {
        if (hit & 1u) {
          WarpList<S> Lj = L[0];
          float tj = thr[0];
#pragma unroll
          for (int i = 1; i < QPW; ++i)
            if (i == j) {
              Lj = L[i];
              tj = thr[i];
            }
          {
            const float qs = uq[q0 + j], bj = ub[q0 + j];
            const float x0 = __fmul_rn(__fmul_rn(__int2float_rn(a[j * SROW]), qs), rs0);
            const float x1 = __fmul_rn(__fmul_rn(__int2float_rn(a[j * SROW + 32]), qs), rs1);
            list_offer(Lj, k, tj, x0, row, bj);
            list_offer(Lj, k, tj, x1, row + 32, bj);
            // publish the list's first n_pub scores for the other ranges
            if (lane < n_pub) part_v[((size_t)range * B + b0 + q0 + j) * k + lane] = Lj.v[0];
          }
#pragma unroll
          for (int i = 0; i < QPW; ++i)
            if (i == j) {
              L[i] = Lj;
              thr[i] = tj;
            }
        }
      }
      if (st + WG_NBUF < nsteps) tss_named_bar_arrive(bar + WG_NBUF + buf, Sh::BAR_THREADS);
    }
#pragma unroll
    for (int j = 0; j < QPW; ++j) {
      const int b = b0 + q0 + j;
      if (b >= B) continue;
      const int z = __reduce_max_sync(FULL, zl[j]);
      if (lane == 0) part_z[(size_t)range * B + b] = z;
      const size_t o = ((size_t)range * B + b) * k;
#pragma unroll
      for (int g = 0; g < S; ++g) {
        const int t = g * 32 + lane;
        if (t < k) {
          part_v[o + t] = L[j].v[g];
          part_i[o + t] = L[j].i[g];
        }
      }
    }
    return;
  }

  // scorers: warpgroup w multiplies block queries 64 w ... by each step's
  // 64 rows on the tensor cores and writes the raw products out
  const int wg = warp / 4;
  const uint32_t a_base = q_base + wg * STEP_BOX;
  int acc[32] = {};
  tss_mbar_wait(qbar, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % stages;
    tss_mbar_wait(bars + 8 * s, (it / stages) & 1);
#pragma unroll
    for (int h = 0; h < WG_ROWS / WG_STEP; ++h) {
#if TSS_INT8_TOPK_ABLATE != 6
      tss_wgmma_issue<Sh::QN * KBOX, TILE_BOX>(acc, a_base, c_base + s * tile_bytes + h * STEP_BOX,
                                               ksteps);
      tss_wgmma_wait_all();
      tss_fence_regs(acc);
#endif
#if TSS_INT8_TOPK_ABLATE < 5
      tss_dump_step<WG_NBUF, SROW, Sh::BUF_WORDS, 64, Sh::BAR_THREADS>(
          acc, sbuf + wg * WG_NBUF * Sh::BUF_WORDS, scales_generic + s * SCALE_BYTES + h * WG_STEP * 4,
          WG_STEP * 4, it * (WG_ROWS / WG_STEP) + h, warp % 4, lane, 1 + 2 * WG_NBUF * wg);
#elif TSS_INT8_TOPK_ABLATE == 7
      {  // the hand-off's barriers without its stores
        const int st2 = it * (WG_ROWS / WG_STEP) + h, b2 = 1 + 2 * WG_NBUF * wg;
        if (st2 >= WG_NBUF) tss_named_bar_sync(b2 + WG_NBUF + st2 % WG_NBUF, Sh::BAR_THREADS);
        tss_named_bar_arrive(b2 + st2 % WG_NBUF, Sh::BAR_THREADS);
      }
#elif TSS_INT8_TOPK_ABLATE == 8
      {  // the hand-off's stores without its barriers
        int* out = sbuf + wg * WG_NBUF * Sh::BUF_WORDS + (h % WG_NBUF) * Sh::BUF_WORDS +
                   (16 * (warp % 4) + lane / 4) * SROW + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            *reinterpret_cast<int2*>(out + 8 * e * SROW + 8 * j) =
                make_int2(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
      }
#endif
    }
    __syncwarp();
    if (lane == 0) tss_mbar_arrive(bars + 8 * (stages + s));  // the stage is read
  }
}

// No range has published a score yet: part_v[range][b][0, n_pub) = -inf.
__global__ void int8_topk_clear(float* __restrict__ part_v, int B, int k, int n_ranges,
                                int n_pub) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_ranges * B * n_pub)
    part_v[(size_t)(i / n_pub) * k + i % n_pub] = tss_neg_inf();
}

template <int QW, int S>
cudaError_t launch_wgmma(const CUtensorMap (&maps)[3], const float* qscale, float* part_v,
                         int32_t* part_i, int32_t* part_z, int B, int D, int N, int k,
                         int n_ranges, int rows_per_range, int n_pub, cudaStream_t st) {
  const int stages = wg_stages(D, QW);
  const size_t smem = wg_smem_bytes(D, QW, stages);
  auto kernel = int8_topk_wgmma<QW, S>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + WgShape<QW>::QN - 1) / WgShape<QW>::QN, n_ranges);
  kernel<<<grid, WgShape<QW>::THREADS, smem, st>>>(maps[0], maps[1], maps[2], qscale, part_v,
                                                   part_i, part_z, B, D, N, k, n_ranges,
                                                   rows_per_range, n_pub, stages);
  return cudaGetLastError();
}

}  // namespace

// Queries per block of the wgmma variant at this shape (its grid is
// (ceil(B / that), n_ranges)), 0 where it does not take the shape.
extern "C" int tss_int8_topk_block_queries(int B, int D, int k) {
  return 64 * wg_warpgroups(B, D, k);
}

// The wgmma variant. part_v/part_i: [n_ranges, B, k] and part_z:
// [n_ranges, B] scratch; out_v/out_i: [B, k]. Rows [c * rows_per_range,
// (c+1) * rows_per_range) form range c; rows_per_range is a multiple of
// 128 and n_ranges * rows_per_range covers N. Returns a cudaError_t, or
// 1000 when a TMA tensor map could not be made.
extern "C" int tss_int8_topk(const int8_t* q8, const float* qscale,
                             const int8_t* corpus, const float* cscale,
                             float* part_v, int32_t* part_i, int32_t* part_z,
                             float* out_v, int32_t* out_i, int B, int D, int N,
                             int k, int n_ranges, int rows_per_range,
                             void* stream) {
  const int qw = wg_warpgroups(B, D, k);
  const bool aligned = reinterpret_cast<uintptr_t>(q8) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(corpus) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(cscale) % 16 == 0;
  if (qw == 0 || B < 1 || N < 1 || k > N || n_ranges < 1 || n_ranges > 65535 ||
      rows_per_range < 1 || rows_per_range % WG_ROWS ||
      (long long)n_ranges * rows_per_range < N || !aligned)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // queries [B, D] and rows [N, D] in 128-byte K boxes; row scales [N]
  const cuuint64_t qdims[2] = {(cuuint64_t)D, (cuuint64_t)B}, qstr[1] = {(cuuint64_t)D};
  const cuuint32_t qbox[2] = {KBOX, (cuuint32_t)(64 * qw)};
  const cuuint64_t cdims[2] = {(cuuint64_t)D, (cuuint64_t)N}, cstr[1] = {(cuuint64_t)D};
  const cuuint32_t cbox[2] = {KBOX, WG_ROWS};
  const cuuint64_t sdims[1] = {(cuuint64_t)N}, sstr[1] = {4};
  const cuuint32_t sbox[1] = {WG_ROWS};
  CUtensorMap maps[3];
  const bool ok = tss_make_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q8, qdims, qstr, qbox,
                               CU_TENSOR_MAP_SWIZZLE_128B) &&
                  tss_make_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, corpus, cdims, cstr,
                               cbox, CU_TENSOR_MAP_SWIZZLE_128B) &&
                  tss_make_map(&maps[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, cscale, sdims, sstr,
                               sbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return 1000;
  // scores each range publishes for the others (published_bound): as
  // many of each list's first as the bound reads in all, at most 32 and k
  const int read = 32 * (k <= 32 ? pub_per_lane<1>() : pub_per_lane<2>());
  const int n_pub = min(min(32, k), max(1, read / n_ranges));
  const int n_clear = n_ranges * B * n_pub;
  int8_topk_clear<<<(n_clear + 255) / 256, 256, 0, st>>>(part_v, B, k, n_ranges, n_pub);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (qw == 2)
    err = launch_wgmma<2, 1>(maps, qscale, part_v, part_i, part_z, B, D, N, k, n_ranges,
                             rows_per_range, n_pub, st);
  else if (k <= 32)
    err = launch_wgmma<1, 1>(maps, qscale, part_v, part_i, part_z, B, D, N, k, n_ranges,
                             rows_per_range, n_pub, st);
  else if (k <= 64)
    err = launch_wgmma<1, 2>(maps, qscale, part_v, part_i, part_z, B, D, N, k, n_ranges,
                             rows_per_range, n_pub, st);
  else
    err = launch_wgmma<1, 4>(maps, qscale, part_v, part_i, part_z, B, D, N, k, n_ranges,
                             rows_per_range, n_pub, st);
  if (err != cudaSuccess) return (int)err;
  int8_topk_merge<<<B, 32, 0, st>>>(part_v, part_i, part_z, out_v, out_i, B, k, n_ranges);
  return (int)cudaGetLastError();
}

// The dp4a variant: the same arguments and outputs, any D % 16 == 0 and
// any rows_per_range.
extern "C" int tss_int8_topk_dp4a(const int8_t* q8, const float* qscale,
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
      int8_topk_dp4a, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + QB - 1) / QB, n_ranges);
  int8_topk_dp4a<<<grid, THREADS, smem, st>>>(q8, qscale, corpus, cscale,
                                              part_v, part_i, part_z, B, D,
                                              N, k, rows_per_range);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int8_topk_merge<<<B, 32, 0, st>>>(part_v, part_i, part_z, out_v, out_i, B,
                                    k, n_ranges);
  return (int)cudaGetLastError();
}
