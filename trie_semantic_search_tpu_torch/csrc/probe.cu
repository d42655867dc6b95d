// Partitioned-ANN probe scan, partition-major: every probed partition is
// streamed through shared memory once for all the queries that probe it.
//
// Replaces: trie_semantic_search_tpu/ops/pallas_scan.py, _probe_kernel and
// its wrapper pallas_probe_candidates (:447-626, pallas_call at :601).
//
// What it computes, for query b and its p-th probed partition P = top_p[b,p]
// (clamped into [0, P-1]): the int8 dot of q8[b] with each of the
// partition's m slots, scored float(acc) * q_scale[b] * slot_scale (that
// order), masked to -inf unless the court word/bit matches, the int32 date
// lies in [lo, hi], the slot is not padding (row >= 0) and the score reaches
// min_sim. Over the m/128 sub-blocks each lane keeps its best two (strict
// '>', the slot-1 loser competing for slot 2, sub-blocks strictly in order),
// the TPU kernel's exact update rule, so the slot ids of dead entries match
// too. Output: [B, NP, 2, 128] values and slots. Each (query, probe) result
// is independent of every other, so the order in which pairs are grouped
// below does not change it.
//
// What bounds it on an H100: bytes. A partition is an m x D int8 block plus
// five 4-byte columns (404 KiB at 1024 x 384), and the dot products are
// about one operation per byte read, far below the card's int8 ridge
// point: the floor is the distinct probed partitions' bytes over the
// memory rate (2,789 distinct of 4,096 pairs at B=64, nprobe 64).
//
// Old design: one 128-thread block per (probe, query) pair, each thread
// walking its own 384-byte row with 16-byte __ldg loads. It read 4,096
// blocks for those 2,789 partitions (1.69 GB) with no asynchronous copy and
// little in flight per block: 0.842 ms on an H100 80GB HBM3 at 700 W, about
// 2 TB/s, against a 0.347 ms bound.
//
// Design (0.403-0.406 ms at that shape on the same card, the plan 0.008 ms
// of it; chip_smoke.py --only kernels):
//  1. probe_plan (one block): groups the B*NP (query, probe) pairs by
//     partition on the device: counts (in shared memory when they fit), an
//     exclusive scan and a fill give a CSR list of pair ids per partition
//     (their order inside a partition comes from atomics), cut into work
//     groups of at most G queries, listed in partition order. All of it
//     lives in scratch the caller allocates (see probe_candidates_cuda).
//  2. probe_scan (persistent, one block per SM): a producer warp takes work
//     groups from an atomic counter, in list order, so the groups of a hot
//     partition run side by side and its re-reads come from L2; it fetches
//     the next group over the current group's first stages, so those
//     dependent loads stay off the copy path. It streams the group's
//     partition through a ring of four shared-memory stages, one 128-slot
//     sub-block per stage: the rows as 2-D TMA boxes of 128 rows x 128 B in
//     the 128B swizzle (three per stage at D=384; the swizzle puts a
//     thread-per-row 16-byte read of eight neighbouring rows on distinct
//     banks, where the plain 384-byte stride puts them all on one), the
//     five filter columns and the group's query rows by cp.async.bulk, all
//     counted on the stage's mbarrier. Eight consumer warps score a stage:
//     thread (lane l, half h) takes slot j*128 + l against the group's
//     queries h, h+2, ... with __dp4a from shared memory (the query rows are
//     broadcast reads), keeps their top-2 in registers across the
//     sub-blocks and writes them after the last one. The filter columns are
//     read once per group, not once per query. A row wider than one stage
//     holds (D > 1,664: at D = 2,048 a whole sub-block and its queries take
//     281,600 bytes) goes through the ring in parts of K (four of 512
//     bytes at D = 2,048, three stages): the consumers carry their dot
//     products across a sub-block's parts and score after the last, which
//     brings the columns. Every narrower width keeps one stage a
//     sub-block, as before.
//
// What bounds it now: the memory rate. The scan moves the distinct
// partitions' bytes at about 2.9 TB/s, 86% of the bound with the plan
// included. A first version that copied each 384-byte row with its own
// bulk copy (133 copies per stage) and fetched each next group only when
// it needed it took 0.749 ms.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int G = 8;                     // queries per work group
constexpr int QPT = G / 2;               // queries per consumer thread
constexpr int CONSUMER_WARPS = 8;        // 256 threads: 128 lanes x 2 halves
constexpr int THREADS = 32 * (CONSUMER_WARPS + 1);
constexpr int MAX_STAGES = 4;
constexpr int PLAN_THREADS = 1024;
constexpr int PLAN_SMEM_COUNTS = 12 * 1024;  // partitions whose counts the plan keeps in 48 KB
constexpr int NCOLS = 5;                 // scale, row, court word, court bit, date
constexpr int COL_BYTES = TSS_LANES * 4;
constexpr int KBOX = 128;                // bytes of a row per TMA box (the 128B swizzle span)
constexpr int BOX_BYTES = TSS_LANES * KBOX;
constexpr int SMEM_BLOCK = 232448;       // shared memory of one block per SM
constexpr int SPLIT_STAGES = 3;          // ring stages a row split into parts keeps

// One stage, 1024-byte aligned: kp of the rows' 128-byte boxes for the
// sub-block's 128 rows ([128 rows][128 B] each, in the 128B swizzle) |
// columns | the group's query rows, the same part of them | query scalars
// | header. A stage holds the whole row (kp = kb) at every width where
// one such stage fits (up to D = 1,664); wider rows go through the ring
// in np parts of K, the consumers' dot products carried in registers
// across a sub-block's parts and the columns loaded with its last part.
struct Layout {
  int kb, kp, np, qw, cols, q, par, hdr, bytes;
  __host__ __device__ Layout(int D, int kp_) {
    kb = (D + KBOX - 1) / KBOX;
    kp = kp_;
    np = (kb + kp - 1) / kp;
    qw = kp == kb ? D : kp * KBOX;  // bytes of a query row in a stage (its stride)
    cols = kp * BOX_BYTES;
    q = cols + NCOLS * COL_BYTES;
    par = q + G * qw;
    hdr = par + 5 * G * 4;
    bytes = (hdr + 16 + 1023) / 1024 * 1024;
  }
  // bytes of part p of a row
  __host__ __device__ int part_bytes(int D, int p) const {
    const int lo = p * kp * KBOX;
    return (D - lo < kp * KBOX ? D - lo : kp * KBOX);
  }
};

__host__ __device__ inline int stages_for(const Layout& L) {
  const int s = (SMEM_BLOCK - 1024) / (L.bytes + 16);
  return s < MAX_STAGES ? s : MAX_STAGES;
}

// Boxes of K a stage holds at width D: the whole row where one stage of it
// fits, else the widest part that leaves SPLIT_STAGES stages (0: none).
__host__ inline int stage_boxes(int D) {
  const int kb = (D + KBOX - 1) / KBOX;
  if (stages_for(Layout(D, kb)) >= 1) return kb;
  for (int kp = kb - 1; kp >= 1; --kp)
    if (stages_for(Layout(D, kp)) >= SPLIT_STAGES) return kp;
  return 0;
}

// Wait until the phase of parity `parity` of the barrier has completed; a
// wait that never ends (a lost copy) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 22)) __trap();
  }
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ int clamp_pid(int p, int P) { return min(max(p, 0), P - 1); }

// groups[g] = (partition, first pair in `pairs`, queries); meta[0] = number
// of groups, meta[1] = the scan's work counter (zeroed here). The counts
// (then the fill's cursors) live in shared memory when `P` of them fit
// (dynamic shared memory of P ints), else in `counts_g`.
__global__ void __launch_bounds__(PLAN_THREADS) probe_plan(
    const int32_t* __restrict__ top_p, int BNP, int P, int max_groups,
    int4* __restrict__ groups, int32_t* __restrict__ meta, int32_t* __restrict__ counts_g,
    int32_t* __restrict__ pairs, int in_smem) {
  extern __shared__ int counts_s[];
  __shared__ int warp_pairs[32], warp_groups[32];
  int* counts = in_smem ? counts_s : counts_g;
  // a count written by other threads' atomics: from L2 when in device memory
  auto count = [&](int p) { return in_smem ? counts[p] : __ldcg(&counts_g[p]); };
  const int t = threadIdx.x;
  for (int p = t; p < P; p += PLAN_THREADS) counts[p] = 0;
  if (t == 0) meta[1] = 0;
  __syncthreads();
  for (int i = t; i < BNP; i += PLAN_THREADS) atomicAdd(&counts[clamp_pid(top_p[i], P)], 1);
  __syncthreads();

  // exclusive scan of (pairs, groups) over the partitions: thread t owns
  // a contiguous range of them
  const int per = (P + PLAN_THREADS - 1) / PLAN_THREADS;
  const int lo = min(P, t * per), hi = min(P, lo + per);
  int n_pairs = 0, n_groups = 0;
  for (int p = lo; p < hi; ++p) {
    const int c = count(p);
    n_pairs += c;
    n_groups += (c + G - 1) / G;
  }
  int in_pairs = n_pairs, in_groups = n_groups;  // inclusive, within the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(0xffffffffu, in_pairs, o);
    const int b = __shfl_up_sync(0xffffffffu, in_groups, o);
    if ((t & 31) >= o) {
      in_pairs += a;
      in_groups += b;
    }
  }
  if ((t & 31) == 31) {
    warp_pairs[t >> 5] = in_pairs;
    warp_groups[t >> 5] = in_groups;
  }
  __syncthreads();
  if (t < 32) {
    int a = warp_pairs[t], b = warp_groups[t];
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, a, o);
      const int y = __shfl_up_sync(0xffffffffu, b, o);
      if (t >= o) {
        a += x;
        b += y;
      }
    }
    warp_pairs[t] = a;
    warp_groups[t] = b;
  }
  __syncthreads();
  int off = in_pairs - n_pairs + (t >= 32 ? warp_pairs[(t >> 5) - 1] : 0);
  int goff = in_groups - n_groups + (t >= 32 ? warp_groups[(t >> 5) - 1] : 0);
  for (int p = lo; p < hi; ++p) {
    const int c = count(p);
    counts[p] = off;  // the fill's cursor
    for (int k = 0; k < c; k += G, ++goff)
      if (goff < max_groups) groups[goff] = make_int4(p, off + k, min(G, c - k), 0);
    off += c;
  }
  if (t == PLAN_THREADS - 1) meta[0] = min(goff, max_groups);
  __syncthreads();
  for (int i = t; i < BNP; i += PLAN_THREADS)
    pairs[atomicAdd(&counts[clamp_pid(top_p[i], P)], 1)] = i;
}

// What the producer knows of a work group: the group and, in lane l < its
// query count, query l's pair id, row and scalars.
struct GroupRef {
  int4 grp;  // partition, first pair, queries (-1: no more groups), unused
  int pair, b, qlo, qhi;
  float qsc, qmin;
};

__global__ void __launch_bounds__(THREADS, 1) probe_scan(
    const __grid_constant__ CUtensorMap rows_map, const int8_t* __restrict__ q8,
    const float* __restrict__ qscale, const float* __restrict__ pscale,
    const int32_t* __restrict__ prows, const int32_t* __restrict__ pcword,
    const int32_t* __restrict__ pcbit, const int32_t* __restrict__ pdate,
    const int32_t* __restrict__ qwords, const int32_t* __restrict__ dlo,
    const int32_t* __restrict__ dhi, const float* __restrict__ mins,
    float* __restrict__ out_v, int32_t* __restrict__ out_s,
    const int4* __restrict__ groups, int32_t* __restrict__ meta,
    const int32_t* __restrict__ pairs, int NP, int m, int D, int W, int kp, int stages) {
  extern __shared__ unsigned char smem_raw[];
  const Layout L(D, kp);
  const uint32_t raw = tss_smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 128B swizzle's alignment
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bars = base + stages * L.bytes;  // full[s], then empty[s]
  const int tid = threadIdx.x;
  const int nb = m / TSS_LANES;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      tss_mbar_init(bars + 8 * s, 1);                          // the producer + bytes
      tss_mbar_init(bars + 8 * (stages + s), CONSUMER_WARPS);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 32 * CONSUMER_WARPS) {
    // producer warp. The next group is fetched in steps spread over the
    // current group's stages (the counter at j=0, the group at j=2, its
    // pairs at j=4, their scalars at j=6), so the dependent loads' latency
    // hides behind the copies.
    const int l = tid & 31;
    const int n_groups = meta[0];
    const int jB = min(2, nb - 1), jC = min(4, nb - 1), jD = min(6, nb - 1);
    // lanes 16..20 copy the columns, 21.. the query rows
    const int32_t* col = l == 16   ? reinterpret_cast<const int32_t*>(pscale)
                         : l == 17 ? prows
                         : l == 18 ? pcword
                         : l == 19 ? pcbit
                                   : pdate;
    auto fetch_index = [&]() {
      const int g = l == 0 ? atomicAdd(&meta[1], 1) : 0;
      return __shfl_sync(0xffffffffu, g, 0);
    };
    auto fetch_group = [&](GroupRef& r, int g) {
      r.grp = g < n_groups ? groups[g] : make_int4(0, 0, -1, 0);
    };
    auto fetch_pair = [&](GroupRef& r) {
      if (l < r.grp.z) {
        r.pair = pairs[r.grp.y + l];
        r.b = r.pair / NP;
      }
    };
    auto fetch_scalars = [&](GroupRef& r) {
      if (l < r.grp.z) {
        r.qsc = qscale[r.b];
        r.qmin = mins[r.b];
        r.qlo = dlo[r.b];
        r.qhi = dhi[r.b];
      }
    };
    GroupRef cur{}, nxt{};
    fetch_group(cur, fetch_index());
    fetch_pair(cur);
    fetch_scalars(cur);
    int it = 0;
    for (; cur.grp.z >= 0; cur = nxt) {
      const int pid = cur.grp.x, cnt = cur.grp.z;
      int g_next = 0;
      for (int j = 0; j < nb; ++j) {
        if (j == 0) g_next = fetch_index();
        if (j == jB) fetch_group(nxt, g_next);
        if (j == jC) fetch_pair(nxt);
        if (j == jD) fetch_scalars(nxt);
        for (int p = 0; p < L.np; ++p, ++it) {
          const int s = it % stages;
          if (it >= stages) mbar_wait(bars + 8 * (stages + s), ((it / stages) & 1) ^ 1);
          unsigned char* st = smem + s * L.bytes;
          const uint32_t sb = base + s * L.bytes;
          const uint32_t full = bars + 8 * s;
          const bool last = p == L.np - 1;
          const int pb = L.part_bytes(D, p);
          const int nbox = (pb + KBOX - 1) / KBOX;
          if (l < cnt) {
            int* par = reinterpret_cast<int*>(st + L.par);
            par[l] = cur.pair;
            par[G + l] = __float_as_int(cur.qsc);
            par[2 * G + l] = __float_as_int(cur.qmin);
            par[3 * G + l] = cur.qlo;
            par[4 * G + l] = cur.qhi;
          }
          if (l == 0)
            *reinterpret_cast<int4*>(st + L.hdr) = make_int4(pid, cur.grp.y, cnt, j * L.np + p);
          __syncwarp();
          if (l == 0)
            tss_mbar_expect_tx(full, nbox * BOX_BYTES + (last ? NCOLS * COL_BYTES : 0) + cnt * pb);
          __syncwarp();
          const int row0 = pid * m + j * TSS_LANES;
          for (int k = l; k < nbox && l < 16; k += 16)
            tss_tma_load_2d(sb + k * BOX_BYTES, &rows_map, full, (p * L.kp + k) * KBOX, row0);
          if (last && l >= 16 && l < 16 + NCOLS)
            bulk_load(sb + L.cols + (l - 16) * COL_BYTES, col + row0, COL_BYTES, full);
          // the query rows' part: lane 21 + q carries query q's (its scalars sit in lane q)
          const int qb = __shfl_sync(0xffffffffu, cur.b, (l - 21) & 31);
          if (l >= 21 && l - 21 < cnt)
            bulk_load(sb + L.q + (l - 21) * L.qw, q8 + (size_t)qb * D + p * L.kp * KBOX, pb, full);
        }
      }
    }
    // no more groups: an empty stage tells the consumers to stop
    const int s = it % stages;
    if (it >= stages) mbar_wait(bars + 8 * (stages + s), ((it / stages) & 1) ^ 1);
    if (l == 0) {
      *reinterpret_cast<int4*>(smem + s * L.bytes + L.hdr) = make_int4(0, 0, -1, 0);
      tss_mbar_arrive(bars + 8 * s);
    }
    return;
  }

  // consumers: lane `lane` of the sub-block, queries half, half + 2, ...
  const int lane = tid & (TSS_LANES - 1);
  const int half = tid >> 7;
  const int qw16 = L.qw / 16;
  // 16-byte chunk c of this lane's row part in the swizzled boxes
  const int row_off = lane * KBOX;
  const int sw = lane & 7;
  auto chunk = [&](const unsigned char* rows, int c) {
    return *reinterpret_cast<const int4*>(rows + (c >> 3) * BOX_BYTES + row_off +
                                          (((c & 7) ^ sw) << 4));
  };
  float v1[QPT], v2[QPT];
  int j1[QPT], j2[QPT], pair[QPT];
  int acc0[QPT], acc1[QPT];
  for (int it = 0;; ++it) {
    const int s = it % stages;
    mbar_wait(bars + 8 * s, (it / stages) & 1);
    const unsigned char* st = smem + s * L.bytes;
    const int4 hdr = *reinterpret_cast<const int4*>(st + L.hdr);
    const int cnt = hdr.z, j = hdr.w / L.np, p = hdr.w % L.np;
    if (cnt < 0) break;
    const bool last = p == L.np - 1;
    if (half < cnt) {
      if (p == 0) {
#pragma unroll
        for (int k = 0; k < QPT; ++k) acc0[k] = acc1[k] = 0;
      }
      const int dw = L.part_bytes(D, p) / 16;
      const int4* qr = reinterpret_cast<const int4*>(st + L.q);
      int c = 0;
      for (; c + 1 < dw; c += 2) {
        const int4 r0 = chunk(st, c), r1 = chunk(st, c + 1);
#pragma unroll
        for (int k = 0; k < QPT; ++k) {
          const int qi = half + 2 * k;
          if (qi < cnt) {
            acc0[k] = tss_dot16(r0, qr[qi * qw16 + c], acc0[k]);
            acc1[k] = tss_dot16(r1, qr[qi * qw16 + c + 1], acc1[k]);
          }
        }
      }
      if (c < dw) {
        const int4 r0 = chunk(st, c);
#pragma unroll
        for (int k = 0; k < QPT; ++k) {
          const int qi = half + 2 * k;
          if (qi < cnt) acc0[k] = tss_dot16(r0, qr[qi * qw16 + c], acc0[k]);
        }
      }
      if (last) {
        const int* col = reinterpret_cast<const int*>(st + L.cols);
        const float slot_scale = __int_as_float(col[lane]);
        const int prow = col[TSS_LANES + lane];
        const int cw = col[2 * TSS_LANES + lane];
        const int cb = col[3 * TSS_LANES + lane];
        const int dt = col[4 * TSS_LANES + lane];
        const int* par = reinterpret_cast<const int*>(st + L.par);
#pragma unroll
        for (int k = 0; k < QPT; ++k) {
          const int qi = half + 2 * k;
          if (qi < cnt) {
            pair[k] = par[qi];
            const float qsc = __int_as_float(par[G + qi]);
            const float qmin = __int_as_float(par[2 * G + qi]);
            float sc = __fmul_rn(__fmul_rn(__int2float_rn(acc0[k] + acc1[k]), qsc), slot_scale);
            const int b = pair[k] / NP;
            const int qw = (cw >= 0 && cw < W) ? __ldg(qwords + (size_t)b * W + cw) : 0;
            const bool keep = (qw & cb) != 0 && dt >= par[3 * G + qi] && dt <= par[4 * G + qi] &&
                              prow >= 0 && sc >= qmin;
            if (!keep) sc = tss_neg_inf();
            if (j == 0) {
              v1[k] = sc;
              j1[k] = 0;
              v2[k] = tss_neg_inf();
              j2[k] = 0;
            } else {
              // the loser of the slot-1 contest competes for slot 2
              const bool gt1 = sc > v1[k];
              const float c2v = gt1 ? v1[k] : sc;
              const int c2j = gt1 ? j1[k] : j;
              if (gt1) {
                v1[k] = sc;
                j1[k] = j;
              }
              if (c2v > v2[k]) {
                v2[k] = c2v;
                j2[k] = c2j;
              }
            }
          }
        }
      }
    }
    __syncwarp();
    if ((tid & 31) == 0) tss_mbar_arrive(bars + 8 * (stages + s));
    if (last && j == nb - 1 && half < cnt) {
#pragma unroll
      for (int k = 0; k < QPT; ++k) {
        if (half + 2 * k < cnt) {
          const size_t o = (size_t)pair[k] * 2 * TSS_LANES + lane;
          out_v[o] = v1[k];
          out_v[o + TSS_LANES] = v2[k];
          out_s[o] = j1[k] * TSS_LANES + lane;
          out_s[o + TSS_LANES] = j2[k] * TSS_LANES + lane;
        }
      }
    }
  }
}

// Per device: its streaming multiprocessors, 0 until probe_scan's shared
// memory limit is raised there (a function attribute is set per device, so
// a process that launches on several cards sets it on each).
constexpr int MAX_DEVICES = 64;
int g_sms[MAX_DEVICES] = {};

}  // namespace

// Queries per work group; the wrapper sizes its scratch with it.
extern "C" int tss_probe_group_size() { return G; }

// scratch: int32, 4 * max_groups (groups) + 4 (meta) + P (counts) + B*NP
// (pairs), 16-byte aligned; max_groups >= the groups the plan can make
// (sum over partitions of ceil(pairs / G)). Returns a cudaError_t, or 1000
// when the TMA tensor map could not be made.
extern "C" int tss_probe_candidates(
    const int8_t* q8, const float* qscale, const int32_t* top_p,
    const int8_t* part_int8, const float* pscale, const int32_t* prows,
    const int32_t* pcword, const int32_t* pcbit, const int32_t* pdate,
    const int32_t* qwords, const int32_t* dlo, const int32_t* dhi,
    const float* mins, float* out_v, int32_t* out_s, int32_t* scratch,
    int max_groups, int B, int NP, int P, int m, int D, int W, void* stream) {
  if (D % 16 || D <= 0 || m % TSS_LANES || m <= 0 || P <= 0 || B <= 0 || NP <= 0 ||
      max_groups <= 0 || (long long)B * NP >= (1LL << 31) || (long long)P * m >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int kp = stage_boxes(D);
  if (kp < 1) return (int)cudaErrorInvalidValue;
  const Layout L(D, kp);
  const int stages = stages_for(L);
  const size_t smem = 1024 + (size_t)stages * (L.bytes + 16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (g_sms[dev] == 0) {
    int sms = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)err;
    if ((err = cudaFuncSetAttribute(probe_scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    SMEM_BLOCK)) != cudaSuccess)
      return (int)err;
    g_sms[dev] = sms;
  }
  // the partitions' rows as one [P * m, D] byte matrix, boxes of 128 rows
  // x 128 bytes (zeros past the row's end)
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)P * m}, strides[1] = {(cuuint64_t)D};
  const cuuint32_t box[2] = {KBOX, TSS_LANES};
  CUtensorMap rows_map;
  if (!tss_make_map(&rows_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, part_int8, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B))
    return 1000;
  int4* groups = reinterpret_cast<int4*>(scratch);
  int32_t* meta = scratch + 4 * (size_t)max_groups;
  int32_t* counts = meta + 4;
  int32_t* pairs = counts + P;
  const int in_smem = P <= PLAN_SMEM_COUNTS;
  probe_plan<<<1, PLAN_THREADS, in_smem ? P * 4 : 0, st>>>(top_p, B * NP, P, max_groups, groups,
                                                          meta, counts, pairs, in_smem);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int grid = std::min(g_sms[dev], max_groups);
  probe_scan<<<grid, THREADS, smem, st>>>(rows_map, q8, qscale, pscale, prows, pcword, pcbit,
                                         pdate, qwords, dlo, dhi, mins, out_v, out_s, groups, meta,
                                         pairs, NP, m, D, W, kp, stages);
  return (int)cudaGetLastError();
}
