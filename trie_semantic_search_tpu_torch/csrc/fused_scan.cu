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
// For each lane l = r % 128 it runs the TPU kernel's list update over the
// lane's rows in ascending order: a strict '>' bubble insert into T slots
// sorted by score. Dead slots stay (-inf, -1).
//
// That update is sequential, not a top-T that can be merged: on a tie the
// carried entry does not pass its equal, so a higher score arriving after
// two equal ones drops the LOWER row (rows 0 and 128 at 5.0, then row 256
// at 6.0, keep rows 256 and 128 at T=2; split before row 128 and merged,
// they would keep rows 256 and 0). So every lane's rows go through one
// thread, in row order, as the TPU grid walks them; nothing is merged.
//
// Two variants. The caller picks one by T and D (fused_scan_variant in
// ops/scan_kernels.py), explicitly and never as a fallback:
//
// * tss_fused_scan_wgmma, T <= 16 and D <= 2048 (every serving T: the
//   engine's k buckets give T = 2, 3, 5). The products run on the int8
//   tensor cores (wgmma m64n64k32 .s32.s8.s8).
// * tss_fused_scan_dp4a, any T up to 64: products as __dp4a on CUDA cores
//   (4 multiply-adds per instruction), one thread per lane and query tile.
//
// What bounds it on an H100: a 256-query batch against one 163,840-row
// slab at D=384 is 63 MB of rows (18.8 us at 3.35 TB/s) and 16.1 G
// multiply-adds (16.3 us at 1,979 T int8 op/s): bytes and tensor-core
// operations about equally. The list update (scale, filter, bubble) is
// 42 M (row, query) elements of a few dependent CUDA-core instructions
// each, and it, not the products, is what the design has to hide.
//
// Design of the wgmma variant. A block owns 64 queries and one group of 8
// lanes and walks all N/128 row tiles of the call, 8 tiles (64 rows) a
// step; the grid is (ceil(B / 64) query tiles, 16 lane groups), query
// tiles fastest, so the blocks that read one lane group's rows run
// together and re-read them from L2 (64 blocks for B=256, about one per
// SM). Three roles, 672 threads:
//
// * loader (warp 4): one thread loads the query tile once and streams the
//   steps through a ring of 2-6 stages in shared memory with TMA. A step's
//   box is 8 tiles x 8 lanes x 128 bytes of K (128B swizzle; bytes past D
//   and tiles past N/128 read 0), so shared row c = 8 j + i holds lane
//   l0 + i of tile 8 step + j; the row columns (scale, court word and
//   bit, date) come with it, 8 x 8 values each. Up to D = 896 a stage
//   holds a whole step; wider, the query tile takes most of shared memory
//   (128 KB at D = 2048) and a stage holds one box of K, so a step goes
//   through the ring in ceil(D / 128) parts (six stages at D = 2048), its
//   columns with the first part. Such a block takes 4 lanes and 16 tiles a
//   step (still 64 rows, the wgmma N), so twice the blocks (128 for B=256)
//   keep twice the copies in flight, with 8 updater warps each.
// * scorers (warps 0-3, one warpgroup): wgmma multiplies the 64 queries
//   (operand A, K-major as they lie) by the 64 rows (operand B, K-major as
//   the corpus lies) in ceil(D/32) k32 steps into 32 int32 registers a
//   thread, and writes them raw, with the step's row columns, into one of
//   two buffers in shared memory; then the stage goes back to the loader.
//   A step in parts chains each part's products onto the accumulators and
//   hands a part's stage back once the next part's products are issued.
// * list updaters (warps 5-20): thread u keeps the list of query u / 8 and
//   lane l0 + u % 8 in registers and takes its 8 products of each step in
//   row order: scale, filter (a dropped row scores -inf) and a strict '>'
//   bubble through the T slots, as selects. Named barriers pass the two
//   buffers between scorers and updaters.
//
// Why so: with the lists in the scorers' own registers (one warp per
// scheduler) the dependent bubble chains ran at a fraction of the issue
// rate and the kernel took 0.44-0.57 ms at T=2; sixteen updater warps hide
// them. A branch per element that some lane takes diverges, and its
// convergence barrier cost more than the bubble itself, so the filters
// are branch-free and the only branches are warp votes: a tile whose
// scores beat no tail of the warp's 32 lists (the tail only rises; about
// T ln(tiles / T) insertions per list over a call) skips the bubble.
// Reading the accumulators only in convergent code keeps ptxas from
// serialising the wgmma. The lists go straight to the [B, T*128] output:
// no partial lists, no merge kernel.
#include "common.cuh"

namespace {

constexpr int MAX_T = 64;       // longest lane list of the dp4a variant
constexpr int DP4A_QB = 8;      // queries per block of the dp4a variant

constexpr int WG_MAX_T = 16;    // longest lane list the wgmma variant holds
constexpr int WG_MAX_D = 2048;  // widest row (beyond 896 the ring holds parts of K)
constexpr int QT = 64;          // queries per block (wgmma M)
constexpr int STEP_ROWS = 64;   // rows per step (wgmma N): LG lanes x STEP_ROWS / LG tiles
constexpr int LG = 8;           // lanes per block where a stage holds a whole step
constexpr int SPLIT_LG = 4;     // lanes per block where a step goes in parts: twice the blocks
constexpr int KBOX = 128;       // bytes of K per TMA box (the 128B swizzle span)
constexpr int BOX_BYTES = 64 * KBOX;  // 64 rows (queries, or one step's rows) x 128 B
constexpr int COL_BYTES = STEP_ROWS * 4;  // one row column of a step
constexpr int COLS_BYTES = 4 * COL_BYTES;  // scale, court word, court bit, date
constexpr int MAX_STAGES = 6;
constexpr int SCORERS = 128;          // the wgmma warpgroup
constexpr int SROW = STEP_ROWS + 8;   // words per query row of the product buffer (padded)
constexpr int SCORE_BYTES = QT * SROW * 4 + COLS_BYTES;  // products, then the row columns
constexpr int NBUF = 2;               // score buffers between the scorers and the updaters
constexpr int SMEM_LIMIT = 232448;

// ---------------------------------------------------------------------------
// PTX helper: 3-D TMA boxes (the barrier wait, the wgmma helpers and the
// score hand-off in common.cuh)
// ---------------------------------------------------------------------------

// A 3-D TMA box into shared memory, its bytes counted on `bar`
// (coordinates innermost first, in elements).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma variant
// ---------------------------------------------------------------------------

// The ring: each stage holds kp of a step's ceil(D / 128) boxes of K, and
// `stages` of them fit beside the whole query tile. A whole step a stage
// where two such stages fit (D <= 896, the layout this kernel had before
// it took wider rows); past that one box (128 bytes of K) a stage and as
// many stages as fit, at least three, so that one part's products run
// while the next part's copy lands. kp 0: the width does not fit.
struct WgPlan {
  int kp, stages;
};

__host__ inline WgPlan wgmma_plan(int D) {
  const int kb = (D + KBOX - 1) / KBOX;
  const int fixed = 1024 /* alignment */ + 256 /* barriers */ + kb * BOX_BYTES + NBUF * SCORE_BYTES;
  const int whole = (SMEM_LIMIT - fixed) / (kb * BOX_BYTES + COLS_BYTES);
  if (whole >= 2) return {kb, whole > MAX_STAGES ? MAX_STAGES : whole};
  const int part = (SMEM_LIMIT - fixed) / (BOX_BYTES + COLS_BYTES);
  return part >= 3 ? WgPlan{1, part > MAX_STAGES ? MAX_STAGES : part} : WgPlan{0, 0};
}

__host__ inline size_t wgmma_smem_bytes(int D, WgPlan plan) {
  const int kb = (D + KBOX - 1) / KBOX;
  return 1024 + 256 + (size_t)kb * BOX_BYTES + NBUF * SCORE_BYTES +
         (size_t)plan.stages * (plan.kp * BOX_BYTES + COLS_BYTES);
}

// One part's k32 steps of the 64 x 64 product into `acc`, chained onto
// what it holds unless this is the step's first part, and committed:
// the queries' part at `a`, the rows' at `b` (128-byte boxes BOX_BYTES
// apart). No register fence: products into one accumulator chain in
// order, so only the step's first part needs one.
__device__ __forceinline__ void wgmma_part(int (&acc)[32], uint32_t a, uint32_t b, int ksteps,
                                           bool chain) {
  for (int k = 0; k < ksteps; ++k) {
    const uint32_t off = (k >> 2) * BOX_BYTES + (k & 3) * 32;
    tss_mma_64x64x32(acc, tss_sw128_desc(a + off), tss_sw128_desc(b + off), chain || k > 0);
  }
  tss_wgmma_commit();
}

// Wait until at most one committed group of products is still running.
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// LGT lanes a block (one updater thread per query and lane), STEP_ROWS / LGT
// row tiles a step.
template <int TM, int LGT>
__global__ void __launch_bounds__(SCORERS + 32 + QT * LGT, 1) fused_scan_wgmma(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap cmap,
    const __grid_constant__ CUtensorMap smap, const __grid_constant__ CUtensorMap wmap,
    const __grid_constant__ CUtensorMap bmap, const __grid_constant__ CUtensorMap dmap,
    const float* __restrict__ qscale, const int32_t* __restrict__ qwords,
    const float* __restrict__ qdlo, const float* __restrict__ qdhi,
    const float* __restrict__ qmins, float* __restrict__ out_v, int32_t* __restrict__ out_i,
    int B, int D, int N, int W, int use_date, int T, int kp, int stages) {
  constexpr int TPS = STEP_ROWS / LGT;  // row tiles per step
  constexpr int UPDATERS = QT * LGT;    // one thread per (query, lane) list
  constexpr bool SPLIT = LGT == SPLIT_LG;  // a step in parts of K (else kp = kb)
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = tss_smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int kb = (D + KBOX - 1) / KBOX;
  const int np = (kb + kp - 1) / kp;  // parts of K a step goes through the ring in
  const uint32_t part_bytes = kp * BOX_BYTES;
  const uint32_t q_base = base;                          // [kb][64 queries][128 B]
  const uint32_t c_base = q_base + kb * BOX_BYTES;       // [stages][kp][64 rows][128 B]
  const uint32_t s_base = c_base + stages * part_bytes;  // [stages][4 columns][8 tiles][8 lanes], by step
  const uint32_t f_base = s_base + stages * COLS_BYTES;  // [NBUF] products and columns
  const uint32_t bars = f_base + NBUF * SCORE_BYTES;     // full[s], empty[s], query
  const uint32_t qbar = bars + 16 * stages;
  const unsigned char* cols_generic = smem_raw + (s_base - raw);
  int* sbuf = reinterpret_cast<int*>(smem_raw + (f_base - raw));
  const bool filtered = W > 0 || use_date;

  const int tid = threadIdx.x;
  // the role broadcast from lane 0, so the compiler sees it warp-uniform
  // and keeps the wgmma code on a convergent path
  const int role = __shfl_sync(0xffffffffu, tid < SCORERS ? 0 : tid < SCORERS + 32 ? 1 : 2, 0);
  const int b0 = blockIdx.x * QT;
  const int l0 = blockIdx.y * LGT;
  const int nj = N / TSS_LANES;
  const int nsteps = (nj + TPS - 1) / TPS;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      tss_mbar_init(bars + 8 * s, 1);  // full: the loader's arrival + bytes
      tss_mbar_init(bars + 8 * (stages + s), SCORERS / 32);  // empty: one per scorer warp
    }
    tss_mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (role == 1) {
    // loader: the query tile once, then every part of every step of this
    // lane group; a step's row columns come with its first part, into the
    // column slot of the step (it % stages), which the scorers read after
    // its last part
    if (tid == SCORERS) {
      tss_mbar_expect_tx(qbar, kb * BOX_BYTES);
      for (int c = 0; c < kb; ++c) tss_tma_load_2d(q_base + c * BOX_BYTES, &qmap, qbar, c * KBOX, b0);
      for (int it = 0, g = 0; it < nsteps; ++it) {
        for (int p = 0; p < (SPLIT ? np : 1); ++p, ++g) {
          const int s = g % stages;
          if (g >= stages) tss_mbar_wait(bars + 8 * (stages + s), ((g / stages) & 1) ^ 1);
          const uint32_t full = bars + 8 * s;
          const int nbox = SPLIT ? min(kp, kb - p * kp) : kb;
          tss_mbar_expect_tx(full, nbox * BOX_BYTES + (p ? 0 : filtered ? COLS_BYTES : COL_BYTES));
          for (int c = 0; c < nbox; ++c)
            tma_load_3d(c_base + s * part_bytes + c * BOX_BYTES, &cmap, full, (p * kp + c) * KBOX,
                        l0, it * TPS);
          if (p == 0) {
            const uint32_t cols = s_base + (it % stages) * COLS_BYTES;
            tss_tma_load_2d(cols, &smap, full, l0, it * TPS);
            if (filtered) {
              tss_tma_load_2d(cols + COL_BYTES, &wmap, full, l0, it * TPS);
              tss_tma_load_2d(cols + 2 * COL_BYTES, &bmap, full, l0, it * TPS);
              tss_tma_load_2d(cols + 3 * COL_BYTES, &dmap, full, l0, it * TPS);
            }
          }
        }
      }
    }
    return;
  }

  const int warp = tid / 32;
  const int lane = tid % 32;
  if (role == 2) {
    // list updaters: thread u keeps the list of query u / 8, lane l0 + u % 8;
    // per step it scales its 8 products, drops filtered rows to -inf and
    // bubbles the scores in row order (strict '>', as selects)
    const int u = tid - SCORERS - 32;
    const int q = u / LGT, l = u % LGT;
    const int b = b0 + q;
    const bool ok = b < B;
    const float qs = ok ? qscale[b] : 0.0f;
    const float mins = ok ? qmins[b] : __int_as_float(0x7f800000);  // past the batch: none
    const float lo = ok ? qdlo[b] : 0.0f, hi = ok ? qdhi[b] : 0.0f;
    const int32_t* words = qwords + (size_t)(ok ? b : 0) * W;
    // T itself where the instantiation is exact (TM <= 5), so the slot
    // tests fold away
    const int Tk = TM <= 5 ? TM : T;
    float lv[TM], tail = tss_neg_inf();  // slots t >= T stay -inf; tail is slot T - 1
    int li[TM];
#pragma unroll
    for (int t = 0; t < TM; ++t) {
      lv[t] = tss_neg_inf();
      li[t] = -1;
    }
    for (int it = 0; it < nsteps; ++it) {
      const int buf = it % NBUF;
      tss_named_bar_sync(1 + buf, SCORERS + UPDATERS);  // the step's products written
      const int* a = sbuf + buf * (SCORE_BYTES / 4) + q * SROW + l;
      const float* cols = reinterpret_cast<const float*>(sbuf + buf * (SCORE_BYTES / 4) + QT * SROW) + l;
      // the step's 8 scores of this list, -inf where a filter or the
      // threshold drops the row (one uniform branch a step; the filter
      // tests have no branch: the court word load is always in bounds)
      float v[TPS];
#pragma unroll
      for (int j = 0; j < TPS; ++j)
        v[j] = __fmul_rn(__fmul_rn(__int2float_rn(a[j * LGT]), qs), cols[j * LGT]);
      if (filtered) {
#pragma unroll
        for (int j = 0; j < TPS; ++j) {
          const int cw = __float_as_int(cols[COL_BYTES / 4 + j * LGT]);
          const int cb = __float_as_int(cols[2 * COL_BYTES / 4 + j * LGT]);
          const float dt = cols[3 * COL_BYTES / 4 + j * LGT];
          const bool in = (unsigned)cw < (unsigned)W;
          const bool court = (W == 0) | (in & ((__ldg(words + (in ? cw : 0)) & cb) != 0));
          const bool date = !use_date | ((dt >= lo) & (dt <= hi));
          v[j] = (v[j] >= mins) & court & date ? v[j] : tss_neg_inf();
        }
      } else {
#pragma unroll
        for (int j = 0; j < TPS; ++j) v[j] = v[j] >= mins ? v[j] : tss_neg_inf();
      }
      if (it + NBUF < nsteps) tss_named_bar_arrive(1 + NBUF + buf, SCORERS + UPDATERS);  // buffer read
      // which of the step's tiles can change some list of the warp: the
      // tail only rises within the step, so its value now decides (warp
      // votes, so every branch below is uniform)
      const int ntile = min(TPS, nj - it * TPS);
      unsigned enter = 0;
#pragma unroll
      for (int j = 0; j < TPS; ++j)
        enter |= (__any_sync(0xffffffffu, j < ntile && v[j] > tail) ? 1u : 0u) << j;
#pragma unroll
      for (int j = 0; j < TPS; ++j) {
        if (enter >> j & 1u) {
          float x = v[j];
          int r = (it * TPS + j) * TSS_LANES + l0 + l;
          // the new tail, slot T - 1, as the least of the first T slots (the
          // list is sorted; a signed zero is equal either way in a '>' test)
          tail = __int_as_float(0x7f800000);
#pragma unroll
          for (int t = 0; t < TM; ++t) {
            const bool p = x > lv[t] && t < Tk;
            const float cv = lv[t];
            const int ci = li[t];
            lv[t] = p ? x : cv;
            li[t] = p ? r : ci;
            x = p ? cv : x;
            r = p ? ci : r;
            if (t < Tk) tail = fminf(tail, lv[t]);
          }
        }
      }
    }
    if (ok) {
#pragma unroll
      for (int t = 0; t < TM; ++t) {
        if (t < Tk) {
          const size_t o = ((size_t)b * T + t) * TSS_LANES + l0 + l;
          out_v[o] = lv[t];
          out_i[o] = li[t];
        }
      }
    }
    return;
  }

  // scorers (warpgroup 0): the products on the tensor cores, written out
  // raw for the updaters
  int acc[32] = {};
  tss_mbar_wait(qbar, 0);
  if constexpr (!SPLIT) {
    const int ksteps = (D + 31) / 32;
    for (int it = 0; it < nsteps; ++it) {
      const int s = it % stages;
      tss_mbar_wait(bars + 8 * s, (it / stages) & 1);
      tss_wgmma_issue<BOX_BYTES, BOX_BYTES>(acc, q_base, c_base + s * part_bytes, ksteps);
      tss_wgmma_wait_all();
      tss_fence_regs(acc);
      // the raw products (the list updaters scale and filter them) and the
      // step's row columns into score buffer it % NBUF
      tss_dump_step<NBUF, SROW, SCORE_BYTES / 4, QT, SCORERS + UPDATERS>(
          acc, sbuf, cols_generic + s * COLS_BYTES, (filtered ? 4 : 1) * COL_BYTES, it, warp, lane);
      __syncwarp();
      if (lane == 0) tss_mbar_arrive(bars + 8 * (stages + s));  // products and columns taken
    }
  } else {
    // a step's parts chain into one accumulator; each part's stage goes
    // back to the loader once the next part's products are issued and its
    // own are done, the last one after the dump (which reads the step's
    // columns)
    for (int it = 0, g = 0; it < nsteps; ++it) {
      tss_wgmma_fence();
      tss_fence_regs(acc);
      for (int p = 0; p < np; ++p, ++g) {
        const int s = g % stages;
        tss_mbar_wait(bars + 8 * s, (g / stages) & 1);
        const int ksteps = min(4 * kp, (D - p * kp * KBOX + 31) / 32);
        wgmma_part(acc, q_base + p * part_bytes, c_base + s * part_bytes, ksteps, p > 0);
        if (p > 0) {
          wgmma_wait_one();
          __syncwarp();
          if (lane == 0) tss_mbar_arrive(bars + 8 * (stages + (g - 1) % stages));
        }
      }
      tss_wgmma_wait_all();
      tss_fence_regs(acc);
      tss_dump_step<NBUF, SROW, SCORE_BYTES / 4, QT, SCORERS + UPDATERS>(
          acc, sbuf, cols_generic + (it % stages) * COLS_BYTES, (filtered ? 4 : 1) * COL_BYTES, it,
          warp, lane);
      __syncwarp();
      if (lane == 0) tss_mbar_arrive(bars + 8 * (stages + (g - 1) % stages));
    }
  }
}

// ---------------------------------------------------------------------------
// dp4a variant: one block of 128 threads per 8-query tile; thread l walks
// lane l's rows in order (16-byte loads) and keeps each query's lane list
// in shared memory, the 8 queries read from shared memory as broadcasts.
// ---------------------------------------------------------------------------

__global__ void fused_scan_dp4a(
    const int8_t* __restrict__ q8, const float* __restrict__ qscale,
    const int32_t* __restrict__ qwords, const float* __restrict__ qdlo,
    const float* __restrict__ qdhi, const float* __restrict__ qmins,
    const int8_t* __restrict__ corpus, const float* __restrict__ cscale,
    const int32_t* __restrict__ cword, const int32_t* __restrict__ cbit,
    const float* __restrict__ cdate, float* __restrict__ out_v,
    int32_t* __restrict__ out_i, int B, int D, int N, int W, int use_date, int T) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dw = D / 16;
  int4* qs = reinterpret_cast<int4*>(smem);                   // [QB][dw]
  float* lv = reinterpret_cast<float*>(smem + DP4A_QB * D);   // [QB][T][128]
  int32_t* li = reinterpret_cast<int32_t*>(lv + DP4A_QB * T * TSS_LANES);

  const int lane = threadIdx.x;
  const int b0 = blockIdx.x * DP4A_QB;
  const int nq = min(DP4A_QB, B - b0);

  for (int x = lane; x < DP4A_QB * dw; x += TSS_LANES) {
    const int q = x / dw, c = x % dw;
    qs[x] = q < nq
        ? reinterpret_cast<const int4*>(q8 + (size_t)(b0 + q) * D)[c]
        : make_int4(0, 0, 0, 0);
  }
  for (int x = 0; x < DP4A_QB * T; ++x) {
    lv[x * TSS_LANES + lane] = tss_neg_inf();
    li[x * TSS_LANES + lane] = -1;
  }
  __syncthreads();

  for (int j = 0; j < N / TSS_LANES; ++j) {
    const long long row = (long long)j * TSS_LANES + lane;
    const int4* rp = reinterpret_cast<const int4*>(corpus + row * D);
    int acc[DP4A_QB];
#pragma unroll
    for (int q = 0; q < DP4A_QB; ++q) acc[q] = 0;
    for (int c = 0; c < dw; ++c) {
      const int4 r = __ldg(rp + c);
#pragma unroll
      for (int q = 0; q < DP4A_QB; ++q) acc[q] = tss_dot16(r, qs[q * dw + c], acc[q]);
    }
    const float rs = cscale[row];
    const int cw = W ? cword[row] : 0;
    const int cb = W ? cbit[row] : 0;
    const float dt = use_date ? cdate[row] : 0.0f;
#pragma unroll
    for (int q = 0; q < DP4A_QB; ++q) {
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
      const size_t o = ((size_t)(b0 + q) * T + t) * TSS_LANES + lane;
      out_v[o] = lv[(q * T + t) * TSS_LANES + lane];
      out_i[o] = li[(q * T + t) * TSS_LANES + lane];
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct ScanArgs {
  const float* qscale;
  const int32_t* qwords;
  const float *qdlo, *qdhi, *qmins;
  float* out_v;
  int32_t* out_i;
  int B, D, N, W, use_date, T;
};

template <int TM, int LGT>
cudaError_t launch_wgmma(const CUtensorMap (&maps)[6], const ScanArgs& a, WgPlan plan,
                         cudaStream_t st) {
  const size_t smem = wgmma_smem_bytes(a.D, plan);
  auto kernel = fused_scan_wgmma<TM, LGT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.B + QT - 1) / QT, TSS_LANES / LGT);
  kernel<<<grid, SCORERS + 32 + QT * LGT, smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], a.qscale, a.qwords, a.qdlo, a.qdhi,
      a.qmins, a.out_v, a.out_i, a.B, a.D, a.N, a.W, a.use_date, a.T, plan.kp, plan.stages);
  return cudaGetLastError();
}

// The list length's instantiation: T itself for the engine's T = 2, 3, 5
// (and 4), else the next of 8 and 16.
template <int LGT>
cudaError_t launch_for_t(const CUtensorMap (&maps)[6], const ScanArgs& a, WgPlan plan,
                         cudaStream_t st) {
  switch (a.T) {
    case 1:
    case 2: return launch_wgmma<2, LGT>(maps, a, plan, st);
    case 3: return launch_wgmma<3, LGT>(maps, a, plan, st);
    case 4: return launch_wgmma<4, LGT>(maps, a, plan, st);
    case 5: return launch_wgmma<5, LGT>(maps, a, plan, st);
    default:
      return a.T <= 8 ? launch_wgmma<8, LGT>(maps, a, plan, st)
                      : launch_wgmma<16, LGT>(maps, a, plan, st);
  }
}

}  // namespace

// out_v/out_i: [B, T*128] with element (b, t*128 + l) slot t of lane l's
// list. Grid (ceil(B / 64), 16), or (ceil(B / 64), 32) for a step in parts. Returns a cudaError_t, or 1000 when a TMA
// tensor map could not be made.
extern "C" int tss_fused_scan_wgmma(
    const int8_t* q8, const float* qscale, const int32_t* qwords,
    const float* qdlo, const float* qdhi, const float* qmins,
    const int8_t* corpus, const float* cscale, const int32_t* cword,
    const int32_t* cbit, const float* cdate, float* out_v, int32_t* out_i,
    int B, int D, int N, int W, int use_date, int T, void* stream) {
  const void* cols[4] = {cscale, cword, cbit, cdate};
  bool aligned = reinterpret_cast<uintptr_t>(q8) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(corpus) % 16 == 0;
  for (const void* c : cols) aligned = aligned && reinterpret_cast<uintptr_t>(c) % 16 == 0;
  if (T < 1 || T > WG_MAX_T || D % 16 || D > WG_MAX_D || N % TSS_LANES || N < TSS_LANES ||
      B < 1 || !aligned)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const WgPlan plan = wgmma_plan(D);
  if (plan.kp < 1) return (int)cudaErrorInvalidValue;
  // a step in parts streams its rows slower a block: twice the blocks
  // (half the lanes each) keep twice the copies in flight
  const int lg = plan.kp == (D + KBOX - 1) / KBOX ? LG : SPLIT_LG;
  const int nj = N / TSS_LANES;
  // queries [B, D]; rows as [tiles, 128 lanes, D]; row columns as [tiles, 128]
  const cuuint64_t qdims[2] = {(cuuint64_t)D, (cuuint64_t)B}, qstr[1] = {(cuuint64_t)D};
  const cuuint32_t qbox[2] = {KBOX, QT};
  const cuuint64_t cdims[3] = {(cuuint64_t)D, TSS_LANES, (cuuint64_t)nj};
  const cuuint64_t cstr[2] = {(cuuint64_t)D, (cuuint64_t)D * TSS_LANES};
  const cuuint32_t cbox[3] = {KBOX, (cuuint32_t)lg, (cuuint32_t)(STEP_ROWS / lg)};
  const cuuint64_t sdims[2] = {TSS_LANES, (cuuint64_t)nj}, sstr[1] = {TSS_LANES * 4};
  const cuuint32_t sbox[2] = {(cuuint32_t)lg, (cuuint32_t)(STEP_ROWS / lg)};
  const CUtensorMapDataType col_type[4] = {
      CU_TENSOR_MAP_DATA_TYPE_FLOAT32, CU_TENSOR_MAP_DATA_TYPE_INT32,
      CU_TENSOR_MAP_DATA_TYPE_INT32, CU_TENSOR_MAP_DATA_TYPE_FLOAT32};
  CUtensorMap maps[6];  // queries, rows, then scale, court word, court bit, date
  bool ok = tss_make_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q8, qdims, qstr, qbox,
                         CU_TENSOR_MAP_SWIZZLE_128B) &&
            tss_make_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, corpus, cdims, cstr, cbox,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  for (int c = 0; c < 4; ++c)
    ok = ok && tss_make_map(&maps[2 + c], col_type[c], 2, cols[c], sdims, sstr, sbox,
                            CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return 1000;
  const ScanArgs a{qscale, qwords, qdlo, qdhi, qmins, out_v, out_i, B, D, N, W, use_date, T};
  return (int)(lg == LG ? launch_for_t<LG>(maps, a, plan, st)
                         : launch_for_t<SPLIT_LG>(maps, a, plan, st));
}

// Shared memory one block of the dp4a variant needs.
extern "C" size_t tss_fused_scan_dp4a_smem_bytes(int D, int T) {
  return (size_t)DP4A_QB * D + (size_t)DP4A_QB * T * TSS_LANES * 8;
}

// Same outputs as tss_fused_scan_wgmma; grid ceil(B / 8).
extern "C" int tss_fused_scan_dp4a(
    const int8_t* q8, const float* qscale, const int32_t* qwords,
    const float* qdlo, const float* qdhi, const float* qmins,
    const int8_t* corpus, const float* cscale, const int32_t* cword,
    const int32_t* cbit, const float* cdate, float* out_v, int32_t* out_i,
    int B, int D, int N, int W, int use_date, int T, void* stream) {
  if (T < 1 || T > MAX_T || D % 16 || N % TSS_LANES) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = tss_fused_scan_dp4a_smem_bytes(D, T);
  cudaError_t err = cudaFuncSetAttribute(
      fused_scan_dp4a, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_scan_dp4a<<<(B + DP4A_QB - 1) / DP4A_QB, TSS_LANES, smem, st>>>(
      q8, qscale, qwords, qdlo, qdhi, qmins, corpus, cscale, cword, cbit,
      cdate, out_v, out_i, B, D, N, W, use_date, T);
  return (int)cudaGetLastError();
}
