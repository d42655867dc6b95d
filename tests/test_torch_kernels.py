"""The port's kernel wrappers (their plain versions on the CPU) against the
JAX package's Pallas kernels in interpret mode, on the same numpy inputs.

Tolerances: the three int8 kernels are compared bitwise (values and rows
or slots: int32 dots and the same f32 multiply order on both sides); the
rescore within 1e-5 (bf16 products are exact in f32, only the order of the
f32 sum differs).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from trie_semantic_search_tpu.ops import pallas_scan as ps
from trie_semantic_search_tpu_torch.ops import scan_kernels as sk

torch.set_num_threads(1)


def _filtered_data(B, D, N, V, seed, dup_every=0):
    rng = np.random.default_rng(seed)
    q8 = rng.integers(-127, 127, (B, D)).astype(np.int8)
    qs = (rng.random((B, 1)) * 0.01 + 1e-3).astype(np.float32)
    cq = rng.integers(-127, 127, (N, D)).astype(np.int8)
    cs = (rng.random((N, 1)) * 0.01 + 1e-3).astype(np.float32)
    if dup_every:
        # exact duplicate rows (equal scores): the tie order is under test
        src = np.arange(0, N, dup_every)
        cq[src[1:]] = cq[src[0]]
        cs[src[1:]] = cs[src[0]]
        cs[5] = 0.0  # zero scale: +0.0 / -0.0 scores
    court = rng.integers(0, V, N).astype(np.int32)
    date = rng.integers(0, 1000, N).astype(np.int32)
    table = rng.random((B, V)) < 0.7
    lo = rng.integers(0, 300, B).astype(np.int32)
    hi = rng.integers(600, 1000, B).astype(np.int32)
    ms = np.full(B, -1e30, np.float32)
    ms[0] = 0.0
    return q8, qs, cq, cs, court, date, table, lo, hi, ms


@pytest.mark.parametrize(
    "tile_n,lanes,V,k,use_court,use_date,dup",
    [
        (64, 32, 16, 7, True, True, 0),     # one court word
        (128, 32, 40, 40, True, True, 0),   # two court words, T=3
        (128, 32, 40, 12, False, True, 0),  # court mask dropped
        (64, 32, 16, 9, True, False, 3),    # ties and signed zeros
        (256, 128, 70, 20, True, True, 2),  # serving lane count, three words
        # the serving lane count at the engine's k buckets x overfetch 4
        # (k = 128, 256, 512: T = 2, 3, 5), with and without equal rows
        (1024, 128, 16, 128, True, True, 0),
        (1024, 128, 40, 128, True, True, 3),
        (1024, 128, 40, 256, True, False, 0),
        (1024, 128, 16, 256, True, True, 3),
        (1024, 128, 16, 512, False, True, 0),
        (1024, 128, 40, 512, True, True, 3),
    ],
)
def test_fused_scan_matches_pallas(tile_n, lanes, V, k, use_court, use_date, dup):
    B, D, N = 8, 64, max(512, 2 * tile_n)
    q8, qs, cq, cs, court, date, table, lo, hi, ms = _filtered_data(
        B, D, N, V, seed=tile_n + V + k, dup_every=dup
    )
    jv, ji = ps.pallas_fused_topk(
        jnp.asarray(q8), jnp.asarray(qs), jnp.asarray(cq), jnp.asarray(cs),
        jnp.asarray(court), jnp.asarray(date), jnp.asarray(table),
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(ms), k=k, tile_b=8,
        tile_n=tile_n, lanes=lanes, interpret=True, use_court=use_court,
        use_date=use_date,
    )
    t = torch.from_numpy
    tv, ti = sk.fused_scan_topk(
        t(q8), t(qs), t(cq), t(cs), t(court), t(date), t(table), t(lo),
        t(hi), t(ms), k=k, tile_n=tile_n, lanes=lanes, use_court=use_court,
        use_date=use_date,
    )
    np.testing.assert_array_equal(
        tv.numpy().view(np.int32), np.asarray(jv).view(np.int32)
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("D,T,variant", [
    (384, 2, "wgmma"),   # the B=256 stream's slab
    (384, 3, "wgmma"),   # the engine's k=64 bucket
    (384, 5, "wgmma"),   # the engine's k=128 bucket
    (80, 1, "wgmma"),    # D % 32 == 16
    (896, 16, "wgmma"),  # the longest list, the widest row a stage holds whole
    (384, 17, "dp4a"),   # T beyond the tensor-core lists
    (912, 2, "wgmma"),   # a row the ring takes in parts of K
    (2048, 2, "wgmma"),  # the widest row it takes (DeepSeek-V2-Lite's)
    (2064, 2, "dp4a"),   # a row wider than that
    (1024, 64, "dp4a"),  # the longest list the wrapper takes
])
def test_fused_scan_variant(D, T, variant):
    """The CUDA fused scan picks its variant from the row width and the
    lane list length alone (explicitly; a failed launch raises)."""
    assert sk.fused_scan_variant(D, T) == variant


@pytest.mark.parametrize("T", [2, 3])
def test_fused_scan_plain_lane_update_is_sequential(T):
    """The plain version runs the TPU kernel's sequential list update, in
    which a tie carried down by a higher score does not pass its equal:
    rows 0 and 128 score 5.0, row 256 scores 6.0 (all lane 0); at T=2 the
    list keeps rows 256 and 128, not the (score, row) top-2 256 and 0; at
    T=3 all three stay, in the slot order the update leaves."""
    D, N = 32, 512
    cq = np.zeros((N, D), np.int8)
    cq[[0, 128], 0] = 5
    cq[256, 0] = 6
    t = torch.from_numpy
    inp = sk.fused_scan_inputs(
        torch.ones(1), t(np.zeros(N, np.int32)), t(np.zeros(N, np.int32)),
        torch.ones((1, 16), dtype=torch.bool), torch.zeros(1, dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32), torch.full((1,), 1.0), torch.ones(N),
    )
    q8 = torch.zeros((1, D), dtype=torch.int8)
    q8[0, 0] = 1
    v, i = sk.fused_scan_plain(q8, corpus_q=t(cq), n_keep=T, use_court=False, use_date=False, **inp)
    lane0 = i[0, :: sk.LANES].tolist()
    assert lane0 == ([256, 128] if T == 2 else [256, 128, 0])
    assert v[0, :: sk.LANES].tolist() == [6.0, 5.0] + [5.0] * (T - 2)


def _probe_data(B, D, P, m, NP, V, seed):
    rng = np.random.default_rng(seed)
    q8 = rng.integers(-127, 127, (B, D)).astype(np.int8)
    qs = (rng.random((B, 1)) * 0.01 + 1e-3).astype(np.float32)
    pint8 = rng.integers(-127, 127, (P, m, D)).astype(np.int8)
    pscale = (rng.random((P, m)) * 0.01 + 1e-3).astype(np.float32)
    pint8[1, 3::7] = pint8[1, 2]  # equal scores inside one partition
    pscale[1, 3::7] = pscale[1, 2]
    prows = np.arange(P * m, dtype=np.int32).reshape(P, m)
    prows[-1, -5:] = -1  # pad slots
    prows[2, :] = -1  # an all-pad partition: every entry dead
    chunk_court = rng.integers(0, V, P * m).astype(np.int32)
    chunk_date = rng.integers(0, 1000, P * m).astype(np.int32)
    table = rng.random((B, V)) < 0.7
    lo = rng.integers(0, 300, B).astype(np.int32)
    hi = rng.integers(600, 1000, B).astype(np.int32)
    ms = np.full(B, -1e30, np.float32)
    ms[1] = 0.0
    top_p = rng.integers(0, P, (B, NP)).astype(np.int32)
    top_p[0, :3] = [P - 1, 2, 1]
    return (q8, qs, pint8, pscale, prows, chunk_court, chunk_date, table, lo,
            hi, ms, top_p)


def _skewed_top_p(B, NP, P):
    """Every query probes hot partition 1 (with equal scores inside),
    query 0 probes it twice, and the all-pad partition 2 is probed."""
    top_p = (np.arange(B * NP).reshape(B, NP) * 3 % P).astype(np.int32)
    top_p[:, 0] = 1
    top_p[0, 1] = 1
    top_p[1:, 1] = 2
    return top_p


@pytest.mark.parametrize("lanes,V,m,skewed", [
    (32, 16, 256, False), (32, 40, 256, False), (128, 70, 256, False),
    # the serving geometry: m=1024 at 128 lanes, nb=8 sub-blocks, and a
    # skewed, duplicated probe list
    (128, 16, 1024, True), (128, 40, 1024, True),
])
def test_probe_candidates_match_pallas(lanes, V, m, skewed):
    B, D, P, NP = 4, 32, 8, 4
    (q8, qs, pint8, pscale, prows, court, date, table, lo, hi, ms,
     top_p) = _probe_data(B, D, P, m, NP, V, seed=lanes + V + m)
    if skewed:
        top_p = _skewed_top_p(B, NP, P)
    pcw, pcb, pdt = ps.partition_filter_columns(prows, court, date)
    jv, js = ps.pallas_probe_candidates(
        jnp.asarray(q8), jnp.asarray(qs), jnp.asarray(top_p),
        jnp.asarray(pint8), jnp.asarray(pscale), jnp.asarray(prows), pcw,
        pcb, pdt, ps.pack_court_words(jnp.asarray(table)), jnp.asarray(lo),
        jnp.asarray(hi), jnp.asarray(ms), lanes=lanes, interpret=True,
    )
    t = torch.from_numpy
    cw, cb, cd = sk.partition_filter_columns(prows, court, date)
    tv, ts = sk.probe_candidates(
        t(q8), t(qs), t(top_p), t(pint8), t(pscale), t(prows), t(cw), t(cb),
        t(cd), sk.pack_court_words(t(table)), t(lo), t(hi), t(ms), lanes=lanes,
    )
    np.testing.assert_array_equal(
        tv.numpy().view(np.int32), np.asarray(jv).view(np.int32)
    )
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("B,NP,P,skew", [
    (64, 64, 5120, "random"), (64, 64, 5120, "shared"), (3072, 64, 5120, "random"),
    (3072, 64, 5120, "shared"), (5, 7, 3, "random"), (1, 1, 1, "shared"), (9, 16, 40, "one"),
])
def test_probe_scratch_holds_every_plan(B, NP, P, skew):
    """The CUDA probe's scratch holds the groups its plan makes from any
    probe list: per partition ceil(pairs / PROBE_GROUP), counted here with
    numpy on random, shared and single-partition lists (duplicates
    included), never more than probe_max_groups."""
    rng = np.random.default_rng(B + NP + P)
    top_p = rng.integers(0, P, (B, NP))
    if skew == "shared":
        top_p[:] = top_p[0]
    elif skew == "one":
        top_p[:] = P - 1
    counts = np.bincount(top_p.ravel(), minlength=P)
    groups = int((-(-counts // sk.PROBE_GROUP)).sum())
    assert groups <= sk.probe_max_groups(B, NP, P)
    if skew == "one":  # a single partition: exactly ceil(B*NP / G) groups
        assert groups == -(-B * NP // sk.PROBE_GROUP)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gather_rescore_matches_pallas_multi_segment(dtype):
    rng = np.random.default_rng(21)
    N, D, B, C = 1536, 64, 4, 24
    corpus = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((B, D)).astype(np.float32)
    idx = rng.integers(0, N, (B, C)).astype(np.int32)
    idx[0, :3] = [0, 511, 512]  # segment edges
    bounds = (0, 512, 1024, N)
    jseg = tuple(
        jnp.asarray(corpus[a:b], getattr(jnp, dtype))
        for a, b in zip(bounds, bounds[1:])
    )
    want = ps.pallas_gather_rescore(
        jnp.asarray(q), jseg, jnp.asarray(idx), interpret=True
    )
    tseg = tuple(
        torch.from_numpy(corpus[a:b]).to(getattr(torch, dtype))
        for a, b in zip(bounds, bounds[1:])
    )
    got = sk.gather_rescore_rows(torch.from_numpy(q), tseg, torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_layout_helpers_match_jax():
    rng = np.random.default_rng(3)
    table = rng.random((5, 70)) < 0.5
    np.testing.assert_array_equal(
        sk.pack_court_words(torch.from_numpy(table)).numpy(),
        np.asarray(ps.pack_court_words(jnp.asarray(table))).view(np.int32),
    )
    rows = np.arange(64, dtype=np.int32).reshape(4, 16)
    rows[3, 10:] = -1
    court = rng.integers(0, 70, 64).astype(np.int32)
    date = rng.integers(0, 99, 64).astype(np.int32)
    for got, want in zip(
        sk.partition_filter_columns(rows, court, date),
        ps.partition_filter_columns(rows, court, date),
    ):
        np.testing.assert_array_equal(got, np.asarray(want).view(got.dtype))
    v = rng.standard_normal((100, 8)).astype(np.float32)
    old_t, old_j = sk.GATHER_SEG_BYTES, ps.GATHER_SEG_BYTES
    try:
        sk.GATHER_SEG_BYTES = ps.GATHER_SEG_BYTES = 8 * 4 * 32
        got = sk.split_rescore_corpus(v)
        want = ps.split_rescore_corpus(v)
    finally:
        sk.GATHER_SEG_BYTES, ps.GATHER_SEG_BYTES = old_t, old_j
    assert [s.shape for s in got] == [s.shape for s in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for n in (100, sk.TILE_N, sk._BIG_N, sk._BIG_N + 5, 8 << 20):
        assert sk.auto_tile_n(n) == ps.auto_tile_n(n)
        assert sk.pad_align_for(n) == ps.pad_align_for(n)
    assert (sk.TILE_N, sk.TILE_N_BIG, sk.TILE_B) == (ps.TILE_N, ps.TILE_N_BIG, ps.TILE_B)


def _pallas_int8_topk(q8, qs, cq, cs, k, tile_b, tile_n):
    """``pallas_int8_topk``'s ``pallas_call`` in interpret mode (as
    ``tests/test_pallas.py`` runs it), at any tiling."""
    B, D = q8.shape
    N = cq.shape[0]
    if B % tile_b:
        tile_b = B
    vmem = dict(memory_space=pltpu.VMEM)
    return pl.pallas_call(
        functools.partial(ps._scan_kernel, k=k, tile_n=tile_n),
        grid=(B // tile_b, N // tile_n),
        in_specs=[
            pl.BlockSpec((tile_b, D), lambda b, n: (b, 0), **vmem),
            pl.BlockSpec((tile_b, 1), lambda b, n: (b, 0), **vmem),
            pl.BlockSpec((tile_n, D), lambda b, n: (n, 0), **vmem),
            pl.BlockSpec((tile_n, 1), lambda b, n: (n, 0), **vmem),
        ],
        out_specs=(
            pl.BlockSpec((tile_b, k), lambda b, n: (b, 0), **vmem),
            pl.BlockSpec((tile_b, k), lambda b, n: (b, 0), **vmem),
        ),
        out_shape=(jax.ShapeDtypeStruct((B, k), jnp.float32),
                   jax.ShapeDtypeStruct((B, k), jnp.int32)),
        scratch_shapes=[pltpu.VMEM((tile_b, k), jnp.float32), pltpu.VMEM((tile_b, k), jnp.int32)],
        interpret=True,
    )(*(jnp.asarray(a) for a in (q8, qs, cq, cs)))


def _int8_data(B, D, N, seed, zero_rows=0.0, dup_every=0):
    rng = np.random.default_rng(seed)
    q8 = rng.integers(-127, 127, (B, D)).astype(np.int8)
    qs = (rng.random((B, 1)) * 0.01 + 1e-3).astype(np.float32)
    cq = rng.integers(-127, 127, (N, D)).astype(np.int8)
    cs = (rng.random((N, 1)) * 0.01 + 1e-3).astype(np.float32)
    if dup_every:  # exact duplicate rows: equal scores, the lower row first
        cq[dup_every::dup_every] = cq[0]
        cs[dup_every::dup_every] = cs[0]
    if zero_rows:  # scale-0 rows (pad slots): +0.0 and -0.0 scores
        cs[rng.random(N) < zero_rows] = 0.0
        qs[::2] *= -1
    return q8, qs, cq, cs


def _port_int8_topk(q8, qs, cq, cs, k):
    v, i = sk.int8_topk(*(torch.from_numpy(a) for a in (q8, qs, cq, cs)), k)
    return v.numpy(), i.numpy()


def _assert_bitwise(got, want):
    np.testing.assert_array_equal(got[0].view(np.int32), np.asarray(want[0]).view(np.int32))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))


@pytest.mark.parametrize("B,N,tile_b,tile_n,k,zero_rows,dup", [
    (8, 512, 8, 128, 10, 0.0, 0),     # several tiles
    (16, 256, 8, 64, 7, 0.0, 5),      # two query tiles, equal scores
    (8, 256, 8, 32, 40, 0.0, 0),      # k above a tile's row count
    (4, 256, 4, 64, 8, 0.9, 0),       # mostly scale-0 rows: +-0 ties
    (12, 384, 256, 128, 33, 0.5, 7),  # single query tile (B % tile_b), all of it
])
def test_int8_topk_matches_pallas_kernel(B, N, tile_b, tile_n, k, zero_rows, dup):
    data = _int8_data(B, 32, N, seed=B + N + k, zero_rows=zero_rows, dup_every=dup)
    want = _pallas_int8_topk(*data, k, tile_b, tile_n)
    _assert_bitwise(_port_int8_topk(*data, k), want)


@pytest.mark.parametrize("chunk,k", [(32, 40), (100, 12), (256, 128)])
def test_int8_topk_plain_chunk_merge_matches_pallas_kernel(monkeypatch, chunk, k):
    """The plain version's running list across row chunks (one chunk for
    every other N here) keeps the kernel's order and its +-0 values, with
    chunks shorter than k and not aligned to its tiles."""
    monkeypatch.setattr(sk, "INT8_TOPK_PLAIN_CHUNK", chunk)
    data = _int8_data(8, 32, 768, seed=chunk, zero_rows=0.6, dup_every=9)
    _assert_bitwise(_port_int8_topk(*data, k), _pallas_int8_topk(*data, k, 8, 128))


@pytest.mark.parametrize("N,tile_n,k", [(300, 128, 12), (200, 64, 40), (77, 32, 77)])
def test_int8_topk_ragged_n_matches_pallas_kernel(N, tile_n, k):
    """N not a multiple of the tile: the Pallas kernel runs over the corpus
    padded to whole tiles with rows that score -inf (a positive dot times a
    -inf scale), the port over the N real rows."""
    q8, qs, cq, cs = _int8_data(8, 32, N, seed=N + k, dup_every=11)
    q8[:, 0] = np.clip(np.abs(q8[:, 0].astype(np.int32)), 1, 127)
    n_pad = -N % tile_n
    cq_pad = np.concatenate([cq, np.zeros((n_pad, 32), np.int8)])
    cq_pad[N:, 0] = 127
    cs_pad = np.concatenate([cs, np.full((n_pad, 1), -np.inf, np.float32)])
    want = _pallas_int8_topk(q8, qs, cq_pad, cs_pad, k, 8, tile_n)
    _assert_bitwise(_port_int8_topk(q8, qs, cq, cs, k), want)


@pytest.mark.parametrize("N,k,dup", [(256, 10, 0), (1000, 17, 0), (777, 128, 9), (130, 128, 0)])
def test_int8_topk_matches_xla_without_signed_zeros(N, k, dup):
    """Without +-0 ties the public op's two JAX paths agree, and so does the
    port at any N (no tile divisibility) and its ``xla_int8_topk``."""
    data = _int8_data(8, 48, N, seed=N + k, dup_every=dup)
    jd = [jnp.asarray(a) for a in data]
    want = ps.xla_int8_topk(*jd, k)
    _assert_bitwise(_port_int8_topk(*data, k), want)
    _assert_bitwise(_port_int8_topk(*data, k), ps.fused_int8_topk(*jd, k))
    t = [torch.from_numpy(a) for a in data]
    for fn in (sk.fused_int8_topk, sk.xla_int8_topk):
        v, i = fn(*t, k)
        _assert_bitwise((v.numpy(), i.numpy()), want)


@pytest.mark.parametrize("chunk", [1 << 18, 192])
@pytest.mark.parametrize("dup,k", [(61, 40), (127, 12)])
def test_int8_topk_duplicates_across_tile_edges_match_pallas_kernel(monkeypatch, chunk, dup, k):
    """Duplicate rows at a stride that crosses the tensor-core variant's
    64-row steps and 128-row tiles (61: every edge lands between two
    copies; 127: copies on both sides of each 128-row edge), with +-0
    ties, in one row range (one chunk of the plain version) and across
    ranges of 192 rows merged in order."""
    monkeypatch.setattr(sk, "INT8_TOPK_PLAIN_CHUNK", chunk)
    data = _int8_data(8, 64, 1024, seed=dup + k, zero_rows=0.2, dup_every=dup)
    _assert_bitwise(_port_int8_topk(*data, k), _pallas_int8_topk(*data, k, 8, 128))


@pytest.mark.parametrize("D,k,variant", [
    (384, 32, "wgmma"),   # the timed case
    (384, 128, "wgmma"),  # the longest list
    (32, 1, "wgmma"),     # the narrowest row: one k32 step
    (64, 40, "wgmma"),
    (512, 128, "wgmma"),  # the widest row two ring stages hold
    (48, 8, "dp4a"),      # D % 32 == 16
    (16, 128, "dp4a"),    # narrower than one k32 step
    (400, 32, "dp4a"),    # D % 32 == 16 past the timed width
    (544, 32, "dp4a"),    # wider than two ring stages
])
def test_int8_topk_variant(D, k, variant):
    """The CUDA int8 top-k picks its variant from the row width alone
    (explicitly; a failed launch raises)."""
    assert sk.int8_topk_variant(D, k) == variant


def test_int8_topk_launch_counts_name_both_variants():
    """Each variant counts its own launches; a CPU call counts none."""
    assert {"int8_topk", "int8_topk_dp4a"} <= set(sk.LAUNCHES)
    sk.reset_launch_counts()
    data = [torch.from_numpy(a) for a in _int8_data(4, 48, 200, seed=2)]
    sk.fused_int8_topk(*data, 5)
    assert sk.LAUNCHES["int8_topk"] == 0 and sk.LAUNCHES["int8_topk_dp4a"] == 0


def test_int8_topk_signed_zero_ties_follow_the_kernel():
    """Scale-0 rows and negative dots give +0.0 and -0.0 scores.
    ``lax.top_k`` ranks +0.0 above -0.0, the Pallas kernel ties them to the
    lower row: the two JAX paths differ, and the port follows the kernel
    (``fused_int8_topk`` on the accelerator returns the kernel's result)."""
    B, D, N, k = 8, 32, 256, 8
    q8, qs, cq, cs = _int8_data(B, D, N, seed=0)
    cs[1:] = 0.0  # pad rows: every score but row 0's is +0.0 or -0.0,
    qs[:] = np.abs(qs)  # signed as the row's dot
    kernel = _pallas_int8_topk(q8, qs, cq, cs, k, 8, 64)
    xla = ps.xla_int8_topk(*(jnp.asarray(a) for a in (q8, qs, cq, cs)), k)
    assert not np.array_equal(np.asarray(kernel[1]), np.asarray(xla[1]))
    _assert_bitwise(_port_int8_topk(q8, qs, cq, cs, k), kernel)
    v, i = sk.xla_int8_topk(*(torch.from_numpy(a) for a in (q8, qs, cq, cs)), k)
    _assert_bitwise((v.numpy(), i.numpy()), xla)


def test_int8_topk_negative_zero_values_follow_the_kernel():
    """A query whose zero scores turn -0.0 after its last +0.0 row: the
    kernel writes -0.0 there and +0.0 before, and so does the port."""
    B, D, N, k = 8, 32, 512, 8
    q8, qs, cq, cs = _int8_data(B, D, N, seed=3)
    cs[1:] = 0.0
    qs[:] = np.abs(qs)
    dots = cq.astype(np.int32) @ q8[0].astype(np.int32)
    flip = np.where(np.arange(N) < 4, dots < 0, dots > 0) & (np.arange(N) > 0)
    cq[flip] *= -1  # query 0: rows 1-3 score +0.0, rows 4 on -0.0
    kernel = _pallas_int8_topk(q8, qs, cq, cs, k, 8, 128)
    assert np.signbit(np.asarray(kernel[0])[0]).sum() >= 4
    _assert_bitwise(_port_int8_topk(q8, qs, cq, cs, k), kernel)


def test_int8_topk_wrapper_refuses_bad_input():
    q8, qs, cq, cs = (torch.from_numpy(a) for a in _int8_data(4, 32, 300, seed=1))
    with pytest.raises(ValueError, match="k="):
        sk.int8_topk(q8, qs, cq, cs, 129)
    with pytest.raises(ValueError, match="k="):
        sk.int8_topk(q8, qs, cq[:20], cs[:20], 21)
    with pytest.raises(TypeError):
        sk.int8_topk(q8.float(), qs, cq, cs, 5)
    with pytest.raises(TypeError):
        sk.int8_topk(q8, qs.double(), cq, cs, 5)
    with pytest.raises(ValueError):
        sk.int8_topk(q8, qs, cq[:, :16], cs, 5)
    with pytest.raises(ValueError):
        sk.int8_topk(q8, qs[:3], cq, cs, 5)


def test_cuda_path_refuses_cpu_build_absent():
    """On a CUDA tensor a wrapper launches its kernel or raises; on the CPU
    it never touches the kernel library (this box has no nvcc)."""
    assert sk._library is None
    sk.reset_launch_counts()
    q8 = torch.zeros((2, 32), dtype=torch.int8)
    seg = torch.zeros((64, 32), dtype=torch.bfloat16)
    sk.gather_rescore_rows(q8.float(), (seg,), torch.zeros((2, 3), dtype=torch.int32))
    sk.int8_topk(q8, torch.ones((2, 1)), torch.zeros((64, 32), dtype=torch.int8),
                 torch.ones((64, 1)), 4)
    assert sk._library is None and sum(sk.LAUNCHES.values()) == 0
