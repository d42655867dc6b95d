"""The port's kernel wrappers (their plain versions on the CPU) against the
JAX package's Pallas kernels in interpret mode, on the same numpy inputs.

Tolerances: the two int8 kernels are compared bitwise (values and rows or
slots: int32 dots and the same f32 multiply order on both sides); the
rescore within 1e-5 (bf16 products are exact in f32, only the order of the
f32 sum differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    ],
)
def test_fused_scan_matches_pallas(tile_n, lanes, V, k, use_court, use_date, dup):
    B, D, N = 8, 64, 512
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


@pytest.mark.parametrize("lanes,V", [(32, 16), (32, 40), (128, 70)])
def test_probe_candidates_match_pallas(lanes, V):
    B, D, P, m, NP = 4, 32, 8, 256, 4
    (q8, qs, pint8, pscale, prows, court, date, table, lo, hi, ms,
     top_p) = _probe_data(B, D, P, m, NP, V, seed=lanes + V)
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


def test_cuda_path_refuses_cpu_build_absent():
    """On a CUDA tensor a wrapper launches its kernel or raises; on the CPU
    it never touches the kernel library (this box has no nvcc)."""
    assert sk._library is None
    sk.reset_launch_counts()
    q8 = torch.zeros((2, 32), dtype=torch.int8)
    seg = torch.zeros((64, 32), dtype=torch.bfloat16)
    sk.gather_rescore_rows(q8.float(), (seg,), torch.zeros((2, 3), dtype=torch.int32))
    assert sk._library is None and sum(sk.LAUNCHES.values()) == 0
