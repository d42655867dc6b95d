"""The port's tensor ops against the JAX package's, bitwise, on the same
numpy inputs: query quantisation, the top-k family's tie order (signed
zeros included), the lexical side list, merge + dedup, and the hybrid
steps at op level."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trie_semantic_search_tpu.ops import hybrid as jh
from trie_semantic_search_tpu.ops import pallas_scan as jps
from trie_semantic_search_tpu.ops import topk as jt
from trie_semantic_search_tpu_torch.ops import hybrid as th
from trie_semantic_search_tpu_torch.ops import scan_kernels as sk
from trie_semantic_search_tpu_torch.ops import topk as tt

torch.set_num_threads(1)
T = torch.from_numpy


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _tied_scores(seed, shape=(6, 40)):
    rng = np.random.default_rng(seed)
    v = rng.integers(-3, 4, shape).astype(np.float32) / 4
    v[v == 0] = np.where(rng.random((v == 0).sum()) < 0.5, -0.0, 0.0)
    v[0, :5] = -np.inf
    return v


def test_quantize_queries_bitwise():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((9, 48)).astype(np.float32)
    q[0] = 0.0
    q[1, :3] = [0.5, -0.5, 1.5]  # halves round to even
    j8, js = jh.quantize_queries(jnp.asarray(q))
    t8, ts = th.quantize_queries(T(q))
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))


@pytest.mark.parametrize("seed", [1, 2])
def test_exact_topk_tie_order(seed):
    v = _tied_scores(seed)
    jv, ji = jt.exact_topk(jnp.asarray(v), 17)
    tv, ti = tt.exact_topk(T(v), 17)
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("seed", [3, 4])
def test_topk_by_score_then_row_tie_order(seed):
    v = _tied_scores(seed)
    rng = np.random.default_rng(seed)
    rows = rng.permutation(v.shape[1] * 3)[: v.shape[1]].astype(np.int32)
    rows = np.broadcast_to(rows, v.shape).copy()
    rows[:, 7] = rows[:, 8]  # equal (score, row) pairs
    jv, jr = jt.topk_by_score_then_row(jnp.asarray(v), jnp.asarray(rows), 25)
    tv, tr = tt.topk_by_score_then_row(T(v), T(rows), 25)
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_merge_topk_tie_order():
    v = _tied_scores(5, (4, 3, 10))
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 100, v.shape).astype(np.int32)
    jv, ji = jt.merge_topk(jnp.asarray(v), jnp.asarray(idx), 12)
    tv, ti = tt.merge_topk(T(v), T(idx), 12)
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def _tail_inputs(seed, B=6, R=9, N=80, C=30, V=5, Ks=20):
    rng = np.random.default_rng(seed)
    chunk_case = rng.integers(0, C, N).astype(np.int32)
    rep = np.full(C, -1, np.int32)
    rep[chunk_case[::-1]] = np.arange(N - 1, -1, -1, dtype=np.int32)
    d = dict(
        trie_rows=np.where(rng.random((B, R)) < 0.6, rng.integers(0, C, (B, R)), -1).astype(np.int32),
        trie_src=rng.integers(1, 4, (B, R)).astype(np.int32),
        trie_chunk_of_case=rep,
        chunk_court=rng.integers(0, V, N).astype(np.int32),
        chunk_date=rng.integers(0, 50, N).astype(np.int32),
        court_table=rng.random((B, V)) < 0.7,
        date_lo=rng.integers(0, 20, B).astype(np.int32),
        date_hi=rng.integers(25, 50, B).astype(np.int32),
        exact_weight=np.full(B, 2.0, np.float32),
    )
    sem_v = np.sort(rng.integers(0, 8, (B, Ks)).astype(np.float32) / 8, axis=1)[:, ::-1].copy()
    sem_v[:, -3:] = -np.inf
    sem_chunk = rng.integers(0, N, (B, Ks)).astype(np.int32)
    return d, sem_v, sem_chunk, chunk_case


@pytest.mark.parametrize("seed", [6, 7])
def test_lexical_side_list_and_merge_dedup(seed):
    d, sem_v, sem_chunk, chunk_case = _tail_inputs(seed)
    jl = jh.lexical_side_list(**{k: jnp.asarray(v) for k, v in d.items()})
    tl = th.lexical_side_list(**{k: T(v) for k, v in d.items()})
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jm = jh.merge_dedup_topk(
        jnp.asarray(sem_v), jnp.asarray(sem_chunk), *jl, jnp.asarray(chunk_case), 10
    )
    tm = th.merge_dedup_topk(T(sem_v), T(sem_chunk), *tl, T(chunk_case), 10)
    np.testing.assert_array_equal(_bits(tm[0].numpy()), _bits(jm[0]))
    for a, b in zip(tm[1:], jm[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _corpus_inputs(seed, B=4, D=32, P=8, m=128, C=300, V=6):
    rng = np.random.default_rng(seed)
    N = P * m
    q = rng.standard_normal((B, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    v = rng.standard_normal((N, D)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[10:20] = v[9]  # duplicate rows
    scale = np.abs(v).max(axis=1) / 127.0
    q8 = np.clip(np.round(v / scale[:, None]), -127, 127).astype(np.int8)
    rows = np.arange(N, dtype=np.int32).reshape(P, m)
    rows[-1, -7:] = -1
    chunk_case = rng.integers(0, C, N).astype(np.int32)
    rep = np.full(C, -1, np.int32)
    rep[chunk_case[::-1]] = np.arange(N - 1, -1, -1, dtype=np.int32)
    court = rng.integers(0, V, N).astype(np.int32)
    date = rng.integers(0, 100, N).astype(np.int32)
    tail = dict(
        court_table=rng.random((B, V)) < 0.8,
        date_lo=np.array([-(2**31), 10, 0, 5][:B], np.int32),
        date_hi=np.array([2**31 - 1, 90, 99, 60][:B], np.int32),
        trie_rows=np.where(rng.random((B, 6)) < 0.5, rng.integers(0, C, (B, 6)), -1).astype(np.int32),
        trie_src=np.full((B, 6), 3, np.int32),
        trie_chunk_of_case=rep,
        min_similarity=np.array([-1.0, 0.0, 0.05, -1.0][:B], np.float32),
        exact_weight=np.full(B, 2.0, np.float32),
    )
    cents = rng.standard_normal((P, D)).astype(np.float32)
    return dict(q=q, v=v, q8=q8, scale=scale.astype(np.float32), rows=rows,
                chunk_case=chunk_case, court=court, date=date, tail=tail,
                cents=cents, P=P, m=m, D=D)


def _assert_same(tout, jout):
    np.testing.assert_array_equal(_bits(tout[0].numpy()), _bits(jout[0]))
    for a, b in zip(tout[1:], jout[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("use_filters", [True, False])
def test_fused_hybrid_topk_exact_bitwise(use_filters):
    c = _corpus_inputs(8)
    args = (c["q"], c["q8"], c["scale"][:, None], c["chunk_case"], c["court"], c["date"])
    kw = dict(k=6, overfetch=4, recall_target=1.0, use_court=use_filters, use_date=use_filters)
    jout = jh.fused_hybrid_topk(
        *[jnp.asarray(a) for a in args], **{k: jnp.asarray(v) for k, v in c["tail"].items()}, **kw
    )
    tout = th.fused_hybrid_topk(*[T(a) for a in args], **{k: T(v) for k, v in c["tail"].items()}, **kw)
    _assert_same(tout, jout)


@pytest.mark.parametrize("nc", [1, 4])
def test_fused_layout_brute_exact_bitwise(nc):
    c = _corpus_inputs(9)
    P, m, D = c["P"], c["m"], c["D"]
    rows = c["rows"]
    safe = np.maximum(rows, 0)
    slot_court = np.where(rows >= 0, c["court"][safe], -1).astype(np.int32)
    slot_date = np.where(rows >= 0, c["date"][safe], np.iinfo(np.int32).min).astype(np.int32)
    pint8 = c["q8"].reshape(P, m, D)
    pscale = np.where(rows >= 0, c["scale"].reshape(P, m), 0).astype(np.float32)
    bf = c["v"]
    args = (c["q"], rows, pint8, pscale)
    rest = (slot_court, slot_date, c["chunk_case"], c["court"], c["date"])
    kw = dict(k=6, overfetch=4, num_chunks=nc, recall_target=1.0)
    jout = jh.fused_layout_brute_topk(
        *[jnp.asarray(a) for a in args], jnp.asarray(bf, jnp.bfloat16),
        *[jnp.asarray(a) for a in rest],
        **{k: jnp.asarray(v) for k, v in c["tail"].items()}, **kw,
    )
    tout = th.fused_layout_brute_topk(
        *[T(a) for a in args], T(bf).to(torch.bfloat16), *[T(a) for a in rest],
        **{k: T(v) for k, v in c["tail"].items()}, **kw,
    )
    for a, b in zip(tout[1:], jout[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), atol=1e-5, rtol=0)


def test_fused_partitioned_gather_branch_bitwise():
    """The probe's exact gather branch (``hybrid.py:785-828``) with no
    rescore copy: every score is an int8 score, so bitwise."""
    c = _corpus_inputs(10)
    P, m, D = c["P"], c["m"], c["D"]
    pint8 = c["q8"].reshape(P, m, D)
    pscale = c["scale"].reshape(P, m)
    args = (c["q"], c["cents"], c["rows"], pint8, pscale)
    cols = (c["chunk_case"], c["court"], c["date"])
    kw = dict(k=6, nprobe=3, overfetch=2, rescore_factor=2, recall_target=1.0,
              use_probe_kernel=False)
    jout = jh.fused_partitioned_topk(
        *[jnp.asarray(a) for a in args], None, *[jnp.asarray(a) for a in cols],
        **{k: jnp.asarray(v) for k, v in c["tail"].items()}, probe_interpret=False, **kw,
    )
    tout = th.fused_partitioned_topk(
        *[T(a) for a in args], None, *[T(a) for a in cols],
        **{k: T(v) for k, v in c["tail"].items()}, **kw,
    )
    _assert_same(tout, jout)


def test_pick_num_chunks_and_resolve_probe_kernel(monkeypatch):
    for n, b, kf in [(5_242_880, 256, 40), (5_242_880, 8, 40), (1 << 20, 64, 10), (100, 1, 1)]:
        assert th.pick_num_chunks(n, b, kf) == jh.pick_num_chunks(n, b, kf)
    monkeypatch.delenv("TSS_PROBE_INTERPRET", raising=False)
    assert th.resolve_probe_kernel(0.97, 1024, 384) == (True, False)
    assert th.resolve_probe_kernel(1.0, 1024, 384)[0] is False
    assert th.resolve_probe_kernel(0.97, 1000, 384)[0] is False
    assert th.resolve_probe_kernel(0.97, 1024, 64)[0] is False
    monkeypatch.setenv("TSS_PROBE_INTERPRET", "1")
    assert th.resolve_probe_kernel(0.97, 1024, 64) == jh.resolve_probe_kernel(0.97, 1024, 64)
    assert th.use_scan_kernel(4096, 0.97) and not th.use_scan_kernel(4096, 1.0)
    assert not th.use_scan_kernel(4000, 0.97)
    assert jax.default_backend() == "cpu"


def test_stream_hoists_the_scan_inputs(monkeypatch):
    """The slab walk makes the fused scan's per-query inputs once per batch
    and slices its per-row inputs per slab: the split inputs equal
    ``fused_scan_inputs``'s, the court words are packed once, and the walk
    returns bitwise what the JAX package's returns (its Pallas kernel in
    interpret mode)."""
    rng = np.random.default_rng(12)
    B, D, N, V, nc = 4, 32, 4 * 2048, 40, 4
    q8 = rng.integers(-127, 127, (B, D)).astype(np.int8)
    qs = (rng.random((B, 1)) * 0.01 + 1e-3).astype(np.float32)
    cq = rng.integers(-127, 127, (N, D)).astype(np.int8)
    cq[384::512] = cq[0]  # equal scores in one lane
    cs = (rng.random((N, 1)) * 0.01 + 1e-3).astype(np.float32)
    cs[384::512] = cs[0]
    court = rng.integers(0, V, N).astype(np.int32)
    date = rng.integers(0, 100, N).astype(np.int32)
    table = rng.random((B, V)) < 0.7
    lo = np.array([-(2**31), 10, 0, 5], np.int32)
    hi = np.array([2**31 - 1, 90, 99, 60], np.int32)
    ms = np.array([-1e30, 0.0, -1e30, -1e30], np.float32)
    args = (q8, qs, cq, cs, court, date, table, lo, hi, ms)

    whole = sk.fused_scan_inputs(T(qs), T(court), T(date), T(table), T(lo), T(hi), T(ms), T(cs))
    split = {**sk.fused_scan_query_inputs(T(qs), T(table), T(lo), T(hi), T(ms)),
             **sk.fused_scan_row_inputs(T(court), T(date), T(cs))}
    assert split.keys() == whole.keys()
    for name in whole:
        assert torch.equal(split[name], whole[name]), name

    packs = []
    real_pack = sk.pack_court_words
    monkeypatch.setattr(sk, "pack_court_words", lambda t: packs.append(1) or real_pack(t))
    kw = dict(ksem=24, num_chunks=nc, recall_target=0.97, use_court=True, use_date=True)
    tv, ti = th._chunked_semantic_scan(*(T(a) for a in args), **kw)
    assert len(packs) == 1
    monkeypatch.setattr(jh, "_use_pallas", lambda n, rt: rt < 1.0 and n % 2048 == 0)
    monkeypatch.setattr(jh, "pallas_fused_topk", functools.partial(jps.pallas_fused_topk, interpret=True))
    jax.clear_caches()
    try:
        jv, ji = jh._chunked_semantic_scan(*(jnp.asarray(a) for a in args), **kw)
    finally:
        monkeypatch.undo()
        jax.clear_caches()
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
