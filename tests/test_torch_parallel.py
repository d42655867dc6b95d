"""The port's sharded serving against the JAX package's, case for case.

The JAX side runs on its 8-device virtual CPU mesh (``tests/conftest.py``),
the port on a mesh of 8 × ``cpu``, over the same seeded numpy inputs (those
of ``tests/test_parallel.py`` and ``tests/test_sharded_index.py``). Where
the JAX function reaches a Pallas kernel it runs in interpret mode, and the
port's kernel route runs the kernel's plain version.

Tolerances: int8 scores bitwise (the same int8 products, the same multiply
order); bf16 products within 1e-6 (f32 sums in another order); the bf16
rescore of the partitioned modes within 1e-5; rows, cases and sources
equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as PS
from test_parallel import _fused_inputs, _run_fused
from test_torch_engine import QUERIES, _assert_same, _requests
from torch_distributed_job import run_job
from torch_engine_fixtures import (  # noqa: F401  (fixtures)
    art,
    kernels_interpret,
    share_embeddings,
)

from trie_semantic_search_tpu.core.config import Config as JaxConfig
from trie_semantic_search_tpu.core.config import MeshConfig as JaxMeshConfig
from trie_semantic_search_tpu.core.types import SearchConfig as JaxSearchConfig
from trie_semantic_search_tpu.index.builder import load_artifacts as jax_load_artifacts
from trie_semantic_search_tpu.index.kmeans import train_kmeans
from trie_semantic_search_tpu.index.sharded import ShardedCorpusIndex as JaxSharded
from trie_semantic_search_tpu.index.sharded import build_sharded_partitions as jax_partitions
from trie_semantic_search_tpu.ops import quantize_int8 as jax_quantize_int8
from trie_semantic_search_tpu.ops.pallas_scan import TILE_N
from trie_semantic_search_tpu.parallel import corpus_sharding, row_sharding
from trie_semantic_search_tpu.parallel import make_mesh as jax_make_mesh
from trie_semantic_search_tpu.parallel import pad_corpus as jax_pad_corpus
from trie_semantic_search_tpu.parallel import sharded_brute_topk as jax_brute
from trie_semantic_search_tpu.parallel import sharded_int8_topk as jax_int8
import trie_semantic_search_tpu.parallel.collectives as jax_collectives
from trie_semantic_search_tpu.parallel.collectives import (
    sharded_partitioned_topk as jax_partitioned,
)
from trie_semantic_search_tpu.search.engine import SearchEngine as JaxEngine
from trie_semantic_search_tpu.search.engine import SearchQuery as JaxQuery
from trie_semantic_search_tpu.search.fused import FusedHybridSearch as JaxFused
from trie_semantic_search_tpu.storage.store import StorageManager as JaxStorage
from trie_semantic_search_tpu_torch.core.config import AnnConfig, Config, MeshConfig, VectorConfig
from trie_semantic_search_tpu_torch.core.types import SearchConfig
from trie_semantic_search_tpu_torch.index.builder import load_artifacts
from trie_semantic_search_tpu_torch.index.sharded import ShardedCorpusIndex
from trie_semantic_search_tpu_torch.index.sharded import build_sharded_partitions, slot_court_ids
from trie_semantic_search_tpu_torch.index.vector import VectorIndex
from trie_semantic_search_tpu_torch.ops.scoring import quantize_int8
from trie_semantic_search_tpu_torch.parallel import (
    DATA_AXIS,
    MODEL_AXIS,
    make_mesh,
    pad_corpus,
    pad_rows,
    shard_rows,
    sharded_brute_topk,
    sharded_int8_topk,
    single_device_mesh,
)
from trie_semantic_search_tpu_torch.parallel.collectives import (
    resolve_scan_kernel,
    sharded_fused_topk,
    sharded_layout_brute_topk,
    sharded_partitioned_topk,
)
from trie_semantic_search_tpu_torch.parallel.mesh import make_distributed_mesh, replicate
from trie_semantic_search_tpu_torch.search.engine import SearchEngine, SearchQuery
from trie_semantic_search_tpu_torch.search.fused import FusedHybridSearch
from trie_semantic_search_tpu_torch.storage.store import StorageManager

CPU8 = ["cpu"] * 8

#: the JAX package's sharded stream, jitted: its ``shard_map`` runs eagerly
#: when called bare (seconds per call on the CPU mesh), and the JAX
#: package calls it bare; jitted it computes the same function
_STREAM_STATIC = ("k", "overfetch", "recall_target", "use_court", "use_date",
                  "use_gather_kernel", "gather_interpret")
jax_layout_brute = jax.jit(jax_collectives.sharded_layout_brute_topk, static_argnums=0,
                           static_argnames=_STREAM_STATIC)


@pytest.fixture()
def jax_stream_jitted(monkeypatch):
    monkeypatch.setattr(jax_collectives, "sharded_layout_brute_topk", jax_layout_brute)


@pytest.fixture(scope="module")
def jmesh(cpu_devices):
    return jax_make_mesh(JaxMeshConfig(data_parallel=8, model_parallel=1))


@pytest.fixture(scope="module")
def pmesh():
    return make_mesh(MeshConfig(data_parallel=8, model_parallel=1), devices=CPU8)


def t(a):
    return torch.as_tensor(np.asarray(a))


def normed(x):
    return (x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)).astype(np.float32)


def bits(a):
    return np.asarray(a, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dp,mp", [(4, 2), (0, 2), (8, 1), (0, 1), (2, 1), (0, 4)])
def test_make_mesh_shapes_match_jax(cpu_devices, dp, mp):
    want = jax_make_mesh(JaxMeshConfig(data_parallel=dp, model_parallel=mp))
    got = make_mesh(MeshConfig(data_parallel=dp, model_parallel=mp), devices=CPU8)
    assert got.shape == dict(want.shape)
    assert got.shape[DATA_AXIS] * got.shape[MODEL_AXIS] == want.devices.size
    assert len(got.data_devices) == got.shape[DATA_AXIS]


@pytest.mark.parametrize("dp,mp", [(0, 3), (16, 1), (3, 3)])
def test_make_mesh_errors_match_jax(cpu_devices, dp, mp):
    with pytest.raises(ValueError) as want:
        jax_make_mesh(JaxMeshConfig(data_parallel=dp, model_parallel=mp))
    with pytest.raises(ValueError) as got:
        make_mesh(MeshConfig(data_parallel=dp, model_parallel=mp), devices=CPU8)
    assert str(got.value) == str(want.value)


def test_mesh_placement_and_distributed_mesh(pmesh, tmp_path):
    """Shard blocks never alias, even on one device; replicas are one copy
    per distinct device; a mesh across two processes (one ``cpu`` shard in
    rank 0, three in rank 1) orders its rows by rank, places only local
    blocks, gathers in shard order, and refuses a model axis across the
    processes."""
    x = torch.arange(64, dtype=torch.float32).reshape(16, 4)
    blocks = shard_rows(x, pmesh)
    assert [tuple(b.shape) for b in blocks] == [(2, 4)] * 8
    ptrs = {b.data_ptr() for b in blocks} | {x.data_ptr()}
    assert len(ptrs) == 9
    blocks[0].add_(1.0)
    assert float(x[0, 0]) == 0.0 and float(blocks[1][0, 0]) == 8.0
    np_blocks = shard_rows(x.numpy(), pmesh, torch.bfloat16)
    assert all(b.dtype == torch.bfloat16 for b in np_blocks)
    reps = replicate(x, pmesh)
    assert all(r is x for r in reps)
    with pytest.raises(ValueError):
        shard_rows(x[:15], pmesh)
    assert single_device_mesh("cpu").shape == {DATA_AXIS: 1, MODEL_AXIS: 1}
    for rank, (info, _) in enumerate(run_job("mesh", tmp_path, [["cpu"], ["cpu"] * 3])):
        assert info["shape"] == {DATA_AXIS: 4, MODEL_AXIS: 1} and info["backend"] == "gloo"
        assert info["owners"] == [[0], [1], [1], [1]] and info["rows_of"] == [[0], [1, 2, 3]]
        assert info["local_rows"] == ([0] if rank == 0 else [1, 2, 3])
        assert info["gathered"] == [0.0, 11.0, 21.0, 31.0]
        assert info["blocks"] == ([[0.0, 1.0], None, None, None] if rank == 0
                                  else [None, [2.0, 3.0], [4.0, 5.0], [6.0, 7.0]])
        assert "spans processes [0, 1]" in info["model_axis_error"]
        assert info["other_job_error"].startswith("RuntimeError: this process already joined")
    assert make_distributed_mesh(MeshConfig(data_parallel=8), devices=CPU8).shape == pmesh.shape
    four = make_mesh(MeshConfig(), devices=["cuda"] * 4)
    assert four.data_devices == [torch.device("cuda", 0)] * 4


def test_pad_rows():
    assert pad_rows(100, 8) == 104
    assert pad_rows(104, 8) == 104
    assert pad_rows(1, 1024) == 1024


@pytest.mark.parametrize("n,multiple", [(100, 8), (128, 8), (1, 1024), (4097, TILE_N)])
def test_pad_corpus_bitwise(jmesh, pmesh, n, multiple):
    m = np.random.default_rng(n).standard_normal((n, 16)).astype(np.float32)
    want, wn = jax_pad_corpus(m, jmesh, row_multiple=multiple)
    got, gn = pad_corpus(m, pmesh, row_multiple=multiple)
    assert gn == wn == n and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# exact sharded scans
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return normed(rng.standard_normal((4, 64))), normed(rng.standard_normal((800, 64)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_valid", [None, 797])
def test_sharded_brute_topk_matches_jax(jmesh, pmesh, data, dtype, n_valid):
    q, c = data
    cj = jax.device_put(jnp.asarray(c, getattr(jnp, dtype)), corpus_sharding(jmesh))
    wv, wi = jax_brute(jmesh, jnp.asarray(q), cj, 10, n_valid=n_valid)
    gv, gi = sharded_brute_topk(pmesh, t(q), t(c).to(getattr(torch, dtype)), 10, n_valid=n_valid)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-6, rtol=0)


@pytest.mark.parametrize("k", [10, 200])
def test_sharded_int8_topk_matches_jax_bitwise(jmesh, pmesh, data, k):
    q, c = data
    cq, cs = jax_quantize_int8(c)
    wv, wi = jax_int8(jmesh, jnp.asarray(q), jax.device_put(cq, corpus_sharding(jmesh)),
                      jax.device_put(cs, corpus_sharding(jmesh)), k)
    pq, ps = quantize_int8(t(c))
    gv, gi = sharded_int8_topk(pmesh, t(q), shard_rows(pq, pmesh), shard_rows(ps, pmesh), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(bits(gv.numpy()), bits(wv))


# ---------------------------------------------------------------------------
# sharded fused step (brute)
# ---------------------------------------------------------------------------


def _port_fused(pmesh, corpus, cq, cs, chunk_case, chunk_court, chunk_date, case_court,
                case_date, court_table, lex, lex_src, date_lo, date_hi, min_sim, ew, K,
                n_valid=None, **kw):
    B = court_table.shape[0]
    v, r, c, s = sharded_fused_topk(
        pmesh, t(corpus[:B]), t(np.asarray(cq)), t(np.asarray(cs)), t(chunk_case),
        t(chunk_court), t(chunk_date), t(court_table), t(date_lo), t(date_hi), t(lex),
        t(lex_src), t(np.maximum(lex, 0)), t(case_court), t(case_date), t(min_sim), t(ew),
        k=K, n_valid=n_valid, **kw,
    )
    return v.numpy(), r.numpy(), c.numpy(), s.numpy()


def _fused_cases():
    """The inputs of the JAX package's sharded fused tests: filters and a
    passing lexical hit; pad rows with hazardous columns; a lexical hit
    that fails the court filter."""
    N, D, B, K = 256, 32, 4, 6
    corpus, cq, cs, case, court, date, ccourt, cdate, ctable, _ = _fused_inputs(None, N=N, D=D, B=B)
    lex = np.full((B, 3), -1, np.int32)
    lex_src = np.zeros((B, 3), np.int32)
    ok = next(int(c) for c in range(64) if ctable[0, ccourt[c]] and 0 <= cdate[c] <= 800)
    lex[0, 0], lex_src[0, 0] = ok, 1
    yield "filters", (corpus, cq, cs, case, court, date, ccourt, cdate, ctable, lex, lex_src,
                      np.zeros(B, np.int32), np.full(B, 800, np.int32),
                      np.full(B, 0.3, np.float32), np.full(B, 2.0, np.float32), K), {}

    N, B, K = 100, 2, 8
    corpus, _, _, case, court, date, ccourt, cdate, _, _ = _fused_inputs(None, N=N, D=D, B=B)
    padded = np.concatenate([corpus, np.zeros((28, D), np.float32)])
    pq, ps = jax_quantize_int8(padded)
    pad = lambda col: np.concatenate([col, np.zeros(28, np.int32)])  # noqa: E731
    yield "pad_rows", (corpus, pq, ps, pad(case), pad(court), pad(date), ccourt, cdate,
                       np.ones((B, 4), bool), np.full((B, 2), -1, np.int32),
                       np.zeros((B, 2), np.int32), np.full(B, -(2**31), np.int32),
                       np.full(B, 2**31 - 1, np.int32), np.full(B, -1.0, np.float32),
                       np.full(B, 2.0, np.float32), K), {"n_valid": N}

    N, B, K = 256, 2, 6
    corpus, cq, cs, case, court, date, ccourt, cdate, _, _ = _fused_inputs(None, N=N, D=D, B=B)
    ctable = np.zeros((B, 4), bool)
    ctable[:, 1] = True
    lex = np.full((B, 3), -1, np.int32)
    lex[0, 0] = next(int(c) for c in range(64) if ccourt[c] == 2)
    yield "lexical_fails_filter", (corpus, cq, cs, case, court, date, ccourt, cdate, ctable, lex,
                                   np.ones((B, 3), np.int32), np.full(B, -(2**31), np.int32),
                                   np.full(B, 2**31 - 1, np.int32), np.full(B, 0.3, np.float32),
                                   np.full(B, 2.0, np.float32), K), {}


@pytest.mark.parametrize("case", [c[0] for c in _fused_cases()])
def test_sharded_fused_topk_matches_jax(jmesh, pmesh, case):
    """The matmul route against JAX's XLA route: filters (also on lexical
    hits), dedup by case, pad rows that must never surface."""
    args, kw = next((a, k) for name, a, k in _fused_cases() if name == case)
    wv, wc, ws = _run_fused(jmesh, *args, **kw)
    gv, gr, gc, gs = _port_fused(pmesh, *args, **kw)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(bits(gv), bits(wv))
    live = gc >= 0
    assert live.any() and (gr[live] >= 0).all() and (gr[~live] == -1).all()
    n_valid = kw.get("n_valid")
    if n_valid is not None:  # every surfaced row is a real one
        assert (gr[live] < n_valid).all() and np.isfinite(gv[live]).all()


@pytest.mark.parametrize("n_pad", [0, 100])
def test_sharded_fused_kernel_route_matches_jax_pallas(jmesh, pmesh, n_pad):
    """The kernel route (the fused scan's plain version on CPU shards)
    against JAX's per-shard Pallas kernel in interpret mode, with court and
    date filters, a lexical hit, and pad rows past ``n_valid``."""
    N = 8 * TILE_N
    corpus, cq, cs, case, court, date, ccourt, cdate, ctable, _ = _fused_inputs(
        None, n_cases=512, N=N, D=32, B=4, seed=21)
    B, n_valid = 4, N - n_pad
    cs = np.array(cs)
    cs[n_valid:] = 0.0
    lex = np.full((B, 3), -1, np.int32)
    lex[0, 0] = 7
    args = (corpus, cq, cs, case, court, date, ccourt, cdate, ctable, lex,
            np.full((B, 3), 1, np.int32), np.zeros(B, np.int32), np.full(B, 1000, np.int32),
            np.full(B, -1.0 if n_pad else 0.0, np.float32), np.full(B, 2.0, np.float32), 5)
    mode, forced = resolve_scan_kernel(0.9, N // 8, torch.device("cpu"), force_kernel=True)
    assert (mode, forced) == ("kernel", True)
    assert resolve_scan_kernel(0.9, N // 8, torch.device("cpu"))[0] == "matmul"
    assert resolve_scan_kernel(1.0, N // 8, torch.device("cuda"))[0] == "matmul"
    wv, wc, ws = _run_fused(jmesh, *args, n_valid=n_valid, recall_target=0.9,
                            scan_mode="pallas", scan_interpret=True)
    gv, gr, gc, gs = _port_fused(pmesh, *args, n_valid=n_valid, recall_target=0.9,
                                 scan_mode=mode)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(bits(gv), bits(wv))
    assert (gr[gc >= 0] < n_valid).all()


# ---------------------------------------------------------------------------
# per-shard partitions and the sharded partitioned steps
# ---------------------------------------------------------------------------


def _partition_inputs():
    N, D, B, P = 2048, 32, 4, 8
    corpus, cq, cs, case, court, date, ccourt, cdate, ctable, _ = _fused_inputs(
        None, n_cases=256, N=N, D=D, B=B, seed=33)
    cent = train_kmeans(corpus, P, iters=5, sample=N, seed=0)
    return corpus, case, court, date, ccourt, cdate, ctable, cent


def _duplicate_inputs():
    rng = np.random.default_rng(5)
    N, D, P = 4096, 32, 16
    dup = rng.standard_normal((1, D)).astype(np.float32)
    v = normed(np.concatenate([np.repeat(dup, N // 2, axis=0),
                               rng.standard_normal((N // 2, D)).astype(np.float32)]))
    cent = train_kmeans(v, P, iters=5, sample=N, seed=0)
    return v, cent, rng.integers(0, 40, N).astype(np.int32), rng.integers(0, 900, N).astype(np.int32)


@pytest.mark.parametrize("case", ["padded", "duplicates"])
def test_build_sharded_partitions_bitwise(case):
    """Every array of the per-shard layout equals the JAX package's,
    including the duplicate-heavy capacity case, where the overflow
    rebalance moves rows within their shard."""
    if case == "padded":
        corpus, _, court, date, *_, cent = _partition_inputs()
        n, S = 2000, 8
        v = np.array(corpus)
        v[n:] = 0.0
    else:
        v, cent, court, date = _duplicate_inputs()
        n, S = v.shape[0], 4
    want = jax_partitions(v, n, S, cent, court, date)
    got = build_sharded_partitions(v, n, S, cent, court, date, device="cpu")
    assert got["m"] == want["m"] and got["m"] % 128 == 0
    for name in ("part_rows", "part_int8", "part_scale", "part_cword", "part_cbit", "part_date"):
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # the stream's raw slot courts, by bit search, equal JAX's float log2
    cw = want["part_cword"].astype(np.int64)
    raw = cw * 32 + np.log2(np.maximum(want["part_cbit"], 1).astype(np.float64)).astype(np.int64)
    np.testing.assert_array_equal(
        slot_court_ids(got["part_rows"], got["part_cword"], got["part_cbit"]),
        np.where(want["part_rows"] >= 0, raw, -1).astype(np.int32))
    if case == "duplicates":
        rows = got["part_rows"]
        assert rows.shape[2] < v.shape[0] // 2
        for s in range(S):
            np.testing.assert_array_equal(np.sort(rows[s][rows[s] >= 0]), np.arange(v.shape[0] // S))


@pytest.fixture(scope="module")
def parts_fixture(jmesh):
    corpus, case, court, date, ccourt, cdate, ctable, cent = _partition_inputs()
    parts = jax_partitions(corpus, corpus.shape[0], 8, cent, court, date)
    B = ctable.shape[0]
    lex = np.full((B, 3), -1, np.int32)
    lex[1, 0] = next(int(c) for c in range(256) if ctable[1, ccourt[c]] and 0 <= cdate[c] <= 1000)
    shared = (ctable, np.zeros(B, np.int32), np.full(B, 1000, np.int32), lex,
              np.full((B, 3), 1, np.int32), np.maximum(lex, 0), ccourt, cdate,
              np.full(B, 0.0, np.float32), np.full(B, 2.0, np.float32))
    return corpus, case, court, cent, parts, shared


def _jax_parts(jmesh, parts, names):
    p3 = NamedSharding(jmesh, PS("data", None, None))
    p4 = NamedSharding(jmesh, PS("data", None, None, None))
    return [jax.device_put(jnp.asarray(parts[n]), p4 if parts[n].ndim == 4 else p3) for n in names]


def _assert_merged(got, want, tol=1e-5):
    gv, gr, gc, gs = (x.numpy() for x in got)
    wv, wr, wc, ws = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(gr, wr)
    fin = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), fin)
    np.testing.assert_allclose(gv[fin], wv[fin], atol=tol, rtol=0)
    assert (gc >= 0).any()


@pytest.mark.parametrize("upk,nprobe", [(False, 3), (True, 3), (True, 8)])
def test_sharded_partitioned_topk_matches_jax(jmesh, pmesh, parts_fixture, upk, nprobe):
    """The probe step, its gather scan and its kernel route (JAX's probe
    and rescore kernels in interpret mode, the port's plain versions)."""
    corpus, case, _, cent, parts, shared = parts_fixture
    B, K = 4, 5
    names = ("part_rows", "part_int8", "part_scale", "part_cword", "part_cbit", "part_date")
    want = jax_partitioned(
        jmesh, jnp.asarray(corpus[:B]), jnp.asarray(cent, jnp.float32),
        *_jax_parts(jmesh, parts, names),
        jax.device_put(jnp.asarray(corpus, jnp.bfloat16), corpus_sharding(jmesh)),
        jax.device_put(jnp.asarray(case), row_sharding(jmesh)), *map(jnp.asarray, shared),
        k=K, nprobe=nprobe, use_probe_kernel=upk, probe_interpret=upk,
    )
    pparts = [t(parts[n]) for n in names]
    pparts[4] = t(parts["part_cbit"].view(np.int32))
    got = sharded_partitioned_topk(
        pmesh, t(corpus[:B]), t(cent), *pparts, t(corpus).to(torch.bfloat16), t(case),
        *map(t, shared), k=K, nprobe=nprobe, use_probe_kernel=upk,
    )
    _assert_merged(got, want)


@pytest.mark.parametrize("upk,recall", [(False, 1.0), (True, 0.9)])
def test_sharded_layout_brute_topk_matches_jax(jmesh, pmesh, parts_fixture, upk, recall):
    """The stream step over each shard's layout, with the filters on, with
    and without the rescore kernel."""
    corpus, case, court, cent, parts, shared = parts_fixture
    B, K = 4, 5
    rows = parts["part_rows"]
    S, shard_n = rows.shape[0], corpus.shape[0] // rows.shape[0]
    glob = np.maximum(rows, 0) + (np.arange(S) * shard_n)[:, None, None]
    slot_court = np.where(rows >= 0, court[glob], -1).astype(np.int32)
    parts = dict(parts, slot_court=slot_court)
    names = ("part_rows", "part_int8", "part_scale", "slot_court", "part_date")
    want = jax_layout_brute(
        jmesh, jnp.asarray(corpus[:B]), *_jax_parts(jmesh, parts, names),
        jax.device_put(jnp.asarray(corpus, jnp.bfloat16), corpus_sharding(jmesh)),
        jax.device_put(jnp.asarray(case), row_sharding(jmesh)), *map(jnp.asarray, shared),
        k=K, overfetch=8, recall_target=recall, use_gather_kernel=upk, gather_interpret=upk,
    )
    got = sharded_layout_brute_topk(
        pmesh, t(corpus[:B]), *[t(parts[n]) for n in names], t(corpus).to(torch.bfloat16),
        t(case), *map(t, shared), k=K, overfetch=8, recall_target=recall, use_gather_kernel=upk,
    )
    _assert_merged(got, want)


# ---------------------------------------------------------------------------
# ShardedCorpusIndex and VectorIndex(mesh=)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus_data():
    rng = np.random.default_rng(5)
    corpus = normed(rng.standard_normal((500, 64)).astype(np.float32))
    queries = corpus[:8] + 0.01 * rng.standard_normal((8, 64)).astype(np.float32)
    return corpus, normed(queries)


@pytest.mark.parametrize("use_int8", [True, False])
def test_sharded_index_matches_jax(jmesh, pmesh, corpus_data, use_int8):
    corpus, queries = corpus_data
    want, got = JaxSharded(jmesh, use_int8=use_int8), ShardedCorpusIndex(pmesh, use_int8=use_int8)
    want.build(corpus)
    got.build(corpus)
    assert got.get_stats() == want.get_stats() == {
        "num_vectors": 500, "padded": 512, "shards": 8, "int8": use_int8}
    wv, wi = want.search_brute(queries, 10)
    gv, gi = got.search(queries, 10)
    np.testing.assert_array_equal(gi, wi)
    if use_int8:
        np.testing.assert_array_equal(bits(gv), bits(wv))
        assert (gi[:, 0] == np.arange(8)).all()
    else:
        np.testing.assert_allclose(gv, wv, atol=1e-6, rtol=0)


def test_sharded_index_pad_rows_never_surface(jmesh, pmesh):
    corpus = normed(np.random.default_rng(6).standard_normal((10, 32)).astype(np.float32))
    want, got = JaxSharded(jmesh), ShardedCorpusIndex(pmesh)
    want.build(corpus)
    got.build(corpus)
    wv, wi = want.search_brute(corpus[:4], 10)
    gv, gi = got.search_brute(corpus[:4], 10)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(bits(gv), bits(wv))
    assert gi.max() < 10


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_sharded_index_npz_loads_in_the_other_package(jmesh, pmesh, corpus_data, tmp_path, saver):
    """Saved on an 8-shard mesh by one package, loaded on a 2-shard mesh by
    the other: the same logical corpus, the same results."""
    corpus, queries = corpus_data
    jmesh2 = jax_make_mesh(JaxMeshConfig(data_parallel=2), jax.devices()[:2])
    pmesh2 = make_mesh(MeshConfig(data_parallel=2), devices=["cpu"] * 2)
    path = tmp_path / "ann.npz"
    if saver == "jax":
        src = JaxSharded(jmesh)
        src.build(corpus)
        src.save(path)
        back = ShardedCorpusIndex.load(path, pmesh2)
        ref = JaxSharded.load(path, jmesh2)
    else:
        src = ShardedCorpusIndex(pmesh)
        src.build(corpus)
        src.save(path)
        back = JaxSharded.load(path, jmesh2)
        ref = ShardedCorpusIndex.load(path, pmesh2)
    assert back.num_shards == 2 and back.num_vectors == 500
    v1, i1 = src.search_brute(queries, 5)
    v2, i2 = back.search_brute(queries, 5)
    v3, i3 = ref.search_brute(queries, 5)
    np.testing.assert_array_equal(i2, i1)
    np.testing.assert_array_equal(bits(v2), bits(v3))
    np.testing.assert_array_equal(i2, i3)


def _tiny_port_embedder(docs):
    from trie_semantic_search_tpu_torch.core.config import EmbeddingModelConfig
    from trie_semantic_search_tpu_torch.models.embedder import Embedder
    from trie_semantic_search_tpu_torch.models.minilm import MiniLM, MiniLMConfig
    from trie_semantic_search_tpu_torch.models.tokenizer import (
        WordPieceTokenizer,
        train_wordpiece_vocab,
    )

    vocab = train_wordpiece_vocab(docs, vocab_size=2048, min_frequency=1)
    cfg = MiniLMConfig(vocab_size=2048, hidden_size=64, num_layers=2, num_heads=4,
                       intermediate_size=128, max_position=32)
    return Embedder(EmbeddingModelConfig(max_sequence_length=32), tokenizer=WordPieceTokenizer(vocab),
                    model=MiniLM(cfg, device="cpu"), device="cpu")


def test_vector_index_uses_sharded_on_mesh(pmesh, jmesh, corpus_data, tmp_path):
    docs = [
        "the supreme court held that due process requires notice",
        "the defendant filed a motion to suppress evidence",
        "equal protection forbids racial segregation in schools",
        "freedom of speech is protected by the first amendment",
    ]
    vidx = VectorIndex(VectorConfig(hnsw=AnnConfig(), dimension=64),
                       embedder=_tiny_port_embedder(docs), device="cpu", mesh=pmesh)
    assert isinstance(vidx.ann, ShardedCorpusIndex)
    one = VectorIndex(VectorConfig(dimension=64), embedder=vidx.embedder, device="cpu",
                      mesh=single_device_mesh("cpu"))
    assert not isinstance(one.ann, ShardedCorpusIndex)
    for row, d in enumerate(docs):
        vidx.add_document(row, d, row)
    vidx.freeze()
    hits = vidx.search(docs[2], top_k=2)
    assert hits and hits[0].row == 2
    assert vidx.get_stats().ann["shards"] == 8

    # a sharded save loads as sharded; a partitioned artifact loaded with a
    # mesh (and a sharded one without) is rebuilt from the saved vectors
    corpus, queries = corpus_data
    vidx._vectors, vidx._refs = corpus, [(r, 0) for r in range(len(corpus))]
    vidx.ann.build(corpus)
    vidx.save(tmp_path / "v")
    back = VectorIndex(VectorConfig(dimension=64), embedder=vidx.embedder, device="cpu", mesh=pmesh)
    back.load(tmp_path / "v")
    np.testing.assert_array_equal(back.ann.search_brute(queries, 5)[1],
                                  vidx.ann.search_brute(queries, 5)[1])
    plain = VectorIndex(VectorConfig(dimension=64), embedder=vidx.embedder, device="cpu")
    plain.load(tmp_path / "v")
    assert plain.ann.num_vectors == 500 and not isinstance(plain.ann, ShardedCorpusIndex)
    plain.save(tmp_path / "p")
    again = VectorIndex(VectorConfig(dimension=64), embedder=vidx.embedder, device="cpu", mesh=pmesh)
    again.load(tmp_path / "p")
    assert isinstance(again.ann, ShardedCorpusIndex) and again.ann.num_vectors == 500


# ---------------------------------------------------------------------------
# FusedHybridSearch(mesh=) and SearchEngine(mesh=)
# ---------------------------------------------------------------------------


def _fused_pair(art, jmesh, pmesh, mode):
    jcfg, pcfg = JaxConfig.from_file(art["toml"]), Config.from_file(art["toml"])
    jt, jv, jc = jax_load_artifacts(jcfg)
    pt, pv, pc = load_artifacts(pcfg, device="cpu")
    jf = JaxFused(jt, jv, jc, ann_mode=mode, mesh=jmesh, flat_escalate_eps=0.01)
    pf = FusedHybridSearch(pt, pv, pc, ann_mode=mode, mesh=pmesh, flat_escalate_eps=0.01)
    return jv, jf, pf


@pytest.mark.parametrize("mode", ["brute", "partitioned"])
@pytest.mark.parametrize("recall", [1.0, 0.97])
def test_fused_hybrid_search_sharded_matches_jax(art, jmesh, pmesh, mode, recall, kernels_interpret,
                                                 jax_stream_jitted):
    """Both sharded modes: a batch of 1 probes and a padded batch of 8
    streams in the partitioned mode; rows, cases and sources equal."""
    jv, jf, pf = _fused_pair(art, jmesh, pmesh, mode)
    want_mode = "sharded" if mode == "brute" else "sharded-partitioned"
    assert jf.ann_mode == pf.ann_mode == want_mode
    texts = [q[0] for q in QUERIES]
    embs = jv.generate_embeddings(texts)
    if mode == "partitioned":
        assert pf.sp_m == jf.sp_m and pf.sp_nprobe == jf.sp_nprobe
        assert not pf._layout_brute_batch(1) and pf._layout_brute_batch(8)
    for sel in (slice(0, 1), slice(0, 8), slice(2, 10)):
        B = len(texts[sel])
        courts = [q[1] for q in QUERIES[sel]]
        dates = [q[2] for q in QUERIES[sel]]
        args = (embs[sel], texts[sel], courts, dates, [0.0] * B, [2.0] * B)
        want = jf.query_batch(*args, k=8, recall_target=recall)
        got = pf.query_batch(*args, k=8, recall_target=recall)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g, np.asarray(w))
        fin = np.isfinite(np.asarray(want[0]))
        np.testing.assert_array_equal(np.isfinite(got[0]), fin)
        np.testing.assert_allclose(got[0][fin], np.asarray(want[0])[fin], atol=1e-5, rtol=0)
        assert (got[2] >= 0).any()


@pytest.mark.parametrize("mode", ["auto", "partitioned"])
def test_search_engine_with_mesh_matches_jax(art, jmesh, pmesh, mode, kernels_interpret,
                                             jax_stream_jitted):
    """``SearchEngine(mesh=)`` against the JAX engine with the same mesh:
    same cases in the same order, match types, snippets and metadata."""
    jcfg, pcfg = JaxConfig.from_file(art["toml"]), Config.from_file(art["toml"])
    for c in (jcfg, pcfg):
        c.search.fused_ann_mode = mode
        c.search.enable_query_cache = False
        c.search.use_fused_device_path = False  # the mesh alone picks the fused path
    jeng = JaxEngine(jcfg, JaxStorage(jcfg.storage), *jax_load_artifacts(jcfg), mesh=jmesh)
    peng = SearchEngine(pcfg, StorageManager(pcfg.storage), *load_artifacts(pcfg, device="cpu"),
                        device="cpu", mesh=pmesh)
    share_embeddings(jeng, peng, [q[0] for q in QUERIES])
    want = jeng.search_batch(_requests(JaxQuery, JaxSearchConfig))
    got = peng.search_batch(_requests(SearchQuery, SearchConfig))
    _assert_same(got, want, bitwise=False)
    assert peng._get_fused().ann_mode == ("sharded" if mode == "auto" else "sharded-partitioned")
    assert got[0][0].case_metadata.name == "Brown v. Board of Education"
