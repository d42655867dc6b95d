"""The port's mesh across processes: each process of a job answers what a
single process answers on a mesh of the same shape.

A job here is two processes (``tests/torch_distributed_job.py``, spawned
with a coordinator on a free port of 127.0.0.1 and a timeout of their own),
each owning two ``cpu`` shards of a 4×1 mesh over ``gloo``. The reference
is the single-process port on four ``cpu`` shards, which
``tests/test_torch_parallel.py`` holds against the JAX package's sharded
steps on its CPU mesh.

Tolerances: every collective, ``ShardedCorpusIndex`` and
``FusedHybridSearch`` output bitwise (each process merges the same lists in
the same order); the sharded train step's loss within 1e-5 and its
parameters after three AdamW steps within ``PARAM_TOL`` (the gradients of
the two processes are summed in another order), and bitwise the same on
both processes.
"""

import json

import numpy as np
import pytest
import torch
from torch_distributed_job import (
    TRAIN_STEPS,
    run_job,
    search_cases,
    train_batch,
    train_case,
)
from torch_engine_fixtures import art  # noqa: F401  (fixture)

from trie_semantic_search_tpu_torch.core.config import Config, MeshConfig
from trie_semantic_search_tpu_torch.index.builder import load_artifacts
from trie_semantic_search_tpu_torch.parallel import batch_sharding, make_distributed_mesh, make_mesh
from trie_semantic_search_tpu_torch.parallel.mesh import job_mesh, pick_backend

torch.set_num_threads(1)

PARAM_TOL = 5e-6
TWO_RANKS = [["cpu", "cpu"], ["cpu", "cpu"]]

COLLECTIVE_CASES = ["brute_float32", "brute_bfloat16", "int8_k10", "int8_k200", "fused_matmul",
                    "fused_kernel", "partitioned_upk0_np3", "partitioned_upk1_np8", "stream_upk0",
                    "stream_upk1", "index_int81", "index_int80"]
FHS_CASES = [f"fhs_{mode}_{recall}_{lo}_{hi}" for mode in ("sharded", "sharded-partitioned")
             for recall in (1.0, 0.97) for lo, hi in ((0, 1), (0, 8), (2, 10))]
QUERY_TEXTS = ["brown v. board of education", "384 U.S. 436 (1966)", "right to remain silent",
               "separate educational facilities are inherently unequal", "contract breach damages",
               "fourth amendment search and seizure", "duty of care negligence", "the court",
               "miranda v. arizona", "counsel for indigent defendants"]


def cpu4():
    return make_mesh(MeshConfig(data_parallel=4), devices=["cpu"] * 4)


@pytest.fixture(scope="module")
def queries(art):
    """The query texts and their port embeddings, beside the artifacts,
    where the job's processes read them."""
    root = art["root"]
    _, vec, _ = load_artifacts(Config.from_file(art["toml"]), device="cpu")
    np.save(root / "embs.npy", np.asarray(vec.generate_embeddings(QUERY_TEXTS), np.float32))
    (root / "queries.json").write_text(json.dumps(QUERY_TEXTS))
    return str(art["toml"])


@pytest.fixture(scope="module")
def search_job(queries, tmp_path_factory):
    return run_job("search", tmp_path_factory.mktemp("search_job"), TWO_RANKS, art=queries)


@pytest.fixture(scope="module")
def one_process(queries):
    return search_cases(cpu4(), queries)


def _bitwise(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("case", COLLECTIVE_CASES + FHS_CASES)
def test_each_rank_answers_what_one_process_answers(search_job, one_process, case, rank):
    """Every collective (brute f32 and bf16, int8, the fused step's matmul
    and kernel routes, the partitioned step with and without the probe
    kernel, the stream), ``ShardedCorpusIndex`` in int8 and bf16, and
    ``FusedHybridSearch`` in both sharded modes: bitwise."""
    info, arrays = search_job[rank]
    want = one_process[case]
    assert case in info["cases"]
    for i, w in enumerate(want):
        _bitwise(arrays[f"{case}/{i}"], w)
    if case.startswith("fhs_"):
        assert (want[2] >= 0).any()


def test_each_rank_places_only_its_shards_and_refuses_save(search_job):
    """Rank r owns shards 2r and 2r+1; saving a sharded index, which reads
    every shard to the host, raises there."""
    for r, (info, _) in enumerate(search_job):
        assert info["local_rows"] == [2 * r, 2 * r + 1]
        assert info["save_error"] and f"rank {r} holds only shards" in info["save_error"]


@pytest.fixture(scope="module")
def train_job(tmp_path_factory):
    return run_job("train", tmp_path_factory.mktemp("train_job"), TWO_RANKS, shapes=[[2, 2], [4, 1]])


@pytest.mark.parametrize("dp,mp", [(2, 2), (4, 1)])
def test_train_step_across_processes_equals_one_process(train_job, dp, mp):
    """dp across the two processes (2×2: tensor parallel inside each; 4×1:
    two data rows each): the losses and the parameters after the steps
    equal the single-process sharded step's, and both processes hold the
    same parameters."""
    losses, params = train_case(make_mesh(MeshConfig(data_parallel=dp, model_parallel=mp), devices=["cpu"] * 4))
    key = f"{dp}x{mp}"
    (i0, a0), (i1, a1) = train_job
    assert i0[key]["local_rows"] == list(range(dp // 2)) and i1[key]["local_rows"] == list(range(dp // 2, dp))
    for info in (i0, i1):
        assert len(info[key]["losses"]) == TRAIN_STEPS
        np.testing.assert_allclose(info[key]["losses"], losses, rtol=1e-5)
    for name, want in params.items():
        _bitwise(a0[f"{key}/{name}"], a1[f"{key}/{name}"])
        d = float(np.abs(a0[f"{key}/{name}"] - want).max())
        assert d <= PARAM_TOL, (name, d)


# -- the layout rules, without processes ----------------------------------------


@pytest.mark.parametrize("ids,want", [
    ([["cuda:a", "cuda:b"], ["cuda:c", "cuda:d"]], "nccl"),
    ([["cuda:a"], ["cuda:a"]], "gloo"),
    ([["cuda:a", "cuda:a"], ["cuda:b"]], "nccl"),
    ([["cpu"], ["cpu"]], "gloo"),
    ([["cuda:a"], ["cpu"]], "gloo"),
])
def test_backend_follows_the_layout(ids, want):
    """NCCL only when every process owns cards no other process holds (a
    process may place several shards on one card)."""
    assert pick_backend(ids) == want


def test_job_mesh_orders_devices_by_rank():
    """The global grid is the processes' devices in rank order; each data
    row belongs to one process; the errors of a model axis across
    processes and of a process with no row."""
    per_rank = [["cpu"], ["cpu"] * 3]
    for rank in (0, 1):
        mesh = job_mesh(MeshConfig(), per_rank, rank)
        assert mesh.shape == {"data": 4, "model": 1} and mesh.distributed
        assert mesh.owners == [[0], [1], [1], [1]]
        assert mesh.local_data_rows == ([0] if rank == 0 else [1, 2, 3])
        assert [mesh.is_local(s) for s in range(4)] == [rank == 0] + [rank == 1] * 3
    two = job_mesh(MeshConfig(model_parallel=2), [["cpu"] * 2, ["cpu"] * 2], 1)
    assert two.owners == [[0, 0], [1, 1]] and two.local_data_rows == [1]
    with pytest.raises(ValueError, match="spans processes"):
        job_mesh(MeshConfig(model_parallel=2), per_rank, 0)
    with pytest.raises(ValueError, match="own no data row"):
        job_mesh(MeshConfig(data_parallel=2), [["cpu"] * 2, ["cpu"] * 2], 0)
    with pytest.raises(ValueError, match="not divisible"):
        job_mesh(MeshConfig(model_parallel=3), [["cpu"] * 2, ["cpu"] * 2], 0)


def test_make_distributed_mesh_without_coordinator_is_make_mesh():
    mesh = make_distributed_mesh(MeshConfig(data_parallel=2), devices=["cpu"] * 2)
    assert mesh.shape == {"data": 2, "model": 1} and not mesh.distributed
    assert mesh.local_data_rows == [0, 1]
    with pytest.raises(ValueError, match="num_processes"):
        make_distributed_mesh(MeshConfig(), "127.0.0.1:1", devices=["cpu"])


def test_batch_sharding_splits_the_batch_over_the_data_rows():
    """``P("data")``: row block r of the batch on data row r's device; a
    process keeps only its own rows' blocks."""
    batch = torch.arange(24).reshape(8, 3)
    blocks = batch_sharding(make_mesh(MeshConfig(model_parallel=2), devices=["cpu"] * 8))(batch)
    assert [b.tolist() for b in blocks] == [batch[2 * r : 2 * r + 2].tolist() for r in range(4)]
    remote = batch_sharding(job_mesh(MeshConfig(), [["cpu"] * 2, ["cpu"] * 2], 1))(batch)
    assert remote[:2] == [None, None] and [b.tolist() for b in remote[2:]] == [
        batch[4:6].tolist(), batch[6:8].tolist()]
    with pytest.raises(ValueError):
        batch_sharding(cpu4())(batch[:6])


def test_train_batch_is_the_sharded_steps_batch():
    """The job's batch has exactly the keys of the JAX step's
    ``in_shardings``; another key is refused."""
    from trie_semantic_search_tpu_torch.models import minilm as tm
    from trie_semantic_search_tpu_torch.models import train as tt
    from torch_distributed_job import TRAIN_TINY

    cfg = tm.MiniLMConfig(**TRAIN_TINY)
    step = tt.make_sharded_train_step(cpu4(), cfg, tt.TrainConfig())
    state = step.init(tm.MiniLM(cfg, device="cpu"))
    b = train_batch()
    assert sorted(b) == sorted(tt.SHARDED_BATCH_KEYS)
    with pytest.raises(ValueError, match="exactly"):
        step(state, dict(b, neg_mask=np.ones((8, 8), bool)))
    with pytest.raises(ValueError, match="divide"):
        step(state, {k: v[:6] for k, v in b.items()})
