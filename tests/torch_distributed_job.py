"""A job of the port across processes, for the tests: its inputs, the
cases each process runs, and the spawning of its processes.

The tests run a case twice: in the test's process on a single-process mesh
of four ``cpu`` shards, and in a job of two processes (spawned by
:func:`run_job`, each owning two ``cpu`` shards of the same 4×1 mesh,
joined by ``make_distributed_mesh`` over ``gloo``). Every process computes
the same inputs from the same seeds. This module imports numpy and the
port only; run as a script it is one process of a job::

    python tests/torch_distributed_job.py TASK --rank R --world W --port P --out DIR

Each process writes ``DIR/rank<R>.npz`` (arrays) and ``DIR/rank<R>.json``,
and leaves the process group before it exits.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from trie_semantic_search_tpu_torch.core.config import Config, MeshConfig
from trie_semantic_search_tpu_torch.index.kmeans import train_kmeans
from trie_semantic_search_tpu_torch.index.sharded import ShardedCorpusIndex, build_sharded_partitions
from trie_semantic_search_tpu_torch.models import minilm as tm
from trie_semantic_search_tpu_torch.models import train as tt
from trie_semantic_search_tpu_torch.ops.scoring import quantize_int8
from trie_semantic_search_tpu_torch.parallel.collectives import (
    sharded_brute_topk,
    sharded_fused_topk,
    sharded_int8_topk,
    sharded_layout_brute_topk,
    sharded_partitioned_topk,
)
from trie_semantic_search_tpu_torch.parallel.mesh import (
    all_gather_shards,
    make_distributed_mesh,
    shard_rows,
    shutdown_distributed,
)

#: seconds a process may take to join its job, and a whole job to finish
JOIN_TIMEOUT_S, JOB_TIMEOUT_S = 60, 240

TRAIN_TINY = dict(vocab_size=256, hidden_size=32, num_layers=2, num_heads=4,
                  intermediate_size=64, max_position=32)
TRAIN_CFG = dict(learning_rate=1e-3, warmup_steps=1, total_steps=5, max_grad_norm=6.5)
TRAIN_STEPS, TRAIN_SEED = 3, 3


def t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a))


def normed(x: np.ndarray) -> np.ndarray:
    return (x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)).astype(np.float32)


def _np(outs) -> list[np.ndarray]:
    return [o.cpu().numpy() if isinstance(o, torch.Tensor) else np.asarray(o) for o in outs]


# ---------------------------------------------------------------------------
# the search cases: every collective, ShardedCorpusIndex, FusedHybridSearch
# ---------------------------------------------------------------------------


def fused_inputs(n_cases=64, N=256, D=32, B=4, seed=12):
    """Corpus, int8 codes, chunk and case columns, and a court table (the
    shapes of the JAX package's sharded fused tests)."""
    rng = np.random.default_rng(seed)
    corpus = normed(rng.standard_normal((N, D)))
    cq, cs = quantize_int8(t(corpus))
    chunk_case = rng.integers(0, n_cases, N).astype(np.int32)
    court = rng.integers(0, 4, N).astype(np.int32)
    date = rng.integers(0, 1000, N).astype(np.int32)
    case_court = np.zeros(n_cases, np.int32)
    case_date = np.zeros(n_cases, np.int32)
    for i in range(N - 1, -1, -1):
        case_court[chunk_case[i]] = court[i]
        case_date[chunk_case[i]] = date[i]
    court_table = rng.random((B, 4)) < 0.6
    return (corpus, cq.numpy(), cs.numpy(), chunk_case, case_court[chunk_case], case_date[chunk_case],
            case_court, case_date, court_table)


def _fused(mesh, scan_mode: str, recall: float):
    corpus, cq, cs, case, court, date, ccourt, cdate, ctable = fused_inputs(N=8 * 2048, n_cases=512, B=4,
                                                                            seed=21)
    B = ctable.shape[0]
    lex = np.full((B, 3), -1, np.int32)
    lex[0, 0] = next(int(c) for c in range(64) if ctable[0, ccourt[c]] and 0 <= cdate[c] <= 800)
    n_valid = corpus.shape[0] - 100
    cs = cs.copy()
    cs[n_valid:] = 0.0
    return sharded_fused_topk(
        mesh, t(corpus[:B]), t(cq), t(cs), t(case), t(court), t(date), t(ctable),
        t(np.zeros(B, np.int32)), t(np.full(B, 800, np.int32)), t(lex), t(np.full((B, 3), 1, np.int32)),
        t(np.maximum(lex, 0)), t(ccourt), t(cdate), t(np.full(B, -1.0, np.float32)),
        t(np.full(B, 2.0, np.float32)), k=5, n_valid=n_valid, recall_target=recall, scan_mode=scan_mode,
    )


def _partition_state():
    corpus, _, _, case, court, date, ccourt, cdate, ctable = fused_inputs(n_cases=256, N=2048, B=4, seed=33)
    cent = train_kmeans(corpus, 8, iters=5, sample=2048, seed=0, device="cpu")
    parts = build_sharded_partitions(corpus, corpus.shape[0], 4, cent, court, date, device="cpu")
    B = ctable.shape[0]
    lex = np.full((B, 3), -1, np.int32)
    lex[1, 0] = next(int(c) for c in range(256) if ctable[1, ccourt[c]] and 0 <= cdate[c] <= 1000)
    shared = (ctable, np.zeros(B, np.int32), np.full(B, 1000, np.int32), lex,
              np.full((B, 3), 1, np.int32), np.maximum(lex, 0), ccourt, cdate,
              np.full(B, 0.0, np.float32), np.full(B, 2.0, np.float32))
    return corpus, case, court, cent, parts, shared


def search_cases(mesh, art_toml: str | None = None) -> dict[str, list[np.ndarray]]:
    """Every case's outputs on ``mesh`` (4 shards), as host arrays."""
    out: dict[str, list[np.ndarray]] = {}
    rng = np.random.default_rng(0)
    q, c = normed(rng.standard_normal((4, 64))), normed(rng.standard_normal((800, 64)))
    for dtype in ("float32", "bfloat16"):
        out[f"brute_{dtype}"] = _np(sharded_brute_topk(mesh, t(q), t(c).to(getattr(torch, dtype)), 10,
                                                       n_valid=797))
    pq, ps = quantize_int8(t(c))
    for k in (10, 200):
        out[f"int8_k{k}"] = _np(sharded_int8_topk(mesh, t(q), shard_rows(pq, mesh), shard_rows(ps, mesh), k))
    out["fused_matmul"] = _np(_fused(mesh, "matmul", 1.0))
    out["fused_kernel"] = _np(_fused(mesh, "kernel", 0.9))

    corpus, case, court, cent, parts, shared = _partition_state()
    names = ("part_rows", "part_int8", "part_scale", "part_cword", "part_cbit", "part_date")
    pparts = [t(parts[n]) for n in names]
    pparts[4] = t(parts["part_cbit"].view(np.int32))
    for upk, nprobe in ((False, 3), (True, 8)):
        out[f"partitioned_upk{int(upk)}_np{nprobe}"] = _np(sharded_partitioned_topk(
            mesh, t(corpus[:4]), t(cent), *pparts, t(corpus).to(torch.bfloat16), t(case),
            *map(t, shared), k=5, nprobe=nprobe, use_probe_kernel=upk))
    rows = parts["part_rows"]
    shard_n = corpus.shape[0] // rows.shape[0]
    glob = np.maximum(rows, 0) + (np.arange(rows.shape[0]) * shard_n)[:, None, None]
    slot_court = np.where(rows >= 0, court[glob], -1).astype(np.int32)
    for upk, recall in ((False, 1.0), (True, 0.9)):
        out[f"stream_upk{int(upk)}"] = _np(sharded_layout_brute_topk(
            mesh, t(corpus[:4]), t(rows), t(parts["part_int8"]), t(parts["part_scale"]), t(slot_court),
            t(parts["part_date"]), t(corpus).to(torch.bfloat16), t(case), *map(t, shared), k=5,
            overfetch=8, recall_target=recall, use_gather_kernel=upk))

    corpus = normed(np.random.default_rng(5).standard_normal((500, 64)))
    for use_int8 in (True, False):
        idx = ShardedCorpusIndex(mesh, use_int8=use_int8)
        idx.build(corpus)
        out[f"index_int8{int(use_int8)}"] = _np(idx.search_brute(corpus[:8] * 0.99 + 0.01, 10))
    if art_toml is not None:
        out.update(fused_search_cases(mesh, art_toml))
    return out


def fused_search_cases(mesh, art_toml: str) -> dict[str, list[np.ndarray]]:
    """``FusedHybridSearch(mesh=)`` over the artifacts of ``art_toml`` in
    both sharded modes: a batch of 1 (the probe) and of 8 (the stream),
    at recall 1.0 and 0.97; the query vectors from ``embs.npy`` beside it."""
    from trie_semantic_search_tpu_torch.index.builder import load_artifacts
    from trie_semantic_search_tpu_torch.search.fused import FusedHybridSearch

    root = Path(art_toml).parent
    texts = json.loads((root / "queries.json").read_text())
    embs = np.load(root / "embs.npy")
    out = {}
    for mode in ("brute", "partitioned"):
        trie, vec, cols = load_artifacts(Config.from_file(art_toml), device="cpu")
        f = FusedHybridSearch(trie, vec, cols, ann_mode=mode, mesh=mesh, flat_escalate_eps=0.01)
        for recall in (1.0, 0.97):
            for lo, hi in ((0, 1), (0, 8), (2, 10)):
                B = hi - lo
                got = f.query_batch(embs[lo:hi], texts[lo:hi], [None] * B, [None] * B, [0.0] * B,
                                    [2.0] * B, k=8, recall_target=recall)
                out[f"fhs_{f.ann_mode}_{recall}_{lo}_{hi}"] = _np(got)
    return out


# ---------------------------------------------------------------------------
# the train case
# ---------------------------------------------------------------------------


def train_batch(B: int = 8, L: int = 12) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(0)
    b = {"ids_a": rng.integers(1, 256, (B, L)).astype(np.int32), "mask_a": np.ones((B, L), np.int32),
         "ids_b": rng.integers(1, 256, (B, L)).astype(np.int32), "mask_b": np.ones((B, L), np.int32)}
    b["mask_a"][2, 7:] = 0
    b["mask_b"][5, 4:] = 0
    return b


def train_case(mesh) -> tuple[list[float], dict[str, np.ndarray]]:
    """``TRAIN_STEPS`` sharded f32 steps from the seeded tiny encoder on
    one batch: the losses and the parameters after them."""
    cfg = tm.MiniLMConfig(**TRAIN_TINY)
    step = tt.make_sharded_train_step(mesh, cfg, tt.TrainConfig(**TRAIN_CFG), 0.05)
    state = step.init(tm.MiniLM(cfg, device="cpu", seed=TRAIN_SEED, compute_dtype=torch.float32))
    batch = train_batch()
    losses = [float(step(state, batch)[0]) for _ in range(TRAIN_STEPS)]
    model = step.gather(state, "cpu")
    return losses, {k: v.numpy() for k, v in model.state_dict().items()}


# ---------------------------------------------------------------------------
# one process of a job
# ---------------------------------------------------------------------------


def _task_mesh(rank: int, world: int, address: str, devices: list) -> tuple[dict, dict]:
    """The job's mesh, its ownership and gather; the errors of a model axis
    across processes and of a second job."""
    mesh = make_distributed_mesh(MeshConfig(), address, world, rank, devices=devices,
                                 timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    local = torch.tensor([[10.0 * s + rank] for s in mesh.local_data_rows])
    info = dict(shape=mesh.shape, owners=mesh.owners, local_rows=mesh.local_data_rows,
                rows_of=[mesh.rows_of(r) for r in range(world)], backend=mesh.backend,
                first_device=str(mesh.first_device), data_devices=[str(d) for d in mesh.data_devices],
                gathered=all_gather_shards(mesh, local).reshape(-1).tolist(),
                blocks=[None if b is None else b.tolist() for b in shard_rows(np.arange(8.0), mesh)])
    for name, call in (
        ("model_axis_error", lambda: make_distributed_mesh(MeshConfig(model_parallel=2), address, world, rank)),
        ("other_job_error", lambda: make_distributed_mesh(MeshConfig(), address, world, (rank + 1) % world)),
    ):
        try:
            call()
            info[name] = None
        except (ValueError, RuntimeError) as e:
            info[name] = f"{type(e).__name__}: {e}"
    return info, {}


def _task_search(rank: int, world: int, address: str, devices: list, art: str | None) -> tuple[dict, dict]:
    mesh = make_distributed_mesh(MeshConfig(), address, world, rank, devices=devices,
                                 timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    outs = search_cases(mesh, art)
    arrays = {f"{name}/{i}": a for name, arrs in outs.items() for i, a in enumerate(arrs)}
    idx = ShardedCorpusIndex(mesh)
    idx.build(normed(np.random.default_rng(1).standard_normal((64, 16))))
    try:
        idx.save(os.devnull)
        save_error = None
    except RuntimeError as e:
        save_error = str(e)
    return dict(cases=sorted(outs), local_rows=mesh.local_data_rows, backend=mesh.backend,
                save_error=save_error), arrays


def _task_train(rank: int, world: int, address: str, devices: list, shapes: list) -> tuple[dict, dict]:
    info, arrays = {}, {}
    for dp, mp in shapes:
        mesh = make_distributed_mesh(MeshConfig(data_parallel=dp, model_parallel=mp), address, world, rank,
                                     devices=devices, timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
        losses, params = train_case(mesh)
        info[f"{dp}x{mp}"] = dict(losses=losses, local_rows=mesh.local_data_rows)
        arrays.update({f"{dp}x{mp}/{k}": v for k, v in params.items()})
    return info, arrays


def main() -> int:
    ap = argparse.ArgumentParser(description="one process of a job of the port across processes")
    ap.add_argument("task", choices=["mesh", "search", "train"])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--devices", required=True, help="JSON: each rank's device list")
    ap.add_argument("--art", default=None, help="a config TOML of saved artifacts (search)")
    ap.add_argument("--shapes", default="[[2, 2], [4, 1]]", help="JSON: train meshes (dp, mp)")
    a = ap.parse_args()
    torch.set_num_threads(1)
    devices = json.loads(a.devices)[a.rank]
    address = f"127.0.0.1:{a.port}"
    try:
        if a.task == "mesh":
            info, arrays = _task_mesh(a.rank, a.world, address, devices)
        elif a.task == "search":
            info, arrays = _task_search(a.rank, a.world, address, devices, a.art)
        else:
            info, arrays = _task_train(a.rank, a.world, address, devices, json.loads(a.shapes))
    finally:
        shutdown_distributed()
    out = Path(a.out)
    np.savez(out / f"rank{a.rank}.npz", **arrays)
    (out / f"rank{a.rank}.json").write_text(json.dumps(info))
    return 0


# ---------------------------------------------------------------------------
# the spawning side
# ---------------------------------------------------------------------------


def free_port() -> int:
    """A port the kernel hands out for 127.0.0.1 (bound and released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_job(task: str, out: Path, devices: list[list[str]], timeout: float = JOB_TIMEOUT_S,
            **extra) -> list[tuple[dict, dict]]:
    """Spawn one process per entry of ``devices`` running ``task`` and
    wait for all of them (``timeout`` seconds in all); any process that
    fails, or outlives the timeout (then every process is killed), raises
    ``AssertionError`` with its output. Returns each rank's ``(info,
    arrays)``."""
    out.mkdir(parents=True, exist_ok=True)
    port, world = free_port(), len(devices)
    cmd = [sys.executable, str(Path(__file__).resolve()), task, "--world", str(world), "--port", str(port),
           "--out", str(out), "--devices", json.dumps(devices)]
    for k, v in extra.items():
        cmd += [f"--{k}", v if isinstance(v, str) else json.dumps(v)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=env, text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            try:
                logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{task} job: a process outlived {timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    assert not bad, f"{task} job: processes failed: {bad}"
    results = []
    for r in range(world):
        with np.load(out / f"rank{r}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        results.append((json.loads((out / f"rank{r}.json").read_text()), arrays))
    return results


if __name__ == "__main__":
    sys.exit(main())
