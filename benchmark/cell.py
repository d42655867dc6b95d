"""One run of one cell: inputs from the seed, set-up, the measured window,
the check against the plain reference, the metrics.

:func:`run` is what ``run.py`` calls on the card; tests call it on the CPU
at a small ``scale`` (it does not look for a card itself)."""

from __future__ import annotations

import copy
import gc
import importlib.util
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import check, data, drivers, encoders, store, sut, trace
from .reference import search, wordpiece

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names a run may not load (the port's own name begins
#: with the JAX package's, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "trie_semantic_search_tpu")
#: the build and kernel caches: fixed directories inside the checkout
CACHE = ROOT / ".bench_cache"


def set_cache_dirs() -> None:
    os.environ["TSS_TORCH_BUILD_DIR"] = str(CACHE / "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def forbidden_modules(modules) -> list[str]:
    return sorted({m.split(".", 1)[0] for m in modules if m.split(".", 1)[0] in FORBIDDEN})


@dataclass
class Spec:
    """A cell as ``BENCHMARK.json`` and its files define it."""

    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    bench: dict = field(default_factory=dict)


def load_spec(name: str, root: Path = ROOT) -> Spec:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    centry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = json.loads((root / centry["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{wl['traffic']}.json").read_text())

    def mine(ms):
        return [m for m in ms if "workloads" not in m or name in m["workloads"]]

    return Spec(wl, config, traffic, mine(bench["end_to_end"]), mine(bench["per_layer"]), bench)


def listing(root: Path = ROOT) -> list[str]:
    """One line per cell: its configuration and traffic files, its
    encoder's architecture and plug-in file, and its metrics with their
    readers; raises where a file is missing."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    out = []
    for wl in bench["workloads"]:
        spec = load_spec(wl["name"], root)
        files = [next(c["file"] for c in bench["configs"] if c["name"] == wl["config"]),
                 f"benchmark/traffic/{wl['traffic']}.json"]
        enc = spec.config["encoder"]
        plugin = Path(encoders.load(enc).__file__).resolve().relative_to(root.resolve())
        metrics = [m["name"] for m in spec.end_to_end + spec.per_layer]
        for m in metrics:
            if not (root / "benchmark" / "metrics" / f"{m}.py").is_file():
                raise FileNotFoundError(f"{wl['name']}: no reader for {m}")
        out.append(f"{wl['name']}: {' '.join(files)} arch={enc['arch']} encoder={plugin} "
                   f"driver={spec.traffic['driver']} metrics={','.join(metrics)}")
    return out


def reader(name: str, root: Path = ROOT):
    """The ``read(obs)`` function of ``benchmark/metrics/<name>.py``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Session:
    """A cell set up: what a driver needs during the window (``engine``,
    ``queries`` and ``search_queries``, the same as the engine's
    ``SearchQuery``, ``warm_queries``, ``traffic``, ``seed``, ``out_dir``,
    ``torch``) and what the check needs after it."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def index_of(self, q) -> int:
        return self.text_index.get(q.query, -1)

    def spans(self) -> dict:
        from trie_semantic_search_tpu_torch.core.metrics import metrics

        return {n: (metrics.histogram(n).count, metrics.histogram(n).total_ms) for n in SPANS}

    def spans_since(self, snap: dict) -> dict:
        now = self.spans()
        return {n: (now[n][0] - snap[n][0], now[n][1] - snap[n][1]) for n in SPANS}

    def clear_caches(self) -> None:
        self.engine.query_cache.clear()
        self.engine.vector_index.cache.clear()


#: the engine's spans the per-layer metrics read (``core/metrics``)
SPANS = ("search_batch", "fused_embed", "fused_device")


def scaled(config: dict, scale: dict | None) -> dict:
    """The configuration with ``scale``'s corpus keys replaced (tests)."""
    cfg = copy.deepcopy(config)
    for k, v in (scale or {}).get("corpus", {}).items():
        cfg["corpus"][k] = v
    return cfg


def to_search_query(q: data.Query):
    from trie_semantic_search_tpu_torch.search.engine import SearchQuery

    return SearchQuery(query=q.text, max_results=q.max_results, court_filter=q.court_filter,
                       date_range=q.date_range)


def log(*a) -> None:
    import sys

    print(*a, file=sys.stderr, flush=True)


def prepare(spec: Spec, seed: int, seconds: float, trace_on: bool, device: str, t_start: float,
            scale: dict | None = None, fault=None, out_dir: Path | None = None,
            n_queries: int | None = None) -> Session:
    """Inputs from the seed, the port set up over them and warmed for the
    cell's own shapes. ``fault`` wraps ``SearchEngine.search_batch`` (the
    tests' broken timed path); ``n_queries`` overrides the driver's count
    (the knee sweep's several windows)."""
    set_cache_dirs()
    import torch

    cfg = scaled(spec.config, scale)
    traffic = copy.deepcopy(spec.traffic)
    traffic.update((scale or {}).get("traffic", {}))
    enc, corpus = cfg["encoder"], dict(cfg["corpus"], seed=seed)
    P, m, D, chunks = corpus["partitions"], corpus["slots"], corpus["dim"], corpus["chunks_per_case"]
    n_cases = P * m // chunks
    timings: dict = {}
    tmp = tempfile.TemporaryDirectory(prefix="bench-")
    work = Path(out_dir or tmp.name)
    work.mkdir(parents=True, exist_ok=True)
    db = str(Path(tmp.name) / "store.sqlite")
    writer = store.start(db, n_cases, chunks, seed, int(cfg["serving"]["store_workers"]))
    prep = Session(torch=torch, spec=spec, cfg=cfg, traffic=traffic, corpus=corpus, seed=seed, device=device,
                    root=ROOT, out_dir=work, tmp=tmp, writer=writer, timings=timings, trace_on=trace_on,
                    to_search=to_search_query, http=None, engine=None)
    try:
        t0 = time.perf_counter()
        lex = data.lexicon()
        prep.cases = cases = data.make_cases(n_cases, chunks, seed, lex)
        vocab = data.vocabulary(lex, enc["vocab_size"])
        prep.driver = driver = drivers.load(traffic["driver"])
        n = n_queries or driver.queries_needed(traffic, seconds, trace_on)
        prep.queries = queries = data.make_queries(traffic, n, cases, seed)
        prep.warm_queries = data.make_queries(traffic, int(traffic["warm_queries"]), cases, seed + 1)
        timings["inputs_s"] = time.perf_counter() - t0
        prep.encoder = plugin = encoders.load(enc)

        # the reference's own work (its weights, tokens and embeddings of
        # the pool, which the planting needs) is timed apart and left out of
        # setup_s
        t0 = time.perf_counter()
        prep.token_ids = [wordpiece.token_ids(q.text, vocab, enc["max_position_embeddings"]) for q in queries]
        prep.ref_emb = ref_emb = plugin.reference_embeddings(torch, enc, seed, prep.token_ids, device)
        if device == "cuda":
            torch.cuda.synchronize()
        timings["reference_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        layout = data.make_layout(torch, P, m, D, seed, device, *sut.seg_geometry(D))
        sem = np.asarray([i for i, q in enumerate(queries) if q.kind == "semantic"], np.int64)
        prep.plan = plan = data.plan_plants(torch, ref_emb, sem, traffic["plant"], layout, chunks, seed)
        layout.write_rows(torch, torch.as_tensor(plan.rows, device=ref_emb.device), plan.vecs)
        timings["plant_rank_max"] = plan.deepest
        if device == "cuda":
            torch.cuda.synchronize()
        timings["corpus_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        trie = sut.build_trie(cases, device)
        timings["trie_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        embedder = sut.build_embedder(plugin.build_model(torch, enc, seed, device), vocab, device)
        timings["encoder_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        timings.update(store.finish(writer, db))
        timings["store_wait_s"] = time.perf_counter() - t0
        engine = sut.build_engine(torch, cfg, cases, layout, embedder, trie, db, device, timings)
        del layout, embedder, trie
        if fault is not None:
            engine.search_batch = fault(engine.search_batch)
        prep.engine = engine
        prep.search_queries = [to_search_query(q) for q in queries]
        prep.text_index = {q.text: i for i, q in enumerate(queries)}
        t0 = time.perf_counter()
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        driver.warm(prep)
        # the set-up's garbage goes before the window, and what set-up keeps
        # leaves the collector's passes in it: one full pass over that heap
        # held the server's interpreter for 0.58 s (PERF.md §6)
        gc.collect()
        gc.freeze()
        timings["warm_s"] = time.perf_counter() - t0
    except BaseException:
        release(prep)
        raise
    prep.setup_s = time.perf_counter() - t_start - timings["reference_s"]
    log("set-up seconds: " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                                        for k, v in timings.items()) + f"; setup_s {prep.setup_s:.3f} (without reference_s)")
    return prep


def release(prep: Session) -> None:
    """Stop the driver's server and the store writer, and free the
    program's state, before the reference runs."""
    gc.unfreeze()
    try:
        if getattr(prep, "http", None):
            prep.driver.close(prep)
    finally:
        if prep.writer.is_alive():
            prep.writer.terminate()
            prep.writer.join()
        prep.engine = None
        gc.collect()
        if prep.device == "cuda":
            prep.torch.cuda.empty_cache()


def sample_of(prep: Session, answered: list[int]) -> list[int]:
    """A seeded sample of the answered queries, with the longest in it."""
    rng = np.random.default_rng([prep.seed, 5])
    k = min(len(answered), int(prep.traffic["check_sample"]))
    longest = sorted(answered, key=lambda i: -len(prep.token_ids[i]))[:16]
    return sorted(set(rng.choice(answered, k, replace=False).tolist()) | set(longest)) if answered else []


def judge(prep: Session, answers: dict, control: bool = False):
    """The window's answers against the reference: ``(numbers, verdict,
    control numbers or None)``."""
    torch = prep.torch
    limits = prep.cfg["checks"]
    chunks = prep.corpus["chunks_per_case"]
    sample = sample_of(prep, sorted(answers))
    lexical = search.Lexical(prep.cases)
    qs = [prep.queries[i] for i in sample]

    def expected_for(emb):
        rows = search.semantic_scores(torch, emb, prep.corpus, prep.plan, SCORE_FLOOR)
        return dict(zip(sample, search.expected(qs, lexical, rows, chunks, MIN_SIMILARITY, EXACT_WEIGHT,
                                                limits["score_gap"])))

    idx = torch.as_tensor(sample, device=prep.ref_emb.device, dtype=torch.long)
    expected = expected_for(prep.ref_emb[idx])
    v = check.judge(prep.queries, {i: answers[i] for i in sample}, expected, prep.cases, limits["score_gap"])
    numbers = {"score_gap": {"value": v.score_gap, "limit": limits["score_gap"]},
               "bad_results": {"value": v.bad_results, "limit": limits["bad_results"]}}
    ctrl = None
    if control:
        emb = prep.encoder.reference_embeddings(torch, prep.cfg["encoder"], prep.seed,
                                                [prep.token_ids[i] for i in sample], prep.device, "fp8")
        cv = check.judge(prep.queries, check.as_answers(expected_for(emb), prep.cases), expected, prep.cases,
                         limits["score_gap"])
        ctrl = {"score_gap": cv.score_gap, "bad_results": cv.bad_results, "recall": cv.recall}
    return numbers, v, ctrl


#: the engine's defaults the reference applies (``SearchConfig``)
MIN_SIMILARITY, EXACT_WEIGHT = 0.5, 2.0
#: rows the reference keeps per query: under the threshold by more than
#: any limit on the score
SCORE_FLOOR = 0.45


def run(spec: Spec, seed: int, seconds: float, trace_on: bool, device: str, t_start: float,
        scale: dict | None = None, fault=None, control: bool = False, out_dir: Path | None = None) -> dict:
    """One run; returns ``{"line": <the result object>, "numbers": ...,
    "control": ...}``; ``control`` also judges the reference computed in
    float8 in the program's place."""
    prep = prepare(spec, seed, seconds, trace_on, device, t_start, scale, fault, out_dir)
    torch = prep.torch
    try:
        obs = prep.driver.measure(prep, seconds, trace_on)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    finally:
        release(prep)
    stretch = obs.pop("stretch", None)
    traced = None
    if stretch is not None:
        st, batches = stretch
        traced = trace.read(st, batches)
        traced["batches"] = batches
    if "lateness_ms" in obs:
        late = obs.pop("lateness_ms")
        log(f"generator lateness ms: median {late[len(late) // 2]:.3f}, max {late[-1]:.3f}")

    t0 = time.perf_counter()
    numbers, v, ctrl = judge(prep, obs["answers"], control)
    prep.timings["check_s"] = time.perf_counter() - t0
    for note in v.notes:
        log("check:", note)
    log(f"checked {v.queries} queries, {v.results} results in {prep.timings['check_s']:.2f} s; "
        f"recall@10 {v.recall:.6f}")
    correct = all(x["value"] <= x["limit"] for x in numbers.values())

    obs.update(setup_s=prep.setup_s, recall=v.recall, cfg=prep.cfg, corpus=prep.corpus,
               token_ids=prep.token_ids, ref_emb=prep.ref_emb, trace=traced)
    units = {mm["name"]: mm["unit"] for mm in spec.end_to_end + spec.per_layer}
    metrics = {}
    for mm in spec.per_layer if trace_on else spec.end_to_end:
        val = reader(mm["name"])(obs)
        if val is not None:
            metrics[mm["name"]] = {"value": float(val), "unit": units[mm["name"]]}
    device_info = {"platform": "gpu" if device == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": int(obs["attempted"]), "failed": int(obs["failed"]),
            "metrics": metrics, "device": device_info}
    if traced is not None:
        device_info.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        line["breakdown"] = {"device_ops": traced["device_ops"], "idle_gaps": traced["idle_gaps"]}
    line["checks"] = numbers
    prep.tmp.cleanup()
    return {"line": line, "numbers": numbers, "control": ctrl, "verdict": v, "timings": prep.timings}
