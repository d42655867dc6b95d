"""The port's command line against the JAX package's, on the CPU.

The one-shot commands read the store and artifacts the JAX package saved
(``torch_engine_fixtures.art``), with ``mesh.enabled = false`` so the JAX
side serves on one device as the port does; the port gets the JAX
encoder's query vectors in its embedding cache, as in the engine tests.
The JAX commands run through their parser's handlers, not ``main`` (which
also sets JAX's compile cache).
"""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import tomllib
import urllib.request
from pathlib import Path

import pytest
import torch
from aiohttp.test_utils import TestServer
from torch_engine_fixtures import art, engines  # noqa: F401  (fixtures)

from trie_semantic_search_tpu import cli as jcli
from trie_semantic_search_tpu.core.config import Config as JaxConfig
from trie_semantic_search_tpu_torch import cli as pcli
from trie_semantic_search_tpu_torch.api.server import ApiServer
from trie_semantic_search_tpu_torch.core.config import Config
from trie_semantic_search_tpu_torch.core.types import AppState

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def _jax(argv, capsys) -> tuple[int, str]:
    args = jcli.build_parser().parse_args(argv)
    rc = args.fn(args)
    return rc, capsys.readouterr().out


def _port(argv, capsys) -> tuple[int, str]:
    rc = pcli.main(argv)
    return rc, capsys.readouterr().out


def _close(got, want):
    """JSON equality with floats within 1e-5."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _close(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    elif isinstance(want, float):
        assert abs(got - want) <= 1e-5
    else:
        assert got == want


def _options(parser):
    """{option strings: (dest, default, nargs, type, choices)} of a parser."""
    return {
        tuple(a.option_strings) or (a.dest,): (a.dest, a.default, a.nargs, a.type, a.choices)
        for a in parser._actions
        if a.dest not in ("help", "command")
    }


def _subparsers(parser):
    return next(a for a in parser._actions if a.dest == "command").choices


def test_parser_matches_jax():
    """The same subcommands with the same options and defaults; at the top,
    ``--device`` (default cuda) in place of ``--platform``."""
    jp, pp = jcli.build_parser(), pcli.build_parser()
    jtop, ptop = _options(jp), _options(pp)
    assert jtop.pop(("--platform",))[1] is None
    assert ptop.pop(("--device",))[:2] == ("device", "cuda")
    assert ptop == jtop
    jsub, psub = _subparsers(jp), _subparsers(pp)
    assert list(psub) == list(jsub)
    for name in jsub:
        assert _options(psub[name]) == _options(jsub[name]), name
        assert psub[name].description == jsub[name].description
    args = pp.parse_args(["serve", "-p", "9000"])
    assert args.port == 9000 and args.fn is pcli.cmd_serve and args.device == "cuda"
    assert pcli.main([]) == 2


@pytest.mark.parametrize("source", ["missing", "defaults", "edited", "env"])
def test_config_dump_matches_jax(tmp_path, capsys, monkeypatch, source):
    """``config-dump`` prints the JAX CLI's bytes for the same file."""
    path = tmp_path / "c.toml"
    if source != "missing":
        cfg = JaxConfig()
        if source == "edited":
            cfg.server.port = 9123
            cfg.server.api_key = 'se"cret'
            cfg.ingestion.validation.required_fields = ["title"]
            cfg.logging.json_format = True
            cfg.performance.gc.interval_seconds = 7
            cfg.mesh.enabled = False
            cfg.vector.hnsw.partition_overalloc = 1.5
        cfg.save_to_file(path)
    if source == "env":
        monkeypatch.setenv("LEGAL_SEARCH_PORT", "7777")
        monkeypatch.setenv("LEGAL_SEARCH_DB_PATH", "/data/x.db")
    want = _jax(["-c", str(path), "config-dump"], capsys)
    got = _port(["-c", str(path), "config-dump"], capsys)
    assert got == want and want[0] == 0
    assert Config.from_dict(tomllib.loads(got[1])).to_toml() + "\n" == got[1]
    if source == "edited":
        assert "port = 9123" in got[1] and "[mesh]\nenabled = false" in got[1]


@pytest.fixture()
def one_device_toml(art, tmp_path):
    cfg = JaxConfig.from_file(art["toml"])
    cfg.mesh.enabled = False
    cfg.save_to_file(tmp_path / "config.toml")
    return tmp_path / "config.toml"


def test_one_shot_commands_match_jax(art, one_device_toml, capsys, monkeypatch):
    """``search``, ``completions`` and ``check-health`` print what the JAX
    CLI prints (search scores within 1e-5)."""
    jeng, _ = engines(art)
    build = pcli._build_components

    def shared(cfg, device, rebuild=False):
        storage, engine = build(cfg, device, rebuild)
        for q in ("miranda v. arizona", "right to remain silent", "contract breach damages"):
            engine.vector_index.cache.put(q, jeng.vector_index.generate_embeddings([q])[0])
        return storage, engine

    monkeypatch.setattr(pcli, "_build_components", shared)
    c = ["-c", str(one_device_toml)]
    for argv in (["search", "miranda v. arizona", "--limit", "3"],
                 ["search", "right to remain silent"],
                 ["search", "contract breach damages", "--limit", "2"]):
        rc, want = _jax(c + argv, capsys)
        prc, got = _port(c + ["--device", "cpu"] + argv, capsys)
        assert prc == rc == 0
        _close(json.loads(got), json.loads(want))
        assert json.loads(got)
    rc, got = _port(c + ["--device", "cpu", "search", "miranda v. arizona"], capsys)
    assert json.loads(got)[0]["case_metadata"]["name"] == "Miranda v. Arizona"
    for argv in (["completions", "brown"], ["completions", "miranda", "--limit", "1"],
                 ["completions", "zzz"], ["check-health"]):
        want = _jax(c + argv, capsys)
        assert _port(c + ["--device", "cpu"] + argv, capsys) == want and want[0] == 0
    assert json.loads(want[1]) == {"status": "healthy", "storage": "healthy",
                                   "search_engine": "healthy"}


@pytest.mark.parametrize("argv,slice_name", [
    (["bench"], "not ported"),
])
def test_later_slices_raise(tmp_path, argv, slice_name):
    """``bench`` refuses, naming what brings it; nothing is written."""
    cfg = Config()
    cfg.storage.db_path = str(tmp_path / "db.sqlite")
    cfg.trie.index_path = str(tmp_path / "trie")
    cfg.vector.hnsw.index_path = str(tmp_path / "vec")
    cfg.save_to_file(tmp_path / "config.toml")
    with pytest.raises(NotImplementedError, match=slice_name):
        pcli.main(["-c", str(tmp_path / "config.toml"), "--device", "cpu", *argv])
    assert not (tmp_path / "vec").exists() and not (tmp_path / "trie").exists()


def _fresh_tomls(tmp_path):
    """A config per package over an empty store of its own (mean pooling,
    the default full-width encoder)."""
    paths = {}
    for tag in ("jax", "port"):
        root = tmp_path / tag
        root.mkdir()
        cfg = JaxConfig()
        cfg.storage.db_path = str(root / "db.sqlite")
        cfg.trie.index_path = str(root / "trie")
        cfg.vector.hnsw.index_path = str(root / "vec")
        cfg.vector.pooling = "mean"
        cfg.mesh.enabled = False
        cfg.save_to_file(root / "config.toml")
        paths[tag] = root / "config.toml"
    return paths


@pytest.mark.parametrize("argv", [["ingest", "--source", "mock"],
                                  ["ingest", "--source", "mock", "--incremental"],
                                  ["ingest", "--source", "mock", "--limit", "2"],
                                  ["ingest", "--source", "nope"]])
def test_ingest_command_matches_jax(tmp_path, capsys, argv):
    """``ingest`` twice into an empty store prints the JAX CLI's JSON (the
    job id aside), and both stores hold the same cases (an unknown source
    fails the job in both)."""
    from trie_semantic_search_tpu.storage.store import StorageManager as JaxStorage
    from trie_semantic_search_tpu_torch.storage.store import StorageManager

    paths = _fresh_tomls(tmp_path)
    outs = []
    for _ in range(2):
        rc, want = _jax(["-c", str(paths["jax"])] + argv, capsys)
        prc, got = _port(["-c", str(paths["port"]), "--device", "cpu"] + argv, capsys)
        want, got = json.loads(want.splitlines()[-1]), json.loads(got.splitlines()[-1])
        assert prc == rc and got.pop("job") > 0 and want.pop("job") > 0
        assert got == want
        outs.append(want)
    names = []
    for store_cls, cfg_cls, tag in ((JaxStorage, JaxConfig, "jax"), (StorageManager, Config, "port")):
        store = store_cls(cfg_cls.from_file(paths[tag]).storage)
        names.append(sorted(m.name for m, _ in store.iter_cases()))
        store.close()
    assert names[0] == names[1]
    if argv == ["ingest", "--source", "mock"]:
        assert rc == 0 and outs[0]["processed"] == 3 and outs[1] == dict(
            outs[0], processed=0, skipped=3) and len(names[0]) == 3


def test_build_index_tune_recall_command_matches_jax(tmp_path, capsys):
    """``ingest --source mock`` then ``build-index --tune-recall 0.95``
    into empty stores: the same JSON (seconds and paths aside) and the
    same saved nprobe; with 3 cases the tuner is skipped in both."""
    from trie_semantic_search_tpu_torch.index.ann import PartitionedANN

    paths = _fresh_tomls(tmp_path)
    _jax(["-c", str(paths["jax"]), "ingest", "--source", "mock"], capsys)
    _port(["-c", str(paths["port"]), "--device", "cpu", "ingest", "--source", "mock"], capsys)
    argv = ["build-index", "--tune-recall", "0.95"]
    rc, want = _jax(["-c", str(paths["jax"])] + argv, capsys)
    prc, got = _port(["-c", str(paths["port"]), "--device", "cpu"] + argv, capsys)
    want, got = json.loads(want.splitlines()[-1]), json.loads(got.splitlines()[-1])
    for d in (want, got):
        assert d.pop("seconds") > 0
        d.pop("trie_path"), d.pop("vector_path")
    assert prc == rc == 0 and got == want and want["cases"] == 3
    saved = [PartitionedANN.load(p.parent / "vec" / "ann.npz", device="cpu").tuned_nprobe
             for p in (paths["jax"], paths["port"])]
    assert saved[0] == saved[1]
    rc, got = _port(["-c", str(paths["port"]), "--device", "cpu", "search", "miranda v. arizona"], capsys)
    hit = json.loads(got)[0]
    assert rc == 0 and hit["case_metadata"]["name"] == "Miranda v. Arizona"


def test_build_index_pretrain_steps_command_matches_jax(tmp_path, capsys, monkeypatch):
    """``ingest --source mock`` then ``build-index --pretrain-steps 4`` into
    empty stores (the full-width encoder, sequences cut to 32 tokens): exit
    0 in both, the same report keys and counts, and each build's
    pretraining report (read from ``pretrain_encoder_guarded``) has the same
    keys, four steps and a guardrail record."""
    import trie_semantic_search_tpu.models.train as jtrain
    import trie_semantic_search_tpu_torch.models.train as ttrain

    reps = {}
    for tag, mod in (("jax", jtrain), ("port", ttrain)):
        def wrapped(*a, _fn=mod.pretrain_encoder_guarded, _tag=tag, **k):
            reps[_tag] = _fn(*a, **k)
            return reps[_tag]
        monkeypatch.setattr(mod, "pretrain_encoder_guarded", wrapped)
    paths = _fresh_tomls(tmp_path)
    for tag in ("jax", "port"):
        cfg = JaxConfig.from_file(paths[tag])
        cfg.vector.model.max_sequence_length = 32
        cfg.save_to_file(paths[tag])
    _jax(["-c", str(paths["jax"]), "ingest", "--source", "mock"], capsys)
    _port(["-c", str(paths["port"]), "--device", "cpu", "ingest", "--source", "mock"], capsys)
    argv = ["build-index", "--pretrain-steps", "4"]
    rc, want = _jax(["-c", str(paths["jax"])] + argv, capsys)
    prc, got = _port(["-c", str(paths["port"]), "--device", "cpu"] + argv, capsys)
    want, got = json.loads(want.splitlines()[-1]), json.loads(got.splitlines()[-1])
    assert prc == rc == 0 and sorted(got) == sorted(want) and got["cases"] == want["cases"] == 3
    assert (got["content_chunks"], got["citations"]) == (want["content_chunks"], want["citations"])
    jrep, prep = reps["jax"], reps["port"]
    assert sorted(prep) == sorted(jrep) and prep["steps"] == jrep["steps"] == 4
    assert prep["pairs"] == jrep["pairs"] and sorted(prep["guardrail"]) == sorted(jrep["guardrail"])


def test_build_index_command_matches_jax(art, tmp_path, capsys):
    """``build-index`` over a copy of the store (mean pooling, full-width
    encoder from the config): the JAX CLI's counts, and the quality gate's
    report beside the vectors; with ``pooling = "auto"`` (the default) both
    builds select the pooling and print the same counts, and ``serve``'s
    build on a store without artifacts runs too (the pick itself is held
    against the JAX package's with a shared encoder in
    ``test_torch_build.py``)."""
    import shutil

    paths = {}
    for tag in ("jax", "port"):
        root = tmp_path / tag
        root.mkdir()
        shutil.copy(art["root"] / "db.sqlite", root / "db.sqlite")
        cfg = JaxConfig.from_file(art["toml"])
        cfg.storage.db_path = str(root / "db.sqlite")
        cfg.trie.index_path = str(root / "trie")
        cfg.vector.hnsw.index_path = str(root / "vec")
        cfg.vector.dimension = 384
        cfg.vector.pooling = "mean"
        cfg.vector.quality_gate = "warn"
        cfg.mesh.enabled = False
        cfg.save_to_file(root / "config.toml")
        paths[tag] = root
    rc, want = _jax(["-c", str(paths["jax"] / "config.toml"), "build-index"], capsys)
    prc, got = _port(["-c", str(paths["port"] / "config.toml"), "--device", "cpu", "build-index"],
                     capsys)
    assert prc == rc == 0
    want, got = json.loads(want), json.loads(got)
    for k in ("cases", "content_chunks", "citations"):
        assert got[k] == want[k], k
    assert got["cases"] == 7 and got["vector_path"].endswith("port/vec")
    meta = json.loads((paths["port"] / "vec" / "quality.json").read_text())
    assert meta["mode"] == "warn" and meta["probes"] > 0
    for tag in ("jax", "port"):
        toml = paths[tag] / "config.toml"
        toml.write_text(toml.read_text().replace('pooling = "mean"', 'pooling = "auto"'))
        argv = ["-c", str(toml), "build-index"]
        rc, out = _jax(argv, capsys) if tag == "jax" else _port(argv[:2] + ["--device", "cpu"] + argv[2:],
                                                                capsys)
        got = json.loads(out.splitlines()[-1])
        assert rc == 0 and {k: got[k] for k in ("cases", "content_chunks", "citations")} == {
            k: want[k] for k in ("cases", "content_chunks", "citations")}
    cfg = Config.from_file(paths["port"] / "config.toml")
    cfg.trie.index_path = str(tmp_path / "no_artifacts")
    _, engine = pcli._build_components(cfg, "cpu")
    assert engine.vector_index.size == want["content_chunks"]


def _streaming_roots(art, tmp_path):
    """A copy of the store and of the saved encoder (tokenizer, checkpoint)
    per package, with a TOML config: ``build-index --streaming`` loads the
    encoder, so nothing is pretrained."""
    import shutil

    roots = {}
    for tag in ("jax", "port"):
        root = tmp_path / tag
        (root / "vec").mkdir(parents=True)
        shutil.copy(art["root"] / "db.sqlite", root / "db.sqlite")
        shutil.copy(art["root"] / "vec" / "tokenizer.json", root / "vec" / "tokenizer.json")
        shutil.copytree(art["root"] / "vec" / "encoder", root / "vec" / "encoder")
        cfg = JaxConfig.from_file(art["toml"])
        cfg.storage.db_path = str(root / "db.sqlite")
        cfg.trie.index_path = str(root / "trie")
        cfg.vector.hnsw.index_path = str(root / "vec")
        cfg.vector.quality_gate = "off"
        cfg.mesh.enabled = False
        cfg.save_to_file(root / "config.toml")
        roots[tag] = root
    return roots


@pytest.mark.parametrize("extra", [[], ["--no-resume"]])
def test_build_index_streaming_command_matches_jax(art, tmp_path, capsys, extra):
    """``build-index --streaming --shard-chunks 8`` with a saved encoder,
    twice: the JAX CLI's JSON but for seconds, rate, RSS and paths (the
    second run resumes at the end of the store, or with ``--no-resume``
    builds again from row 0); both vector directories hold the same files,
    and the port's artifacts serve ``search``."""
    roots = _streaming_roots(art, tmp_path)
    for run in range(2):
        outs = {}
        for tag, root in roots.items():
            argv = ["-c", str(root / "config.toml"), "build-index", "--streaming", "--shard-chunks", "8",
                    "--work-dir", str(root / "work"), *(extra if run else [])]
            rc, out = _jax(argv, capsys) if tag == "jax" else _port(
                argv[:2] + ["--device", "cpu"] + argv[2:], capsys)
            assert rc == 0
            outs[tag] = json.loads(out.splitlines()[-1])
            for k in ("seconds", "chunks_per_second", "peak_rss_bytes"):
                assert outs[tag].pop(k) >= 0
            for k in ("trie_path", "vector_path"):
                assert outs[tag].pop(k).startswith(str(root))
        assert outs["port"] == outs["jax"]
        assert outs["port"]["cases"] == 7 and outs["port"]["shards"] >= 2
        assert outs["port"]["resumed_from_row"] == (7 if run and not extra else 0)
    files = {tag: sorted(str(p.relative_to(root / "vec")) for p in (root / "vec").rglob("*"))
             for tag, root in roots.items()}
    assert files["port"] == files["jax"]
    rc, out = _port(["-c", str(roots["port"] / "config.toml"), "--device", "cpu", "search",
                     "miranda v. arizona"], capsys)
    assert rc == 0 and json.loads(out)[0]["case_metadata"]["name"] == "Miranda v. Arizona"


@pytest.mark.parametrize("argv", [["eval-retrieval", "--control"],
                                  ["eval-retrieval", "--probes", "5", "--max-cases", "4"]])
def test_eval_retrieval_command_matches_jax(art, one_device_toml, capsys, monkeypatch, argv):
    """``eval-retrieval`` over the JAX package's artifacts, the port's
    encoder handing over the JAX encoder's vectors: the JAX CLI's JSON,
    but for the random control's MRRs (its weights are the port's own
    seeded init, not the JAX package's ``PRNGKey(1234)``)."""
    from trie_semantic_search_tpu_torch.models.embedder import EmbeddingResult

    jeng, _ = engines(art)
    build = pcli._build_components

    def shared(cfg, device, rebuild=False):
        storage, engine = build(cfg, device, rebuild)
        engine.vector_index.embedder.embed = lambda texts: EmbeddingResult(
            jeng.vector_index.embedder.embed(list(texts)).embedding, 0.0)
        return storage, engine

    monkeypatch.setattr(pcli, "_build_components", shared)
    c = ["-c", str(one_device_toml)]
    rc, want = _jax(c + argv, capsys)
    prc, got = _port(c + ["--device", "cpu"] + argv, capsys)
    assert prc == rc == 0
    want, got = json.loads(want), json.loads(got)
    if "--control" in argv:
        w, g = want.pop("random_control"), got.pop("random_control")
        assert g.keys() == w.keys() and all(g[k]["n"] == w[k]["n"] for k in w)
    assert got == want and want["probes"] > 0 and "ann_only" in want["stages"]


@pytest.mark.parametrize("enabled,dp,mp", [
    (True, 0, 1), (True, 4, 2), (True, 2, 1), (True, 1, 1), (True, 0, 8), (True, 0, 4),
    (False, 0, 1),
])
def test_serving_mesh_matches_jax(monkeypatch, enabled, dp, mp):
    """``_serving_mesh`` decides as the JAX package's does over the same
    number of devices (its 8-device CPU mesh, 8 visible cards here): None
    when the mesh is disabled or its data axis is 1, else the same shape;
    None on the CPU, and with one card unless ``data_parallel`` asks for
    more."""
    jcfg, cfg = JaxConfig(), Config()
    for c in (jcfg, cfg):
        c.mesh.enabled, c.mesh.data_parallel, c.mesh.model_parallel = enabled, dp, mp
    cuda = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    want, got = jcli._serving_mesh(jcfg), pcli._serving_mesh(cfg, cuda)
    assert (got is None) == (want is None)
    if want is not None:
        assert got.shape == dict(want.shape)
        assert got.data_devices == [torch.device("cuda", r * max(1, mp)) for r in range(got.shape["data"])]
    assert pcli._serving_mesh(cfg, torch.device("cpu")) is None
    if not dp:  # all of one card: a data axis of 1
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        assert pcli._serving_mesh(cfg, cuda) is None


def test_serving_mesh_errors_match_jax(monkeypatch):
    """A model axis that does not divide the devices raises in both."""
    jcfg, cfg = JaxConfig(), Config()
    jcfg.mesh.model_parallel = cfg.mesh.model_parallel = 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    with pytest.raises(ValueError) as want:
        jcli._serving_mesh(jcfg)
    with pytest.raises(ValueError) as got:
        pcli._serving_mesh(cfg, torch.device("cuda"))
    assert str(got.value) == str(want.value)


def test_loadtest_against_a_test_server(art, capsys):
    """``loadtest`` drives a live port server and reports its numbers."""
    _, peng = engines(art)
    server = ApiServer(AppState(config=peng.config, search_engine=peng, storage=peng.storage))
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    ts = TestServer(server.app)
    asyncio.run_coroutine_threadsafe(ts.start_server(), loop).result(30)
    try:
        rc, out = _port(["loadtest", "--url", f"http://127.0.0.1:{ts.port}", "--requests", "12",
                         "--concurrency", "4", "--query-template", "right to remain silent {i}",
                         "--wait-warm", "1"], capsys)
        got = json.loads(out.strip().splitlines()[-1])
        assert rc == 0 and got["requests"] == 12 and got["errors"] == 0
        assert got["by_status"] == {"200": 12} and got["qps"] > 0 and got["p50_ms"] > 0
        assert server.batcher.stats["items"] == 16  # the warm pass and the run
    finally:
        asyncio.run_coroutine_threadsafe(ts.close(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=5)
        loop.close()
    assert not thread.is_alive()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_lifecycle(art, tmp_path):
    """``python -m trie_semantic_search_tpu_torch.cli serve --device cpu``:
    warms up, answers, and on SIGINT logs "shutting down" and exits 0."""
    cfg = JaxConfig.from_file(art["toml"])
    cfg.server.port = _free_port()
    cfg.storage.backup.backup_dir = str(tmp_path / "backups")
    cfg.save_to_file(tmp_path / "config.toml")
    log = open(tmp_path / "serve.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "trie_semantic_search_tpu_torch.cli", "-c",
         str(tmp_path / "config.toml"), "--device", "cpu", "serve"],
        cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    try:
        deadline = time.monotonic() + 180
        while "warmup complete" not in (tmp_path / "serve.log").read_text():
            assert proc.poll() is None and time.monotonic() < deadline, \
                (tmp_path / "serve.log").read_text()
            time.sleep(0.2)
        base = f"http://127.0.0.1:{cfg.server.port}"
        health = json.loads(urllib.request.urlopen(base + "/health", timeout=30).read())
        assert health["status"] == "healthy"
        req = urllib.request.Request(base + "/search", data=b'{"query": "miranda v. arizona"}',
                                     headers={"Content-Type": "application/json"})
        res = json.loads(urllib.request.urlopen(req, timeout=60).read())
        assert res["results"][0]["case_metadata"]["name"] == "Miranda v. Arizona"
        stats = json.loads(urllib.request.urlopen(base + "/stats", timeout=30).read())
        assert stats["engine"]["is_warm"] and stats["batching"]["items"] == 1
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    text = (tmp_path / "serve.log").read_text()
    assert "shutting down" in text and list((tmp_path / "backups").glob("*.db"))
