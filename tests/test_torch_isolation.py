"""The port stands alone: no file of it, and not ``chip_smoke.py``, imports
JAX or the JAX package; it imports with JAX made unimportable; and its
entry points refuse a missing card unless the caller asks for the CPU."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "trie_semantic_search_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "optax", "trie_semantic_search_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 20 and (REPO / "chip_smoke.py").exists()
    bad = [
        (str(f.relative_to(REPO)), mod)
        for f in files
        for mod in _imported_modules(f)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def test_port_imports_with_jax_unimportable():
    modules = sorted(
        "trie_semantic_search_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py")
        if p.name != "__init__.py"
    )
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'ml_dtypes', 'trie_semantic_search_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_default_device_without_cuda_raises(monkeypatch):
    from trie_semantic_search_tpu_torch.device import resolve_device
    from trie_semantic_search_tpu_torch.index.ann import PartitionedANN
    from trie_semantic_search_tpu_torch.index.trie import TrieIndex
    from trie_semantic_search_tpu_torch.models.minilm import MiniLM, MiniLMConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (
        resolve_device,
        lambda: resolve_device("cuda:0"),
        TrieIndex,
        PartitionedANN,
        lambda: MiniLM(MiniLMConfig(vocab_size=8, hidden_size=8, num_layers=1,
                                    num_heads=2, intermediate_size=8, max_position=8)),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Run alone (no repository beside it) and without a card, the chip
    smoke exits non-zero and prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run(
        [sys.executable, str(lone)], cwd=tmp_path, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_cli_and_server_run_with_jax_unimportable():
    """``python -m trie_semantic_search_tpu_torch.cli --help`` and the
    server's import succeed where ``jax`` cannot be imported."""
    block = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'ml_dtypes', 'trie_semantic_search_tpu'):\n"
        "    sys.modules[name] = None\n"
    )
    cli = subprocess.run(
        [sys.executable, "-c", block + "import runpy, sys\n"
         "sys.argv = ['cli', '--help']\n"
         "runpy.run_module('trie_semantic_search_tpu_torch.cli', run_name='__main__')\n"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert cli.returncode == 0, cli.stderr
    assert "legal-search-server-torch" in cli.stdout and "config-dump" in cli.stdout
    server = subprocess.run(
        [sys.executable, "-c", block + "import trie_semantic_search_tpu_torch.api.server as s\n"
         "print(s.ApiServer.__name__)\n"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert server.returncode == 0, server.stderr
    assert server.stdout.strip() == "ApiServer"


def test_ingest_and_tuner_stand_alone():
    """The ingest package, its sources and the case-level tuner are among
    the files checked above, and import where ``jax`` cannot be imported."""
    files = {str(f.relative_to(REPO)) for f in _port_files()}
    for name in ("ingest/__init__.py", "ingest/validation.py", "ingest/cache.py", "ingest/pipeline.py",
                 "ingest/manager.py", "ingest/sources/base.py", "ingest/sources/mock.py",
                 "ingest/sources/cap.py", "ingest/sources/courtlistener.py", "index/tuning.py"):
        assert f"trie_semantic_search_tpu_torch/{name}" in files, name
    block = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'ml_dtypes', 'trie_semantic_search_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from trie_semantic_search_tpu_torch.ingest import IngestionManager\n"
        "from trie_semantic_search_tpu_torch.ingest.sources import CapDataSource, MockDataSource\n"
        "from trie_semantic_search_tpu_torch.index.tuning import tune_nprobe_case_recall\n"
        "print(IngestionManager.__name__, CapDataSource.__name__, tune_nprobe_case_recall.__name__)\n"
    )
    out = subprocess.run([sys.executable, "-c", block], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["IngestionManager", "CapDataSource", "tune_nprobe_case_recall"]


def test_streaming_build_stands_alone():
    """The streaming build, its spill, the pooling selection and the
    retrieval evaluation are among the files checked above, and import
    where ``jax`` cannot be imported."""
    files = {str(f.relative_to(REPO)) for f in _port_files()}
    for name in ("index/spill.py", "index/streaming.py", "models/train.py", "models/quality.py"):
        assert f"trie_semantic_search_tpu_torch/{name}" in files, name
    block = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'ml_dtypes', 'trie_semantic_search_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from trie_semantic_search_tpu_torch.index.spill import SpillContentBuilder\n"
        "from trie_semantic_search_tpu_torch.index.streaming import StreamingIndexBuilder\n"
        "from trie_semantic_search_tpu_torch.models.train import select_pooling_guarded\n"
        "from trie_semantic_search_tpu_torch.models.quality import evaluate_stages\n"
        "print(SpillContentBuilder.__name__, StreamingIndexBuilder.__name__,\n"
        "      select_pooling_guarded.__name__, evaluate_stages.__name__)\n"
    )
    out = subprocess.run([sys.executable, "-c", block], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["SpillContentBuilder", "StreamingIndexBuilder",
                                  "select_pooling_guarded", "evaluate_stages"]


def test_training_stands_alone():
    """Encoder training and the checkpoints with optimizer state are among
    the files checked above, and import and take a step where ``jax`` and
    ``optax`` cannot be imported."""
    files = {str(f.relative_to(REPO)) for f in _port_files()}
    for name in ("models/train.py", "models/checkpoint.py", "models/minilm.py"):
        assert f"trie_semantic_search_tpu_torch/{name}" in files, name
    block = (
        "import sys, tempfile\n"
        "for name in ('jax', 'jaxlib', 'ml_dtypes', 'optax', 'trie_semantic_search_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "from trie_semantic_search_tpu_torch.models import minilm, train\n"
        "from trie_semantic_search_tpu_torch.models.checkpoint import restore_checkpoint, save_checkpoint\n"
        "cfg = minilm.MiniLMConfig(vocab_size=64, hidden_size=8, num_layers=1, num_heads=2,\n"
        "                          intermediate_size=8, max_position=8)\n"
        "model = minilm.MiniLM(cfg, device='cpu', compute_dtype=torch.float32)\n"
        "opt = train.make_optimizer(train.TrainConfig(warmup_steps=0, total_steps=2), model)\n"
        "ids = torch.randint(1, 64, (4, 8), generator=torch.Generator().manual_seed(0))\n"
        "batch = dict(ids_a=ids, mask_a=torch.ones_like(ids), ids_b=ids.flip(1), mask_b=torch.ones_like(ids))\n"
        "with model.trainable():\n"
        "    loss, acc = train.train_step(model, opt, batch, 0.05)\n"
        "d = tempfile.mkdtemp()\n"
        "save_checkpoint(d, 1, model.state_dict(), optimizer=opt)\n"
        "opt2 = train.make_optimizer(train.TrainConfig(warmup_steps=0, total_steps=2), model)\n"
        "restore_checkpoint(d, cfg, optimizer=opt2)\n"
        "print(opt.count, opt2.count, bool(torch.isfinite(loss)))\n"
    )
    out = subprocess.run([sys.executable, "-c", block], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["1", "1", "True"]


def test_sharded_serving_stands_alone():
    """The mesh, the sharded steps and the sharded index are among the
    files checked above, and serve a sharded search over four CPU shards
    where ``jax`` cannot be imported."""
    files = {str(f.relative_to(REPO)) for f in _port_files()}
    for name in ("parallel/__init__.py", "parallel/mesh.py", "parallel/collectives.py",
                 "index/sharded.py"):
        assert f"trie_semantic_search_tpu_torch/{name}" in files, name
    block = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'ml_dtypes', 'trie_semantic_search_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from trie_semantic_search_tpu_torch.core.config import MeshConfig\n"
        "from trie_semantic_search_tpu_torch.parallel import make_mesh\n"
        "from trie_semantic_search_tpu_torch.index.sharded import ShardedCorpusIndex\n"
        "v = np.random.default_rng(0).standard_normal((50, 16)).astype(np.float32)\n"
        "idx = ShardedCorpusIndex(make_mesh(MeshConfig(), devices=['cpu'] * 4))\n"
        "idx.build(v)\n"
        "print(idx.num_shards, int(idx.search_brute(v[:3], 2)[1][2, 0]))\n"
    )
    out = subprocess.run([sys.executable, "-c", block], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["4", "2"]


def test_distributed_mesh_and_sharded_training_stand_alone():
    """A job through ``make_distributed_mesh`` (one process, a coordinator
    on a free local port) and a dp × tp train step on its mesh, where
    ``jax`` cannot be imported; the process group is left at the end."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    block = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'ml_dtypes', 'optax', 'trie_semantic_search_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        "import torch.distributed as dist\n"
        "from trie_semantic_search_tpu_torch.core.config import MeshConfig\n"
        "from trie_semantic_search_tpu_torch.models import minilm, train\n"
        "from trie_semantic_search_tpu_torch.parallel import make_distributed_mesh\n"
        "from trie_semantic_search_tpu_torch.parallel.mesh import shutdown_distributed\n"
        f"mesh = make_distributed_mesh(MeshConfig(model_parallel=2), '127.0.0.1:{port}', 1, 0,\n"
        "                              devices=['cpu'] * 4)\n"
        "cfg = minilm.MiniLMConfig(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,\n"
        "                          intermediate_size=32, max_position=8)\n"
        "step = train.make_sharded_train_step(mesh, cfg, train.TrainConfig())\n"
        "state = step.init(minilm.MiniLM(cfg, device='cpu'))\n"
        "ids = np.arange(32, dtype=np.int32).reshape(4, 8) % 64\n"
        "b = {'ids_a': ids, 'mask_a': np.ones_like(ids), 'ids_b': ids[::-1].copy(), 'mask_b': np.ones_like(ids)}\n"
        "loss, _ = step(state, b)\n"
        "print(mesh.shape['data'], mesh.shape['model'], mesh.backend, bool(np.isfinite(float(loss))))\n"
        "shutdown_distributed()\n"
        "print(dist.is_initialized())\n"
    )
    out = subprocess.run([sys.executable, "-c", block], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["2", "2", "gloo", "True", "False"]


def test_native_library_is_the_ports_own(tmp_path):
    """The port's ``native.py`` builds from ``csrc/host/`` into its own
    build directory and loads that library: no file it opens, no command
    it runs and no library it loads lies under the repository's
    ``native/`` (the JAX package's library), and the build directory holds
    its own ``libtss_native.so``."""
    block = (
        "import os, sys\n"
        "seen = []\n"
        "def hook(event, args):\n"
        "    if event in ('open', 'ctypes.dlopen', 'subprocess.Popen', 'os.listdir', 'os.scandir'):\n"
        "        seen.append((event, repr(args)))\n"
        "sys.addaudithook(hook)\n"
        "for name in ('jax', 'jaxlib', 'ml_dtypes', 'trie_semantic_search_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from trie_semantic_search_tpu_torch import native\n"
        "assert native.available()\n"
        "b = native.NativeTrieBuilder()\n"
        "b.insert([1, 2, 3], 0, 0)\n"
        "assert b.freeze_arrays()['post_case'].tolist() == [0]\n"
        "assert native.tokenize_spans('a bc').tolist() == [[0, 1], [2, 4]]\n"
        "import json\n"
        "print(json.dumps({'lib': str(native.LIBRARY_PATH), 'seen': seen}))\n"
    )
    env = {**os.environ, "TSS_TORCH_BUILD_DIR": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", block], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    lib = Path(rec["lib"])
    assert lib.parent.parent == tmp_path / "host" and lib.name == "libtss_native.so" and lib.exists()
    jax_native = str(REPO / "native")
    assert not [s for s in rec["seen"] if jax_native + "/" in s[1] or s[1].endswith(jax_native + "'")], rec
    assert any(e == "ctypes.dlopen" and str(lib) in a for e, a in rec["seen"])
    assert any(e == "subprocess.Popen" and str(PORT / "csrc" / "host" / "trie_builder.cpp") in a
               for e, a in rec["seen"])
