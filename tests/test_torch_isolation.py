"""The port stands alone: no file of it, and not ``chip_smoke.py``, imports
JAX or the JAX package; it imports with JAX made unimportable; and its
entry points refuse a missing card unless the caller asks for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "trie_semantic_search_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "trie_semantic_search_tpu")


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
