"""Encoder checkpoints: port of the JAX package's ``models/checkpoint.py``.

A checkpoint is a ``step_<N>/`` directory holding ``params.npz``,
``meta.json`` and, when an optimizer is saved with it, ``opt_state.npz``.
The parameter leaves are saved as ``p0 … pN-1`` in ``jax.tree.flatten``
order of ``minilm.init_params``, which is the nested dict keys sorted:
``embeddings`` then ``layers``, each by name (:func:`~.minilm.leaf_keys`).
The optimizer state's leaves are ``o0 … o2N+1`` in the flatten order of
the JAX package's optax state: Adam's count, ``mu`` and ``nu`` of each
parameter leaf in that order, the schedule's count
(:meth:`.train.Optimizer.state_leaves`). So either package restores what
the other saved. Restoring checks every leaf's count and shape.
"""

from __future__ import annotations

import json
import logging
import re
import shutil
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch

from ..core.errors import IndexCorrupted
from . import minilm

_log = logging.getLogger("tss_torch.checkpoint")

_STEP_RE = re.compile(r"step_(\d+)$")


def save_checkpoint(
    directory: str | Path,
    step: int,
    state: Mapping[str, torch.Tensor],
    optimizer=None,  # models.train.Optimizer
    metadata: Optional[dict] = None,
    keep: int = 3,
) -> Path:
    """Save a :class:`~.minilm.MiniLM` state dict (keys
    ``"<group>.<name>"``) as step ``step``, with ``optimizer``'s state when
    given; keeps the newest ``keep`` steps."""
    directory = Path(directory)
    path = directory / f"step_{step}"
    path.mkdir(parents=True, exist_ok=True)
    groups: dict[str, list[str]] = {}
    for key in state:
        g, n = key.split(".", 1)
        groups.setdefault(g, []).append(n)
    leaves = [
        state[f"{g}.{n}"].detach().to("cpu", torch.float32).numpy()
        for g in sorted(groups) for n in sorted(groups[g])
    ]
    np.savez(path / "params.npz", **{f"p{i}": x for i, x in enumerate(leaves)})
    if optimizer is not None:
        oleaves = optimizer.state_leaves()
        np.savez(path / "opt_state.npz", **{f"o{i}": x for i, x in enumerate(oleaves)})
    (path / "meta.json").write_text(json.dumps({"step": step, **(metadata or {})}))
    steps = sorted(
        (int(m.group(1)), p)
        for p in directory.iterdir()
        if p.is_dir() and (m := _STEP_RE.search(p.name))
    )
    for _, old in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(old, ignore_errors=True)
    _log.info("saved checkpoint %s", path)
    return path


def latest_step(directory: str | Path) -> Optional[int]:
    """Highest ``step_<N>`` under ``directory``, or None."""
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [
        int(m.group(1))
        for p in directory.iterdir()
        if p.is_dir() and (m := _STEP_RE.search(p.name))
    ]
    return max(steps) if steps else None


def restore_checkpoint(
    directory: str | Path, config: minilm.MiniLMConfig, step: Optional[int] = None,
    optimizer=None,  # models.train.Optimizer, loaded in place
) -> Optional[tuple[dict[str, torch.Tensor], dict]]:
    """``(state dict for MiniLM, metadata)`` from ``step`` (default the
    latest), or None when there is no checkpoint. When ``optimizer`` is
    given and the step holds ``opt_state.npz``, its state is loaded into
    ``optimizer``; without the file ``optimizer`` is left as it is. Raises
    :class:`IndexCorrupted` when a leaf's count or shape does not match
    ``config``."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None
    path = directory / f"step_{step}"
    if not (path / "params.npz").exists():
        return None
    shapes = minilm.param_shapes(config)
    order = [tuple(k.split(".", 1)) for k in minilm.leaf_keys(config)]
    with np.load(path / "params.npz") as z:
        if len(z.files) != len(order):
            raise IndexCorrupted(
                index_type="encoder",
                details=f"{path / 'params.npz'} holds {len(z.files)} leaves, expected {len(order)}",
            )
        tree: dict[str, dict[str, np.ndarray]] = {g: {} for g in shapes}
        for i, (g, n) in enumerate(order):
            leaf = z[f"p{i}"]
            if tuple(leaf.shape) != tuple(shapes[g][n]):
                raise IndexCorrupted(
                    index_type="encoder",
                    details=f"{g}.{n} has shape {leaf.shape}, expected {shapes[g][n]}",
                )
            tree[g][n] = leaf
    if optimizer is not None and (path / "opt_state.npz").exists():
        with np.load(path / "opt_state.npz") as z:
            oleaves = [z[f"o{i}"] for i in range(len(z.files))]
        try:
            optimizer.load_state_leaves(oleaves)
        except ValueError as e:
            raise IndexCorrupted(index_type="encoder", details=f"{path / 'opt_state.npz'}: {e}") from e
    meta_path = path / "meta.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return minilm.params_from_jax(tree), meta
