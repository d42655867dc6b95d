"""Device mesh construction and placement helpers.

Port of ``trie_semantic_search_tpu/parallel/mesh.py``. The JAX package lays
the corpus out row-sharded over the ``data`` axis of a ``(data, model)``
mesh and lets one ``shard_map`` program run every shard. The port keeps the
single controller: a :class:`Mesh` is a ``[dp, mp]`` grid of
``torch.device``, the corpus is a list of row blocks (block ``s`` on the
device of data row ``s``), and one process issues each shard's stage on its
device (:mod:`.collectives`).

A mesh may name one device more than once: four shards on ``cuda:0`` run
the same per-shard work and merge as four cards would, and the CPU tests
build an eight-shard mesh over ``cpu``. Every shard block is its own
tensor, even where two shards share a device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..core.config import MeshConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _indexed(d: Union[str, torch.device]) -> torch.device:
    """``cuda`` as ``cuda:0``, the device a tensor placed there reports."""
    d = torch.device(d)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d


class Mesh:
    """A ``[dp, mp]`` grid of ``torch.device``; ``shape`` reads as the JAX
    mesh's (``{"data": dp, "model": mp}``)."""

    def __init__(self, grid: Sequence[Sequence[Union[str, torch.device]]]):
        self.devices = [[_indexed(d) for d in row] for row in grid]
        mp = len(self.devices[0]) if self.devices else 0
        if not mp or any(len(row) != mp for row in self.devices):
            raise ValueError("a mesh needs a non-empty rectangular grid of devices")

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: len(self.devices), MODEL_AXIS: len(self.devices[0])}

    @property
    def data_devices(self) -> list[torch.device]:
        """The device of each shard (data row ``s``, model column 0)."""
        return [row[0] for row in self.devices]

    @property
    def first_device(self) -> torch.device:
        """Where shard-local results merge."""
        return self.devices[0][0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.data_devices})"


def visible_devices() -> list[torch.device]:
    """Every visible CUDA device (none on a host without a card)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    config: Optional[MeshConfig] = None,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
) -> Mesh:
    """Build the ``(data, model)`` mesh from config over ``devices``
    (default: every visible CUDA device; repeats allowed).

    ``data_parallel == 0`` → use all remaining devices on the data axis.
    """
    config = config or MeshConfig()
    devices = list(devices if devices is not None else visible_devices())
    mp = max(1, config.model_parallel)
    if len(devices) % mp != 0:
        raise ValueError(
            f"device count {len(devices)} not divisible by model_parallel {mp}"
        )
    dp = config.data_parallel or (len(devices) // mp)
    if dp * mp > len(devices):
        raise ValueError(
            f"mesh {dp}x{mp} needs {dp * mp} devices, have {len(devices)}"
        )
    return Mesh([devices[r * mp : (r + 1) * mp] for r in range(dp)])


def make_distributed_mesh(
    config: Optional[MeshConfig] = None,
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Mesh:
    """The mesh of a job. Without a coordinator (one process) it is
    :func:`make_mesh` over the visible cards; a job spanning hosts is not
    ported yet."""
    if coordinator_address is not None:
        raise NotImplementedError(
            "a mesh across hosts (coordinator_address) comes with ROADMAP.md §1 slice 5b; "
            "serve from one host with make_mesh"
        )
    return make_mesh(config)


def single_device_mesh(device: Union[str, torch.device, None] = None) -> Mesh:
    """1×1 mesh over ``device`` (default the first card)."""
    return Mesh([[device if device is not None else torch.device("cuda", 0)]])


def pad_rows(n: int, multiple: int) -> int:
    """Round row count up to a multiple (shard divisibility + tiling)."""
    return -(-n // multiple) * multiple


def pad_corpus(
    matrix: np.ndarray, mesh: Mesh, row_multiple: int = 8
) -> tuple[np.ndarray, int]:
    """Pad corpus rows with zero rows so every shard is equal-sized and
    tile-aligned. Returns (padded matrix, original row count); callers mask
    rows at or past the original count."""
    n = matrix.shape[0]
    shards = mesh.shape[DATA_AXIS]
    target = pad_rows(max(n, 1), shards * row_multiple)
    if target == n:
        return matrix, n
    pad = np.zeros((target - n, *matrix.shape[1:]), dtype=matrix.dtype)
    return np.concatenate([matrix, pad], axis=0), n


def _placed(block, device: torch.device) -> torch.Tensor:
    """A new tensor on ``device`` holding ``block`` (numpy or torch)."""
    if isinstance(block, torch.Tensor):
        return block.to(device, copy=True)
    from ..index.ann import to_device

    return to_device(np.ascontiguousarray(block), device)


def shard_block(x, mesh: Mesh, s: int, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Row block ``s`` of ``x`` (``[N, ...]``, numpy or torch, ``N``
    divisible by the data axis) as a new tensor on shard ``s``'s device,
    cast to ``dtype`` there."""
    S = mesh.shape[DATA_AXIS]
    n = x.shape[0]
    if n % S:
        raise ValueError(f"{n} rows do not divide over {S} shards")
    r = n // S
    out = _placed(x[s * r : (s + 1) * r], mesh.data_devices[s])
    return out if dtype is None else out.to(dtype)


def shard_rows(x, mesh: Mesh, dtype: Optional[torch.dtype] = None) -> list[torch.Tensor]:
    """Split ``x`` row-wise: block ``s`` on shard ``s``'s device, each
    block a tensor of its own (the counterpart of ``corpus_sharding`` and
    ``row_sharding``)."""
    return [shard_block(x, mesh, s, dtype) for s in range(mesh.shape[DATA_AXIS])]


def shard_leading(x, mesh: Mesh) -> list[torch.Tensor]:
    """``x [S, ...]`` with one slice per shard (``P(data, ...)``): slice
    ``s`` on shard ``s``'s device."""
    S = mesh.shape[DATA_AXIS]
    if x.shape[0] != S:
        raise ValueError(f"leading axis {x.shape[0]} is not the data axis {S}")
    return [_placed(x[s], d) for s, d in enumerate(mesh.data_devices)]


def replicate(t: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """``t`` on every shard's device (the counterpart of ``replicated``):
    one copy per distinct device, shared by the shards on it, and ``t``
    itself where it already lies."""
    copies: dict[torch.device, torch.Tensor] = {t.device: t}
    out = []
    for d in mesh.data_devices:
        if d not in copies:
            copies[d] = t.to(d, non_blocking=True)
        out.append(copies[d])
    return out
