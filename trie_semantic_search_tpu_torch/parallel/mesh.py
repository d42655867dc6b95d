"""Device mesh construction and placement helpers.

Port of ``trie_semantic_search_tpu/parallel/mesh.py``. The JAX package lays
the corpus out row-sharded over the ``data`` axis of a ``(data, model)``
mesh and lets one ``shard_map`` program run every shard. The port keeps a
controller per process: a :class:`Mesh` is a ``[dp, mp]`` grid of
``torch.device``, the corpus is a list of row blocks (block ``s`` on the
device of data row ``s``), and each process issues the stages of the shards
it owns on their devices (:mod:`.collectives`).

A mesh may name one device more than once: four shards on ``cuda:0`` run
the same per-shard work and merge as four cards would, and the CPU tests
build an eight-shard mesh over ``cpu``. Every shard block is its own
tensor, even where two shards share a device.

A mesh may span processes (:func:`make_distributed_mesh`, the counterpart
of ``jax.distributed.initialize`` followed by ``make_mesh`` over the global
device list). Every cell then records the rank that owns it; a process
holds only the blocks of its own data rows (the placement helpers leave
``None`` in the others' places, as JAX's ``device_put`` places only a
process's addressable shards), and the shard lists meet in an
``all_gather`` over the job's process group.
"""

from __future__ import annotations

import datetime
import functools
import logging
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..core.config import MeshConfig

_log = logging.getLogger("tss_torch.mesh")

DATA_AXIS = "data"
MODEL_AXIS = "model"

#: how long :func:`make_distributed_mesh` waits for every process to join
DEFAULT_JOIN_TIMEOUT = datetime.timedelta(seconds=300)


def _indexed(d: Union[str, torch.device]) -> torch.device:
    """``cuda`` as ``cuda:0``, the device a tensor placed there reports."""
    d = torch.device(d)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d


class Mesh:
    """A ``[dp, mp]`` grid of ``torch.device``; ``shape`` reads as the JAX
    mesh's (``{"data": dp, "model": mp}``).

    ``owners`` (same grid, default all 0) holds the rank of the process
    that owns each cell, ``rank`` this process's; a data row's cells always
    share one owner. ``group`` and ``backend`` are the process group the
    shard lists are gathered over (None and ``"gloo"``: the job's default
    group)."""

    def __init__(
        self,
        grid: Sequence[Sequence[Union[str, torch.device]]],
        owners: Optional[Sequence[Sequence[int]]] = None,
        rank: int = 0,
        world_size: int = 1,
        group=None,
        backend: Optional[str] = None,
    ):
        self.devices = [[_indexed(d) for d in row] for row in grid]
        mp = len(self.devices[0]) if self.devices else 0
        if not mp or any(len(row) != mp for row in self.devices):
            raise ValueError("a mesh needs a non-empty rectangular grid of devices")
        self.owners = [[0] * mp for _ in self.devices] if owners is None else [list(r) for r in owners]
        self.rank, self.world_size = rank, world_size
        self.group, self.backend = group, backend

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: len(self.devices), MODEL_AXIS: len(self.devices[0])}

    @property
    def data_devices(self) -> list[torch.device]:
        """The device of each shard (data row ``s``, model column 0), as
        its owner names it."""
        return [row[0] for row in self.devices]

    @property
    def distributed(self) -> bool:
        """Whether the mesh spans processes."""
        return self.world_size > 1

    def is_local(self, s: int) -> bool:
        """Whether this process owns data row ``s``."""
        return self.owners[s][0] == self.rank

    @property
    def local_data_rows(self) -> list[int]:
        """The data rows (shards) this process owns, in order."""
        return [s for s in range(len(self.devices)) if self.is_local(s)]

    def rows_of(self, rank: int) -> list[int]:
        """The data rows process ``rank`` owns, in order."""
        return [s for s in range(len(self.devices)) if self.owners[s][0] == rank]

    @property
    def first_device(self) -> torch.device:
        """Where shard-local results merge: the device of this process's
        first shard (the mesh's first device in a single process)."""
        return self.data_devices[self.local_data_rows[0]]

    def __repr__(self) -> str:
        where = f", rank {self.rank} of {self.world_size}" if self.distributed else ""
        return f"Mesh({self.shape}, {self.data_devices}{where})"


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


#: the job this process joined through :func:`make_distributed_mesh` (a
#: process joins one ``torch.distributed`` job, whose group is itself
#: process-wide state; later meshes of the job reuse its layout)
_JOB: dict = {}


def _device_id(d: torch.device) -> str:
    """What tells two processes' devices apart: a card's UUID (a process
    may name a shared card by another index), ``cpu`` for the host."""
    if d.type == "cuda":
        return f"cuda:{torch.cuda.get_device_properties(d).uuid}"
    return d.type


def pick_backend(device_ids: Sequence[Sequence[str]]) -> str:
    """The collective backend of a job whose process ``r`` holds the
    devices ``device_ids[r]`` (:func:`_device_id`): ``nccl`` when every
    device is a card and no card belongs to two processes (NCCL refuses two
    ranks on one card), ``gloo`` otherwise (processes sharing a card, or on
    the CPU), which stages the shard lists through host memory."""
    owner: dict[str, int] = {}
    for r, ids in enumerate(device_ids):
        for i in ids:
            if not i.startswith("cuda:") or owner.setdefault(i, r) != r:
                return "gloo"
    return "nccl"


def job_mesh(
    config: Optional[MeshConfig],
    process_devices: Sequence[Sequence[Union[str, torch.device]]],
    rank: int,
    group=None,
    backend: str = "gloo",
) -> Mesh:
    """The ``(data, model)`` mesh of a job whose process ``r`` contributes
    ``process_devices[r]``: :func:`make_mesh` over the devices in rank
    order (as ``jax.devices()`` orders a job's devices), each cell owned by
    the process that contributed it. Raises ``ValueError`` when a data
    row's model axis would span processes (tensor parallelism stays inside
    a process) or when a process would own no data row."""
    flat: list = []
    owner: list[int] = []
    for r, devs in enumerate(process_devices):
        flat.extend(devs)
        owner.extend([r] * len(devs))
    base = make_mesh(config, flat)
    mp = base.shape[MODEL_AXIS]
    owners = [[owner[i * mp + c] for c in range(mp)] for i in range(base.shape[DATA_AXIS])]
    for i, row in enumerate(owners):
        if len(set(row)) > 1:
            raise ValueError(
                f"data row {i} of the {base.shape[DATA_AXIS]}x{mp} mesh spans processes "
                f"{sorted(set(row))}: a model axis (model_parallel {mp}) stays inside one process"
            )
    idle = [r for r in range(len(process_devices)) if not any(row[0] == r for row in owners)]
    if idle:
        raise ValueError(f"processes {idle} own no data row of the {base.shape[DATA_AXIS]}x{mp} mesh")
    return Mesh(base.devices, owners=owners, rank=rank, world_size=len(process_devices),
                group=group, backend=backend)


def make_distributed_mesh(
    config: Optional[MeshConfig] = None,
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
    timeout: datetime.timedelta = DEFAULT_JOIN_TIMEOUT,
) -> Mesh:
    """The mesh of a job. Without a coordinator (one process) it is
    :func:`make_mesh` over ``devices`` (default: the visible cards).

    With one (``host:port``, where process 0 listens), every process of the
    job calls it with the job's ``num_processes`` and its own
    ``process_id``: it joins ``torch.distributed`` (``init_method
    tcp://<coordinator_address>``, a ``gloo`` default group, ``timeout`` for
    the rendezvous and every collective), contributes its local
    ``devices`` and returns the job's global mesh (:func:`job_mesh`), the
    same grid on every process. The shard lists are gathered over
    :func:`pick_backend`'s backend (an ``nccl`` group beside the default one
    when every process owns cards of its own); the choice is logged.
    Every process runs the same program, places the same host rows (keeping
    its own blocks) and gets the same merged answers. Later calls in the
    process reuse the job for another mesh shape; :func:`shutdown_distributed`
    leaves it."""
    if coordinator_address is None:
        return make_mesh(config, devices)
    import torch.distributed as dist

    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs num_processes and process_id")
    local = [_indexed(d) for d in (devices if devices is not None else visible_devices())]
    if _JOB:
        if (_JOB["address"], _JOB["world"], _JOB["rank"]) != (coordinator_address, num_processes, process_id):
            raise RuntimeError(f"this process already joined the job {_JOB['address']} as rank "
                               f"{_JOB['rank']} of {_JOB['world']}")
        if devices is not None and [str(d) for d in local] != _JOB["devices"][process_id]:
            raise ValueError(f"this process joined the job with devices {_JOB['devices'][process_id]}")
    else:
        if dist.is_initialized():
            raise RuntimeError("torch.distributed is already initialised outside make_distributed_mesh")
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id, timeout=timeout)
        mine = ([str(d) for d in local], [_device_id(d) for d in local])
        layouts: list = [None] * num_processes
        dist.all_gather_object(layouts, mine)
        backend = pick_backend([ids for _, ids in layouts])
        group = None
        if backend == "nccl":
            torch.cuda.set_device(local[0])
            group = dist.new_group(backend="nccl", timeout=timeout)
        _JOB.update(address=coordinator_address, world=num_processes, rank=process_id,
                    devices=[devs for devs, _ in layouts], backend=backend, group=group)
        _log.info("joined %s as rank %d of %d; devices by rank %s; backend %s (%s)",
                  coordinator_address, process_id, num_processes, _JOB["devices"], backend,
                  "each process owns its cards" if backend == "nccl"
                  else "processes share a card or run on the host")
    return job_mesh(config, _JOB["devices"], process_id, _JOB["group"], _JOB["backend"])


def shutdown_distributed() -> None:
    """Leave the job :func:`make_distributed_mesh` joined (the counterpart
    of ``jax.distributed.shutdown``); nothing when none was joined."""
    if _JOB:
        import torch.distributed as dist

        _JOB.clear()
        dist.destroy_process_group()


def all_gather_shards(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """``local [n_local, ...]`` (this process's shards' slices, in its
    shard order) → ``[S, ...]`` in global shard order on the mesh's first
    device, the same on every process (the port's ``all_gather``). A
    single-process mesh returns ``local``. Over ``gloo`` the slices travel
    through host memory; processes owning fewer shards pad their slices.
    Differentiable (``torch.distributed.nn.functional.all_gather``): the
    backward sums over the processes the gradients each computed for a
    process's slices."""
    if not mesh.distributed:
        return local
    import torch.distributed.nn.functional as dist_fn

    owned = [len(mesh.rows_of(r)) for r in range(mesh.world_size)]
    if local.shape[0] < max(owned):
        local = torch.cat([local, local.new_zeros((max(owned) - local.shape[0], *local.shape[1:]))])
    stage = local.cpu() if mesh.backend != "nccl" else local.contiguous()
    parts = dist_fn.all_gather(stage, group=mesh.group)
    # a job's rows are in rank order (job_mesh), so the parts concatenate
    # in shard order
    return torch.cat([p[:n] for p, n in zip(parts, owned)]).to(mesh.first_device)


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


def shard_rows(x, mesh: Mesh, dtype: Optional[torch.dtype] = None) -> list[Optional[torch.Tensor]]:
    """Split ``x`` row-wise: block ``s`` on shard ``s``'s device, each
    block a tensor of its own (the counterpart of ``corpus_sharding`` and
    ``row_sharding``); ``None`` for the shards of other processes."""
    if x.shape[0] % mesh.shape[DATA_AXIS]:
        raise ValueError(f"{x.shape[0]} rows do not divide over {mesh.shape[DATA_AXIS]} shards")
    return [shard_block(x, mesh, s, dtype) if mesh.is_local(s) else None
            for s in range(mesh.shape[DATA_AXIS])]


def batch_sharding(mesh: Mesh):
    """``P("data")`` for ``[B, ...]`` training activations: the split that
    puts the batch's row block ``r`` on data row ``r``'s device
    (:func:`shard_rows`; ``B`` divisible by the data axis)."""
    return functools.partial(shard_rows, mesh=mesh)


def shard_leading(x, mesh: Mesh) -> list[Optional[torch.Tensor]]:
    """``x [S, ...]`` with one slice per shard (``P(data, ...)``): slice
    ``s`` on shard ``s``'s device; ``None`` for other processes' shards."""
    S = mesh.shape[DATA_AXIS]
    if x.shape[0] != S:
        raise ValueError(f"leading axis {x.shape[0]} is not the data axis {S}")
    return [_placed(x[s], d) if mesh.is_local(s) else None for s, d in enumerate(mesh.data_devices)]


def replicate(t: torch.Tensor, mesh: Mesh) -> list[Optional[torch.Tensor]]:
    """``t`` on every local shard's device (the counterpart of
    ``replicated``): one copy per distinct device, shared by the shards on
    it, and ``t`` itself where it already lies; ``None`` for the shards of
    other processes."""
    copies: dict[torch.device, torch.Tensor] = {t.device: t}
    out: list[Optional[torch.Tensor]] = []
    for s, d in enumerate(mesh.data_devices):
        if not mesh.is_local(s):
            out.append(None)
            continue
        if d not in copies:
            copies[d] = t.to(d, non_blocking=True)
        out.append(copies[d])
    return out
