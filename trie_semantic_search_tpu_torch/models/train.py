"""Encoder training (port of ``trie_semantic_search_tpu/models/train.py``).

In-batch-negative InfoNCE (the sentence-transformers recipe) over (anchor,
positive) text pairs mined from the corpus itself, which turns the seeded
MiniLM init into a corpus-adapted encoder with no downloaded weights:

* :func:`make_optimizer`: ``optax.chain(clip_by_global_norm, adamw)`` with
  optax's ``warmup_cosine_decay_schedule``, written in torch: a global-norm
  clip by hand (optax's rule: kept below the limit, scaled by
  ``max_norm / g_norm`` at or above it), ``torch.optim.AdamW`` with one
  parameter group holding every leaf (optax's ``adamw`` decays every leaf)
  and a ``LambdaLR`` whose factor is the schedule's.
* :func:`info_nce_loss`, :func:`loss_and_grads` and :func:`train_step`: the
  symmetric loss and one eager step through
  :meth:`~.minilm.MiniLM.sentence_embeddings` at the model's compute dtype.
* Pair mining, augmentation views, the false-negative mask and the batch
  stream: host numpy on the JAX package's ``default_rng`` seeds, so both
  packages draw the same pairs, views, batches and masks bitwise; the
  batches become tensors on the embedder's device.
* :func:`pretrain_encoder` (an eager loop) and
  :func:`pretrain_encoder_guarded`, which keeps the trained weights only
  when they do not lower probe retrieval; its snapshot of the init is a
  copy, since AdamW updates the parameters in place.
* :func:`select_pooling_guarded`: mean or SIF pooling on probe merit.
* :func:`make_sharded_train_step`: the same step with data parallelism over
  the ``data`` axis of a :mod:`..parallel` mesh and tensor parallelism over
  its ``model`` axis (the leaves :func:`.minilm.param_partition_specs`
  names), also across processes (:func:`..parallel.mesh.make_distributed_mesh`).
"""

from __future__ import annotations

import itertools
import logging
import math
import re
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, all_gather_shards, batch_sharding
from .minilm import (
    MiniLM,
    MiniLMConfig,
    check_model_parallel,
    count_token_ids,
    join_params,
    leaf_keys,
    params_from_jax,
    sif_weights_from_counts,
    split_params,
    tp_sentence_embeddings,
)
from .quality import build_probes, evaluate_embedder_direct

_log = logging.getLogger("tss_torch.train")


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-4
    weight_decay: float = 0.01
    temperature: float = 0.05
    warmup_steps: int = 100
    total_steps: int = 1000
    max_grad_norm: float = 1.0


def warmup_cosine_factor(step: int, warmup_steps: int, total_steps: int) -> float:
    """optax's ``warmup_cosine_decay_schedule(0, peak, warmup_steps,
    max(total_steps, warmup_steps + 1))`` divided by its peak: linear from
    0 over the warmup, then a cosine to 0 over the remaining steps, 0 after
    them."""
    if step < warmup_steps:
        return step / warmup_steps
    decay = max(total_steps, warmup_steps + 1) - warmup_steps
    return 0.5 * (1.0 + math.cos(math.pi * min(step - warmup_steps, decay) / decay))


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: ``g_norm = sqrt(Σ‖g‖²)``;
    the gradients are kept when ``g_norm < max_norm`` and become
    ``g / g_norm * max_norm`` otherwise (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``). Returns ``g_norm`` on the first
    gradient's device (the leaves may lie on several), without a host
    sync."""
    dev = grads[0].device
    g_norm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))).to(dev) for g in grads))
    for g in grads:
        n = g_norm.to(g.device)
        g.copy_(torch.where(n < max_norm, g, g / n.to(g.dtype) * max_norm))
    return g_norm


class Optimizer:
    """The JAX package's optimizer on a :class:`~.minilm.MiniLM`: the clip,
    AdamW (betas 0.9 / 0.999, eps 1e-8, decoupled decay scaled by the
    learning rate, as optax's ``adamw``) and the warmup-cosine schedule.
    :meth:`step` applies one update from the parameters' ``.grad``."""

    def __init__(self, cfg: TrainConfig, model):
        self.config = cfg
        self.leaves = model.leaves()
        self.params = [p for _, p in self.leaves]
        self.adamw = torch.optim.AdamW(
            self.params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=cfg.weight_decay,
        )
        self.schedule = torch.optim.lr_scheduler.LambdaLR(self.adamw, self.factor)

    def factor(self, step: int) -> float:
        return warmup_cosine_factor(step, self.config.warmup_steps, self.config.total_steps)

    def step(self) -> torch.Tensor:
        """Clip the gradients, update the parameters and advance the
        schedule; returns the global norm before clipping."""
        g_norm = clip_by_global_norm_([p.grad for p in self.params], self.config.max_grad_norm)
        self.adamw.step()
        self.schedule.step()
        return g_norm

    @property
    def count(self) -> int:
        """Updates applied."""
        return self.schedule.last_epoch

    def state_leaves(self) -> list[np.ndarray]:
        """The optax state's leaves in its tree-flatten order: Adam's count
        (int32), ``mu`` and ``nu`` of each parameter leaf, the schedule's
        count (int32)."""
        count = np.asarray(self.count, np.int32)
        mu, nu = [], []
        for p in self.params:
            st = self.adamw.state.get(p, {})
            mu.append(st["exp_avg"].detach().cpu().numpy().copy() if st else np.zeros(p.shape, np.float32))
            nu.append(st["exp_avg_sq"].detach().cpu().numpy().copy() if st else np.zeros(p.shape, np.float32))
        return [count, *mu, *nu, count.copy()]

    def load_state_leaves(self, leaves: Sequence[np.ndarray]) -> None:
        """Restore what :meth:`state_leaves` (or the JAX package's optax
        state) holds. Raises ``ValueError`` on a leaf count or shape that
        does not match the model."""
        n = len(self.params)
        if len(leaves) != 2 * n + 2:
            raise ValueError(f"{len(leaves)} optimizer leaves, expected {2 * n + 2}")
        adam_count, sched_count = int(leaves[0]), int(leaves[-1])
        for (key, p), mu, nu in zip(self.leaves, leaves[1 : n + 1], leaves[n + 1 : 2 * n + 1]):
            if tuple(mu.shape) != tuple(p.shape) or tuple(nu.shape) != tuple(p.shape):
                raise ValueError(f"optimizer state of {key}: {mu.shape}, {nu.shape}, expected {tuple(p.shape)}")
            self.adamw.state[p] = {
                "step": torch.tensor(float(adam_count), dtype=torch.float32),
                "exp_avg": torch.as_tensor(np.asarray(mu, np.float32), device=p.device).clone(),
                "exp_avg_sq": torch.as_tensor(np.asarray(nu, np.float32), device=p.device).clone(),
            }
        self.schedule.last_epoch = sched_count
        for group, base in zip(self.adamw.param_groups, self.schedule.base_lrs):
            group["lr"] = base * self.factor(sched_count)
        self.schedule._last_lr = [g["lr"] for g in self.adamw.param_groups]


def make_optimizer(cfg: TrainConfig, model) -> Optimizer:
    """The JAX package's ``make_optimizer(cfg)``, bound to ``model``'s
    parameters as torch optimizers are."""
    return Optimizer(cfg, model)


def info_nce_loss(
    anchors: torch.Tensor,  # [B, D] L2-normalised
    positives: torch.Tensor,  # [B, D] L2-normalised
    temperature: float,
    neg_mask: Optional[torch.Tensor] = None,  # [B, B] bool: True = usable negative
) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric in-batch-negative InfoNCE: ``(loss, accuracy)``.
    ``neg_mask[i, j]`` False drops pair j as a negative of anchor i (the
    diagonal, the positive, is always kept) by a ``-1e30`` logit, so a row
    with every negative masked gives 0, not nan. The accuracy takes the
    first index on ties."""
    logits = anchors @ positives.T / temperature  # [B, B]
    B = logits.shape[0]
    labels = torch.arange(B, device=logits.device)
    if neg_mask is not None:
        keep = neg_mask | torch.eye(B, dtype=torch.bool, device=logits.device)
        logits = torch.where(keep, logits, torch.full_like(logits, -1e30))
    loss_a = torch.nn.functional.cross_entropy(logits, labels, reduction="none")
    loss_b = torch.nn.functional.cross_entropy(logits.T, labels, reduction="none")
    loss = (loss_a + loss_b).mean() / 2
    acc = (torch.argmax(logits, dim=1) == labels).to(torch.float32).mean()
    return loss, acc


def loss_and_grads(model, batch: dict[str, torch.Tensor], temperature: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The InfoNCE loss of one batch (``ids_a``, ``mask_a``, ``ids_b``,
    ``mask_b`` [B, L], optional ``neg_mask``) and its gradients in each
    parameter's ``.grad`` (the model must be :meth:`~.minilm.MiniLM.trainable`).
    Returns ``(loss, accuracy)``, detached."""
    for p in model.parameters():
        p.grad = None
    a = model.sentence_embeddings(batch["ids_a"], batch["mask_a"])
    b = model.sentence_embeddings(batch["ids_b"], batch["mask_b"])
    loss, acc = info_nce_loss(a, b, temperature, batch.get("neg_mask"))
    loss.backward()
    return loss.detach(), acc


def train_step(
    model, optimizer: Optimizer, batch: dict[str, torch.Tensor], temperature: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One InfoNCE step in place: the parameters and the optimizer state
    are updated; returns ``(loss, accuracy)``."""
    loss, acc = loss_and_grads(model, batch, temperature)
    optimizer.step()
    return loss, acc


# ---------------------------------------------------------------------------
# The sharded step (data and tensor parallel over a mesh)
# ---------------------------------------------------------------------------

#: the batch of a sharded step (the JAX step's ``in_shardings`` names these)
SHARDED_BATCH_KEYS = ("ids_a", "mask_a", "ids_b", "mask_b")


class ShardedTrainState:
    """Parameters and optimizer state of :class:`ShardedTrainStep`: per
    mesh column ``c``, ``columns[c]`` holds that column's slices of the
    sharded leaves (:func:`.minilm.split_params`) as f32 parameters on the
    device of cell (this process's first data row, ``c``); the replicated
    leaves live once, in column 0. ``optimizer`` (the clip, AdamW and the
    schedule of :class:`Optimizer`) holds a moment pair per slice, so the
    clip's global norm counts every replicated leaf once."""

    def __init__(self, columns: list[dict[str, torch.Tensor]], config: MiniLMConfig,
                 compute_dtype: torch.dtype, optimizer_cfg: TrainConfig):
        self.config = config
        self.compute_dtype = compute_dtype
        self.columns = [{k: torch.nn.Parameter(t) for k, t in col.items()} for col in columns]
        self.optimizer = Optimizer(optimizer_cfg, self)

    def leaves(self) -> list[tuple[str, torch.nn.Parameter]]:
        """``(key, parameter)`` in the parameter tree's leaf order, a
        sharded leaf's slices in column order (``key@c``)."""
        out = []
        for key in leaf_keys(self.config):
            held = [(c, col[key]) for c, col in enumerate(self.columns) if key in col]
            out.extend((key if len(held) == 1 else f"{key}@{c}", p) for c, p in held)
        return out


class ShardedTrainStep:
    """One InfoNCE step over ``mesh`` (the port's ``make_sharded_train_step``).

    The batch (``ids_a``, ``mask_a``, ``ids_b``, ``mask_b`` ``[B, L]``, the
    same on every process) splits over the data axis (:func:`..parallel.
    mesh.batch_sharding`). Each local data row encodes its block with its
    columns' parameter slices (:func:`.minilm.tp_sentence_embeddings`); the
    row's replicas are differentiable copies of the state's slices, so
    their gradients sum back into the state. The embeddings of every row
    meet in data order on this process's first device
    (:func:`..parallel.mesh.all_gather_shards`: across processes a
    ``torch.distributed.nn.functional.all_gather``) for the
    symmetric loss of the whole batch. That gather's backward sums over
    the processes, which all hold the same loss, so each backpropagates
    its loss divided by the process count; the gradients of each process's
    rows are then summed over the processes. The optimizer clips by the
    global norm and steps AdamW with the warmup-cosine factor, the same on
    every process."""

    def __init__(self, mesh: Mesh, model_config: MiniLMConfig, optimizer_cfg: TrainConfig,
                 temperature: float = 0.05):
        self.mesh = mesh
        self.config = model_config
        self.optimizer_cfg = optimizer_cfg
        self.temperature = temperature
        self.split = batch_sharding(mesh)
        check_model_parallel(model_config, mesh.shape[MODEL_AXIS])

    def init(self, model: MiniLM) -> ShardedTrainState:
        """The state of ``model``'s parameters (copied), at its compute dtype."""
        params = {k: p.detach() for k, p in model.named_parameters()}
        return self._state(params, model.compute_dtype)

    def init_from_jax(self, tree, compute_dtype: torch.dtype = torch.bfloat16) -> ShardedTrainState:
        """The state of a JAX parameter tree (through :func:`.minilm.params_from_jax`)."""
        return self._state(params_from_jax(tree), compute_dtype)

    def _state(self, params: dict, compute_dtype: torch.dtype) -> ShardedTrainState:
        home = self.mesh.local_data_rows[0]
        cols = split_params(params, self.config, self.mesh.shape[MODEL_AXIS])
        placed = [
            {k: t.to(self.mesh.devices[home][c], torch.float32, copy=True)
             for k, t in col.items() if c == 0 or t is not params[k]}
            for c, col in enumerate(cols)
        ]
        return ShardedTrainState(placed, self.config, compute_dtype, self.optimizer_cfg)

    def gather(self, state: ShardedTrainState, device: DeviceLike = None) -> MiniLM:
        """The state's parameters as a :class:`MiniLM` on ``device``
        (default: this process's first device)."""
        dev = self.mesh.first_device if device is None else resolve_device(device)
        full = {k: t.detach() for k, t in join_params(state.columns, self.config).items()}
        return MiniLM(self.config, device=dev, compute_dtype=state.compute_dtype).load_params(full)

    def _replicas(self, state: ShardedTrainState, r: int) -> list[dict[str, torch.Tensor]]:
        """The state's columns on data row ``r``'s devices (differentiable
        copies where a cell's device differs from the state's)."""
        return [{k: p if p.device == d else p.to(d) for k, p in col.items()}
                for col, d in zip(state.columns, self.mesh.devices[r])]

    def _sum_over_processes(self, grads: list[torch.Tensor]) -> None:
        """Each gradient summed over the job's processes, in place."""
        import torch.distributed as dist

        stage = self.mesh.first_device if self.mesh.backend == "nccl" else torch.device("cpu")
        flat = torch.cat([g.reshape(-1).to(stage) for g in grads])
        dist.all_reduce(flat, group=self.mesh.group)
        off = 0
        for g in grads:
            g.copy_(flat[off : off + g.numel()].view_as(g))
            off += g.numel()

    def __call__(self, state: ShardedTrainState, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """One step in place on ``state``; returns ``(loss, accuracy)`` of
        the whole batch, the same on every process."""
        mesh = self.mesh
        if set(batch) != set(SHARDED_BATCH_KEYS):
            raise ValueError(f"a sharded batch holds exactly {SHARDED_BATCH_KEYS}, got {sorted(batch)}")
        B = int(batch["ids_a"].shape[0])
        dp = mesh.shape[DATA_AXIS]
        if B % dp:
            raise ValueError(f"batch {B} does not divide over the {dp} data rows")
        blocks = {k: self.split(torch.as_tensor(v)) for k, v in batch.items()}
        for _, p in state.leaves():
            p.grad = None
        home = mesh.first_device
        emb_a, emb_b = [], []
        for r in mesh.local_data_rows:
            cols = self._replicas(state, r)
            for side, out in (("a", emb_a), ("b", emb_b)):
                e = tp_sentence_embeddings(cols, self.config, blocks[f"ids_{side}"][r],
                                           blocks[f"mask_{side}"][r], state.compute_dtype)
                out.append(e.to(home))
        # every data row's embeddings, in data order (a row block per shard)
        a = all_gather_shards(mesh, torch.stack(emb_a)).reshape(B, -1)
        b = all_gather_shards(mesh, torch.stack(emb_b)).reshape(B, -1)
        loss, acc = info_nce_loss(a, b, self.temperature)
        (loss / mesh.world_size).backward()
        grads = []
        for _, p in state.leaves():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if mesh.distributed:
            self._sum_over_processes(grads)
        state.optimizer.step()
        return loss.detach(), acc


def make_sharded_train_step(
    mesh: Mesh,
    model_config: MiniLMConfig,
    optimizer_cfg: TrainConfig,
    temperature: float = 0.05,
) -> ShardedTrainStep:
    """The train step with explicit dp×tp sharding over ``mesh`` (the JAX
    package's ``make_sharded_train_step``): build its state with
    ``step.init(model)`` or ``step.init_from_jax(tree)``, run
    ``loss, acc = step(state, batch)``, and read the parameters back with
    ``step.gather(state)``. Raises ``ValueError`` when the model axis does
    not divide the heads and the FFN's intermediate size."""
    return ShardedTrainStep(mesh, model_config, optimizer_cfg, temperature)


# ---------------------------------------------------------------------------
# Pair mining and the pretraining loop
# ---------------------------------------------------------------------------


def mine_pairs(
    docs: Sequence[Sequence[str]],  # per-document sentence lists
    seed: int = 0,
    scrub_digits: bool = False,
) -> list[tuple[str, str]]:
    """Adjacent sentences of each document as positives, plus one random
    long-range pair per document of three or more sentences; shuffled.
    ``scrub_digits`` replaces digit runs with ``0`` in the pair text, so
    document-unique numbers are no shortcut for the loss."""
    rng = np.random.default_rng(seed)
    pairs: list[tuple[str, str]] = []
    for sents in docs:
        if scrub_digits:
            sents = [re.sub(r"\d+", "0", s) for s in sents]
        for i in range(len(sents) - 1):
            pairs.append((sents[i], sents[i + 1]))
        if len(sents) >= 3:
            i, j = rng.choice(len(sents), 2, replace=False)
            pairs.append((sents[i], sents[j]))
    rng.shuffle(pairs)  # type: ignore[arg-type]
    return pairs


#: synonym groups used only to draw augmented views for pretraining
#: (:func:`mine_view_pairs`); a copy of the JAX package's lexicon
TRAIN_SYNONYM_GROUPS: list[list[str]] = [
    ["attorney", "lawyer", "counsel", "advocate"],
    ["judge", "justice", "jurist"],
    ["court", "tribunal", "forum"],
    ["ruling", "judgment", "decision", "holding"],
    ["law", "statute", "enactment"],
    ["regulation", "rule", "ordinance"],
    ["contract", "agreement", "pact"],
    ["evidence", "proof", "testimony"],
    ["defendant", "accused", "respondent"],
    ["plaintiff", "petitioner", "claimant", "complainant"],
    ["crime", "offense", "felony"],
    ["illegal", "unlawful", "illicit"],
    ["forbidden", "prohibited", "banned", "barred"],
    ["permitted", "allowed", "authorized"],
    ["obligation", "duty", "responsibility"],
    ["damages", "compensation", "restitution"],
    ["appeal", "review", "rehearing"],
    ["reversed", "overturned", "vacated"],
    ["affirmed", "upheld", "sustained"],
    ["remanded", "returned"],
    ["dismissed", "rejected", "denied"],
    ["decided", "held", "concluded", "determined", "ruled", "found",
     "reasoned"],
    ["dispute", "controversy", "disagreement"],
    ["doctrine", "principle", "precept"],
    ["framework", "structure", "scheme"],
    ["standard", "test", "criterion"],
    ["analysis", "examination", "inquiry"],
    ["claim", "assertion", "contention"],
    ["record", "transcript", "file"],
    ["trial", "proceeding", "hearing"],
    ["question", "issue", "matter"],
    ["car", "automobile", "vehicle"],
    ["house", "home", "residence", "dwelling"],
    ["money", "funds", "payment"],
    ["big", "large", "substantial"],
    ["small", "minor", "trivial"],
    ["begin", "start", "commence"],
    ["end", "finish", "terminate", "conclude"],
    ["show", "demonstrate", "establish"],
    ["require", "demand", "mandate"],
    ["sensible", "reasonable", "rational"],
    ["acquired", "obtained", "procured"],
    ["applies", "governs", "controls"],
]

#: word → candidate replacements (every other member of its group)
TRAIN_SYNONYMS: dict[str, list[str]] = {}
for _grp in TRAIN_SYNONYM_GROUPS:
    for _w in _grp:
        TRAIN_SYNONYMS.setdefault(_w, []).extend(x for x in _grp if x != _w)

_VIEW_STOPWORDS = frozenset(
    "the a an of in on at to and or is was were be been that this it its by "
    "for with as from".split()
)


def augment_view(
    sentence: str,
    rng: np.random.Generator,
    synonyms: Optional[dict[str, list[str]]] = None,
    swap_prob: float = 0.9,
    drop_prob: float = 0.3,
    scrub_digits: bool = True,
) -> str:
    """One stochastic rewrite that keeps the meaning: synonym swaps (each
    occurrence with ``swap_prob``), stopword drops (``drop_prob``), digit
    runs scrubbed to ``0``."""
    syn = TRAIN_SYNONYMS if synonyms is None else synonyms
    out: list[str] = []
    for w in sentence.split():
        core = w.lower().strip(".,;:()")
        if core in syn and rng.random() < swap_prob:
            out.append(str(rng.choice(syn[core])))
        elif core in _VIEW_STOPWORDS and rng.random() < drop_prob:
            continue
        else:
            out.append(w)
    s = " ".join(out)
    if scrub_digits:
        s = re.sub(r"\d+", "0", s)
    return s


def mine_view_pairs(
    docs: Sequence[Sequence[str]],
    seed: int = 0,
    synonyms: Optional[dict[str, list[str]]] = None,
    scrub_digits: bool = True,
    views_per_sentence: int = 1,
) -> list[tuple[str, str]]:
    """Two independent :func:`augment_view` draws of each sentence as a
    positive pair (non-empty ones), shuffled."""
    rng = np.random.default_rng(seed)
    pairs: list[tuple[str, str]] = []
    for sents in docs:
        for s in sents:
            for _ in range(views_per_sentence):
                a = augment_view(s, rng, synonyms, scrub_digits=scrub_digits)
                b = augment_view(s, rng, synonyms, scrub_digits=scrub_digits)
                if a and b:
                    pairs.append((a, b))
    rng.shuffle(pairs)  # type: ignore[arg-type]
    return pairs


def _false_negative_mask(texts: Sequence[str], jaccard_threshold: float) -> np.ndarray:
    """[B, B] bool, True where pair j is a usable negative for anchor i:
    their token sets' Jaccard is below the threshold."""
    sets = [frozenset(t.lower().split()) for t in texts]
    B = len(sets)
    mask = np.ones((B, B), dtype=bool)
    for i in range(B):
        si = sets[i]
        for j in range(i + 1, B):
            sj = sets[j]
            inter = len(si & sj)
            union = len(si | sj) or 1
            if inter / union >= jaccard_threshold:
                mask[i, j] = mask[j, i] = False
    return mask


def batches_from_pairs(
    pairs: Sequence[tuple[str, str]],
    tokenizer,
    batch_size: int,
    max_len: int,
    seed: int = 0,
    false_negative_jaccard: float = 0.0,
    device: DeviceLike = None,
) -> Iterator[dict[str, torch.Tensor]]:
    """Tokenised [B, L] batches on ``device`` (default ``"cuda"``), cycling
    over reshuffles of ``pairs`` forever (the caller bounds the steps).
    ``false_negative_jaccard`` > 0 adds ``neg_mask`` [B, B] from
    :func:`_false_negative_mask` over each pair's text joined by a space."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    order = np.arange(len(pairs))
    while True:
        rng.shuffle(order)
        for s in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[s : s + batch_size]
            a = tokenizer.encode_batch([pairs[i][0] for i in idx], max_len)
            b = tokenizer.encode_batch([pairs[i][1] for i in idx], max_len)
            batch = {
                "ids_a": torch.as_tensor(a.input_ids, device=dev),
                "mask_a": torch.as_tensor(a.attention_mask, device=dev),
                "ids_b": torch.as_tensor(b.input_ids, device=dev),
                "mask_b": torch.as_tensor(b.attention_mask, device=dev),
            }
            if false_negative_jaccard > 0.0:
                batch["neg_mask"] = torch.as_tensor(_false_negative_mask(
                    [pairs[i][0] + " " + pairs[i][1] for i in idx], false_negative_jaccard,
                ), device=dev)
            yield batch


def pretrain_encoder(
    embedder,  # models.embedder.Embedder (its model is updated in place)
    docs: Sequence[Sequence[str]],
    steps: int = 200,
    batch_size: int = 32,
    max_len: int = 64,
    train_config: Optional[TrainConfig] = None,
    log_every: int = 50,
    false_negative_jaccard: float = 0.0,
    scrub_digits: bool = False,
    pair_style: str = "adjacent",  # "adjacent" | "views"
) -> dict:
    """Corpus-contrastive pretraining of ``embedder.model`` on its device:
    pairs mined from ``docs`` (:func:`mine_pairs` or :func:`mine_view_pairs`),
    ``steps`` eager :func:`train_step` calls. Skips with ``steps: 0`` when
    fewer than 4 pairs come out; the batch shrinks to the pair count.
    Returns ``steps``, ``pairs`` and the last logged loss and accuracy."""
    cfg = train_config or TrainConfig(total_steps=steps)
    if pair_style == "views":
        pairs = mine_view_pairs(docs, scrub_digits=scrub_digits)
    else:
        pairs = mine_pairs(docs, scrub_digits=scrub_digits)
    if len(pairs) < 4:
        _log.warning("only %d pairs (< 4); skipping pretraining", len(pairs))
        return {"steps": 0, "pairs": len(pairs)}
    batch_size = min(batch_size, len(pairs))
    model = embedder.model
    optimizer = make_optimizer(cfg, model)
    it = batches_from_pairs(
        pairs, embedder.tokenizer, batch_size, max_len,
        false_negative_jaccard=false_negative_jaccard, device=embedder.device,
    )
    last_loss = last_acc = float("nan")
    with model.trainable():
        for step in range(steps):
            loss, acc = train_step(model, optimizer, next(it), cfg.temperature)
            if (step + 1) % log_every == 0 or step == steps - 1:
                last_loss, last_acc = float(loss), float(acc)
                _log.info("pretrain step %d/%d: loss=%.4f acc=%.3f", step + 1, steps, last_loss, last_acc)
    return {
        "steps": steps,
        "pairs": len(pairs),
        "final_loss": last_loss,
        "final_accuracy": last_acc,
    }


def _probe_sample(docs: Sequence[Sequence[str]], eval_docs: int, eval_probes: int):
    """Probes of the first ``eval_docs`` documents and the chunk sample
    they are ranked in (each document's first eight sentences)."""
    sample = list(enumerate(docs[:eval_docs]))
    probes = build_probes(sample, max_probes=eval_probes)
    texts: list[str] = []
    rows: list[int] = []
    for i, sents in sample:
        for s in sents[:8]:
            texts.append(s)
            rows.append(i)
    return probes, texts, rows


def pretrain_encoder_guarded(
    embedder,  # models.embedder.Embedder (its model is updated in place)
    docs: Sequence[Sequence[str]],
    steps: int = 200,
    batch_size: int = 32,
    max_len: int = 64,
    train_config: Optional[TrainConfig] = None,
    false_negative_jaccard: float = 0.5,
    scrub_digits: bool = True,
    eval_docs: int = 64,
    eval_probes: int = 96,
    pair_style: str = "views",
) -> dict:
    """:func:`pretrain_encoder` with a retrieval guardrail: the trained
    weights stay only if their probe MRR (:func:`.quality.evaluate_embedder_direct`
    over the first ``eval_docs`` documents) is at least the init's; else the
    init comes back bitwise from a copy taken before training. Returns the
    pretraining report plus ``guardrail``: which weights were kept and both
    MRRs."""
    model = embedder.model
    init_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    rep = pretrain_encoder(
        embedder, docs, steps=steps, batch_size=batch_size,
        max_len=max_len, train_config=train_config,
        false_negative_jaccard=false_negative_jaccard,
        scrub_digits=scrub_digits, pair_style=pair_style,
    )
    if not rep.get("steps"):
        return rep  # pretraining skipped (tiny corpus)
    probes, texts, rows = _probe_sample(docs, eval_docs, eval_probes)
    if not probes or not texts:
        rep["guardrail"] = {"kept": "trained", "reason": "no probes"}
        return rep
    trained_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    trained = evaluate_embedder_direct(embedder, texts, rows, probes)["all"]
    model.load_state_dict(init_state)
    init = evaluate_embedder_direct(embedder, texts, rows, probes)["all"]
    if trained["mrr"] >= init["mrr"]:
        model.load_state_dict(trained_state)
        kept = "trained"
    else:  # the init is loaded already
        kept = "init"
        _log.warning(
            "pretraining degraded probe retrieval (MRR %.3f -> %.3f); keeping the initialisation weights",
            init["mrr"], trained["mrr"],
        )
    rep["guardrail"] = {
        "kept": kept,
        "trained_mrr": trained["mrr"],
        "init_mrr": init["mrr"],
        "probes": len(probes),
    }
    return rep


def select_pooling_guarded(
    embedder,  # models.embedder.Embedder (its token weights are set in place)
    docs: Sequence[Sequence[str]],
    sif_a: float = 0.1,
    eval_docs: int = 64,
    eval_probes: int = 96,
    count_sentences: int = 50_000,
    force: Optional[str] = None,  # "mean" | "sif" skips the comparison
) -> dict:
    """Pick the pooling on probe merit and leave the winner on the
    embedder: SIF weights from a tokenize-only count over at most
    ``count_sentences`` sentences of ``docs``, then the encoder under mean
    and under SIF pooling on held-out probes (:func:`.quality.build_probes`
    over the first ``eval_docs`` documents, each scored by
    :func:`.quality.evaluate_embedder_direct` over their first eight
    sentences); SIF is kept only when its MRR is higher. Mean pooling
    without a comparison when fewer than 8 probes come out. Returns what
    was picked and both MRRs."""
    counts = count_token_ids(
        embedder.tokenizer,
        itertools.islice((s for sents in docs for s in sents), count_sentences),
        vocab_size=max(len(embedder.tokenizer), 128),
    )
    weights = sif_weights_from_counts(counts, a=sif_a)
    if force == "sif":
        embedder.set_token_weights(weights)
        return {"pooling": "sif", "sif_a": sif_a, "forced": True}
    if force == "mean":
        embedder.set_token_weights(None)
        return {"pooling": "mean", "forced": True}

    probes, texts, rows = _probe_sample(docs, eval_docs, eval_probes)
    if len(probes) < 8 or not texts:
        embedder.set_token_weights(None)
        return {"pooling": "mean", "reason": "corpus too small for probes"}
    embedder.set_token_weights(None)
    mean_m = evaluate_embedder_direct(embedder, texts, rows, probes)["all"]
    embedder.set_token_weights(weights)
    sif_m = evaluate_embedder_direct(embedder, texts, rows, probes)["all"]
    if sif_m["mrr"] > mean_m["mrr"]:
        kept = "sif"  # its weights are set already
    else:
        kept = "mean"
        embedder.set_token_weights(None)
    rec = {
        "pooling": kept, "sif_a": sif_a,
        "mean_mrr": mean_m["mrr"], "sif_mrr": sif_m["mrr"],
        "probes": len(probes),
    }
    _log.info("pooling selection: %s", rec)
    return rec
