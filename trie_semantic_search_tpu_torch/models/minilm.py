"""MiniLM sentence encoder as an ``nn.Module``.

Port of ``trie_semantic_search_tpu/models/minilm.py`` (``forward``/``encode``,
:178-293): BERT-family encoder, bf16 compute with f32 accumulation, f32
layer norm / softmax / tanh-GELU, a ``-1e9`` mask bias, masked mean (or
SIF-weighted) pooling and L2 normalisation. Parameters keep the JAX
package's layout — stacked per-layer tensors ``[L, ...]`` with ``[in, out]``
kernels — so :func:`params_from_jax` carries a JAX parameter tree across
unchanged and both packages compute the same function.

Numerics, site by site as the JAX code has them: every projection is a
bf16 product accumulated in f32 and rounded to bf16 once, plus a bf16 bias;
the attention scores and context are f32 sums of bf16 products.

Serving calls :meth:`MiniLM.encode` (``no_grad``); training calls the same
body, :meth:`MiniLM.sentence_embeddings`, inside :meth:`MiniLM.trainable`,
where the parameters require gradients (``models/train.py``).

Tensor parallelism (:func:`param_partition_specs`, :func:`split_params`,
:func:`join_params`, :func:`tp_sentence_embeddings`) splits the attention
heads and the FFN's intermediate dimension over the ``model`` axis of a
mesh, as the JAX package's ``param_partition_specs`` (:137-172 there) does:
each column computes its heads and its slice of the FFN, and the partial
sums of the attention output and of ``wo`` are added up before the
replicated biases. One layer function serves both: the unsplit model is
the case of one column.

:func:`load_hf_checkpoint` reads a local HuggingFace checkpoint into the
same layout, as the JAX package's loader does (:331-403 there).
:func:`count_token_ids` and :func:`sif_weights_from_counts` (numpy, :296-325
there) give the SIF pooling weights.

The JAX module's functional surface maps onto the module's methods here,
with no second, functional copy: ``init_params(rng, config)`` is
``MiniLM(config, seed=...)``, ``forward`` is :meth:`MiniLM.forward`,
``encode`` is :meth:`MiniLM.sentence_embeddings` (:meth:`MiniLM.encode`
without gradients), and a ``Params`` tree is the module's ``state_dict``
(:func:`params_from_jax` converts one). :func:`count_params` counts
either.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device


@dataclass(frozen=True)
class MiniLMConfig:
    """all-MiniLM-L6-v2 geometry (hidden 384 → 384-d embeddings)."""

    vocab_size: int = 30522
    hidden_size: int = 384
    num_layers: int = 6
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


MODEL_FAMILIES: dict[str, MiniLMConfig] = {
    "minilm-l6": MiniLMConfig(),
    "all-minilm-l6-v2": MiniLMConfig(),
    "legal-bert": MiniLMConfig(
        hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072
    ),
    "bert-base": MiniLMConfig(
        hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072
    ),
}


def config_for_model_type(model_type: str, vocab_size: int, max_position: int) -> MiniLMConfig:
    """Named model family → geometry (falls back to MiniLM)."""
    base = MODEL_FAMILIES.get(model_type.lower(), MiniLMConfig())
    return dataclasses.replace(base, vocab_size=vocab_size, max_position=max_position)


def param_shapes(c: MiniLMConfig) -> dict[str, dict[str, tuple[int, ...]]]:
    """The JAX parameter tree's shapes, by group and name."""
    H, I_, L = c.hidden_size, c.intermediate_size, c.num_layers
    return {
        "embeddings": {
            "word": (c.vocab_size, H),
            "position": (c.max_position, H),
            "token_type": (c.type_vocab_size, H),
            "ln_scale": (H,),
            "ln_bias": (H,),
        },
        "layers": {
            "q_kernel": (L, H, H), "q_bias": (L, H),
            "k_kernel": (L, H, H), "k_bias": (L, H),
            "v_kernel": (L, H, H), "v_bias": (L, H),
            "o_kernel": (L, H, H), "o_bias": (L, H),
            "attn_ln_scale": (L, H), "attn_ln_bias": (L, H),
            "wi_kernel": (L, H, I_), "wi_bias": (L, I_),
            "wo_kernel": (L, I_, H), "wo_bias": (L, H),
            "mlp_ln_scale": (L, H), "mlp_ln_bias": (L, H),
        },
    }


def params_from_jax(tree: Mapping[str, Mapping[str, np.ndarray]]) -> dict[str, torch.Tensor]:
    """A JAX parameter tree (``{"embeddings": {...}, "layers": {...}}`` of
    numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``) → a state dict
    for :class:`MiniLM` (keys ``"<group>.<name>"``, f32 CPU tensors)."""
    out = {}
    for group in ("embeddings", "layers"):
        for name, arr in tree[group].items():
            out[f"{group}.{name}"] = torch.from_numpy(np.array(arr, np.float32))
    return out


#: key prefixes a HuggingFace BERT/MiniLM state dict may carry
_HF_PREFIXES = ("", "bert.", "encoder.", "0.auto_model.")


def load_hf_checkpoint(path: str | Path, config: MiniLMConfig) -> Optional[dict[str, torch.Tensor]]:
    """A local HuggingFace BERT/MiniLM checkpoint (a directory holding
    ``model.safetensors`` or ``pytorch_model.bin``) as a :class:`MiniLM`
    state dict, or None when neither file is there. Port of the JAX
    package's ``load_hf_checkpoint``: the same key prefixes, and torch
    ``Linear`` weights (``[out, in]``) transposed to ``[in, out]`` kernels.
    Raises ``KeyError`` for a missing tensor and ``ValueError`` for one of
    the wrong shape."""
    path = Path(path)
    state: Optional[dict[str, np.ndarray]] = None
    if path.is_dir():
        st, pt = path / "model.safetensors", path / "pytorch_model.bin"
        if st.exists():
            from safetensors.numpy import load_file

            state = dict(load_file(str(st)))
        elif pt.exists():
            raw = torch.load(str(pt), map_location="cpu", weights_only=True)
            state = {k: v.numpy() for k, v in raw.items()}
    if state is None:
        return None

    def get(name: str) -> np.ndarray:
        for pre in _HF_PREFIXES:
            if pre + name in state:
                return state[pre + name]
        raise KeyError(name)

    def stacked(fmt: str, transpose: bool = False) -> np.ndarray:
        return np.stack([
            get(fmt.format(i)).T if transpose else get(fmt.format(i))
            for i in range(config.num_layers)
        ])

    A = "encoder.layer.{}.attention.self."
    AO = "encoder.layer.{}.attention.output."
    FF = "encoder.layer.{}."
    tree = {
        "embeddings": {
            "word": get("embeddings.word_embeddings.weight"),
            "position": get("embeddings.position_embeddings.weight"),
            "token_type": get("embeddings.token_type_embeddings.weight"),
            "ln_scale": get("embeddings.LayerNorm.weight"),
            "ln_bias": get("embeddings.LayerNorm.bias"),
        },
        "layers": {
            "q_kernel": stacked(A + "query.weight", True),
            "q_bias": stacked(A + "query.bias"),
            "k_kernel": stacked(A + "key.weight", True),
            "k_bias": stacked(A + "key.bias"),
            "v_kernel": stacked(A + "value.weight", True),
            "v_bias": stacked(A + "value.bias"),
            "o_kernel": stacked(AO + "dense.weight", True),
            "o_bias": stacked(AO + "dense.bias"),
            "attn_ln_scale": stacked(AO + "LayerNorm.weight"),
            "attn_ln_bias": stacked(AO + "LayerNorm.bias"),
            "wi_kernel": stacked(FF + "intermediate.dense.weight", True),
            "wi_bias": stacked(FF + "intermediate.dense.bias"),
            "wo_kernel": stacked(FF + "output.dense.weight", True),
            "wo_bias": stacked(FF + "output.dense.bias"),
            "mlp_ln_scale": stacked(FF + "output.LayerNorm.weight"),
            "mlp_ln_bias": stacked(FF + "output.LayerNorm.bias"),
        },
    }
    for group, shapes in param_shapes(config).items():
        for name, shape in shapes.items():
            if tuple(tree[group][name].shape) != tuple(shape):
                raise ValueError(
                    f"{group}.{name} has shape {tree[group][name].shape}, expected {shape}"
                )
    return params_from_jax(tree)


def _layer_norm(x: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    x = x.to(torch.float32)
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


#: the dim of each layer leaf that shards over ``model`` (JAX's
#: ``param_partition_specs``); every embedding leaf is replicated
_LAYER_SPLIT: dict[str, Optional[int]] = {
    "q_kernel": 2, "q_bias": 1, "k_kernel": 2, "k_bias": 1, "v_kernel": 2, "v_bias": 1,
    "o_kernel": 1, "o_bias": None, "attn_ln_scale": None, "attn_ln_bias": None,
    "wi_kernel": 2, "wi_bias": 1, "wo_kernel": 1, "wo_bias": None,
    "mlp_ln_scale": None, "mlp_ln_bias": None,
}


def param_partition_specs(config: MiniLMConfig) -> dict[str, dict[str, Optional[int]]]:
    """Tensor parallelism over the ``model`` mesh axis, per leaf of the JAX
    parameter tree: the dim that shards, or None (replicated). The q/k/v
    kernels and biases and ``wi`` shard their last (head or intermediate)
    dim, ``o_kernel`` and ``wo_kernel`` their input rows; embeddings, layer
    norms, ``o_bias`` and ``wo_bias`` replicate."""
    return {
        "embeddings": {name: None for name in param_shapes(config)["embeddings"]},
        "layers": dict(_LAYER_SPLIT),
    }


def split_dims(config: MiniLMConfig) -> dict[str, Optional[int]]:
    """:func:`param_partition_specs` by state-dict key (``"<group>.<name>"``)."""
    return {f"{g}.{n}": d for g, leaves in param_partition_specs(config).items() for n, d in leaves.items()}


def check_model_parallel(config: MiniLMConfig, mp: int) -> None:
    """Raise ``ValueError`` unless ``mp`` columns divide the heads and the
    FFN's intermediate size (each column holds whole heads)."""
    if mp < 1 or config.num_heads % mp or config.intermediate_size % mp:
        raise ValueError(f"model_parallel {mp} must divide the {config.num_heads} heads and the "
                         f"intermediate size {config.intermediate_size}")


def split_params(state: Mapping[str, torch.Tensor], config: MiniLMConfig, mp: int) -> list[dict[str, torch.Tensor]]:
    """A full state dict → ``mp`` column state dicts: a sharded leaf's
    ``c``-th of ``mp`` equal slices along its split dim (a view) in column
    ``c``; a replicated leaf whole, the same tensor, in every column."""
    check_model_parallel(config, mp)
    dims = split_dims(config)
    out: list[dict[str, torch.Tensor]] = [{} for _ in range(mp)]
    for key, t in state.items():
        d = dims[key]
        parts = [t] * mp if d is None else list(torch.chunk(t, mp, dim=d))
        for c in range(mp):
            out[c][key] = parts[c]
    return out


def join_params(columns: Sequence[Mapping[str, torch.Tensor]], config: MiniLMConfig) -> dict[str, torch.Tensor]:
    """The inverse of :func:`split_params` on column 0's device: sharded
    leaves concatenated along their split dim, replicated leaves from
    column 0 (the other columns may leave them out)."""
    dims = split_dims(config)
    out = {}
    for key, t in columns[0].items():
        d = dims[key]
        out[key] = t if d is None else torch.cat([col[key].to(t.device) for col in columns], dim=d)
    return out


def _embed_tokens(emb: Mapping[str, torch.Tensor], config: MiniLMConfig, compute_dtype: torch.dtype,
                  input_ids: torch.Tensor, attention_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The embedding stage: ``(hidden [B, L, H] at compute_dtype, mask
    bias [B, 1, 1, L])``."""
    from ..ops.scan_kernels import exact_float32

    exact_float32()
    L = input_ids.shape[1]
    pos = torch.arange(L, device=input_ids.device)
    hidden = emb["word"][input_ids.long()] + emb["position"][pos][None] + emb["token_type"][0][None, None]
    hidden = _layer_norm(hidden, emb["ln_scale"], emb["ln_bias"], config.layer_norm_eps)
    mask_bias = (1.0 - attention_mask.to(torch.float32))[:, None, None, :] * -1e9
    return hidden.to(compute_dtype), mask_bias


def _encoder_layer(columns: Sequence[Mapping[str, torch.Tensor]], hidden: torch.Tensor,
                   mask_bias: torch.Tensor, config: MiniLMConfig) -> torch.Tensor:
    """One encoder layer over model columns: ``columns[c]`` holds column
    ``c``'s slices of the layer's sharded leaves (on its device) and column
    0 also the replicated ones; ``hidden`` lies on column 0's device, where
    the columns' partial sums meet. Every projection is a product at
    ``hidden``'s dtype plus a bias at that dtype; attention in f32."""
    home = hidden.device
    B, Lq = hidden.shape[:2]
    hd = config.head_dim
    f32 = torch.float32
    dt = hidden.dtype

    def proj(x, kernel, bias):
        return torch.matmul(x, kernel.to(dt)) + bias.to(dt)

    def reduced(partials: list) -> torch.Tensor:
        total = partials[0]
        for p in partials[1:]:
            total = total + p.to(home)
        return total

    lp0 = columns[0]
    attn_parts, mlp_in = [], []
    for lp in columns:
        h = hidden.to(lp["q_kernel"].device)
        nh = lp["q_kernel"].shape[-1] // hd
        q = proj(h, lp["q_kernel"], lp["q_bias"]).reshape(B, Lq, nh, hd)
        k = proj(h, lp["k_kernel"], lp["k_bias"]).reshape(B, Lq, nh, hd)
        v = proj(h, lp["v_kernel"], lp["v_bias"]).reshape(B, Lq, nh, hd)
        scores = torch.einsum("bqnd,bknd->bnqk", q.to(f32), k.to(f32))
        scores = scores / math.sqrt(hd) + mask_bias.to(h.device)
        probs = torch.softmax(scores, dim=-1).to(dt)
        ctx = torch.einsum("bnqk,bknd->bqnd", probs.to(f32), v.to(f32)).to(dt)
        attn_parts.append(torch.matmul(ctx.reshape(B, Lq, nh * hd), lp["o_kernel"].to(dt)))
    attn_out = reduced(attn_parts) + lp0["o_bias"].to(dt)
    hidden = _layer_norm(
        hidden.to(f32) + attn_out.to(f32), lp0["attn_ln_scale"], lp0["attn_ln_bias"],
        config.layer_norm_eps,
    ).to(dt)
    for lp in columns:
        h = hidden.to(lp["wi_kernel"].device)
        inter = proj(h, lp["wi_kernel"], lp["wi_bias"])
        inter = torch.nn.functional.gelu(inter.to(f32), approximate="tanh").to(dt)
        mlp_in.append(torch.matmul(inter, lp["wo_kernel"].to(dt)))
    mlp_out = reduced(mlp_in) + lp0["wo_bias"].to(dt)
    return _layer_norm(
        hidden.to(f32) + mlp_out.to(f32), lp0["mlp_ln_scale"], lp0["mlp_ln_bias"],
        config.layer_norm_eps,
    ).to(dt)


def _pool(hidden: torch.Tensor, input_ids: torch.Tensor, attention_mask: torch.Tensor,
          token_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked mean pool (SIF-weighted with ``token_weights [vocab]``) of f32
    hidden states, then L2 normalise → ``[B, H]``."""
    mask = attention_mask.to(torch.float32)
    if token_weights is not None:
        mask = mask * token_weights.to(torch.float32)[input_ids.long()]
    mask = mask[:, :, None]
    summed = (hidden * mask).sum(dim=1)
    counts = torch.clamp(mask.sum(dim=1), min=1e-9)
    pooled = summed / counts
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / torch.clamp(norm, min=1e-12)


def tp_sentence_embeddings(
    columns: Sequence[Mapping[str, torch.Tensor]],
    config: MiniLMConfig,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """:meth:`MiniLM.sentence_embeddings` (mean pooling) with the model
    axis split over ``columns`` (:func:`split_params`, each column on its
    device; column 0 holds the replicated leaves and the inputs lie on its
    device): ``[B, H]`` f32 on column 0's device, with gradients where the
    columns' tensors require them. One column computes what the model does."""
    emb = {k.split(".", 1)[1]: t for k, t in columns[0].items() if k.startswith("embeddings.")}
    hidden, mask_bias = _embed_tokens(emb, config, compute_dtype, input_ids, attention_mask)
    names = [k for k in columns[0] if k.startswith("layers.")]
    for i in range(config.num_layers):
        layer = [{k.split(".", 1)[1]: col[k][i] for k in names if k in col} for col in columns]
        hidden = _encoder_layer(layer, hidden, mask_bias, config)
    return _pool(hidden.to(torch.float32), input_ids, attention_mask)


class MiniLM(nn.Module):
    """The encoder; parameters in the JAX package's stacked layout."""

    def __init__(
        self,
        config: MiniLMConfig = MiniLMConfig(),
        device: DeviceLike = None,
        seed: int = 0,
        compute_dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.config = config
        self.compute_dtype = compute_dtype
        dev = resolve_device(device)
        # seeded BERT-style init: truncated normal (±2 std), std 0.02, for
        # kernels and embeddings; unit layer-norm scales; zero biases
        g = torch.Generator(device="cpu").manual_seed(seed)
        self.embeddings = nn.ParameterDict()
        self.layers = nn.ParameterDict()
        for group, shapes in param_shapes(config).items():
            target = self.embeddings if group == "embeddings" else self.layers
            for name, shape in shapes.items():
                if "ln_scale" in name:
                    t = torch.ones(shape)
                elif "bias" in name:
                    t = torch.zeros(shape)
                else:
                    t = torch.empty(shape)
                    nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=g)
                target[name] = nn.Parameter(t.to(dev), requires_grad=False)

    def load_params(self, state: Mapping[str, torch.Tensor]) -> "MiniLM":
        """Load a :func:`params_from_jax` state dict (shapes checked)."""
        self.load_state_dict({k: v.to(torch.float32) for k, v in state.items()})
        return self

    def hidden_states(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """Token-level hidden states ``[B, L, H]`` (f32), recorded for
        autograd where a parameter requires gradients (training);
        :meth:`forward` is the same under ``no_grad``."""
        hidden, mask_bias = _embed_tokens(self.embeddings, self.config, self.compute_dtype,
                                          input_ids, attention_mask)
        for i in range(self.config.num_layers):
            layer = {name: p[i] for name, p in self.layers.items()}
            hidden = _encoder_layer([layer], hidden, mask_bias, self.config)
        return hidden.to(torch.float32)

    def sentence_embeddings(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
        token_weights: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Sentence embeddings ``[B, H]``: masked mean pool (SIF-weighted
        when ``token_weights [vocab]`` is given), then L2 normalise; with
        gradients as :meth:`hidden_states` has them. :meth:`encode` is the
        same under ``no_grad``."""
        return _pool(self.hidden_states(input_ids, attention_mask), input_ids, attention_mask,
                     token_weights)

    @torch.no_grad()
    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """Token-level hidden states ``[B, L, H]`` (f32), without gradients."""
        return self.hidden_states(input_ids, attention_mask)

    @torch.no_grad()
    def encode(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
        token_weights: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Sentence embeddings ``[B, H]`` for serving, without gradients."""
        return self.sentence_embeddings(input_ids, attention_mask, token_weights)

    def leaves(self) -> list[tuple[str, nn.Parameter]]:
        """``(key, parameter)`` in the JAX package's tree-flatten order of
        the parameter tree (groups, then names, each sorted): the order of
        ``params.npz`` and of the optimizer state's leaves."""
        params = dict(self.named_parameters())
        return [(k, params[k]) for k in leaf_keys(self.config)]

    @contextlib.contextmanager
    def trainable(self):
        """Parameters require gradients inside the block and not after it."""
        for p in self.parameters():
            p.requires_grad_(True)
        try:
            yield self
        finally:
            for p in self.parameters():
                p.requires_grad_(False)
                p.grad = None


def count_params(params: "MiniLM | Mapping[str, torch.Tensor]") -> int:
    """Number of parameters of a model or of its ``state_dict``."""
    tensors = params.state_dict().values() if isinstance(params, nn.Module) else params.values()
    return sum(int(t.numel()) for t in tensors)


def leaf_keys(c: MiniLMConfig) -> list[str]:
    """State-dict keys in the JAX parameter tree's flatten order."""
    shapes = param_shapes(c)
    return [f"{g}.{n}" for g in sorted(shapes) for n in sorted(shapes[g])]


def sif_weights_from_counts(counts: np.ndarray, a: float = 1e-3) -> np.ndarray:
    """Smoothed-inverse-frequency pooling weights ``a / (a + p(t))`` from
    corpus token-id counts, ``p(t)`` the token's corpus probability; all 1.0
    when nothing was counted. ``[vocab]`` f32 (the scale does not matter:
    the weighted mean divides by the weights' sum)."""
    counts = np.asarray(counts, np.float64)
    total = counts.sum()
    if total <= 0:
        return np.ones(counts.shape, np.float32)
    p = counts / total
    return (a / (a + p)).astype(np.float32)


def count_token_ids(tokenizer, texts, vocab_size: int, max_len: int = 512) -> np.ndarray:
    """Token-id counts over ``texts`` (any iterable), tokenized on the host
    and truncated at ``max_len``: the input of :func:`sif_weights_from_counts`."""
    counts = np.zeros(vocab_size, np.int64)
    for t in texts:
        ids, mask = tokenizer.encode(t, max_len)
        n = int(np.sum(mask))
        np.add.at(counts, np.asarray(ids[:n], np.int64), 1)
    return counts
