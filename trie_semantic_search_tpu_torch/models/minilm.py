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

:func:`load_hf_checkpoint` reads a local HuggingFace checkpoint into the
same layout, as the JAX package's loader does (:331-403 there).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Mapping, Optional

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

    def _proj(self, x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        return torch.matmul(x, kernel.to(dt)) + bias.to(dt)

    def _encoder_layer(self, hidden: torch.Tensor, mask_bias: torch.Tensor, i: int) -> torch.Tensor:
        c = self.config
        lp = {name: p[i] for name, p in self.layers.items()}
        B, Lq, H = hidden.shape
        nh, hd = c.num_heads, c.head_dim
        f32 = torch.float32
        q = self._proj(hidden, lp["q_kernel"], lp["q_bias"]).reshape(B, Lq, nh, hd)
        k = self._proj(hidden, lp["k_kernel"], lp["k_bias"]).reshape(B, Lq, nh, hd)
        v = self._proj(hidden, lp["v_kernel"], lp["v_bias"]).reshape(B, Lq, nh, hd)
        scores = torch.einsum("bqnd,bknd->bnqk", q.to(f32), k.to(f32))
        scores = scores / math.sqrt(hd) + mask_bias
        probs = torch.softmax(scores, dim=-1).to(hidden.dtype)
        ctx = torch.einsum("bnqk,bknd->bqnd", probs.to(f32), v.to(f32)).to(hidden.dtype)
        attn_out = self._proj(ctx.reshape(B, Lq, H), lp["o_kernel"], lp["o_bias"])
        hidden = _layer_norm(
            hidden.to(f32) + attn_out.to(f32), lp["attn_ln_scale"],
            lp["attn_ln_bias"], c.layer_norm_eps,
        ).to(hidden.dtype)
        inter = self._proj(hidden, lp["wi_kernel"], lp["wi_bias"])
        inter = torch.nn.functional.gelu(inter.to(f32), approximate="tanh").to(hidden.dtype)
        mlp_out = self._proj(inter, lp["wo_kernel"], lp["wo_bias"])
        return _layer_norm(
            hidden.to(f32) + mlp_out.to(f32), lp["mlp_ln_scale"],
            lp["mlp_ln_bias"], c.layer_norm_eps,
        ).to(hidden.dtype)

    @torch.no_grad()
    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """Token-level hidden states ``[B, L, H]`` (f32)."""
        from ..ops.scan_kernels import exact_float32

        exact_float32()
        c = self.config
        emb = self.embeddings
        L = input_ids.shape[1]
        pos = torch.arange(L, device=input_ids.device)
        hidden = emb["word"][input_ids.long()] + emb["position"][pos][None] + emb["token_type"][0][None, None]
        hidden = _layer_norm(hidden, emb["ln_scale"], emb["ln_bias"], c.layer_norm_eps)
        hidden = hidden.to(self.compute_dtype)
        mask_bias = (1.0 - attention_mask.to(torch.float32))[:, None, None, :] * -1e9
        for i in range(c.num_layers):
            hidden = self._encoder_layer(hidden, mask_bias, i)
        return hidden.to(torch.float32)

    @torch.no_grad()
    def encode(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
        token_weights: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Sentence embeddings ``[B, H]``: masked mean pool (SIF-weighted
        when ``token_weights [vocab]`` is given), then L2 normalise."""
        hidden = self.forward(input_ids, attention_mask)
        mask = attention_mask.to(torch.float32)
        if token_weights is not None:
            mask = mask * token_weights.to(torch.float32)[input_ids.long()]
        mask = mask[:, :, None]
        summed = (hidden * mask).sum(dim=1)
        counts = torch.clamp(mask.sum(dim=1), min=1e-9)
        pooled = summed / counts
        norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        return pooled / torch.clamp(norm, min=1e-12)
