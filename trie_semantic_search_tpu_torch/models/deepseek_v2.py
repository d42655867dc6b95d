"""DeepSeek-V2 as a sentence encoder built from a decoder.

The layer equations are the published ``modeling_deepseek.py`` of
DeepSeek-V2 (deepseek-ai/DeepSeek-V2-Lite): pre-norm RMSNorm layers of
multi-head latent attention (MLA) and a feed-forward part, dense in the
first ``first_k_dense_replace`` layers and a mixture of experts after.

- MLA without a query LoRA: ``q_proj`` H → heads × (nope + rope); the
  compressed KV ``kv_a_proj_with_mqa`` H → ``kv_lora_rank`` + rope, RMSNorm
  on its first part, ``kv_b_proj`` → heads × (nope + v); one rope key
  shared by every head; YaRN rotary frequencies (:func:`yarn_inv_freq`),
  applied to the de-interleaved pairs as the published code does; causal
  softmax at ``q_head_dim^-0.5 · mscale²`` (:func:`softmax_scale`);
  ``o_proj`` heads × v → H.
- The MoE: a softmax router over the routed experts in f32 (fed the normed
  state before its rounding to bf16, one step above the published code's
  bf16 input), greedy top-k,
  no renormalisation, times ``routed_scaling_factor``; SiLU-gated experts;
  the shared experts as one FFN of ``n_shared_experts`` × the expert width,
  added for every token.
- Used as an embedding model the way e5-mistral and gte-Qwen2 use a
  decoder: causal attention over the query, the final-normed state of its
  last real token (the ``[SEP]`` WordPiece appends, where those models
  append an EOS), L2-normalised. No output head.

Serving runs :meth:`DeepseekV2.encode`: weights and products in bf16 with
f32 accumulation, the residual stream, norms and rotary in f32, attention
as one fused ``scaled_dot_product_attention`` (f32 softmax inside).
Padding never reaches a product: the batch's real tokens are packed
(right padding, so position = column) and every projection, the router and
the experts run on them alone; only the attention runs on the padded
``[B, heads, L, d]`` grid, where causality keeps each real token's keys
real. The routed experts run as grouped products
(:mod:`..ops.moe`), and nothing in the forward waits for the device.

Tracing (``core/metrics``): the ranges ``encoder.attention``,
``encoder.router``, ``encoder.experts`` and ``encoder.shared`` per layer
while a ``torch.profiler`` records the thread; the counters ``moe.tokens``
and ``moe.assignments``; and per forward a device vector (the busiest
expert's tokens ÷ the mean, averaged over the MoE layers, and the experts
that got no token) that the caller reads with the embedding's own copy to
the host (:meth:`DeepseekV2.take_stats`, :meth:`DeepseekV2.observe_stats`).

Not done yet: loading a published checkpoint. The weights are a seeded
init here, or the benchmark's draw (``benchmark/encoders/deepseek-v2.py``)
copied in through :meth:`DeepseekV2.named_parameters`.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core.metrics import metrics
from ..device import DeviceLike, resolve_device
from ..ops.moe import grouped_expert_ffn, route_groups


@dataclass(frozen=True)
class DeepseekV2Config:
    """DeepSeek-V2-Lite's published geometry (its ``config.json``)."""

    vocab_size: int = 102400
    hidden_size: int = 2048
    num_hidden_layers: int = 27
    first_k_dense_replace: int = 1
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0
    rope_factor: float = 40.0
    rope_original_max_position: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    rms_norm_eps: float = 1e-6
    max_position_embeddings: int = 163840

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def n_moe_layers(self) -> int:
        return self.num_hidden_layers - self.first_k_dense_replace

    @classmethod
    def from_published(cls, c: dict) -> "DeepseekV2Config":
        """The geometry from a published ``config.json``'s keys (the rope
        group under ``rope_scaling``); refuses what this module does not
        compute: a query LoRA, other scoring, top-k methods or layer
        frequencies."""
        if c.get("q_lora_rank") is not None:
            raise ValueError("a query LoRA (q_lora_rank) is not implemented")
        for key, want in (("scoring_func", "softmax"), ("topk_method", "greedy"), ("moe_layer_freq", 1),
                          ("hidden_act", "silu")):
            if c.get(key, want) != want:
                raise ValueError(f"{key}={c[key]!r} is not implemented (only {want!r})")
        rs = c.get("rope_scaling") or {}
        if rs and rs.get("type") != "yarn":
            raise ValueError(f"rope_scaling type {rs.get('type')!r} is not implemented (only 'yarn')")
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: c[k] for k in names if k in c}
        kw.update(rope_factor=rs.get("factor", 1.0), rope_original_max_position=rs.get(
            "original_max_position_embeddings", c.get("max_position_embeddings", 4096)),
            rope_beta_fast=rs.get("beta_fast", 32), rope_beta_slow=rs.get("beta_slow", 1),
            rope_mscale=rs.get("mscale", 1.0), rope_mscale_all_dim=rs.get("mscale_all_dim", 0.0))
        return cls(**kw)


#: the model types ``Embedder`` builds this module for (beside
#: ``minilm.MODEL_FAMILIES``)
MODEL_TYPES: dict[str, DeepseekV2Config] = {"deepseek-v2-lite": DeepseekV2Config()}


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def softmax_scale(c: DeepseekV2Config) -> float:
    """``q_head_dim^-0.5``, times ``mscale²`` under YaRN with
    ``mscale_all_dim``."""
    s = c.q_head_dim ** -0.5
    if c.rope_factor > 1 and c.rope_mscale_all_dim:
        m = yarn_mscale(c.rope_factor, c.rope_mscale_all_dim)
        s *= m * m
    return s


def yarn_inv_freq(c: DeepseekV2Config) -> torch.Tensor:
    """``[rope_dim / 2]`` f32 (computed in f64): YaRN's blend of the plain
    and the ``factor``-scaled inverse frequencies over a linear ramp between
    the correction dimensions of ``beta_fast`` and ``beta_slow``."""
    dim, base = c.qk_rope_head_dim, c.rope_theta
    exps = torch.arange(0, dim, 2, dtype=torch.float64) / dim
    extra = 1.0 / base ** exps
    if c.rope_factor <= 1:
        return extra.float()
    inter = 1.0 / (c.rope_factor * base ** exps)

    def corr(rot: float) -> float:
        return dim * math.log(c.rope_original_max_position / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr(c.rope_beta_fast)), 0)
    high = min(math.ceil(corr(c.rope_beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - low) / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    return (inter * (1 - mask) + extra * mask).float()


def rope_cos_sin(c: DeepseekV2Config, positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin)`` ``[n, rope_dim]`` f32 at ``positions``, scaled by
    ``mscale / mscale_all_dim`` (1 for DeepSeek-V2-Lite)."""
    inv = yarn_inv_freq(c).to(positions.device)
    freqs = positions.to(torch.float32)[:, None] * inv[None]
    emb = torch.cat([freqs, freqs], dim=-1)
    m = yarn_mscale(c.rope_factor, c.rope_mscale) / yarn_mscale(c.rope_factor, c.rope_mscale_all_dim) \
        if c.rope_mscale_all_dim else 1.0
    return emb.cos() * m, emb.sin() * m


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The published rotary: the interleaved pairs of the last axis are
    de-interleaved, then ``x cos + rotate_half(x) sin``; ``cos``/``sin``
    broadcast over the axes between the token axis (first) and the last."""
    d = x.shape[-1]
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)
    shape = (cos.shape[0],) + (1,) * (x.dim() - 2) + (d,)
    x1, x2 = x[..., : d // 2], x[..., d // 2 :]
    return x * cos.reshape(shape) + torch.cat([-x2, x1], dim=-1) * sin.reshape(shape)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 RMSNorm of ``x`` times ``weight`` (f32 out)."""
    return torch.nn.functional.rms_norm(x.float(), (x.shape[-1],), weight.float(), eps)


def param_shapes(c: DeepseekV2Config) -> dict[str, tuple[int, ...]]:
    """Every parameter's name (as :meth:`DeepseekV2.named_parameters`
    gives it) and shape, in draw order. Projections are ``[in, out]``."""
    H, nh = c.hidden_size, c.num_attention_heads
    out = {"embed_tokens": (c.vocab_size, H)}
    for i in range(c.num_hidden_layers):
        p = f"layers.{i}."
        out |= {p + "input_layernorm": (H,), p + "q_proj": (H, nh * c.q_head_dim),
                p + "kv_a_proj_with_mqa": (H, c.kv_lora_rank + c.qk_rope_head_dim),
                p + "kv_a_layernorm": (c.kv_lora_rank,),
                p + "kv_b_proj": (c.kv_lora_rank, nh * (c.qk_nope_head_dim + c.v_head_dim)),
                p + "o_proj": (nh * c.v_head_dim, H), p + "post_attention_layernorm": (H,)}
        if i < c.first_k_dense_replace:
            I_ = c.intermediate_size
            out |= {p + "gate_proj": (H, I_), p + "up_proj": (H, I_), p + "down_proj": (I_, H)}
        else:
            E, F, S = c.n_routed_experts, c.moe_intermediate_size, c.moe_intermediate_size * c.n_shared_experts
            out |= {p + "router": (H, E), p + "experts_gate_proj": (E, H, F), p + "experts_up_proj": (E, H, F),
                    p + "experts_down_proj": (E, F, H), p + "shared_gate_proj": (H, S),
                    p + "shared_up_proj": (H, S), p + "shared_down_proj": (S, H)}
    out["norm"] = (H,)
    return out


def is_norm(name: str) -> bool:
    return name.endswith("layernorm") or name == "norm"


class DeepseekV2Layer(nn.Module):
    """One decoder layer's parameters (dense or MoE by its index)."""

    def __init__(self, c: DeepseekV2Config, index: int, shapes: dict, dtype, device):
        super().__init__()
        self.moe = index >= c.first_k_dense_replace
        prefix = f"layers.{index}."
        for name, shape in shapes.items():
            if name.startswith(prefix):
                # norms and the router stay f32 (the router runs in f32)
                leaf = name[len(prefix):]
                t = torch.empty(shape, dtype=torch.float32 if is_norm(leaf) or leaf == "router" else dtype,
                                device=device)
                self.register_parameter(leaf, nn.Parameter(t, requires_grad=False))


class DeepseekV2(nn.Module):
    """The encoder. ``seed`` draws a seeded init (N(0, 1) embeddings,
    N(0, 1/fan-in) projections, unit norms); ``seed=None`` leaves the
    parameters unset for a caller that copies weights in."""

    #: :meth:`encode` takes ``real_tokens``, the mask's sum, which a caller
    #: that built the mask on the host passes so that nothing waits
    packs_tokens = True

    def __init__(self, config: DeepseekV2Config = DeepseekV2Config(), device: DeviceLike = None,
                 seed: Optional[int] = 0, compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.config = c = config
        self.compute_dtype = compute_dtype
        dev = resolve_device(device)
        shapes = param_shapes(c)
        self.embed_tokens = nn.Parameter(torch.empty(shapes["embed_tokens"], dtype=compute_dtype, device=dev),
                                         requires_grad=False)
        self.layers = nn.ModuleList(DeepseekV2Layer(c, i, shapes, compute_dtype, dev)
                                    for i in range(c.num_hidden_layers))
        self.norm = nn.Parameter(torch.empty(shapes["norm"], device=dev), requires_grad=False)
        self._stats: Optional[torch.Tensor] = None
        if seed is not None:
            g = torch.Generator(device=dev).manual_seed(seed)
            with torch.no_grad():
                for name, p in self.named_parameters():
                    if is_norm(name.rsplit(".", 1)[-1]):
                        p.fill_(1.0)
                    else:
                        t = torch.randn(p.shape, generator=g, device=dev)
                        p.copy_(t if name == "embed_tokens" else t / math.sqrt(p.shape[-2]))

    # -- the forward ---------------------------------------------------------

    def _attention(self, lp: DeepseekV2Layer, x, cos, sin, pos_flat, B: int, L: int) -> torch.Tensor:
        c, dt = self.config, self.compute_dtype
        n, nh = x.shape[0], c.num_attention_heads
        nope, rope, vd = c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim
        q = (x @ lp.q_proj).view(n, nh, c.q_head_dim)
        ckv = x @ lp.kv_a_proj_with_mqa
        kv = (rms_norm(ckv[:, : c.kv_lora_rank], lp.kv_a_layernorm, c.rms_norm_eps).to(dt)
              @ lp.kv_b_proj).view(n, nh, nope + vd)
        q_pe = apply_rope(q[..., nope:].float(), cos, sin).to(dt)
        k_pe = apply_rope(ckv[:, c.kv_lora_rank:].float(), cos, sin).to(dt)
        # the padded [B, heads, L, d] grids, written at the real tokens only;
        # v padded with zeros to the q/k width, which one fused attention
        # kernel needs
        qd = c.q_head_dim

        def grid(rows):
            g = torch.zeros((B * L, nh, qd), dtype=dt, device=x.device)
            g[pos_flat, :, : rows.shape[-1]] = rows
            return g.view(B, L, nh, qd).transpose(1, 2)

        ctx = torch.nn.functional.scaled_dot_product_attention(
            grid(torch.cat([q[..., :nope], q_pe], dim=-1)),
            grid(torch.cat([kv[..., :nope], k_pe[:, None].expand(n, nh, rope)], dim=-1)),
            grid(kv[..., nope:]), is_causal=True, scale=softmax_scale(c))
        ctx = ctx.transpose(1, 2).reshape(B * L, nh, qd)[pos_flat, :, :vd]
        return (ctx.reshape(n, nh * vd) @ lp.o_proj).float()

    def _moe(self, lp: DeepseekV2Layer, x32, counts_out) -> torch.Tensor:
        c = self.config
        x = x32.to(self.compute_dtype)
        with metrics.profile_range("encoder.router"):
            # the router takes the normed state before its rounding
            probs = torch.softmax(x32 @ lp.router, dim=-1)
            weight, idx = torch.topk(probs, c.num_experts_per_tok, dim=-1)
            if c.norm_topk_prob:
                weight = weight / weight.sum(dim=-1, keepdim=True)
            weight = weight * c.routed_scaling_factor
            order, counts = route_groups(idx, c.n_routed_experts)
            counts_out.copy_(counts)
        with metrics.profile_range("encoder.experts"):
            y = grouped_expert_ffn(x, idx, weight, lp.experts_gate_proj, lp.experts_up_proj,
                                   lp.experts_down_proj, order, counts)
        with metrics.profile_range("encoder.shared"):
            s = self._ffn(x, lp.shared_gate_proj, lp.shared_up_proj, lp.shared_down_proj)
        return y + s

    @staticmethod
    def _ffn(x, gate, up, down) -> torch.Tensor:
        """A SiLU-gated FFN at the compute dtype, rounding where the
        published code does: each projection's output, the activation and
        the gated product."""
        return (torch.nn.functional.silu(x @ gate) * (x @ up)) @ down

    @torch.no_grad()
    def encode(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
               token_weights: Optional[torch.Tensor] = None, real_tokens: Optional[int] = None) -> torch.Tensor:
        """``[B, H]`` f32, L2-normalised: the final-normed state of each
        row's last real token. Rows are right-padded (``attention_mask`` 1
        then 0); a row with no real token gives a row of zeros.
        ``token_weights`` (SIF pooling) does not apply to last-token
        pooling and is ignored. ``real_tokens``: the mask's sum; without it
        the module reads it from the mask (a sync on a card)."""
        c, dt = self.config, self.compute_dtype
        B, L = input_ids.shape
        dev = input_ids.device
        n = int(attention_mask.sum()) if real_tokens is None else int(real_tokens)
        if n == 0:
            return torch.zeros((B, c.hidden_size), device=dev)
        # packed index → flat (row, column) of each real token, in order
        pos_flat = torch.argsort((attention_mask.reshape(-1) == 0).to(torch.uint8), stable=True)[:n]
        cos, sin = rope_cos_sin(c, pos_flat % L)
        h = self.embed_tokens[input_ids.reshape(-1)[pos_flat].long()].float()
        # each MoE layer's tokens per expert, for the forward's statistics
        counts = torch.empty((c.n_moe_layers, c.n_routed_experts), dtype=torch.int64, device=dev)
        for i, lp in enumerate(self.layers):
            x = rms_norm(h, lp.input_layernorm, c.rms_norm_eps).to(dt)
            with metrics.profile_range("encoder.attention"):
                h = h + self._attention(lp, x, cos, sin, pos_flat, B, L)
            x = rms_norm(h, lp.post_attention_layernorm, c.rms_norm_eps)
            if lp.moe:
                h = h + self._moe(lp, x, counts[i - c.first_k_dense_replace])
            else:
                h = h + self._ffn(x.to(dt), lp.gate_proj, lp.up_proj, lp.down_proj).float()
        lengths = attention_mask.sum(dim=1)
        last = (torch.cumsum(lengths, 0) - 1).clamp(min=0)
        out = rms_norm(h[last], self.norm, c.rms_norm_eps)
        out = out / out.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        out = torch.where((lengths > 0)[:, None], out, torch.zeros_like(out))
        if c.n_moe_layers:
            busiest = (counts.amax(dim=1) * c.n_routed_experts).float() / (n * c.num_experts_per_tok)
            self._stats = torch.stack([busiest.mean(), (counts == 0).sum().float()])
            metrics.inc("moe.tokens", n * c.n_moe_layers)
            metrics.inc("moe.assignments", n * c.num_experts_per_tok * c.n_moe_layers)
        return out

    # -- the forward's device statistics ------------------------------------

    def take_stats(self) -> Optional[torch.Tensor]:
        """The last forward's device vector (the busiest expert's tokens ÷
        the mean, averaged over the MoE layers; the (layer, expert) pairs
        with no token), once; None without a forward since."""
        s, self._stats = self._stats, None
        return s

    @staticmethod
    def observe_stats(values: np.ndarray) -> None:
        """Record :meth:`take_stats`'s values, read on the host: the
        ``moe.expert_load`` observation (``MetricsRegistry.between`` gives it
        over a stretch) and the ``moe.idle_experts`` counter."""
        metrics.histogram("moe.expert_load").observe(float(values[0]))
        metrics.inc("moe.idle_experts", int(values[1]))
