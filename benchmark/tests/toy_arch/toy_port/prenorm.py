"""The serving side of the toy pre-norm encoder, as a port module would
hold it: products in bf16 with f32 accumulation, layer norms, softmax and
the residual stream in f32, ``scaled_dot_product_attention`` with a causal
and padding mask, the last real token pooled. ``Embedder(model=...)`` reads
``config.hidden_size`` and calls ``encode(ids, mask, token_weights)``."""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn


class PrenormEncoder(nn.Module):
    def __init__(self, enc: dict, weights: dict):
        super().__init__()
        self.config = SimpleNamespace(hidden_size=enc["hidden_size"])
        self.heads, self.layers, self.eps = enc["num_attention_heads"], enc["num_hidden_layers"], enc["layer_norm_eps"]
        self.w = nn.ParameterDict({k.replace(".", "__"): nn.Parameter(v.clone(), requires_grad=False)
                                   for k, v in weights.items()})

    def p(self, key: str, i: int | None = None):
        t = self.w[key.replace(".", "__")]
        return t if i is None else t[i]

    def linear(self, x, i: int, name: str):
        out = x.to(torch.bfloat16) @ self.p(f"layers.{name}_kernel", i).to(torch.bfloat16)
        return out.float() + self.p(f"layers.{name}_bias", i)

    def layer(self, i: int, h, allowed):
        B, L, H = h.shape
        x = F.layer_norm(h, (H,), self.p("layers.ln1_scale", i), self.p("layers.ln1_bias", i), self.eps)
        q, k, v = (self.linear(x, i, n).reshape(B, L, self.heads, -1).transpose(1, 2).to(torch.bfloat16)
                   for n in "qkv")
        ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=allowed)
        h = h + self.linear(ctx.transpose(1, 2).reshape(B, L, H).float(), i, "o")
        x = F.layer_norm(h, (H,), self.p("layers.ln2_scale", i), self.p("layers.ln2_bias", i), self.eps)
        return h + self.linear(F.gelu(self.linear(x, i, "wi"), approximate="tanh"), i, "wo")

    @torch.no_grad()
    def encode(self, input_ids, attention_mask, token_weights=None):
        B, L = input_ids.shape
        ids = input_ids.long()
        h = self.p("embed.word")[ids] + self.p("embed.position")[:L][None]
        causal = torch.ones((L, L), dtype=torch.bool, device=ids.device).tril()
        real = attention_mask.bool()
        # the diagonal keeps the rows of an all-padding sequence (the
        # batch's padding to its bucket) from being empty
        allowed = (causal[None] & real[:, None, :]) | torch.eye(L, dtype=torch.bool, device=ids.device)[None]
        allowed = allowed[:, None]
        for i in range(self.layers):
            h = self.layer(i, h, allowed)
        h = F.layer_norm(h, (h.shape[-1],), self.p("final.ln_scale"), self.p("final.ln_bias"), self.eps)
        last = h[torch.arange(B, device=ids.device), (real.sum(1) - 1).clamp(min=0)]
        return F.normalize(last, dim=-1)
