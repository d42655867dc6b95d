"""A toy decoder-style encoder (a test's architecture, not a model anyone
serves): BERT's block made pre-norm (a layer norm before the attention and
before the FFN, one more after the last layer), causal self-attention, a
tanh-GELU FFN, the last real token's hidden state as the embedding, L2
normalisation. Float32 with TF32 off; ``precision="fp8"`` rounds every
kernel per output column and every hidden state per row to float8 e4m3."""

from __future__ import annotations

import math

from . import encode_batches, fp8


def _ln(torch, x, scale, bias, eps: float):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


def _forward(torch, w: dict, enc: dict, ids, mask, precision: str):
    F = torch.nn.functional
    H, nh, eps = enc["hidden_size"], enc["num_attention_heads"], enc["layer_norm_eps"]
    hd = H // nh
    B, L = ids.shape

    def r(x):
        return fp8(torch, x, -1) if precision == "fp8" else x

    def linear(x, kernel, bias):
        return r(x @ (fp8(torch, kernel, -2) if precision == "fp8" else kernel) + bias)

    h = r(w["embed.word"][ids] + w["embed.position"][:L][None])
    causal = torch.ones((L, L), dtype=torch.bool, device=ids.device).tril()
    bias = torch.where(causal[None, None] & mask.bool()[:, None, None, :], 0.0, -1e9)
    for i in range(enc["num_hidden_layers"]):
        p = {k.split(".", 1)[1]: v[i] for k, v in w.items() if k.startswith("layers.")}
        x = r(_ln(torch, h, p["ln1_scale"], p["ln1_bias"], eps))
        q, k, v = (linear(x, p[f"{n}_kernel"], p[f"{n}_bias"]).reshape(B, L, nh, hd).transpose(1, 2)
                   for n in "qkv")
        att = r(torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd) + bias, dim=-1))
        h = r(h + linear(r((att @ v).transpose(1, 2).reshape(B, L, H)), p["o_kernel"], p["o_bias"]))
        x = r(_ln(torch, h, p["ln2_scale"], p["ln2_bias"], eps))
        h = r(h + linear(r(F.gelu(linear(x, p["wi_kernel"], p["wi_bias"]), approximate="tanh")),
                         p["wo_kernel"], p["wo_bias"]))
    h = _ln(torch, h, w["final.ln_scale"], w["final.ln_bias"], eps)
    last = h[torch.arange(B, device=ids.device), mask.sum(1) - 1]
    return last / last.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def encode(torch, w: dict, enc: dict, id_lists: list[list[int]], precision: str = "f32"):
    return encode_batches(torch, lambda ids, mask: _forward(torch, w, enc, ids, mask, precision), id_lists,
                          enc["hidden_size"], w["embed.word"].device)
