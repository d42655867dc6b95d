"""The BERT encoder's sentence embedding in plain PyTorch: embeddings and
layer norm, post-norm layers of self-attention and a tanh-GELU FFN, masked
mean pooling, L2 normalisation (all-MiniLM-L6-v2 and legal-bert-base both
have this form). Float32 with TF32 off. For the control, ``precision="fp8"``
rounds to float8 e4m3 at every site where the configurations' bf16
compute rounds (the kernels per output column; the hidden states, every
projection's output, the attention probabilities and context and the FFN's
activation per row), the step below bf16."""

from __future__ import annotations

import math

from . import encode_batches, fp8


def _ln(torch, x, scale, bias, eps: float):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


def _encode_batch(torch, w: dict, enc: dict, ids, mask, precision: str):
    F = torch.nn.functional
    H, nh = enc["hidden_size"], enc["num_attention_heads"]
    hd, eps = H // nh, enc["layer_norm_eps"]
    B, L = ids.shape

    def r(x):  # a rounding site of the compute precision
        return fp8(torch, x, -1) if precision == "fp8" else x

    def linear(x, kernel, bias):
        kernel = fp8(torch, kernel, -2) if precision == "fp8" else kernel
        return r(x @ kernel + bias)

    h = w["embeddings.word"][ids] + w["embeddings.position"][:L][None] + w["embeddings.token_type"][0]
    h = r(_ln(torch, h, w["embeddings.ln_scale"], w["embeddings.ln_bias"], eps))
    bias = (1.0 - mask.float())[:, None, None, :] * -1e9
    for i in range(enc["num_hidden_layers"]):
        p = {k.split(".", 1)[1]: v[i] for k, v in w.items() if k.startswith("layers.")}
        q = linear(h, p["q_kernel"], p["q_bias"]).reshape(B, L, nh, hd).transpose(1, 2)
        k = linear(h, p["k_kernel"], p["k_bias"]).reshape(B, L, nh, hd).transpose(1, 2)
        v = linear(h, p["v_kernel"], p["v_bias"]).reshape(B, L, nh, hd).transpose(1, 2)
        att = r(torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd) + bias, dim=-1))
        ctx = r((att @ v).transpose(1, 2).reshape(B, L, H))
        h = r(_ln(torch, h + linear(ctx, p["o_kernel"], p["o_bias"]), p["attn_ln_scale"], p["attn_ln_bias"], eps))
        ff = r(F.gelu(linear(h, p["wi_kernel"], p["wi_bias"]), approximate="tanh"))
        h = r(_ln(torch, h + linear(ff, p["wo_kernel"], p["wo_bias"]), p["mlp_ln_scale"], p["mlp_ln_bias"], eps))
    m = mask.float()[:, :, None]
    pooled = (h * m).sum(1) / m.sum(1).clamp(min=1e-9)
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def encode(torch, w: dict, enc: dict, id_lists: list[list[int]], precision: str = "f32", batch: int = 512):
    """Sentence embeddings ``[Q, H]`` (f32, on the weights' device) of
    token-id lists."""
    return encode_batches(torch, lambda ids, mask: _encode_batch(torch, w, enc, ids, mask, precision), id_lists,
                          enc["hidden_size"], w["embeddings.word"].device, batch)
