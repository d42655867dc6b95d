"""Seeded encoder weights, made on the device in one call per leaf.

The layout is the BERT encoder's, stacked per layer (``[L, in, out]``
kernels), the layout the port's ``MiniLM`` and the plain reference both
read. Kernels and the position and token-type embeddings are N(0, 0.02)
clipped at two standard deviations, as BERT initialises them; layer-norm
scales are 1 and biases 0. The word embeddings are N(0, 1) (listed under
``assumed`` in each configuration): at BERT's 0.02 a seeded encoder maps
every text onto nearly one direction (cosine 0.84-0.98 between unrelated
phrases), where a trained encoder spreads them.
"""

from __future__ import annotations


def leaf_shapes(enc: dict) -> dict[str, tuple[int, ...]]:
    """``"<group>.<name>"`` → shape, for an encoder block of a config file."""
    H, I_, L = enc["hidden_size"], enc["intermediate_size"], enc["num_hidden_layers"]
    return {
        "embeddings.word": (enc["vocab_size"], H),
        "embeddings.position": (enc["max_position_embeddings"], H),
        "embeddings.token_type": (enc["type_vocab_size"], H),
        "embeddings.ln_scale": (H,), "embeddings.ln_bias": (H,),
        "layers.q_kernel": (L, H, H), "layers.q_bias": (L, H),
        "layers.k_kernel": (L, H, H), "layers.k_bias": (L, H),
        "layers.v_kernel": (L, H, H), "layers.v_bias": (L, H),
        "layers.o_kernel": (L, H, H), "layers.o_bias": (L, H),
        "layers.attn_ln_scale": (L, H), "layers.attn_ln_bias": (L, H),
        "layers.wi_kernel": (L, H, I_), "layers.wi_bias": (L, I_),
        "layers.wo_kernel": (L, I_, H), "layers.wo_bias": (L, H),
        "layers.mlp_ln_scale": (L, H), "layers.mlp_ln_bias": (L, H),
    }


def make_weights(torch, enc: dict, seed: int, device) -> dict:
    """The encoder's f32 parameters on ``device`` from ``seed``."""
    g = torch.Generator(device=torch.device(device)).manual_seed(seed)
    out = {}
    for key, shape in leaf_shapes(enc).items():
        if "ln_scale" in key:
            t = torch.ones(shape, device=device)
        elif "bias" in key:
            t = torch.zeros(shape, device=device)
        elif key == "embeddings.word":
            t = torch.randn(shape, generator=g, device=device)
        else:
            t = torch.randn(shape, generator=g, device=device).mul_(0.02).clamp_(-0.04, 0.04)
        out[key] = t
    return out
