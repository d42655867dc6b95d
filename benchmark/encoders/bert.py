"""BERT's post-norm encoder (all-MiniLM-L6-v2, legal-bert-base): the port's
``MiniLM`` and the plain reference ``benchmark/reference/bert.py``, over
one seeded draw of weights.

The layout is stacked per layer (``[L, in, out]`` kernels), the layout
``MiniLM`` and the reference both read. Kernels and the position and
token-type embeddings are N(0, 0.02) clipped at two standard deviations, as
BERT initialises them; layer-norm scales are 1 and biases 0. The word
embeddings are N(0, 1) (listed under ``assumed`` in each configuration): at
BERT's 0.02 a seeded encoder maps every text onto nearly one direction
(cosine 0.84-0.98 between unrelated phrases), where a trained encoder
spreads them."""

from __future__ import annotations

from benchmark.reference import bert


def leaf_shapes(enc: dict) -> dict[str, tuple[int, ...]]:
    """``"<group>.<name>"`` → shape, in draw order."""
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
    """The encoder's f32 parameters on ``device`` from ``seed``: one
    generator over the leaves in :func:`leaf_shapes` order."""
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


def reference_embeddings(torch, enc: dict, seed: int, id_lists: list[list[int]], device,
                         precision: str = "f32"):
    return bert.encode(torch, make_weights(torch, enc, seed, device), enc, id_lists, precision)


def build_model(torch, enc: dict, seed: int, device):
    from trie_semantic_search_tpu_torch.models.minilm import MiniLM, MiniLMConfig

    config = MiniLMConfig(
        vocab_size=enc["vocab_size"], hidden_size=enc["hidden_size"], num_layers=enc["num_hidden_layers"],
        num_heads=enc["num_attention_heads"], intermediate_size=enc["intermediate_size"],
        max_position=enc["max_position_embeddings"], type_vocab_size=enc["type_vocab_size"],
        layer_norm_eps=enc["layer_norm_eps"],
    )
    model = MiniLM(config, device=device)
    weights = make_weights(torch, enc, seed, device)
    with torch.no_grad():
        for key, p in model.named_parameters():
            p.copy_(weights[key])
    return model


def flops(enc: dict, tokens: list[int]) -> float:
    """Per layer the four H×H projections and the two H×I FFN products (2
    FLOPs a multiply-add per token), plus the attention's scores and
    context (2·n²·H each)."""
    H, I_, L = enc["hidden_size"], enc["intermediate_size"], enc["num_hidden_layers"]
    per_token = 2 * (4 * H * H + 2 * H * I_)
    return float(L * sum(n * per_token + 4 * n * n * H for n in tokens))
