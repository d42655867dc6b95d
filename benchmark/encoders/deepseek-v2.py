"""DeepSeek-V2 (Lite) as a decoder-built encoder: the port's ``DeepseekV2``
and the plain reference ``benchmark/reference/deepseek_v2.py``, over one
seeded draw of weights.

The draw is leaf by leaf, each leaf from a generator seeded by the run's
seed and the leaf's place in :func:`leaf_shapes`, so any leaf can be drawn
alone and the same bits come out every time: the reference draws one layer
at a time in f32, and :func:`build_model` draws each leaf straight into the
port's bf16 module. No f32 copy of the whole model (about 62 GB at the
published widths) is ever held.

Scales (``assumed`` in the configuration): token embeddings N(0, 1);
projections, the router and the experts N(0, 1/fan-in), so that attention
and each FFN move the residual stream about as much as it holds; RMSNorm
weights 1, as the published init sets them."""

from __future__ import annotations

import math

from benchmark.reference import deepseek_v2


def _port():
    """The port's module. Asked for before the reference's work, so that a
    tree without it fails a run of this configuration at once."""
    from trie_semantic_search_tpu_torch.models import deepseek_v2 as port

    return port


def leaf_shapes(enc: dict) -> dict[str, tuple[int, ...]]:
    """``name`` → shape in draw order; the names are the port module's
    parameter names. Projections are ``[in, out]``."""
    H, nh, L = enc["hidden_size"], enc["num_attention_heads"], enc["num_hidden_layers"]
    qd = enc["qk_nope_head_dim"] + enc["qk_rope_head_dim"]
    r, E, F = enc["kv_lora_rank"], enc["n_routed_experts"], enc["moe_intermediate_size"]
    S, I_ = F * enc["n_shared_experts"], enc["intermediate_size"]
    out = {"embed_tokens": (enc["vocab_size"], H)}
    for i in range(L):
        p = f"layers.{i}."
        out |= {p + "input_layernorm": (H,), p + "q_proj": (H, nh * qd),
                p + "kv_a_proj_with_mqa": (H, r + enc["qk_rope_head_dim"]), p + "kv_a_layernorm": (r,),
                p + "kv_b_proj": (r, nh * (enc["qk_nope_head_dim"] + enc["v_head_dim"])),
                p + "o_proj": (nh * enc["v_head_dim"], H), p + "post_attention_layernorm": (H,)}
        if i < enc["first_k_dense_replace"]:
            out |= {p + "gate_proj": (H, I_), p + "up_proj": (H, I_), p + "down_proj": (I_, H)}
        else:
            out |= {p + "router": (H, E), p + "experts_gate_proj": (E, H, F), p + "experts_up_proj": (E, H, F),
                    p + "experts_down_proj": (E, F, H), p + "shared_gate_proj": (H, S),
                    p + "shared_up_proj": (H, S), p + "shared_down_proj": (S, H)}
    out["norm"] = (H,)
    return out


def leaf_drawer(torch, enc: dict, seed: int, device):
    """``leaf(name)`` → the leaf's f32 tensor on ``device``, the same bits
    on every call."""
    shapes = leaf_shapes(enc)
    index = {name: k for k, name in enumerate(shapes)}
    dev = torch.device(device)

    def leaf(name: str):
        shape = shapes[name]
        if name.endswith("layernorm") or name == "norm":
            return torch.ones(shape, device=dev)
        g = torch.Generator(device=dev).manual_seed((int(seed) * 1_000_003 + index[name]) % 2**63)
        t = torch.randn(shape, generator=g, device=dev)
        return t if name == "embed_tokens" else t.div_(math.sqrt(shape[-2]))

    return leaf


def reference_embeddings(torch, enc: dict, seed: int, id_lists: list[list[int]], device,
                         precision: str = "f32"):
    _port()
    out = deepseek_v2.encode(torch, enc, leaf_drawer(torch, enc, seed, device), id_lists, device, precision)
    if torch.device(device).type == "cuda":
        # the pool's f32 work leaves nothing cached beside the program
        torch.cuda.empty_cache()
    return out


def build_model(torch, enc: dict, seed: int, device):
    port = _port()
    model = port.DeepseekV2(port.DeepseekV2Config.from_published(enc), device=device, seed=None)
    leaf = leaf_drawer(torch, enc, seed, device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(leaf(name))
    return model


def flops(enc: dict, tokens: list[int]) -> float:
    """Per real token and layer: MLA's projections (``q_proj`` to the
    heads' nope and rope parts, ``kv_a_proj_with_mqa`` to the latent and
    the shared rope key, ``kv_b_proj``, ``o_proj``); the dense FFN's three
    products in the leading layers; the router, the
    ``num_experts_per_tok`` routed experts' and the shared experts' three
    products each in the others; 2 FLOPs a multiply-add. Per query of
    ``n`` tokens and layer, causal attention's scores and context over the
    ``n(n+1)/2`` pairs it computes."""
    H, nh, L = enc["hidden_size"], enc["num_attention_heads"], enc["num_hidden_layers"]
    nope, rope, vd, r = enc["qk_nope_head_dim"], enc["qk_rope_head_dim"], enc["v_head_dim"], enc["kv_lora_rank"]
    dense, moe = enc["first_k_dense_replace"], L - enc["first_k_dense_replace"]
    F = enc["moe_intermediate_size"]
    attn = H * nh * (nope + rope) + H * (r + rope) + r * nh * (nope + vd) + nh * vd * H
    per_token = (L * attn + dense * 3 * H * enc["intermediate_size"]
                 + moe * (H * enc["n_routed_experts"] + 3 * H * F * (enc["num_experts_per_tok"] + enc["n_shared_experts"])))
    pairs = sum(n * (n + 1) // 2 for n in tokens)
    return float(2 * per_token * sum(tokens) + 2 * L * pairs * nh * (nope + rope + vd))


def routed_flops(enc: dict, tokens: int) -> float:
    """FLOPs of one MoE layer's routed experts over ``tokens`` real
    tokens: ``num_experts_per_tok`` SiLU-gated FFNs (three products) each."""
    return 2.0 * 3 * enc["hidden_size"] * enc["moe_intermediate_size"] * enc["num_experts_per_tok"] * tokens


def expert_bytes(enc: dict) -> int:
    """Bytes of one MoE layer's routed experts' weights in bf16."""
    return 2 * 3 * enc["hidden_size"] * enc["moe_intermediate_size"] * enc["n_routed_experts"]
