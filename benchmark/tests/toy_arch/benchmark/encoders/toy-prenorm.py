"""The toy pre-norm, last-token encoder's plug-in (a test's architecture):
the reference in ``benchmark/reference/toy_prenorm.py`` and the stand-in
for a port module in ``toy_port/prenorm.py``, over one seeded draw."""

from __future__ import annotations

from benchmark.reference import toy_prenorm


def leaf_shapes(enc: dict) -> dict[str, tuple[int, ...]]:
    H, I_, L = enc["hidden_size"], enc["intermediate_size"], enc["num_hidden_layers"]
    shapes = {"embed.word": (enc["vocab_size"], H), "embed.position": (enc["max_position_embeddings"], H)}
    for n in ("ln1", "ln2"):
        shapes |= {f"layers.{n}_scale": (L, H), f"layers.{n}_bias": (L, H)}
    for n in "qkvo":
        shapes |= {f"layers.{n}_kernel": (L, H, H), f"layers.{n}_bias": (L, H)}
    shapes |= {"layers.wi_kernel": (L, H, I_), "layers.wi_bias": (L, I_),
               "layers.wo_kernel": (L, I_, H), "layers.wo_bias": (L, H),
               "final.ln_scale": (H,), "final.ln_bias": (H,)}
    return shapes


def make_weights(torch, enc: dict, seed: int, device) -> dict:
    """Embeddings N(0, 1); kernels N(0, 1/fan-in), so that each layer's
    attention and FFN move the residual stream as much as it holds."""
    g = torch.Generator(device=torch.device(device)).manual_seed(seed)
    out = {}
    for key, shape in leaf_shapes(enc).items():
        if "ln" in key and key.endswith("scale"):
            out[key] = torch.ones(shape, device=device)
        elif key.endswith("bias"):
            out[key] = torch.zeros(shape, device=device)
        elif key.startswith("embed."):
            out[key] = torch.randn(shape, generator=g, device=device)
        else:
            out[key] = torch.randn(shape, generator=g, device=device).div_(shape[-2] ** 0.5)
    return out


def reference_embeddings(torch, enc: dict, seed: int, id_lists, device, precision: str = "f32"):
    return toy_prenorm.encode(torch, make_weights(torch, enc, seed, device), enc, id_lists, precision)


def build_model(torch, enc: dict, seed: int, device):
    from toy_port.prenorm import PrenormEncoder

    return PrenormEncoder(enc, make_weights(torch, enc, seed, device))


def flops(enc: dict, tokens: list[int]) -> float:
    """Four H×H projections and two H×I products a token and layer, and the
    causal scores and context over the lower triangle (n(n+1)/2 pairs)."""
    H, I_, L = enc["hidden_size"], enc["intermediate_size"], enc["num_hidden_layers"]
    return float(L * sum(2 * n * (4 * H * H + 2 * H * I_) + 2 * n * (n + 1) * H for n in tokens))
