"""DeepSeek-V2 as a last-token pooled sentence encoder, in plain PyTorch.

The layer equations of the published ``modeling_deepseek.py``
(deepseek-ai/DeepSeek-V2-Lite), written again here: token embeddings;
``num_hidden_layers`` pre-norm layers (RMSNorm, eps ``rms_norm_eps``) of
multi-head latent attention and a feed-forward part; a final RMSNorm.

- Attention (no query LoRA): ``q = x Wq`` split per head into
  ``qk_nope_head_dim`` and ``qk_rope_head_dim``; ``x Wkv_a`` split into the
  ``kv_lora_rank`` latent and one rope key shared by all heads; the latent
  RMS-normed and projected by ``Wkv_b`` to per-head ``k_nope`` and ``v``;
  YaRN rotary on the rope parts (the interleaved pairs de-interleaved
  first, as the published ``apply_rotary_pos_emb`` does); causal softmax of
  ``q·k`` at ``q_head_dim^-0.5 · mscale(factor, mscale_all_dim)²``; the
  heads' contexts through ``Wo``.
- Layers below ``first_k_dense_replace``: a SiLU-gated FFN of
  ``intermediate_size``. The others: a softmax router over
  ``n_routed_experts`` in float32, the greedy top ``num_experts_per_tok``,
  their weights not renormalised (``norm_topk_prob`` false) times
  ``routed_scaling_factor``; each routed expert a SiLU-gated FFN of
  ``moe_intermediate_size`` applied to its own tokens only; plus the shared
  experts, one SiLU-gated FFN of ``n_shared_experts × moe_intermediate_size``
  for every token.

Departures from the published code, each deliberate:

- Float32 throughout with TF32 off (the published model runs in bf16).
- Pooling and head: the final-normed state of each query's last token
  (the ``[SEP]`` the WordPiece tokenizer appends, standing in for the EOS
  e5-mistral and gte-Qwen2 append), L2-normalised; no output head. This is
  the decoder-as-encoder recipe, not part of the published model.
- No KV cache and no auxiliary loss: one forward of whole queries.
- Projection weights are ``[in, out]`` (the published ``nn.Linear`` holds
  ``[out, in]``); the same function.

The weights are given leaf by leaf (``leaf(name)`` → an f32 tensor on the
device, the plug-in's seeded draw) and drawn one layer at a time: the
pool's tokens pass through a layer together, packed, so one layer's
weights are held at a time. For the control, ``precision="fp8"`` rounds to
float8 e4m3 at every site where the port's bf16 compute rounds: the bf16
weights (projections per output column, the embedding table per row; the
norms and the router stay f32, as the port holds them), the normed inputs
of every product but the router's, each projection's output, the rotary parts, the
attention probabilities and context, the activations and gated products
and each FFN's and expert's output."""

from __future__ import annotations

import math

from . import exact_f32, fp8

#: tokens of the pool a projection handles at once (bounds the f32
#: intermediates: the dense FFN's is ``rows × intermediate_size``)
ROWS = 32768
#: queries whose attention runs at once
SEQS = 1024


def yarn_inv_freq(torch, enc: dict):
    """The rope part's inverse frequencies ``[rope_dim / 2]`` (f32): the
    plain ``theta^(-2i/d)`` below the ramp, the ``factor``-scaled ones above
    it, blended linearly in between."""
    rs, dim, base = enc["rope_scaling"], enc["qk_rope_head_dim"], float(enc["rope_theta"])
    i = torch.arange(0, dim, 2, dtype=torch.float64)
    extra = base ** (-i / dim)
    inter = extra / rs["factor"]

    def turns_dim(turns: float) -> float:
        return dim * math.log(rs["original_max_position_embeddings"] / (turns * 2 * math.pi)) / (2 * math.log(base))

    lo = max(math.floor(turns_dim(rs["beta_fast"])), 0)
    hi = min(math.ceil(turns_dim(rs["beta_slow"])), dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - lo) / ((hi + 0.001 if lo == hi else hi) - lo)).clamp(0, 1)
    return (inter * ramp + extra * (1 - ramp)).float()


def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def softmax_scale(enc: dict) -> float:
    rs = enc["rope_scaling"]
    m = _mscale(rs["factor"], rs["mscale_all_dim"])
    return (enc["qk_nope_head_dim"] + enc["qk_rope_head_dim"]) ** -0.5 * m * m


def _rms(torch, x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(torch, x, cos, sin):
    """Rotary on the last axis of ``x [..., d]`` after de-interleaving its
    pairs; ``cos``/``sin`` broadcast to it."""
    d = x.shape[-1]
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)
    return x * cos + torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1) * sin


def encode(torch, enc: dict, leaf, id_lists: list[list[int]], device, precision: str = "f32"):
    """Sentence embeddings ``[Q, hidden]`` (f32, on ``device``) of the
    token-id lists, with the weights of ``leaf(name)``."""
    H, nh = enc["hidden_size"], enc["num_attention_heads"]
    nope, rope, vd, r = enc["qk_nope_head_dim"], enc["qk_rope_head_dim"], enc["v_head_dim"], enc["kv_lora_rank"]
    qd, eps, k_top = nope + rope, enc["rms_norm_eps"], enc["num_experts_per_tok"]
    F = torch.nn.functional
    ctl = precision == "fp8"

    def rnd(x):  # a rounding site of the port's compute
        return fp8(torch, x, -1) if ctl else x

    def weight(name):  # a bf16 weight of the port
        w = leaf(name)
        return fp8(torch, w, -1 if name == "embed_tokens" else -2) if ctl else w

    def rows(fn, x, width):  # fn over ROWS tokens at a time
        out = torch.empty((x.shape[0], width), device=x.device)
        for s in range(0, x.shape[0], ROWS):
            out[s : s + ROWS] = fn(x[s : s + ROWS])
        return out

    def ffn(x, g, u, d):
        # the port's FFNs, dense, shared and routed, round as the published code
        return rnd(rnd(rnd(F.silu(rnd(x @ g))) * rnd(x @ u)) @ d)

    def expert(x, g, u, d, w):
        # a routed expert: the port weights its rounded output in f32
        return ffn(x, g, u, d) * w[:, None]

    lengths = [len(t) for t in id_lists]
    n = sum(lengths)
    with exact_f32(torch), torch.no_grad():
        ids = torch.as_tensor([i for t in id_lists for i in t], dtype=torch.long, device=device)
        starts = [0]
        for k in lengths[:-1]:
            starts.append(starts[-1] + k)
        pos = torch.arange(n, device=device) - torch.repeat_interleave(
            torch.as_tensor(starts, device=device), torch.as_tensor(lengths, device=device))
        inv = yarn_inv_freq(torch, enc).to(device)
        ang = pos.float()[:, None] * inv[None]
        cos, sin = torch.cat([ang, ang], -1).cos(), torch.cat([ang, ang], -1).sin()
        h = weight("embed_tokens")[ids]
        # queries in batches of like length, each as a [S, L] grid of
        # packed token rows (right padding: a padded key is never attended)
        order = sorted(range(len(id_lists)), key=lambda i: lengths[i])
        grids = []
        for s in range(0, len(order), SEQS):
            sel = order[s : s + SEQS]
            L = max(lengths[i] for i in sel)
            g = torch.full((len(sel), L), -1, dtype=torch.long)
            for j, i in enumerate(sel):
                g[j, : lengths[i]] = torch.arange(starts[i], starts[i] + lengths[i])
            grids.append(g.to(device))
        scale = softmax_scale(enc)
        for i in range(enc["num_hidden_layers"]):
            p = f"layers.{i}."
            x = rnd(_rms(torch, h, leaf(p + "input_layernorm"), eps))
            wq, wa, wb, wo = (weight(p + k) for k in ("q_proj", "kv_a_proj_with_mqa", "kv_b_proj", "o_proj"))
            kv_norm = leaf(p + "kv_a_layernorm")
            for g in grids:
                real = g >= 0
                xs = x[g.clamp(min=0)]  # [S, L, H]
                S, L = g.shape
                q = rnd(xs @ wq).view(S, L, nh, qd)
                ckv = rnd(xs @ wa)
                kv = rnd(rnd(_rms(torch, ckv[..., :r], kv_norm, eps)) @ wb).view(S, L, nh, nope + vd)
                c, sn = cos[g.clamp(min=0)], sin[g.clamp(min=0)]
                q_pe = rnd(_rope(torch, q[..., nope:], c[:, :, None], sn[:, :, None]))
                k_pe = rnd(_rope(torch, ckv[..., r:], c, sn))[:, :, None].expand(S, L, nh, rope)
                qq = torch.cat([q[..., :nope], q_pe], -1).transpose(1, 2)
                kk = torch.cat([kv[..., :nope], k_pe], -1).transpose(1, 2)
                att = qq @ kk.transpose(-1, -2) * scale
                att = att.masked_fill(torch.ones((L, L), dtype=torch.bool, device=device).triu(1), float("-inf"))
                ctx = rnd(rnd(torch.softmax(att, -1)) @ kv[..., nope:].transpose(1, 2))
                out = rnd(ctx.transpose(1, 2).reshape(S, L, nh * vd) @ wo)
                h[g[real]] += out[real]
            del wq, wa, wb, wo
            x32 = _rms(torch, h, leaf(p + "post_attention_layernorm"), eps)
            x = rnd(x32)
            if i < enc["first_k_dense_replace"]:
                wg, wu, wd = (weight(p + k) for k in ("gate_proj", "up_proj", "down_proj"))
                h += rows(lambda xx: ffn(xx, wg, wu, wd), x, H)
                del wg, wu, wd
                continue
            # the port's router takes the normed state before its rounding
            probs = torch.softmax(rows(lambda xx: xx @ leaf(p + "router"), x32, enc["n_routed_experts"]), -1)
            top_w, top_e = torch.topk(probs, k_top, dim=-1)
            if enc["norm_topk_prob"]:
                top_w = top_w / top_w.sum(-1, keepdim=True)
            top_w = top_w * enc["routed_scaling_factor"]
            eg, eu, ed = (weight(p + k) for k in ("experts_gate_proj", "experts_up_proj", "experts_down_proj"))
            for e in range(enc["n_routed_experts"]):
                tok, slot = (top_e == e).nonzero(as_tuple=True)
                if tok.numel():
                    y = expert(x[tok], eg[e], eu[e], ed[e], top_w[tok, slot])
                    h.index_add_(0, tok, y)
            del eg, eu, ed
            sg, su, sd = (weight(p + k) for k in ("shared_gate_proj", "shared_up_proj", "shared_down_proj"))
            h += rows(lambda xx: ffn(xx, sg, su, sd), x, H)
            del sg, su, sd, x, x32
        ends = torch.as_tensor(lengths, device=device).cumsum(0) - 1
        last = _rms(torch, h[ends], leaf("norm"), eps)
        return last / last.norm(dim=-1, keepdim=True).clamp(min=1e-12)
