"""The port's DeepSeek-V2 encoder (``models/deepseek_v2.py``) against the
benchmark's plain reference (``benchmark/reference/deepseek_v2.py``) on one
seeded draw (the plug-in ``benchmark/encoders/deepseek-v2.py``), at a tiny
geometry on the CPU: hidden 64, one dense layer and two MoE layers of 8
routed experts (top 2) and 2 shared, ``kv_lora_rank`` 32, rope 16.

Tolerances. In f32 the two compute the same function in another order
(packed tokens against a padded grid, another summation order of the
experts): 1e-5 on unit vectors, a few f32 roundings. In bf16 the port
rounds weights and activations (8 bits of mantissa, a relative 2^-9 a
site, some thirty sites a layer), and a token whose 2nd and 3rd expert
nearly tie may take the other under that rounding: the median of
``1 - cos`` stays under 5e-4 (read: 3.6e-5) and the least cosine over
0.98 (read: 0.993). The float8 control (3 bits of mantissa) reads a median
of 7.4e-3, so the bf16 tolerance tells the two apart; each planted fault
moves the f32 port past it.

On the card (tests marked ``card``, skipped without one) the grouped expert
products are held against the plain loop at the published widths: ``python
-m pytest --noconftest tests/test_torch_deepseek_v2.py -k card`` (this
file imports no JAX; ``tests/conftest.py`` does)."""

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import data, encoders
from benchmark.reference import deepseek_v2 as ref
from benchmark.reference import wordpiece
from trie_semantic_search_tpu_torch.core.config import EmbeddingModelConfig
from trie_semantic_search_tpu_torch.core.metrics import metrics
from trie_semantic_search_tpu_torch.models import deepseek_v2 as dsv2
from trie_semantic_search_tpu_torch.models.embedder import Embedder
from trie_semantic_search_tpu_torch.models.tokenizer import WordPieceTokenizer
from trie_semantic_search_tpu_torch.ops import moe

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SEED = 2**31 + 5
BF16_MEDIAN, BF16_MIN_COS = 5e-4, 0.98


def published() -> dict:
    return json.loads((ROOT / "benchmark" / "configs" / "deepseek-v2-lite-cap1m.json").read_text())["encoder"]


def tiny(**kw) -> dict:
    enc = published()
    enc.update(vocab_size=10400, hidden_size=64, num_hidden_layers=3, first_k_dense_replace=1,
               intermediate_size=96, moe_intermediate_size=32, n_routed_experts=8, num_experts_per_tok=2,
               n_shared_experts=2, num_attention_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
               qk_rope_head_dim=16, v_head_dim=16, **kw)
    return enc


@pytest.fixture(scope="module")
def pool():
    """Token ids of 96 queries of the bulk mix over the benchmark's
    vocabulary, and the vocabulary."""
    lex = data.lexicon()
    cases = data.make_cases(2048, 4, 3, lex)
    mix = json.loads((ROOT / "benchmark" / "traffic" / "bulk-256.json").read_text())
    vocab = data.vocabulary(lex, 10400)
    return [wordpiece.token_ids(q.text, vocab, 512) for q in data.make_queries(mix, 96, cases, 3)], vocab


def port_model(enc: dict, dtype=torch.float32, config=None):
    plugin = encoders.load(enc)
    model = dsv2.DeepseekV2(config or dsv2.DeepseekV2Config.from_published(enc), device="cpu", seed=None,
                            compute_dtype=dtype)
    leaf = plugin.leaf_drawer(torch, enc, SEED, "cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(leaf(name))
    return model


def padded(ids: list[list[int]]):
    L = max(map(len, ids))
    i = torch.zeros((len(ids), L), dtype=torch.int32)
    m = torch.zeros((len(ids), L), dtype=torch.int32)
    for r, t in enumerate(ids):
        i[r, : len(t)] = torch.as_tensor(t)
        m[r, : len(t)] = 1
    return i, m


def reference(enc, ids, precision="f32"):
    return encoders.load(enc).reference_embeddings(torch, enc, SEED, ids, "cpu", precision)


def cos_stats(a, b):
    c = (a * b).sum(-1)
    return float((1 - c).median()), float(c.min())


def test_param_names_and_shapes_are_the_plugins_draw_order():
    for enc in (published(), tiny()):
        assert dsv2.param_shapes(dsv2.DeepseekV2Config.from_published(enc)) == encoders.load(enc).leaf_shapes(enc)


def test_yarn_frequencies_and_softmax_scale_by_hand():
    c = dsv2.DeepseekV2Config()
    # DeepSeek-V2-Lite: mscale = 0.1 * 0.707 * ln 40 + 1 = 1.2608037774...
    assert dsv2.softmax_scale(c) == pytest.approx(192 ** -0.5 * 1.2608037774058538 ** 2, rel=1e-12)
    assert dsv2.softmax_scale(c) == pytest.approx(0.1147213868, rel=1e-9)
    assert ref.softmax_scale(published()) == pytest.approx(dsv2.softmax_scale(c), rel=1e-12)
    inv = dsv2.yarn_inv_freq(c).double()
    plain = torch.tensor([10000.0 ** (-2 * i / 64) for i in range(32)], dtype=torch.float64)
    # the correction range is [10, 23]: below it the plain frequencies,
    # above it the plain ones over the factor 40, linear in between
    assert torch.allclose(inv[:11], plain[:11], rtol=1e-6)
    assert torch.allclose(inv[23:], plain[23:] / 40, rtol=1e-6)
    ramp = (16 - 10) / 13
    assert float(inv[16]) == pytest.approx(float(plain[16] / 40 * ramp + plain[16] * (1 - ramp)), rel=1e-6)
    assert torch.equal(ref.yarn_inv_freq(torch, published()), dsv2.yarn_inv_freq(c))
    cos, sin = dsv2.rope_cos_sin(c, torch.tensor([0, 5]))
    assert torch.equal(cos[0], torch.ones(64)) and float(sin[1, 1]) == pytest.approx(math.sin(5 * float(inv[1])), rel=1e-5)


def test_port_matches_the_reference_in_f32(pool):
    ids, _ = pool
    enc = tiny()
    i, m = padded(ids)
    out = port_model(enc).encode(i, m)
    want = reference(enc, ids)
    assert torch.allclose(out, want, atol=1e-5, rtol=0)


def test_port_in_bf16_within_its_tolerance_and_the_float8_control_not(pool):
    ids, _ = pool
    enc = tiny()
    i, m = padded(ids)
    want = reference(enc, ids)
    med, low = cos_stats(port_model(enc, torch.bfloat16).encode(i, m), want)
    assert med < BF16_MEDIAN and low > BF16_MIN_COS, (med, low)
    med8, _ = cos_stats(reference(enc, ids, "fp8"), want)
    assert med8 > 10 * BF16_MEDIAN, med8


def _top1(enc):
    return dataclasses.replace(dsv2.DeepseekV2Config.from_published(enc), num_experts_per_tok=1)


def _renormalised(enc):
    return dataclasses.replace(dsv2.DeepseekV2Config.from_published(enc), norm_topk_prob=True)


def _no_shared(model):
    with torch.no_grad():
        for lp in model.layers:
            if lp.moe:
                lp.shared_down_proj.zero_()


def _rope_on_nope(model):
    """Each head's q columns swapped, nope for rope: the rotary then turns
    the nope half of q."""
    with torch.no_grad():
        for lp in model.layers:
            w = lp.q_proj.view(64, 4, 32)
            w.copy_(torch.cat([w[..., 16:], w[..., :16]], dim=-1))


@pytest.mark.parametrize("fault", ["top-1 routing", "shared experts left out", "renormalised top-k",
                                   "rope on the nope half"])
def test_planted_faults_fall_outside_the_tolerance(pool, fault):
    """Top-k one short (top-5 of the published six; top-1 of two here),
    the shared experts left out, the top-k weights renormalised, the
    rotary on q's nope half: each moves the port past the bf16 tolerance."""
    ids, _ = pool
    enc = tiny()
    config = {"top-1 routing": _top1, "renormalised top-k": _renormalised}.get(fault)
    model = port_model(enc, config=config(enc) if config else None)
    {"shared experts left out": _no_shared, "rope on the nope half": _rope_on_nope}.get(fault, lambda m: None)(model)
    i, m = padded(ids)
    med, low = cos_stats(model.encode(i, m), reference(enc, ids))
    assert med > BF16_MEDIAN or low < BF16_MIN_COS, (fault, med, low)


def test_a_query_alone_equals_it_in_a_padded_batch(pool):
    """Through ``Embedder``: the length bucket and the batch bucket pad,
    the padding is packed out, and causal attention over right padding
    keeps it out of every real token."""
    ids, vocab = pool
    enc = tiny()
    emb = Embedder(tokenizer=WordPieceTokenizer(vocab), model=port_model(enc), device="cpu")
    texts = ["lumafo bezi kanopa", "tiru", "vesta lomi kanopa bezi tiru lumafo dovane kep", "bezi tiru"]
    batch = emb.embed(texts).embedding
    for k, t in enumerate(texts):
        np.testing.assert_allclose(emb.embed([t]).embedding[0], batch[k], atol=1e-6, rtol=0)
    assert batch.shape == (4, 64) and emb.dimension == 64


def test_embedder_records_the_moe_spans_and_counters(pool):
    ids, vocab = pool
    enc = tiny()
    emb = Embedder(tokenizer=WordPieceTokenizer(vocab), model=port_model(enc), device="cpu")
    before = metrics.snapshot()["counters"]
    n_obs = metrics.histogram("moe.expert_load").count
    texts = ["lumafo bezi kanopa", "tiru vesta"]
    emb.embed(texts)
    after = metrics.snapshot()["counters"]
    real = sum(len(emb.tokenizer.encode(t, 512)[0]) - list(emb.tokenizer.encode(t, 512)[1]).count(0) for t in texts)
    assert after["moe.tokens"] - before.get("moe.tokens", 0) == 2 * real
    assert after["moe.assignments"] - before.get("moe.assignments", 0) == 2 * 2 * real
    h = metrics.histogram("moe.expert_load")
    assert h.count == n_obs + 1
    # the busiest expert's share over the mean lies in [1, experts]
    last = h.between(0.0, float("inf"))
    assert last is not None and 1.0 <= h._ms[(h.count - 1) % len(h._ms)] <= 8.0


def test_embedder_builds_the_model_type(monkeypatch, pool):
    _, vocab = pool
    enc = tiny()
    monkeypatch.setitem(dsv2.MODEL_TYPES, "deepseek-v2-lite", dsv2.DeepseekV2Config.from_published(enc))
    emb = Embedder(EmbeddingModelConfig(model_type="deepseek-v2-lite", model_path="/nonexistent"),
                   tokenizer=WordPieceTokenizer(vocab), device="cpu", seed=3)
    assert isinstance(emb.model, dsv2.DeepseekV2) and emb.dimension == 64
    out = emb.embed(["lumafo bezi"]).embedding
    assert out.shape == (1, 64) and abs(float(np.linalg.norm(out)) - 1) < 1e-3


def test_grouped_experts_equal_a_loop_over_tokens():
    g = torch.Generator().manual_seed(1)
    n, H, F, E, k = 37, 16, 8, 6, 3
    x = torch.randn((n, H), generator=g)
    wg, wu, wd = (torch.randn(s, generator=g) for s in ((E, H, F), (E, H, F), (E, F, H)))
    w, idx = torch.topk(torch.softmax(torch.randn((n, E), generator=g), -1), k, dim=-1)
    out = moe.grouped_expert_ffn(x, idx, w, wg, wu, wd)
    want = torch.zeros((n, H))
    for t in range(n):
        for j in range(k):
            e = int(idx[t, j])
            want[t] += w[t, j] * ((torch.nn.functional.silu(x[t] @ wg[e]) * (x[t] @ wu[e])) @ wd[e])
    assert torch.allclose(out, want, atol=1e-5)
    order, counts = moe.route_groups(idx, E)
    assert counts.tolist() == torch.bincount(idx.reshape(-1), minlength=E).tolist()
    assert torch.equal(idx.reshape(-1)[order], idx.reshape(-1).sort(stable=True).values)


@pytest.mark.parametrize("E,n", [(8, 37), (5, 3), (6, 64)])
def test_grouped_products_equal_the_plain_loop_on_the_cpu(E, n):
    """The grouped formulation the card runs (gather, three grouped
    products over the groups' running ends, rows put back) against the
    plain loop, in bf16, with expert counts no power of two and idle
    experts (n = 3 tokens over 5 experts at top 2). Bitwise: on the CPU
    each group's product is the same f32-accumulated product."""
    g = torch.Generator().manual_seed(E * n)
    H, F, k = 64, 32, 2
    wg, wu = ((torch.randn((E, H, F), generator=g) / H ** 0.5).to(torch.bfloat16) for _ in "gu")
    wd = (torch.randn((E, F, H), generator=g) / F ** 0.5).to(torch.bfloat16)
    x = torch.randn((n, H), generator=g).to(torch.bfloat16)
    w, idx = torch.topk(torch.softmax(torch.randn((n, E), generator=g), -1), k, dim=-1)
    order, counts = moe.route_groups(idx, E)
    got = moe._grouped_products(x, order, k, counts, wg, wu, wd)
    want = moe._grouped_plain(x, order, k, counts, wg, wu, wd)
    assert torch.equal(got, want)


def test_flops_by_hand_at_the_published_widths():
    """Per token: MLA 2048·16·192 + 2048·576 + 512·16·256 + 16·128·2048 =
    13,762,560 multiply-adds a layer over 27 layers; the dense FFN
    3·2048·10944; 26 MoE layers of the router 2048·64 and 6 routed plus 2
    shared experts of 3·2048·1408 each: 2,241,593,344 in all, 2 FLOPs
    each. Attention over the n(n+1)/2 causal pairs: 2·27·16·(192+128) a
    pair."""
    per_token = 27 * 13_762_560 + 3 * 2048 * 10944 + 26 * (2048 * 64 + 8 * 3 * 2048 * 1408)
    assert per_token == 2_241_593_344
    tokens = [10, 20, 1]
    want = 2 * per_token * 31 + 2 * 27 * (55 + 210 + 1) * 16 * 320
    assert encoders.load(published()).flops(published(), tokens) == float(want)


def test_encoder_ranges_appear_only_under_a_profiler(pool):
    """Each layer's ``encoder.attention`` and each MoE layer's
    ``encoder.router``, ``encoder.experts`` and ``encoder.shared`` are
    profiler ranges while a profiler records, and no histogram."""
    ids, _ = pool
    model = port_model(tiny())
    i, m = padded(ids[:4])
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.encode(i, m)
    counts = {e.key: e.count for e in prof.key_averages()}
    assert counts["encoder.attention"] == 3
    assert counts["encoder.router"] == counts["encoder.experts"] == counts["encoder.shared"] == 2
    assert "encoder.attention" not in metrics.snapshot()["latency"]


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; this machine has none")
    return "cuda"


@pytest.mark.card
@pytest.mark.parametrize("E,n", [(64, 1), (64, 37), (64, 3395), (60, 20), (60, 3395)])
def test_card_grouped_kernels_match_the_plain_loop(card, E, n):
    """The grouped products against the plain per-expert loop at
    DeepSeek-V2-Lite's widths (experts of 1,408, top 6; 64 experts as
    published and 60, a count no power of two), routing skewed as the
    seeded model's is, most experts idle at n = 1 and 20. Not bitwise: the
    grouped GEMM sums each product in another order, so the bf16 rounding
    of a projection moves by a unit in the last place now and then."""
    g = torch.Generator(device=card).manual_seed(n + E)
    H, F, k = 2048, 1408, 6
    wg, wu = ((torch.randn((E, H, F), generator=g, device=card) / H ** 0.5).to(torch.bfloat16) for _ in "gu")
    wd = (torch.randn((E, F, H), generator=g, device=card) / F ** 0.5).to(torch.bfloat16)
    x = torch.randn((n, H), generator=g, device=card).to(torch.bfloat16)
    logits = torch.randn((n, E), generator=g, device=card) + 1.5 * torch.randn((E,), generator=g, device=card)
    w, idx = torch.topk(torch.softmax(logits, -1), k, dim=-1)
    before = moe.LAUNCHES["grouped_expert_ffn"]
    got = moe.grouped_expert_ffn(x, idx, w, wg, wu, wd)
    assert moe.LAUNCHES["grouped_expert_ffn"] == before + 1
    want = moe.grouped_expert_ffn_plain(x, idx, w, wg, wu, wd)
    assert float((got - want).norm() / want.norm()) < 2e-3
