"""The int8 scans at rows wider than an f32 sum of int8 products holds
exactly (D > 1,040; DeepSeek-V2-Lite's D = 2,048).

On the CPU: the plain versions' products (``scan_kernels.int8_products``)
against an int64 product, and the plain fused scan's and probe's scores at
D = 2,048 against scores made from it. On the card (tests marked ``card``,
skipped without one): the probe and the fused scan's tensor-core variant
bitwise against their plain versions at D = 2,048 and 384, at the shapes
the bulk cell runs (a 256-query stream slab of 163,840 rows; the probe's
64 queries × 64 probes over 5,120 partitions of 1,024 slots). Run those on
the card with ``python -m pytest --noconftest tests/test_torch_wide_scan.py``
(this file imports no JAX; ``tests/conftest.py`` does)."""

import pytest
import torch

from trie_semantic_search_tpu_torch.ops import scan_kernels as sk

torch.set_num_threads(1)


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; this machine has none")
    return "cuda"


def exact_scores(q8, rows, q_scale, row_scale):
    """``float32(int64 dot) * q_scale * row_scale``, in the kernels'
    order: ``[B, 1]`` and ``[1, N]`` scales."""
    return (q8.long() @ rows.long().T).to(torch.float32) * q_scale * row_scale


@pytest.mark.parametrize("K", [1024, 1040, 2048, 3000])
def test_int8_products_are_the_int64_products_rounded_once(K):
    g = torch.Generator().manual_seed(K)
    # same-signed large values: the sums pass 2^24, where an f32 sum rounds
    a = torch.randint(100, 128, (5, K), generator=g, dtype=torch.int16).to(torch.int8)
    b = torch.randint(100, 128, (K, 7), generator=g, dtype=torch.int16).to(torch.int8)
    a[0] = -128
    want = (a.long() @ b.long()).to(torch.float32)
    sk.exact_float32()
    assert torch.equal(sk.int8_products(a, b), want)
    if K >= 2048:  # one f32 product over the whole of K is not exact here
        assert not torch.equal(a.float() @ b.float(), want)


def _stream_inputs(B, D, N, seed, device="cpu", big=False):
    g = torch.Generator(device=device).manual_seed(seed)
    lo, hi = (90, 128) if big else (-128, 128)
    q8 = torch.randint(lo, hi, (B, D), generator=g, device=device, dtype=torch.int16).to(torch.int8)
    cq = torch.randint(lo, hi, (N, D), generator=g, device=device, dtype=torch.int16).to(torch.int8)
    qs = torch.rand((B, 1), generator=g, device=device) * 1e-3 + 1e-4
    cs = torch.rand((N, 1), generator=g, device=device) * 1e-3 + 1e-4
    court = torch.randint(0, 40, (N,), generator=g, device=device, dtype=torch.int32)
    date = torch.randint(0, 1000, (N,), generator=g, device=device, dtype=torch.int32)
    table = torch.rand((B, 40), generator=g, device=device) < 0.7
    dlo = torch.randint(0, 300, (B,), generator=g, device=device, dtype=torch.int32)
    dhi = torch.randint(600, 1000, (B,), generator=g, device=device, dtype=torch.int32)
    mins = torch.full((B,), -1e30, device=device)
    inp = sk.fused_scan_inputs(qs, court, date, table, dlo, dhi, mins, cs)
    return q8, cq, qs, cs, inp


def test_plain_fused_scan_scores_are_exact_at_2048():
    B, D, N, T = 3, 2048, 1024, 2
    q8, cq, qs, cs, inp = _stream_inputs(B, D, N, 7, big=True)
    v, i = sk.fused_scan_plain(q8, corpus_q=cq, n_keep=T, use_court=False, use_date=False, **inp)
    want = exact_scores(q8, cq, qs.reshape(B, 1), cs.reshape(1, N))
    live = i >= 0
    assert live.all()
    assert torch.equal(v, torch.gather(want, 1, i.long()))
    # each lane's slot 0 is its best row
    lane_best = want.view(B, N // 128, 128).amax(dim=1)
    assert torch.equal(v[:, :128], lane_best)


def test_plain_probe_scores_are_exact_at_2048():
    B, NP, P, m, D = 2, 2, 3, 256, 2048
    g = torch.Generator().manual_seed(11)
    q8 = torch.randint(90, 128, (B, D), generator=g, dtype=torch.int16).to(torch.int8)
    part = torch.randint(90, 128, (P, m, D), generator=g, dtype=torch.int16).to(torch.int8)
    qs = torch.rand((B,), generator=g) * 1e-3 + 1e-4
    ps = torch.rand((P, m), generator=g) * 1e-3 + 1e-4
    top_p = torch.tensor([[0, 2], [1, 0]], dtype=torch.int32)
    rows = torch.arange(P * m, dtype=torch.int32).reshape(P, m)
    cword = torch.zeros((P, m), dtype=torch.int32)
    cbit = torch.ones((P, m), dtype=torch.int32)
    pdate = torch.zeros((P, m), dtype=torch.int32)
    qwords = torch.ones((B, 1), dtype=torch.int32)
    v, s = sk.probe_candidates_plain(q8, qs, top_p, part, ps, rows, cword, cbit, pdate, qwords,
                                     torch.zeros(B, dtype=torch.int32), torch.zeros(B, dtype=torch.int32),
                                     torch.full((B,), -1e30))
    v, s = v.view(B, NP, 2, 128), s.view(B, NP, 2, 128)
    for b in range(B):
        for p in range(NP):
            pid = int(top_p[b, p])
            want = exact_scores(q8[b : b + 1], part[pid], qs[b], ps[pid][None])[0]
            assert torch.equal(v[b, p], want[s[b, p].long()])
            assert torch.equal(v[b, p, 0], want.view(m // 128, 128).amax(dim=0))


# -- on the card ------------------------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("D", [384, 2048])
@pytest.mark.parametrize("T,filtered", [(2, False), (2, True), (5, True)])
def test_card_fused_scan_is_bitwise_its_plain_version(card, D, T, filtered):
    """The bulk cell's stream slab: 256 queries against 163,840 rows, on
    the tensor-core variant (a row in parts of K at D = 2,048)."""
    B, N = 256, 163_840
    q8, cq, _qs, _cs, inp = _stream_inputs(B, D, N, 2048 + D + T, device=card)
    assert sk.fused_scan_variant(D, T) == "wgmma"
    before = sk.LAUNCHES["fused_scan"]
    kv, ki = sk.fused_scan_cuda(q8, corpus_q=cq, n_keep=T, use_court=filtered, use_date=filtered, **inp)
    assert sk.LAUNCHES["fused_scan"] == before + 1
    pv, pi = sk.fused_scan_plain(q8, corpus_q=cq, n_keep=T, use_court=filtered, use_date=filtered, **inp)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi)
    assert torch.equal(kv, pv)


@pytest.mark.card
@pytest.mark.parametrize("D", [384, 2048])
def test_card_probe_is_bitwise_its_plain_version(card, D):
    """64 queries × 64 probes over 5,120 partitions of 1,024 slots,
    filtered by court and date, some slots padding."""
    B, NP, P, m = 64, 64, 5120, 1024
    g = torch.Generator(device=card).manual_seed(D)
    q8 = torch.randint(-128, 128, (B, D), generator=g, device=card, dtype=torch.int16).to(torch.int8)
    part = torch.randint(-128, 128, (P, m, D), generator=g, device=card, dtype=torch.int16).to(torch.int8)
    qs = torch.rand((B,), generator=g, device=card) * 1e-3 + 1e-4
    ps = torch.rand((P, m), generator=g, device=card) * 1e-3 + 1e-4
    top_p = torch.randint(0, P, (B, NP), generator=g, device=card, dtype=torch.int32)
    rows = torch.arange(P * m, dtype=torch.int32, device=card).reshape(P, m)
    rows[:, -7:] = -1
    court = torch.randint(0, 40, (P, m), generator=g, device=card, dtype=torch.int32)
    cword, cbit = court // 32, (1 << (court % 32)).to(torch.int32)
    pdate = torch.randint(0, 1000, (P, m), generator=g, device=card, dtype=torch.int32)
    qwords = sk.pack_court_words(torch.rand((B, 40), generator=g, device=card) < 0.7)
    dlo = torch.randint(0, 300, (B,), generator=g, device=card, dtype=torch.int32)
    dhi = torch.randint(600, 1000, (B,), generator=g, device=card, dtype=torch.int32)
    mins = torch.full((B,), -1e30, device=card)
    args = (q8, qs, top_p, part, ps, rows, cword, cbit, pdate, qwords, dlo, dhi, mins)
    kv, ks = sk.probe_candidates_cuda(*args)
    pv, ps_ = sk.probe_candidates_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(ks, ps_)
    assert torch.equal(kv, pv)
