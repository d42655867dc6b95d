"""Routed experts of a mixture-of-experts layer as grouped products.

:func:`grouped_expert_ffn` runs every routed expert's SiLU-gated FFN over
the tokens routed to it: the (token, expert) assignments are sorted by
expert, and each expert's run of them is one group. On CUDA tensors in
bf16 three grouped products (``torch._grouped_mm``: CUTLASS's grouped GEMM
on an H100, bf16 with f32 accumulation) run every group at once, the gate
and the up projection of the tokens' rows gathered in group order, then the
down projection of ``silu(gate) * up``; the groups' ends (the running sum
of their sizes) stay on the device, so nothing waits for it. Each
assignment's output is put back at its own row, so a token's ``k`` rows lie
together, and the ``k`` are weighted by their routing weights and added in
f32. The device trace finds the grouped products by :data:`KERNEL_NAME`.

On CPU tensors, and at other dtypes (which the grouped product's fast path
does not take), the plain version loops over the experts and rounds at the
same sites: each product accumulated in f32 and rounded to the weights'
dtype, as the published FFN rounds, the gated activation at that dtype, the
weighted sum in f32. :func:`grouped_expert_ffn_plain` runs it on any device
(what the grouped products are held against). Each grouped call adds one
to :data:`LAUNCHES`."""

from __future__ import annotations

import threading

import torch

#: a part of the device kernel's name that the grouped products alone carry
#: (CUTLASS's problem shape of a grouped GEMM)
KERNEL_NAME = "GroupProblemShape"

#: grouped calls of :func:`grouped_expert_ffn` since the last
#: :func:`reset_launch_counts` (three grouped products each)
LAUNCHES = {"grouped_expert_ffn": 0}
_launch_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def route_groups(expert_idx: torch.Tensor, n_experts: int):
    """``(order, counts)`` of the assignments ``expert_idx [n, k]``:
    ``order [n*k]`` lists the flat assignment positions sorted by expert
    (stably, so a group keeps token order) and ``counts [E]`` int64 the
    group sizes, both on the device, computed without a sync."""
    flat = expert_idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(n_experts, dtype=torch.int64, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    return order, counts


def grouped_expert_ffn(
    x: torch.Tensor,  # [n, H] tokens, at the weights' dtype
    expert_idx: torch.Tensor,  # [n, k] int64 routed experts of each token
    expert_weight: torch.Tensor,  # [n, k] f32 routing weights
    w_gate: torch.Tensor,  # [E, H, F]
    w_up: torch.Tensor,  # [E, H, F]
    w_down: torch.Tensor,  # [E, F, H]
    order: torch.Tensor | None = None,
    counts: torch.Tensor | None = None,
) -> torch.Tensor:
    """``[n, H]`` f32: for each token the sum over its ``k`` experts of the
    routing weight times the expert's output on the token,
    ``(silu(x Wg) * (x Wu)) Wd`` rounded as the published FFN rounds.
    ``order``/``counts``: :func:`route_groups` of ``expert_idx`` where the
    caller has them."""
    if order is None or counts is None:
        order, counts = route_groups(expert_idx, w_gate.shape[0])
    grouped = x.is_cuda and w_gate.dtype == torch.bfloat16
    run = _grouped_products if grouped else _grouped_plain
    y = run(x.to(w_gate.dtype), order, expert_idx.shape[1], counts, w_gate, w_up, w_down)
    if grouped:
        with _launch_lock:
            LAUNCHES["grouped_expert_ffn"] += 1
    return _weighted_sum(y, expert_weight)


def grouped_expert_ffn_plain(x, expert_idx, expert_weight, w_gate, w_up, w_down) -> torch.Tensor:
    """:func:`grouped_expert_ffn` with the plain per-expert loop on any
    device."""
    order, counts = route_groups(expert_idx, w_gate.shape[0])
    y = _grouped_plain(x.to(w_gate.dtype), order, expert_idx.shape[1], counts, w_gate, w_up, w_down)
    return _weighted_sum(y, expert_weight)


def _weighted_sum(y: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``[n, H]`` f32: each token's ``k`` rows of ``y [n*k, H]`` times their
    routing weights ``[n, k]``, added."""
    n, k = weight.shape
    return (y.view(n, k, -1) * weight.view(n, k, 1).float()).sum(dim=1)


def _grouped_plain(x, order, k, counts, w_gate, w_up, w_down) -> torch.Tensor:
    """Every assignment's expert output ``[n*k, H]`` at its own row, one
    expert at a time (reads the group sizes on the host); ``order``: the
    assignments sorted by expert."""
    dt = w_gate.dtype
    out = torch.empty((order.shape[0], w_down.shape[2]), dtype=dt, device=x.device)
    start = 0
    for e, c in enumerate(counts.tolist()):
        if c:
            rows = order[start : start + c]
            xs = x[rows // k].float()
            g, u = (xs @ w_gate[e].float()).to(dt), (xs @ w_up[e].float()).to(dt)
            h = torch.nn.functional.silu(g) * u
            out[rows] = (h.float() @ w_down[e].float()).to(dt)
        start += c
    return out


def _grouped_products(x, order, k, counts, w_gate, w_up, w_down) -> torch.Tensor:
    """:func:`_grouped_plain` as three grouped products over the groups,
    with no host sync."""
    ends = torch.cumsum(counts, 0).to(torch.int32)
    xs = x.index_select(0, order // k)
    g = torch._grouped_mm(xs, w_gate, offs=ends)
    u = torch._grouped_mm(xs, w_up, offs=ends)
    h = torch.nn.functional.silu(g).mul_(u)
    y = torch.empty_like(xs)
    y[order] = torch._grouped_mm(h, w_down, offs=ends)
    return y
