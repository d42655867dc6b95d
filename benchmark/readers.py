"""Arithmetic shared by the metric readers in ``metrics/``: each reader
file names one metric and calls one of these on the run's observations.
A reader returns None where its run has nothing to read, and the metric
is then left out of the result line."""

from __future__ import annotations

from . import costs


def span_mean_ms(obs: dict, name: str):
    count, total = obs["spans"].get(name, (0, 0.0))
    return total / count if count else None


def hydrate_ms(obs: dict):
    """The mean ``search_batch`` span less the mean ``fused_embed`` and
    ``fused_device`` spans over the window: hydration, snippets and the
    engine's other host work. Means of each span on its own, since a batch
    in flight at the window's edge has some of its spans inside and some
    outside."""
    parts = [span_mean_ms(obs, n) for n in ("search_batch", "fused_embed", "fused_device")]
    return None if None in parts else parts[0] - parts[1] - parts[2]


def latency_percentile(obs: dict, q: float):
    lat = obs.get("latencies_ms")
    if not lat:
        return None
    x = costs.percentile(lat, q)
    # a failed request is slower than any served one; past the client's
    # wait it has no finite time, so it reads as that wait
    return x if x != float("inf") else float(obs["cfg"]["serving"]["failed_request_ms"])


def _probed(obs: dict, idx: list[int]) -> int:
    """Distinct partitions that the queries ``idx`` probe: each query's
    ``nprobe`` nearest centroids by its reference embedding."""
    import torch

    from .data import corpus_slabs

    cache = obs.setdefault("_probe_sets", {})
    missing = [i for i in idx if i not in cache]
    if missing:
        c = obs["corpus"]
        cents = obs.get("_centroids")
        if cents is None:
            dev = obs["ref_emb"].device
            cents = torch.cat([cc for _p0, cc, _v in corpus_slabs(
                torch, c["partitions"], c["slots"], c["dim"], c["seed"], dev)])
            obs["_centroids"] = cents
        q = obs["ref_emb"][torch.as_tensor(missing, device=cents.device)]
        top = torch.topk(q @ cents.T, k=min(c["nprobe"], cents.shape[0]), dim=1).indices.cpu().numpy()
        for i, t in zip(missing, top):
            cache[i] = set(t.tolist())
    return len(set().union(*(cache[i] for i in idx)))


def least_semantic_s(obs: dict, idx: list[int]) -> float:
    c = obs["corpus"]
    return costs.seconds_for_bytes(costs.probe_bytes(_probed(obs, idx), c["slots"], c["dim"]))


def least_encoder_s(obs: dict, idx: list[int]) -> float:
    toks = [len(obs["token_ids"][i]) for i in idx]
    return costs.seconds_for_bf16_flops(costs.encoder_flops(obs["cfg"]["encoder"], toks))


def kernel_roofline(obs: dict, fragment: str, least) -> float | None:
    """100 × Σ least time ÷ Σ device time of the kernels whose name holds
    ``fragment``, over the traced batches that launched one."""
    tr = obs.get("trace")
    if not tr:
        return None
    num = den = 0.0
    for bi, kernels in tr["per_batch"].items():
        t = sum(us for name, us in kernels.items() if fragment in name) / 1e6
        if t > 0:
            num += least(obs, tr["batches"][bi][2])
            den += t
    return 100.0 * num / den if den else None


def stream_least_s(obs: dict, _idx) -> float:
    c = obs["corpus"]
    return costs.seconds_for_bytes(costs.stream_bytes(c["partitions"], c["slots"], c["dim"]))


def idle_share(obs: dict):
    tr = obs.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def step_mfu(obs: dict):
    """100 × Σ over the window's batches of the least time (encoder FLOPs
    of the real tokens at the bf16 peak, plus the probed partitions' bytes
    at the HBM peak) ÷ Σ of their wall times."""
    bs = obs.get("window_batches") or []
    if not bs or obs.get("trace") is None:
        return None
    least = sum(least_encoder_s(obs, b[2]) + least_semantic_s(obs, b[2]) for b in bs)
    wall = sum(b[1] - b[0] for b in bs)
    return 100.0 * least / wall if wall > 0 else None
