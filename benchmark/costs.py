"""The yardstick's arithmetic: the card's peaks, the least bytes and
operations of the work the benchmark hands the system, and percentiles.
Counts come from the inputs' shapes, never from the program, so they hold
whatever implements the work."""

from __future__ import annotations

import math

from . import encoders

#: NVIDIA H100 SXM peaks (NVIDIA's data sheet, dense): bytes/s of HBM3 and
#: bf16 tensor-core FLOP/s, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def encoder_flops(enc: dict, tokens: list[int]) -> float:
    """FLOPs of the encoder over queries of ``tokens`` real tokens each
    (``[CLS]`` and ``[SEP]`` included, padding not), as the plug-in of its
    architecture counts them."""
    return encoders.load(enc).flops(enc, tokens)


def partition_bytes(slots: int, dim: int) -> int:
    """Bytes of one partition's int8 rows and their f32 scales."""
    return slots * (dim + 4)


def probe_bytes(probed_partitions: int, slots: int, dim: int) -> int:
    """The probe's least read: every partition the batch probes, once."""
    return probed_partitions * partition_bytes(slots, dim)


def stream_bytes(partitions: int, slots: int, dim: int) -> int:
    """The stream's least read: the whole int8 corpus and its scales."""
    return partitions * partition_bytes(slots, dim)


def seconds_for_bytes(n: float) -> float:
    return n / HBM_BYTES_PER_S


def seconds_for_bf16_flops(n: float) -> float:
    return n / BF16_FLOP_PER_S


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile of every value (``inf`` for a
    request that failed, slower than any served one)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return xs[max(0, math.ceil(q / 100 * len(xs)) - 1)]


def union_seconds(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total
