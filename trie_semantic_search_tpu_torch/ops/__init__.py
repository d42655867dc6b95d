"""Tensor operations of the serving path and the Hopper kernel wrappers.

The public int8 scan op keeps the JAX package's names: ``fused_int8_topk``
(the scan with an exact top-k that keeps the ``[B, N]`` scores out of
device memory; its kernel, ``int8_topk``, replaces ``pallas_int8_topk``)
and ``xla_int8_topk`` (the materialised-scores reference).
"""

from .scan_kernels import fused_int8_topk, int8_topk, xla_int8_topk

__all__ = ["fused_int8_topk", "int8_topk", "xla_int8_topk"]
