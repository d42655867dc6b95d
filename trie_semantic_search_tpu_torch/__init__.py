"""PyTorch/CUDA port of ``trie_semantic_search_tpu``.

The JAX package beside this one is the reference: every module here keeps
its counterpart's path and names (``ops/hybrid.py`` ports
``trie_semantic_search_tpu/ops/hybrid.py``, and so on), and the tests hold
each one against it. The Pallas kernels of the serving path are hand-written
CUDA kernels for Hopper (``csrc/*.cu``), bound through ``ctypes`` by
:mod:`.ops.scan_kernels`.

Device rule: entry points run on ``"cuda"`` unless the caller passes
``device="cpu"`` (the tests do); a missing card raises instead of falling
back (:func:`.device.resolve_device`). This package never imports ``jax``
or the JAX package.
"""

__version__ = "0.1.0"
