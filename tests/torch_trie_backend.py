"""Both packages' trie builders forced onto one backend for a test.

``python``: each package's ``native.available`` reports False and its
``csr_from_sorted_windows`` returns None, so ``FastTrieBuilder`` runs the
Python ``TrieBuilder`` and the spill the Python CSR pass. ``native``: the
defaults, which this checks are the native libraries (g++ builds them at
first use).
"""

import trie_semantic_search_tpu.native as jax_native
import trie_semantic_search_tpu_torch.native as port_native

BACKENDS = ("python", "native")


def force_trie_backend(monkeypatch, backend: str) -> None:
    if backend == "python":
        for mod in (jax_native, port_native):
            monkeypatch.setattr(mod, "available", lambda: False)
            monkeypatch.setattr(mod, "csr_from_sorted_windows", lambda *a, **k: None)
    else:
        assert backend == "native", backend
        assert jax_native.available() and port_native.available()
