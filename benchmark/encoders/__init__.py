"""Encoder plug-ins, one file per architecture. A configuration's
``encoder`` block names its architecture under ``arch``, and the harness
loads ``benchmark/encoders/<arch>.py`` by that name; no list in code names
the architectures, so a new one enters with new files alone.

A plug-in has four functions, and the harness calls nothing else of it:

- ``reference_embeddings(torch, enc, seed, id_lists, device, precision)``:
  the plain reference's sentence embeddings ``[Q, width]`` (f32, on
  ``device``) of token-id lists, in float32 with TF32 off, or with
  ``precision="fp8"`` rounded to float8 where the served compute rounds
  (the control);
- ``build_model(torch, enc, seed, device)``: the port's encoder module for
  ``Embedder(model=...)``, holding the same seeded weights;
- ``flops(enc, tokens)``: the least FLOPs of the encoder over queries of
  ``tokens`` real tokens each (an MoE counts its active experts only);
- ``leaf_shapes(enc)``: each weight leaf's name and shape, in draw order.

Both weight-taking calls get the seed, not a weight tree: a plug-in makes
its own weights from it, the same bits on every call, and holds them no
longer than the call."""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(enc: dict):
    """The plug-in module that ``enc["arch"]`` names; a missing ``arch`` or
    plug-in file is an error."""
    arch = enc.get("arch")
    if not arch:
        raise KeyError("the configuration's encoder block names no 'arch'")
    path = HERE / f"{arch}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no encoder plug-in {path} for arch {arch!r}")
    name = f"benchmark.encoders.{arch}"
    mod = sys.modules.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return mod

