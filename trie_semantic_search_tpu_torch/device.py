"""The port's device rule: CUDA unless the caller asks for the CPU.

There is no "cuda if available else cpu": a serving process that silently
lands on the CPU would answer every query at a fraction of the speed it was
sized for, so a missing card is an error the caller sees.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]

#: device of every entry point when the caller names none
DEFAULT_DEVICE = "cuda"


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``; raises
    ``RuntimeError`` when it names CUDA and no card is visible."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
