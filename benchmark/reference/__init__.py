"""The plain reference: plain PyTorch and NumPy that imports nothing of the
program under test and nothing of JAX. One file per encoder architecture
(``<arch>.py``, the forward pass its plug-in in ``benchmark/encoders/``
calls) and the search's own rules (``search.py``, ``wordpiece.py``); the
helpers every architecture's forward shares are here."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def exact_f32(torch):
    """Matrix products in full float32 (no TF32) inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def fp8(torch, x, dim: int):
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the control's rounding, the step below bf16)."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def encode_batches(torch, forward, id_lists: list[list[int]], width: int, device, batch: int = 512):
    """Sentence embeddings ``[Q, width]`` (f32, on ``device``) of token-id
    lists: ``forward(ids, mask)`` over batches of lists of like length, each
    padded at its end to its longest list under the mask (which leaves every
    embedding as it is alone), with TF32 off and no gradients."""
    order = sorted(range(len(id_lists)), key=lambda i: len(id_lists[i]))
    out = torch.empty((len(id_lists), width), device=device)
    with exact_f32(torch), torch.no_grad():
        for s in range(0, len(order), batch):
            sel = order[s : s + batch]
            L = max(len(id_lists[i]) for i in sel)
            ids = torch.zeros((len(sel), L), dtype=torch.long)
            mask = torch.zeros((len(sel), L), dtype=torch.long)
            for r, i in enumerate(sel):
                ids[r, : len(id_lists[i])] = torch.as_tensor(id_lists[i])
                mask[r, : len(id_lists[i])] = 1
            out[torch.as_tensor(sel, device=device)] = forward(ids.to(device), mask.to(device))
    return out
