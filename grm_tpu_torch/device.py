"""The port's device rule: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """``torch.device`` for an entry point's ``device`` argument.

    ``None`` means ``"cuda"``. A CUDA device raises when CUDA is absent:
    the port never falls back to the CPU on its own. ``"cpu"`` is honoured
    only when asked for; there every kernel runs its plain PyTorch version.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (--device cpu) to "
                "run the plain PyTorch versions on the CPU")
    elif dev.type != "cpu":
        raise ValueError("unsupported device %r: use 'cuda' or 'cpu'" % device)
    return dev
