"""Device resolution: the port runs on the card unless told otherwise.

Every entry point takes ``device`` (default ``"cuda"``) and passes it
through :func:`resolve_device`, which refuses to fall back to the CPU
when CUDA was asked for and is missing — a run that silently lands on
the CPU would report CPU numbers under a GPU's name.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises ``RuntimeError``
    when it names CUDA and no CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False — pass device='cpu' to run on the CPU explicitly")
    return dev
