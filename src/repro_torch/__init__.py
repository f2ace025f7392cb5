"""PyTorch/CUDA port of ``repro``: local SGD with periodic averaging.

The package mirrors ``src/repro/``'s layout module for module
(``repro_torch/core/engine.py`` is the counterpart of
``repro/core/engine.py``) and imports only ``torch`` and numpy. The two
fused plane passes of the training path, ``opt_step`` and ``avg_disp``,
are hand-written CUDA kernels (``kernels/csrc/``); everything else is
eager PyTorch. Entry points run on the card (``device="cuda"``) unless
the caller asks for the CPU, where the kernels' plain versions run.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
