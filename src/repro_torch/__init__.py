"""PyTorch/CUDA port of ``repro``: local SGD with periodic averaging.

The package mirrors ``src/repro/``'s layout module for module
(``repro_torch/core/engine.py`` is the counterpart of
``repro/core/engine.py``) and imports only ``torch`` and numpy. The two
fused plane passes of the training path, ``opt_step`` and ``avg_disp``,
are hand-written CUDA kernels (``kernels/csrc/``); everything else is
eager PyTorch. Entry points run on the card (``device="cuda"``) unless
the caller asks for the CPU, where the kernels' plain versions run.
"""
__all__ = ["resolve_device"]


def __getattr__(name):
    # lazy: ``repro_torch.device`` loads torch, and ``repro_torch.analysis``
    # must import where torch is not installed
    if name == "resolve_device":
        from repro_torch.device import resolve_device
        return resolve_device
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
