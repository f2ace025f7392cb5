"""Wall-clock measurement and the profiler hook.

The reference's timing policy (``repro.telemetry.timing``): one untimed
warm-up call (kernel builds, caches), then best-of-``reps`` wall clock,
so every caller shares one definition of "ms/step". CUDA launches return
before the device finishes, so a timed callable that returns tensors on
the card measures the enqueue unless the clock waits: ``block=True``
synchronizes the CUDA devices of the tensors the call returned (on the
CPU it does nothing).

:func:`profile_trace` wraps a block in ``torch.profiler.profile`` when
given a directory (``train.py --profile-dir``), and is a no-op
otherwise, so callers keep one unconditional ``with`` statement.
"""
from __future__ import annotations

import contextlib
import time


def _block(out):
    """Synchronize every CUDA device holding a tensor of ``out``."""
    import torch
    from repro_torch.core.flat import tree_flatten
    devs = {x.device for x in tree_flatten(out)[0]
            if isinstance(x, torch.Tensor) and x.device.type == "cuda"}
    for d in devs:
        torch.cuda.synchronize(d)
    return out


def timed(fn, *, block: bool = False) -> float:
    """Seconds for ONE ``fn()`` call. ``block=True`` synchronizes the
    devices of the returned tensors before stopping the clock."""
    t0 = time.perf_counter()
    out = fn()
    if block:
        _block(out)
    return time.perf_counter() - t0


def time_run(fn, steps: int, *, reps: int = 3, warmup: int = 1,
             block: bool = False) -> float:
    """ms/step: best of ``reps`` timed ``fn()`` calls after ``warmup``
    untimed ones (``warmup=0`` measures the cold start)."""
    if steps < 1:
        raise ValueError(f"time_run needs steps >= 1, got {steps}")
    if reps < 1:
        raise ValueError(f"time_run needs reps >= 1, got {reps}")
    for _ in range(warmup):
        out = fn()
        if block:
            _block(out)
    best = min(timed(fn, block=block) for _ in range(reps))
    return best / steps * 1e3


@contextlib.contextmanager
def profile_trace(profile_dir: str | None):
    """``torch.profiler.profile`` over the block when a directory is
    given, else a no-op: CPU activities, and CUDA ones when a card is
    present, written into ``profile_dir`` as a TensorBoard-loadable
    trace (``tensorboard_trace_handler``). Work still queued on the card
    is waited for before the profiler stops, so its kernels are in the
    trace."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    handler = torch.profiler.tensorboard_trace_handler(str(profile_dir))
    with profile(activities=acts, on_trace_ready=handler):
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
