"""Fused optimizer step (+ optional averaging) on the (M, P) plane.

The counterpart of the TPU kernel ``repro.kernels.opt_step.opt_step``:
the local SGD / Momentum (± Nesterov) / AdamW update of every worker
row, the per-column dtype rounding, the Eq. 4 dispersion of the updated
plane, and in mode "mean" / "group" the (group) mean broadcast back to
the rows — one pass over the planes. On CUDA tensors it launches the
hand-written kernel ``csrc/opt_step.cu`` (which updates ``plane`` and
the state planes IN PLACE); on CPU tensors it runs the plain version
``repro_torch.kernels.ref.opt_step_ref``. There is no other path: a
CUDA tensor the kernel cannot take raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import _KINDS, _MODES, opt_step_ref

_STATE_PLANES = {"sgd": 0, "momentum": 1, "adamw": 2}
MAX_WORKERS = 64


def _check_plane(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if (t.device != like.device or t.dtype != torch.float32
            or t.shape != like.shape or not t.is_contiguous()):
        raise ValueError(
            f"opt_step: {name} must be a contiguous float32 tensor of shape "
            f"{tuple(like.shape)} on {like.device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def opt_step(plane, grads, planes, scalars, *, kind, mode="none",
             groups: int = 1, mu=0.9, nesterov=False, b1=0.9, b2=0.95,
             eps=1e-8, weight_decay=0.0, codes=None):
    """Fused optimizer step + optional averaging on the (M, P) plane.

    plane/grads: (M, P) f32; planes: tuple of S f32 state planes (S = 0
    sgd, 1 momentum, 2 adamw); scalars: (4,) f32 [lr, c1, c2, _], read
    on the host; codes: optional (P,) f32 rounding codes. mode: "none" |
    "mean" | "group". Returns (plane, state planes, Eq. 4 dispersion as a
    0-dim tensor). On CUDA the returned plane and state planes are the
    input tensors, updated in place."""
    if kind not in _KINDS:
        raise ValueError(f"unknown plane optimizer kind {kind!r}")
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r} (the port runs {_MODES})")
    m, p = plane.shape
    if groups < 1 or m % groups:
        raise ValueError(f"groups={groups} must divide the {m} worker rows")
    if len(planes) != _STATE_PLANES[kind]:
        raise ValueError(f"{kind} carries {_STATE_PLANES[kind]} state "
                         f"planes, got {len(planes)}")
    kw = dict(kind=kind, mode=mode, groups=groups, mu=mu, nesterov=nesterov,
              b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, codes=codes)
    if plane.device.type == "cpu":
        return opt_step_ref(plane, grads, planes, scalars, **kw)
    if plane.device.type != "cuda":
        raise ValueError(f"opt_step runs on cpu or cuda, not {plane.device}")
    if not 1 <= m <= MAX_WORKERS:
        raise ValueError(f"opt_step's kernel takes 1..{MAX_WORKERS} worker "
                         f"rows, got {m}")
    _check_plane("plane", plane, plane)
    _check_plane("grads", grads, plane)
    for s in planes:
        _check_plane("state plane", s, plane)
    if codes is not None:
        _check_plane("codes", codes, plane[0])
    lr, c1, c2 = (float(v) for v in scalars.tolist()[:3])
    nblocks = -(-p // 256)
    dpart = torch.empty(nblocks, dtype=torch.float32, device=plane.device)
    disp = torch.empty((), dtype=torch.float32, device=plane.device)
    s0 = planes[0].data_ptr() if planes else None
    s1 = planes[1].data_ptr() if len(planes) > 1 else None
    lib = _build.library("opt_step")
    with torch.cuda.device(plane.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.opt_step_launch(
            plane.data_ptr(), grads.data_ptr(), s0, s1,
            codes.data_ptr() if codes is not None else None,
            dpart.data_ptr(), disp.data_ptr(), m, p, _KINDS.index(kind),
            _MODES.index(mode), groups, lr, c1, c2, mu, int(nesterov),
            b1, 1 - b1, b2, 1 - b2, eps, weight_decay, stream)
    _build.check(err, "opt_step")
    opt_step.launches += 1
    return plane, tuple(planes), disp


#: kernel launches so far (the CPU plain path does not count)
opt_step.launches = 0
