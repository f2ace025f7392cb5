"""Fused optimizer step (+ optional averaging) on the (M, P) plane.

The counterpart of the TPU kernel ``repro.kernels.opt_step.opt_step``:
the local SGD / Momentum (± Nesterov) / AdamW update of every worker
row, the per-column dtype rounding, the Eq. 4 dispersion of the updated
plane, and in mode "mean" / "group" the (group) mean broadcast back to
the rows, in mode "mix" the gossip mix ``W @`` the updated plane — one
pass over the planes. On CUDA tensors it launches the hand-written
kernel ``csrc/opt_step.cu`` (which updates ``plane`` and the state
planes IN PLACE); on CPU tensors it runs the plain version
``repro_torch.kernels.ref.opt_step_ref``. There is no other path: a
CUDA tensor the kernel cannot take raises.

With a ``wire`` the averaging event is the compressed one: on the card
``opt_step.cu`` runs the update in mode "none" and the compressed event
of ``csrc/compressed_mix.cu`` then encodes, averages or mixes the
updated plane and its residual in place — the update is written once
and read by the event, never applied twice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.avg_disp import (_check_event, _check_mix,
                                          _compressed_event)
from repro_torch.kernels.ref import _KINDS, _MODES, opt_step_ref

_STATE_PLANES = {"sgd": 0, "momentum": 1, "adamw": 2}


def opt_step(plane, grads, planes, scalars, *, kind, mode="none",
             groups: int = 1, W=None, mu=0.9, nesterov=False, b1=0.9,
             b2=0.95, eps=1e-8, weight_decay=0.0, codes=None, wire=None,
             resid=None, u=None, error_feedback: bool = True):
    """Fused optimizer step + optional averaging on the (M, P) plane.

    plane/grads: (M, P) f32; planes: tuple of S f32 state planes (S = 0
    sgd, 1 momentum, 2 adamw); scalars: (4,) f32 [lr, c1, c2, _], read
    on the host; codes: optional (P,) f32 rounding codes. mode: "none" |
    "mean" | "group" | "mix" (``W`` the (M, M) f32 mixing matrix).
    Returns (plane, state planes, Eq. 4 dispersion as a 0-dim tensor).
    On CUDA the returned plane and state planes are the input tensors,
    updated in place.

    ``wire`` (``bf16`` / ``int8`` / ``one_bit``, not with mode "none")
    makes the event the compressed one, with ``resid`` the (M, P)
    error-feedback residual and ``u`` the int8 uniforms; it returns
    (plane, state planes, residual, dispersion), on CUDA the residual
    updated in place too."""
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
    _check_mix(mode, W, m)
    if wire is not None:
        if mode == "none":
            raise ValueError("a wire format compresses an averaging event; "
                             "mode 'none' has none")
        _check_event("opt_step", plane, resid, wire, u)
    elif resid is not None or u is not None:
        raise ValueError("resid and u belong to the wire path")
    kw = dict(kind=kind, mode=mode, groups=groups, W=W, mu=mu,
              nesterov=nesterov, b1=b1, b2=b2, eps=eps,
              weight_decay=weight_decay, codes=codes, wire=wire,
              resid=resid, u=u, error_feedback=error_feedback)
    if plane.device.type == "cpu":
        return opt_step_ref(plane, grads, planes, scalars, **kw)
    if plane.device.type != "cuda":
        raise ValueError(f"opt_step runs on cpu or cuda, not {plane.device}")
    _build.check_workers("opt_step", m)
    _build.check_plane("opt_step", "plane", plane, plane)
    _build.check_plane("opt_step", "grads", grads, plane)
    for s in planes:
        _build.check_plane("opt_step", "state plane", s, plane)
    if codes is not None:
        _build.check_plane("opt_step", "codes", codes, plane[0])
    if W is not None:
        _build.check_matrix("opt_step", W, plane)
    # the wire path's event inputs, checked before the update runs in place
    for name, t in (("resid", resid), ("u", u)):
        if t is not None:
            _build.check_plane("opt_step", name, t, plane)
    lr, c1, c2 = (float(v) for v in scalars.tolist()[:3])
    nblocks = -(-p // 256)
    dpart = torch.empty(nblocks, dtype=torch.float32, device=plane.device)
    disp = torch.empty((), dtype=torch.float32, device=plane.device)
    s0 = planes[0].data_ptr() if planes else None
    s1 = planes[1].data_ptr() if len(planes) > 1 else None
    kmode = "none" if wire is not None else mode
    lib = _build.library("opt_step")
    with torch.cuda.device(plane.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.opt_step_launch(
            plane.data_ptr(), grads.data_ptr(), s0, s1,
            codes.data_ptr() if codes is not None else None,
            W.data_ptr() if W is not None else None,
            dpart.data_ptr(), disp.data_ptr(), m, p, _KINDS.index(kind),
            _MODES.index(kmode), groups, lr, c1, c2, mu, int(nesterov),
            b1, 1 - b1, b2, 1 - b2, eps, weight_decay, stream)
    _build.check(err, "opt_step")
    opt_step.launches += 1
    if wire is None:
        return plane, tuple(planes), disp
    _compressed_event(plane, resid, wire=wire, mode=mode, groups=groups,
                      W=W, u=u, codes=codes, error_feedback=error_feedback)
    return plane, tuple(planes), resid, disp


#: opt_step.cu launches so far (the CPU plain path does not count; the
#: wire path's compressed event counts in ``compressed_mix.launches``)
opt_step.launches = 0
