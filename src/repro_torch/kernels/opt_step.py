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

``alive`` / ``umask`` ((M,) 0/1, :mod:`repro_torch.faults`) run the
fault-degraded pass as the reference's wrapper does: ``opt_step.cu`` in
mode "none", the rows outside ``umask`` (dead and straggling workers)
written back from copies saved before the in-place launch — params and
state planes, k rows and not a plane — then the masked event of
``repro_torch.kernels.avg_disp`` (``avg_disp`` / ``mix_disp`` /
``compressed_mix`` with ``alive``, each one kernel launch), on a coded
plane the alive rows rounded to their codes after the event, and the
event's output copied back into the plane.
"""
from __future__ import annotations

import torch

from repro_torch import faults
from repro_torch.kernels import _build
from repro_torch.kernels.avg_disp import (_check_event, _check_mix,
                                          _compressed_event, avg_disp,
                                          compressed_mix, mix_disp)
from repro_torch.kernels.ref import (_KINDS, _MODES, opt_step_ref,
                                     round_to_codes)

#: columns per chunk of the in-place rounding after a masked event
_ROUND_COLS = 1 << 24

_STATE_PLANES = {"sgd": 0, "momentum": 1, "adamw": 2}


def opt_step(plane, grads, planes, scalars, *, kind, mode="none",
             groups: int = 1, W=None, mu=0.9, nesterov=False, b1=0.9,
             b2=0.95, eps=1e-8, weight_decay=0.0, codes=None, wire=None,
             resid=None, u=None, error_feedback: bool = True, alive=None,
             umask=None):
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
    updated in place too.

    ``alive`` / ``umask`` make it the fault-degraded pass (module note),
    on CUDA in place as well."""
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
        return opt_step_ref(plane, grads, planes, scalars, alive=alive,
                            umask=umask, **kw)
    if alive is not None:
        return _fault_step(plane, grads, planes, scalars, alive,
                           alive if umask is None else umask, **kw)
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


def _fault_step(plane, grads, planes, scalars, alive, umask, *, kind, mode,
                groups, W, codes, wire, resid, u, error_feedback, **hyp):
    """The fault-degraded pass on the card (module note)."""
    frozen = faults.rows_where(umask, on=False)
    saved = [[t[i].clone() for t in (plane, *planes)] for i in frozen]
    plane, planes, _ = opt_step(plane, grads, planes, scalars, kind=kind,
                                codes=codes, **hyp)
    for i, rows in zip(frozen, saved):
        for t, row in zip((plane, *planes), rows):
            t[i] = row
    del saved  # not held through the event's new plane
    if wire is not None:
        plane, resid, disp = compressed_mix(
            plane, resid, wire=wire, mode=mode, groups=groups, W=W, u=u,
            codes=codes, error_feedback=error_feedback, alive=alive)
        return plane, planes, resid, disp
    if mode == "none":
        return plane, planes, faults.masked_dispersion(plane, alive)
    if mode == "mix":
        out, disp = mix_disp(plane, W, alive=alive)
    else:
        out, disp = avg_disp(plane, groups=groups if mode == "group" else 1,
                             alive=alive)
    if codes is not None:
        # the dead rows are the update's, already on their codes
        for i in faults.rows_where(alive):
            for c0 in range(0, out.shape[1], _ROUND_COLS):
                seg = out[i, c0:c0 + _ROUND_COLS]
                seg.copy_(round_to_codes(seg, codes[c0:c0 + _ROUND_COLS]))
    # back into the plane, which stays the caller's one tensor: a new one
    # each step would coexist with the plane its phase started from
    plane.copy_(out)
    return plane, planes, disp


#: opt_step.cu launches so far (the CPU plain path does not count; the
#: wire path's compressed event counts in ``compressed_mix.launches``)
opt_step.launches = 0
