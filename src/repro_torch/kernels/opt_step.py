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
fault-degraded pass in the kernel, as the reference's wrapper computes
it: ONE launch of ``opt_step.cu``'s masked instantiation, in place, the
masks passed as two 64-bit row words (no mask tensor on the card, no
synchronisation). Rows outside ``umask`` (dead and straggling workers)
are not stepped — their gradient and state are not read, their params
and state not written — the dispersion is over the alive rows, modes
"mean" / "group" write the exact masked (group) mean of the alive rows
to the alive rows and mode "mix" the rows of
``faults.degraded_matrix(W, alive)``. With a ``wire`` it is that launch
in mode "none", then the masked compressed event of
``csrc/compressed_mix.cu`` (one launch).
"""
from __future__ import annotations

import torch

from repro_torch import faults
from repro_torch.kernels import _build
from repro_torch.kernels.avg_disp import (_check_event, _check_mix,
                                          _compressed_event)
from repro_torch.kernels.ref import _KINDS, _MODES, opt_step_ref

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
    if plane.device.type != "cuda":
        raise ValueError(f"opt_step runs on cpu or cuda, not {plane.device}")
    return _card_step(plane, grads, planes, scalars, alive=alive,
                      umask=umask, **kw)


def _card_step(plane, grads, planes, scalars, *, kind, mode, groups, W,
               codes, wire, resid, u, error_feedback, alive=None,
               umask=None, **hyp):
    """The pass on the card: one ``opt_step.cu`` launch, in place, then
    the wire's compressed event; masked over ``alive`` / ``umask`` in
    the kernels when given (module note)."""
    m, p = plane.shape
    _build.check_workers("opt_step", m)
    _build.check_plane("opt_step", "plane", plane, plane)
    _build.check_plane("opt_step", "grads", grads, plane)
    for s in planes:
        _build.check_plane("opt_step", "state plane", s, plane)
    if codes is not None:
        _build.check_plane("opt_step", "codes", codes, plane[0])
    # the wire path's event inputs, checked before the update runs in place
    for name, t in (("resid", resid), ("u", u)):
        if t is not None:
            _build.check_plane("opt_step", name, t, plane)
    kmode = "none" if wire is not None else mode
    kW = W if kmode == "mix" else None
    masks = None
    if alive is not None:
        umask = alive if umask is None else umask
        masks = (_build.row_bits("opt_step", alive, m),
                 _build.row_bits("opt_step", umask, m))
        if kW is not None:
            kW = faults.degraded_matrix(kW, alive)
    if kW is not None:
        _build.check_matrix("opt_step", kW, plane)
    lr, c1, c2 = (float(v) for v in scalars.tolist()[:3])
    nblocks = -(-p // 256)
    dpart = torch.empty(nblocks, dtype=torch.float32, device=plane.device)
    disp = torch.empty((), dtype=torch.float32, device=plane.device)
    err = _launch(plane, grads, planes, codes, kW, dpart, disp, kind=kind,
                  mode=kmode, groups=groups, lr=lr, c1=c1, c2=c2,
                  masks=masks, **hyp)
    _build.check(err, "opt_step")
    opt_step.launches += 1
    if wire is None:
        return plane, tuple(planes), disp
    _compressed_event(plane, resid, wire=wire, mode=mode, groups=groups,
                      W=W, u=u, codes=codes, error_feedback=error_feedback,
                      alive=alive)
    return plane, tuple(planes), resid, disp


def _launch(plane, grads, planes, codes, W, dpart, disp, *, kind, mode,
            groups, lr, c1, c2, masks, mu, nesterov, b1, b2, eps,
            weight_decay) -> int:
    """``opt_step_launch`` of ``csrc/opt_step.cu`` on the current stream:
    ``masks`` None or the (alive, update) row words. Returns its
    ``cudaError_t``."""
    m, p = plane.shape
    s0 = planes[0].data_ptr() if planes else None
    s1 = planes[1].data_ptr() if len(planes) > 1 else None
    alive_bits, update_bits = masks if masks is not None else (0, 0)
    lib = _build.library("opt_step")
    with torch.cuda.device(plane.device):
        return lib.opt_step_launch(
            plane.data_ptr(), grads.data_ptr(), s0, s1,
            codes.data_ptr() if codes is not None else None,
            W.data_ptr() if W is not None else None,
            dpart.data_ptr(), disp.data_ptr(), m, p, _KINDS.index(kind),
            _MODES.index(mode), groups, lr, c1, c2, mu, int(nesterov),
            b1, 1 - b1, b2, 1 - b2, eps, weight_decay,
            int(masks is not None), alive_bits, update_bits,
            torch.cuda.current_stream().cuda_stream)


#: opt_step.cu launches so far (the CPU plain path does not count; the
#: wire path's compressed event counts in ``compressed_mix.launches``)
opt_step.launches = 0
