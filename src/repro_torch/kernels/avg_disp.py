"""The averaging events on the flat (M, P) plane, each one fused pass.

The counterparts of the TPU kernels of ``repro.kernels.avg_disp``:

  - :func:`avg_disp`: the worker mean (or the means of ``groups``
    contiguous worker groups — the hierarchical schedule's inner event)
    broadcast back to every row, plus the Eq. 4 dispersion against the
    global mean (``csrc/avg_disp.cu``);
  - :func:`mix_disp`: the gossip mix ``W @ plane`` for a
    doubly-stochastic (M, M) ``W``, each worker keeping its own mixed
    row, plus the pre-mix dispersion (``csrc/mix_disp.cu``);
  - :func:`avg_disp_outer`: the mean, the dispersion and the outer
    optimizer's momentum step on it, broadcast (``csrc/avg_disp_outer.cu``);
  - :func:`compressed_mix`: the error-feedback encode through a wire
    format, the mean / group mean / mix of the decoded plane, the
    residual and the pre-encode dispersion (``csrc/compressed_mix.cu``).

On CUDA tensors each launches its kernel; on CPU tensors it runs the
plain version in ``repro_torch.kernels.ref``. A CUDA tensor a kernel
cannot take raises. ``avg_disp``, ``mix_disp`` and ``avg_disp_outer``
return new tensors; ``compressed_mix`` updates the plane and the
residual in place on the card (a full-width plane is 5.8 GB).

``alive`` ((M,) 0/1, :mod:`repro_torch.faults`) degrades ``avg_disp``,
``mix_disp`` and ``compressed_mix`` over the alive rows, as the
reference's wrappers do. ``compressed_mix`` masks the event in its
kernel: ONE launch of ``compressed_mix.cu``'s masked instantiation, the
mask a 64-bit row word; dead rows ship nothing (not read, encoded or
written: they keep their params and residual), the dispersion is the
pre-encode one over the alive rows, modes "mean" / "group" take the
exact masked (group) mean of the alive rows' decoded plane and mode
"mix" ``faults.degraded_matrix(W, alive)`` — bitwise the plain versions
(one_bit: within one ulp of its row scale). ``avg_disp`` and
``mix_disp`` still run their masked event as a wrapper over
``mix_disp.cu``: a masked (group) mean is the mix ``A @ plane`` with ``A
= faults.masked_event_matrix`` (identity rows for dead workers), a
gossip ``W`` becomes the degraded one, dead rows are written back, and
the dispersion is ``faults.masked_dispersion`` of the input plane; that
matrix's mean agrees with the plain versions' exact masked sums to
rounding.
"""
from __future__ import annotations

import torch

from repro_torch import faults
from repro_torch.kernels import _build
from repro_torch.kernels.ref import (_WIRES, avg_disp_outer_ref,
                                     avg_disp_ref, compressed_avg_ref,
                                     compressed_mix_ref, mix_disp_ref)

_EVENT_MODES = ("mean", "group", "mix")
#: columns per block of compressed_mix.cu's row-statistic pass
_STAT_COLS = 4096


def _cuda_plane(what: str, plane) -> None:
    if plane.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {plane.device}")
    _build.check_workers(what, plane.shape[0])
    _build.check_plane(what, "plane", plane, plane)


def _scratch(plane):
    """(dispersion partials, dispersion) for a column sweep."""
    p = plane.shape[1]
    return (torch.empty(-(-p // 256), dtype=torch.float32,
                        device=plane.device),
            torch.empty((), dtype=torch.float32, device=plane.device))


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def avg_disp(plane, *, groups: int = 1, alive=None):
    """plane: (M, P) float32 -> (averaged plane, Eq. 4 dispersion as a
    0-dim tensor). ``groups`` > 1 broadcasts per-group means; the
    dispersion is always against the global mean. The output is a new
    tensor; the input is not modified. With ``alive`` the masked event
    runs through ``mix_disp`` (module note) and counts there."""
    m, p = plane.shape
    if groups < 1 or m % groups:
        raise ValueError(f"groups={groups} must divide the {m} worker rows")
    if plane.device.type == "cpu":
        return avg_disp_ref(plane, groups=groups, alive=alive)
    if alive is not None:
        A = faults.masked_event_matrix(alive, groups, device=plane.device)
        return _masked_mix(plane, A, alive)
    _cuda_plane("avg_disp", plane)
    out = torch.empty_like(plane)
    dpart, disp = _scratch(plane)
    lib = _build.library("avg_disp")
    with torch.cuda.device(plane.device):
        err = lib.avg_disp_launch(
            plane.data_ptr(), out.data_ptr(), dpart.data_ptr(),
            disp.data_ptr(), m, p, groups, _stream())
    _build.check(err, "avg_disp")
    avg_disp.launches += 1
    return out, disp


def _masked_mix(plane, W, alive):
    """The masked event of matrix ``W`` on the card: one ``mix_disp``
    launch, the dead rows kept, the alive set's dispersion."""
    disp = faults.masked_dispersion(plane, alive)
    out = mix_disp(plane, W)[0]
    return faults.keep_rows_(out, plane, alive), disp


def mix_disp(plane, W, *, alive=None):
    """plane: (M, P) float32, W: (M, M) float32 doubly stochastic ->
    (W @ plane, Eq. 4 dispersion of the input plane). Each worker keeps
    its own mixed row. The output is a new tensor. ``alive`` mixes with
    ``faults.degraded_matrix(W, alive)`` (module note)."""
    m, p = plane.shape
    if tuple(W.shape) != (m, m):
        raise ValueError(f"W must be ({m}, {m}), got {tuple(W.shape)}")
    if plane.device.type == "cpu":
        return mix_disp_ref(plane, W, alive=alive)
    if alive is not None:
        return _masked_mix(plane, faults.degraded_matrix(W, alive), alive)
    _cuda_plane("mix_disp", plane)
    _build.check_matrix("mix_disp", W, plane)
    out = torch.empty_like(plane)
    dpart, disp = _scratch(plane)
    lib = _build.library("mix_disp")
    with torch.cuda.device(plane.device):
        err = lib.mix_disp_launch(
            plane.data_ptr(), W.data_ptr(), out.data_ptr(),
            dpart.data_ptr(), disp.data_ptr(), m, p, _stream())
    _build.check(err, "mix_disp")
    mix_disp.launches += 1
    return out, disp


def avg_disp_outer(plane, prev_avg, vel, *, lr: float, momentum: float,
                   nesterov: bool = True):
    """Fused all-average + dispersion + outer momentum step. plane:
    (M, P) f32; prev_avg/vel: (P,) f32. Returns (averaged plane,
    new_avg, new_vel, dispersion), all new tensors."""
    m, p = plane.shape
    for name, t in (("prev_avg", prev_avg), ("vel", vel)):
        if tuple(t.shape) != (p,):
            raise ValueError(f"{name} must be ({p},), got {tuple(t.shape)}")
    kw = dict(lr=lr, momentum=momentum, nesterov=nesterov)
    if plane.device.type == "cpu":
        return avg_disp_outer_ref(plane, prev_avg, vel, **kw)
    _cuda_plane("avg_disp_outer", plane)
    _build.check_plane("avg_disp_outer", "prev_avg", prev_avg, plane[0])
    _build.check_plane("avg_disp_outer", "vel", vel, plane[0])
    out = torch.empty_like(plane)
    new_avg, new_vel = torch.empty_like(prev_avg), torch.empty_like(vel)
    dpart, disp = _scratch(plane)
    lib = _build.library("avg_disp_outer")
    with torch.cuda.device(plane.device):
        err = lib.avg_disp_outer_launch(
            plane.data_ptr(), prev_avg.data_ptr(), vel.data_ptr(),
            out.data_ptr(), new_avg.data_ptr(), new_vel.data_ptr(),
            dpart.data_ptr(), disp.data_ptr(), m, p, lr, momentum,
            int(nesterov), _stream())
    _build.check(err, "avg_disp_outer")
    avg_disp_outer.launches += 1
    return out, new_avg, new_vel, disp


def _check_mix(mode: str, W, m: int) -> None:
    """Mode "mix" takes an (M, M) ``W``, and only mode "mix" does."""
    if (W is not None) != (mode == "mix"):
        raise ValueError("mode 'mix' takes the mixing matrix W, and only "
                         "mode 'mix' does")
    if W is not None and tuple(W.shape) != (m, m):
        raise ValueError(f"W must be ({m}, {m}), got {tuple(W.shape)}")


def _check_event(what: str, plane, resid, wire, u) -> None:
    """The compressed event's arguments, on any device."""
    if wire not in _WIRES:
        raise ValueError(f"{what}: wire must be one of {_WIRES}, got "
                         f"{wire!r} (f32 is the uncompressed path)")
    if resid is None or resid.shape != plane.shape:
        raise ValueError(f"{what}: the residual must be a plane of shape "
                         f"{tuple(plane.shape)}")
    if (u is not None) != (wire == "int8"):
        raise ValueError(f"{what}: the uniforms u belong to int8, and int8 "
                         "needs them")
    if u is not None and u.shape != plane.shape:
        raise ValueError(f"{what}: u must be a plane of shape "
                         f"{tuple(plane.shape)}")


def _compressed_event(plane, resid, *, wire, mode, groups, W, u, codes,
                      error_feedback, alive=None):
    """One launch of ``csrc/compressed_mix.cu`` on the card's tensors:
    the plane and the residual are updated in place; ``alive`` masks the
    event in the kernel (module note). Counts the launch in
    ``compressed_mix.launches``, whichever wrapper calls it. Returns the
    dispersion."""
    what = "compressed_mix"
    m, p = plane.shape
    _build.check_workers(what, m)
    _build.check_plane(what, "plane", plane, plane)
    _build.check_plane(what, "resid", resid, plane)
    if u is not None:
        _build.check_plane(what, "u", u, plane)
    if codes is not None:
        _build.check_plane(what, "codes", codes, plane[0])
    alive_bits = None
    if alive is not None:
        alive_bits = _build.row_bits(what, alive, m)
        if W is not None:
            W = faults.degraded_matrix(W, alive)
    if W is not None:
        _build.check_matrix(what, W, plane)
    dev = plane.device
    scaled = wire != "bf16"
    rowpart = torch.empty(-(-p // _STAT_COLS) * m if scaled else 1,
                          dtype=torch.float64, device=dev)
    scales = torch.empty(m, dtype=torch.float32, device=dev)
    dpart, disp = _scratch(plane)
    err = _compressed_launch(plane, resid, u, codes, W, rowpart, scales,
                             dpart, disp, wire=wire, mode=mode,
                             groups=groups, error_feedback=error_feedback,
                             alive_bits=alive_bits)
    _build.check(err, what)
    compressed_mix.launches += 1
    return disp


def _compressed_launch(plane, resid, u, codes, W, rowpart, scales, dpart,
                       disp, *, wire, mode, groups, error_feedback,
                       alive_bits) -> int:
    """``compressed_mix_launch`` on the current stream (``alive_bits``
    None: unmasked). Returns its ``cudaError_t``."""
    m, p = plane.shape
    lib = _build.library("compressed_mix")
    with torch.cuda.device(plane.device):
        return lib.compressed_mix_launch(
            plane.data_ptr(), resid.data_ptr(),
            u.data_ptr() if u is not None else None,
            codes.data_ptr() if codes is not None else None,
            W.data_ptr() if W is not None else None,
            rowpart.data_ptr(), scales.data_ptr(), dpart.data_ptr(),
            disp.data_ptr(), m, p, _WIRES.index(wire),
            _EVENT_MODES.index(mode), groups, int(error_feedback),
            int(alive_bits is not None), alive_bits or 0, _stream())


def compressed_mix(plane, resid, *, wire, mode="mean", groups: int = 1,
                   W=None, u=None, codes=None, error_feedback: bool = True,
                   alive=None):
    """Compressed averaging / mixing event on the (M, P) plane: the
    error-feedback encode through ``wire`` (``bf16`` / ``int8`` with the
    uniforms ``u`` / ``one_bit``), the event on the decoded plane (mode
    "mean" | "group" | "mix" with ``W``), the ``codes`` rounding, and
    the Eq. 4 dispersion of the input plane. Returns (plane, residual,
    dispersion); on CUDA the plane and the residual are the inputs,
    updated in place. ``alive`` masks the event (module note)."""
    if mode not in _EVENT_MODES:
        raise ValueError(f"unknown event mode {mode!r}; pick one of "
                         f"{_EVENT_MODES}")
    m = plane.shape[0]
    if groups < 1 or m % groups:
        raise ValueError(f"groups={groups} must divide the {m} worker rows")
    _check_mix(mode, W, m)
    _check_event("compressed_mix", plane, resid, wire, u)
    kw = dict(wire=wire, u=u, codes=codes, error_feedback=error_feedback)
    if plane.device.type == "cpu":
        return compressed_mix_plain(plane, resid, mode=mode, groups=groups,
                                    W=W, alive=alive, **kw)
    if plane.device.type != "cuda":
        raise ValueError(f"compressed_mix runs on cpu or cuda, not "
                         f"{plane.device}")
    disp = _compressed_event(plane, resid, mode=mode, groups=groups, W=W,
                             alive=alive, **kw)
    return plane, resid, disp


def compressed_mix_plain(plane, resid, *, wire, mode="mean", groups: int = 1,
                         W=None, u=None, codes=None,
                         error_feedback: bool = True, alive=None):
    """:func:`compressed_mix`'s plain version, on any device: the event
    of ``mode`` through ``compressed_mix_ref`` / ``compressed_avg_ref``,
    masked over ``alive`` when given. Returns new (plane, residual,
    dispersion)."""
    kw = dict(wire=wire, u=u, codes=codes, error_feedback=error_feedback,
              alive=alive)
    if mode == "mix":
        return compressed_mix_ref(plane, resid, W, **kw)
    return compressed_avg_ref(plane, resid,
                              groups=groups if mode == "group" else 1, **kw)


#: kernel launches so far (the CPU plain path does not count)
avg_disp.launches = 0
mix_disp.launches = 0
avg_disp_outer.launches = 0
compressed_mix.launches = 0
