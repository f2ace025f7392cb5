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
cannot take raises. ``avg_disp_outer``, and ``avg_disp`` / ``mix_disp``
without ``alive``, return new tensors; ``compressed_mix`` and the
masked events update the plane (and the residual) in place on the card
(a full-width plane is 5.8 GB). An ``avg_disp`` event is ONE launch,
its dispersion's cross-block sum included (``csrc/avg_disp.cu``), on
scratch made once for each stream; the other three sum their
dispersion partials in a second launch (``sum_partials``).

``codes`` ((P,) f32 rounding codes, ``FlatSpec.rounding_codes``) round
the event's output per column through the leaf dtype, as the plain
versions do: each of ``avg_disp``, ``mix_disp`` and ``avg_disp_outer``
takes them in its kernel's ``CODES`` instantiation, bitwise
``plane_average_ref`` / ``mix_disp_ref`` / ``avg_disp_outer_ref``.

``alive`` ((M,) 0/1, :mod:`repro_torch.faults`) degrades ``avg_disp``,
``mix_disp`` and ``compressed_mix`` over the alive rows, as the
reference's wrappers do, each in ONE launch of its kernel's masked
instantiation, the mask a 64-bit row word passed by value. Dead
rows are neither read nor written (``compressed_mix``: not encoded
either; they keep their params and residual), the dispersion is the
pre-event one over the alive rows, a mean or group mean is the exact
masked (group) mean of the alive rows (summed in order, divided once)
written to the alive rows only, and a mix takes
``faults.degraded_matrix(W, alive)`` over the alive columns — bitwise
the plain versions (``compressed_mix``'s one_bit: within one ulp of its
row scale).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import faults
from repro_torch.kernels import _build
from repro_torch.kernels.ref import (_WIRES, avg_disp_outer_ref,
                                     compressed_avg_ref, compressed_mix_ref,
                                     mix_disp_ref, plane_average_ref)

_EVENT_MODES = ("mean", "group", "mix")
#: columns per block of compressed_mix.cu's row-statistic pass
_STAT_COLS = 4096


def _cuda_plane(what: str, plane) -> None:
    if plane.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {plane.device}")


def _check_plane(what: str, plane) -> None:
    """The (M, P) plane a plane kernel takes."""
    _build.check_workers(what, plane.shape[0])
    _build.check_plane(what, "plane", plane, plane)


def _scratch(plane):
    """(dispersion partials, dispersion) for a column sweep of
    ``mix_disp.cu``, ``avg_disp_outer.cu`` or ``compressed_mix.cu``."""
    p = plane.shape[1]
    return (torch.empty(-(-p // 256), dtype=torch.float32,
                        device=plane.device),
            torch.empty((), dtype=torch.float32, device=plane.device))


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _event_checks(what: str, plane, codes, alive):
    """The codes row and the row word of an ``avg_disp`` / ``mix_disp``
    launch: raises on codes it cannot take; returns the row word of
    ``alive`` (None: unmasked)."""
    if codes is not None:
        _build.check_plane(what, "codes", codes, plane[0])
    if alive is None:
        return None
    return _build.row_bits(what, alive, plane.shape[0])


def avg_disp(plane, *, groups: int = 1, codes=None, alive=None):
    """plane: (M, P) float32 -> (averaged plane, Eq. 4 dispersion as a
    0-dim tensor). ``groups`` > 1 broadcasts per-group means; the
    dispersion is always against the global mean. ``codes`` round the
    means (module note). The output is a new tensor and the input is not
    modified, but for ``alive`` on the card: the masked event in place
    (module note)."""
    m = plane.shape[0]
    if groups < 1 or m % groups:
        raise ValueError(f"groups={groups} must divide the {m} worker rows")
    if plane.device.type == "cpu":
        return plane_average_ref(plane, groups=groups, codes=codes,
                                 alive=alive)
    _cuda_plane("avg_disp", plane)
    return _card_avg(plane, groups=groups, codes=codes, alive=alive)


def _card_avg(plane, *, groups, codes, alive):
    """One ``avg_disp.cu`` launch on the card's tensors (module note);
    counts it in ``avg_disp.launches``. Returns (plane, dispersion): the
    dispersion a fresh 0-dim tensor (callers keep it)."""
    what = "avg_disp"
    _check_plane(what, plane)
    alive_bits = _event_checks(what, plane, codes, alive)
    out = plane if alive_bits is not None else torch.empty_like(plane)
    disp = torch.empty((), dtype=torch.float32, device=plane.device)
    err = _avg_launch(plane, out, codes, disp, groups=groups,
                      alive_bits=alive_bits)
    _build.check(err, what)
    avg_disp.launches += 1
    return out, disp


#: the most 256-thread blocks an SM holds resident (2048 threads an SM on
#: sm_80 / sm_90): ``avg_disp.cu``'s grid is at most this many a SM
_AVG_BLOCKS_PER_SM = 8
#: (device index, stream) -> (float64 partials, ticket): the scratch of
#: ``avg_disp.cu``'s launches on that stream
_avg_scratch: dict = {}


def _stream_scratch(dev, stream: int):
    """``avg_disp.cu``'s scratch for launches on ``stream`` of ``dev``: a
    float64 partial for each block of the largest grid the card holds
    resident, and the finisher's ticket (an int32 counter, 0 between
    launches). Made at the stream's
    first launch and kept: one stream's launches run in order, so they
    share it; no two streams do."""
    key = (dev.index, stream)
    got = _avg_scratch.get(key)
    if got is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        got = _avg_scratch[key] = (
            torch.empty(sms * _AVG_BLOCKS_PER_SM, dtype=torch.float64,
                        device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))
    return got


def _avg_launch(plane, out, codes, disp, *, groups, alive_bits) -> int:
    """``avg_disp_launch`` on the current stream of the plane's device
    (``alive_bits`` None: unmasked), with the stream's cached scratch.
    Returns its ``cudaError_t``."""
    dev = plane.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _avg_launch(plane, out, codes, disp, groups=groups,
                               alive_bits=alive_bits)
    m, p = plane.shape
    lib = _build.library("avg_disp")
    stream = torch.cuda.current_stream().cuda_stream
    dpart, ticket = _stream_scratch(dev, stream)
    return lib.avg_disp_launch(
        plane.data_ptr(), out.data_ptr(),
        codes.data_ptr() if codes is not None else None, dpart.data_ptr(),
        dpart.numel(), ticket.data_ptr(), disp.data_ptr(), m, p, groups,
        int(alive_bits is not None), alive_bits or 0, stream)


def _avg_grid(x_ptr, codes_ptr, room, m, p, masked) -> int:
    """The grid ``avg_disp_launch`` takes on the current device for an
    (m, p) plane at ``x_ptr`` (its output as aligned), ``codes_ptr`` (None:
    no codes) and ``room`` partials, asked of ``avg_disp_grid`` (the
    launch's own choice of instantiation and grid) without a launch."""
    fn = _build.library("avg_disp").avg_disp_grid
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_longlong, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(x_ptr, x_ptr, codes_ptr, room, m, p, int(masked))


def mix_disp(plane, W, *, codes=None, alive=None):
    """plane: (M, P) float32, W: (M, M) float32 doubly stochastic ->
    (W @ plane, Eq. 4 dispersion of the input plane). Each worker keeps
    its own mixed row; ``codes`` round it (module note). The output is a
    new tensor, but for ``alive`` on the card: the mix with
    ``faults.degraded_matrix(W, alive)``, in place (module note)."""
    m = plane.shape[0]
    if tuple(W.shape) != (m, m):
        raise ValueError(f"W must be ({m}, {m}), got {tuple(W.shape)}")
    if plane.device.type == "cpu":
        return mix_disp_ref(plane, W, codes=codes, alive=alive)
    _cuda_plane("mix_disp", plane)
    return _card_mix(plane, W, codes=codes, alive=alive)


def _card_mix(plane, W, *, codes, alive):
    """One ``mix_disp.cu`` launch on the card's tensors (module note);
    counts it in ``mix_disp.launches``. Returns (plane, dispersion)."""
    what = "mix_disp"
    _check_plane(what, plane)
    alive_bits = _event_checks(what, plane, codes, alive)
    if alive_bits is not None:
        W = faults.degraded_matrix(W, alive)
    _build.check_matrix(what, W, plane)
    out = plane if alive_bits is not None else torch.empty_like(plane)
    dpart, disp = _scratch(plane)
    err = _mix_launch(plane, W, out, codes, dpart, disp,
                      alive_bits=alive_bits)
    _build.check(err, what)
    mix_disp.launches += 1
    return out, disp


def _mix_launch(plane, W, out, codes, dpart, disp, *, alive_bits) -> int:
    """``mix_disp_launch`` on the current stream (``alive_bits`` None:
    unmasked; else ``W`` is the degraded matrix). Returns its
    ``cudaError_t``."""
    m, p = plane.shape
    lib = _build.library("mix_disp")
    with torch.cuda.device(plane.device):
        return lib.mix_disp_launch(
            plane.data_ptr(), W.data_ptr(), out.data_ptr(),
            codes.data_ptr() if codes is not None else None,
            dpart.data_ptr(), disp.data_ptr(), m, p,
            int(alive_bits is not None), alive_bits or 0, _stream())


def avg_disp_outer(plane, prev_avg, vel, *, lr: float, momentum: float,
                   nesterov: bool = True, codes=None):
    """Fused all-average + dispersion + outer momentum step. plane:
    (M, P) f32; prev_avg/vel: (P,) f32; ``codes`` round the mean before
    the outer gradient and the new average (module note; the dispersion
    is against the unrounded mean, the velocity stays f32). Returns
    (averaged plane, new_avg, new_vel, dispersion), all new tensors."""
    p = plane.shape[1]
    for name, t in (("prev_avg", prev_avg), ("vel", vel)):
        if tuple(t.shape) != (p,):
            raise ValueError(f"{name} must be ({p},), got {tuple(t.shape)}")
    kw = dict(lr=lr, momentum=momentum, nesterov=nesterov)
    if plane.device.type == "cpu":
        return avg_disp_outer_ref(plane, prev_avg, vel, codes=codes, **kw)
    _cuda_plane("avg_disp_outer", plane)
    return _card_outer(plane, prev_avg, vel, codes=codes, **kw)


def _card_outer(plane, prev_avg, vel, *, codes, lr, momentum, nesterov):
    """One ``avg_disp_outer.cu`` launch on the card's tensors; counts it
    in ``avg_disp_outer.launches``. Returns (plane, new_avg, new_vel,
    dispersion)."""
    what = "avg_disp_outer"
    _check_plane(what, plane)
    _build.check_plane(what, "prev_avg", prev_avg, plane[0])
    _build.check_plane(what, "vel", vel, plane[0])
    if codes is not None:
        _build.check_plane(what, "codes", codes, plane[0])
    out = torch.empty_like(plane)
    new_avg, new_vel = torch.empty_like(prev_avg), torch.empty_like(vel)
    dpart, disp = _scratch(plane)
    err = _outer_launch(plane, prev_avg, vel, codes, out, new_avg, new_vel,
                        dpart, disp, lr=lr, momentum=momentum,
                        nesterov=nesterov)
    _build.check(err, what)
    avg_disp_outer.launches += 1
    return out, new_avg, new_vel, disp


def _outer_launch(plane, prev_avg, vel, codes, out, new_avg, new_vel, dpart,
                  disp, *, lr, momentum, nesterov) -> int:
    """``avg_disp_outer_launch`` on the current stream (``codes`` None:
    the f32 instantiation). Returns its ``cudaError_t``."""
    m, p = plane.shape
    lib = _build.library("avg_disp_outer")
    with torch.cuda.device(plane.device):
        return lib.avg_disp_outer_launch(
            plane.data_ptr(), prev_avg.data_ptr(), vel.data_ptr(),
            codes.data_ptr() if codes is not None else None,
            out.data_ptr(), new_avg.data_ptr(), new_vel.data_ptr(),
            dpart.data_ptr(), disp.data_ptr(), m, p, lr, momentum,
            int(nesterov), _stream())


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
    _check_plane(what, plane)
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
    _cuda_plane("compressed_mix", plane)
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
