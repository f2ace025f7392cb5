"""The metrics plane: a fixed-layout float32 accumulator per phase.

The reference folds its per-phase aggregates (sums, maxes, counts) into
a ``(NUM_SLOTS,)`` float32 vector riding its phase scan, flushed with
the phase's one trace fetch. The port's phase is a host loop that
already reads each step's dispersion and decision and fetches the
phase's losses in one ``tolist()``, so its accumulator is a numpy
float32 vector on the host, folded from those host values step by step
in the reference's order (``acc + add``, then the max / max / min
slots), all in float32: the float slots (``loss_sum``, ``disp_sum``,
``comm_bytes``) round as the reference's do, and turning telemetry on
adds no host read of a device tensor. It is made fresh every phase and
is never part of the engine state or a checkpoint.
"""
from __future__ import annotations

import numpy as np

# Fixed slot layout of the accumulator vector, the reference's. Appending
# a slot is a backward-compatible change (flush keys by name); reordering
# is not.
SLOT_NAMES = (
    "steps",          # 0: local steps accumulated
    "loss_sum",       # 1: sum of per-step (alive-)mean losses
    "loss_max",       # 2: running max of the per-step loss
    "disp_sum",       # 3: sum of the per-step Eq. 4 dispersion
    "disp_max",       # 4: running max of the dispersion envelope
    "events_inner",   # 5: inner (group-mean) averaging events
    "events_all",     # 6: all-scope averaging / mixing events
    "comm_bytes",     # 7: nominal wire bytes ONE worker shipped
    #                      (topology.comm_bytes pricing per event)
    "alive_sum",      # 8: sum over steps of the alive-worker count
    "alive_min",      # 9: min alive-worker count seen in the phase
    "straggle_sum",   # 10: sum over steps of alive-and-straggling rows
)
NUM_SLOTS = len(SLOT_NAMES)
_I = {name: i for i, name in enumerate(SLOT_NAMES)}
_F32 = np.float32

# the functions that turn the accumulator into host floats
FLUSH_FUNCTIONS = ("flush_metrics",)


def init_metrics() -> np.ndarray:
    """A zero accumulator: max slots at -inf, the min slot at +inf."""
    init = np.zeros((NUM_SLOTS,), _F32)
    init[_I["loss_max"]] = -np.inf
    init[_I["disp_max"]] = -np.inf
    init[_I["alive_min"]] = np.inf
    return init


def accumulate(acc: np.ndarray, *, loss, disp, code: int,
               event_bytes_all: float, event_bytes_inner: float, n_alive,
               n_straggle) -> np.ndarray:
    """Fold one step into the accumulator, in float32. ``loss`` and
    ``disp`` are the step's host values, ``code`` its averaging decision
    (0 none / 1 inner / 2 all), ``event_bytes_*`` the per-event wire
    costs priced by ``topology.comm_bytes``, ``n_alive`` / ``n_straggle``
    the fault plan's per-step counts (constants without one)."""
    loss, disp = _F32(loss), _F32(disp)
    n_alive, n_straggle = _F32(n_alive), _F32(n_straggle)
    inner, allv = _F32(code == 1), _F32(code == 2)
    add = np.array([
        _F32(1.0), loss, _F32(0.0), disp, _F32(0.0), inner, allv,
        inner * _F32(event_bytes_inner) + allv * _F32(event_bytes_all),
        n_alive, _F32(0.0), n_straggle], _F32)
    acc = acc + add
    acc[_I["loss_max"]] = np.maximum(acc[_I["loss_max"]], loss)
    acc[_I["disp_max"]] = np.maximum(acc[_I["disp_max"]], disp)
    acc[_I["alive_min"]] = np.minimum(acc[_I["alive_min"]], n_alive)
    return acc


def flush_metrics(vec) -> dict:
    """The per-phase accumulator as a plain-float dict: the raw slots
    plus the derived means and rates the report table shows."""
    v = np.asarray(vec, dtype=np.float64).reshape(-1)
    if v.shape[0] != NUM_SLOTS:
        raise ValueError(
            f"metrics vector has {v.shape[0]} slots, expected "
            f"{NUM_SLOTS} ({', '.join(SLOT_NAMES)})")
    out = {name: float(v[i]) for i, name in enumerate(SLOT_NAMES)}
    steps = out["steps"]
    if steps < 1:
        raise ValueError("flush_metrics needs a phase of >= 1 steps")
    out["steps"] = int(steps)
    out["events_inner"] = int(out["events_inner"])
    out["events_all"] = int(out["events_all"])
    out["events"] = out["events_inner"] + out["events_all"]
    out["loss_mean"] = out.pop("loss_sum") / steps
    out["disp_mean"] = out.pop("disp_sum") / steps
    alive_sum = out.pop("alive_sum")
    out["alive_mean"] = alive_sum / steps
    straggle_sum = out.pop("straggle_sum")
    out["straggle_rate"] = (straggle_sum / alive_sum if alive_sum > 0
                            else 0.0)
    return out
