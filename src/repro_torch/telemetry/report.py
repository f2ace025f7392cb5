"""Render a run's telemetry JSONL as a per-phase table.

    PYTHONPATH=src python -m repro_torch.telemetry.report run.jsonl

The reference's report (``repro.telemetry.report``), the same table and
calibration; the header names torch and the device. Each row is one
``phase_metrics`` record (one engine phase): steps and wall-clock
throughput, the mean/max loss, the measured Eq. 4 dispersion envelope,
averaging events and the nominal wire bytes they shipped
(``topology.comm_bytes`` pricing), and fault occupancy (alive /
straggle).

When the stream's ``run_meta`` carries the run recipe (``lr``,
``momentum``, ``workers`` — the train CLI emits them), the table adds
the ``variance_model`` envelope prediction: the per-worker gradient
variance is calibrated once from the FIRST phase's measured mean
dispersion (the prediction is linear in sigma^2, so one phase pins it),
then every phase's pre-event envelope is predicted at that phase's
mean inter-event gap via
:func:`repro_torch.core.variance_model.predict_post_resize_dispersion` —
the ``x pred`` column is measured max / predicted, the single-number
check that the run tracks the paper's variance envelope.
"""
from __future__ import annotations

import argparse

from repro_torch.core.variance_model import predict_post_resize_dispersion
from repro_torch.telemetry.events import RunLog


def _phase_gap(ph: dict) -> int:
    """Mean inter-event gap of the phase (its whole length when no
    event fired) — the K the envelope prediction is evaluated at."""
    steps = max(int(ph["steps"]), 1)
    events = int(ph.get("events", 0))
    return max(1, round(steps / events)) if events else steps


def _calibrate(phases: list, meta: dict | None):
    """(sigma2_hat, lr, momentum, workers) from the first phase, or
    None when the stream lacks the recipe or a usable signal."""
    if meta is None or not phases:
        return None
    cfg = meta.get("config") or {}
    lr = cfg.get("lr")
    workers = cfg.get("workers")
    if not lr or not workers or int(workers) < 2:
        return None
    momentum = float(cfg.get("momentum") or 0.0)
    first = phases[0]
    d0 = float(first.get("disp_mean") or 0.0)
    if d0 <= 0.0:
        return None
    # mid-window mean: dispersion resets at each event, so the phase
    # MEAN sits near the envelope at half the inter-event gap
    k_cal = max(1, round((_phase_gap(first) + 1) / 2))
    unit = predict_post_resize_dispersion(
        [1.0] * int(workers), lr=float(lr), steps=k_cal,
        momentum=momentum)["predicted_dispersion"]
    if unit <= 0.0:
        return None
    return d0 / unit, float(lr), momentum, int(workers)


def _predict(cal, ph: dict) -> float | None:
    if cal is None:
        return None
    sigma2, lr, momentum, workers = cal
    return predict_post_resize_dispersion(
        [sigma2] * workers, lr=lr, steps=_phase_gap(ph),
        momentum=momentum)["predicted_dispersion"]


def _fmt(x, width: int, prec: int = 3) -> str:
    if x is None:
        return "-".rjust(width)
    if isinstance(x, int):
        return f"{x:{width}d}"
    return f"{x:{width}.{prec}g}"


def render(log: RunLog) -> str:
    """The report as one printable string."""
    lines = []
    meta = log.meta
    if meta is not None:
        cfg = meta.get("config") or {}
        recipe = " ".join(f"{k}={cfg[k]}" for k in sorted(cfg)
                          if cfg[k] is not None)
        lines.append(
            f"run: torch {meta.get('torch_version')} "
            f"({meta.get('backend')}, {meta.get('device_count')}x "
            f"{meta.get('device_kind')}), git {meta.get('git_sha')}")
        if recipe:
            lines.append(f"config: {recipe}")
    phases = log.phases
    if not phases:
        lines.append("no phase_metrics records")
        return "\n".join(lines)
    cal = _calibrate(phases, meta)
    hdr = (f"{'phase':>5} {'steps':>7} {'steps/s':>8} {'loss':>9} "
           f"{'disp_mean':>9} {'disp_max':>9} {'disp_pred':>9} "
           f"{'x pred':>7} {'events':>6} {'bytes':>10} {'B/event':>9} "
           f"{'alive':>6} {'strag%':>6}")
    lines.append(hdr)
    lines.append("-" * len(hdr))
    tot_steps = tot_events = 0
    tot_bytes = tot_wall = 0.0
    for i, ph in enumerate(phases):
        steps = int(ph["steps"])
        events = int(ph.get("events", 0))
        byts = float(ph.get("comm_bytes", 0.0))
        wall = float(ph.get("wall_s") or 0.0)
        sps = steps / wall if wall > 0 else None
        pred = _predict(cal, ph)
        dmax = ph.get("disp_max")
        ratio = (dmax / pred if pred and dmax is not None else None)
        lines.append(" ".join([
            f"{i:>5d}",
            f"{ph.get('t0', '?')}-{ph.get('t1', '?')}".rjust(7),
            _fmt(sps, 8),
            _fmt(ph.get("loss_mean"), 9, 4),
            _fmt(ph.get("disp_mean"), 9),
            _fmt(dmax, 9),
            _fmt(pred, 9),
            _fmt(ratio, 7, 2),
            f"{events:>6d}",
            _fmt(byts, 10, 4),
            _fmt(byts / events if events else None, 9, 4),
            _fmt(ph.get("alive_mean"), 6, 3),
            _fmt(100.0 * float(ph.get("straggle_rate") or 0.0), 6, 2),
        ]))
        tot_steps += steps
        tot_events += events
        tot_bytes += byts
        tot_wall += wall
    lines.append("-" * len(hdr))
    sps = tot_steps / tot_wall if tot_wall > 0 else None
    lines.append(
        f"total: {tot_steps} steps, {tot_events} events, "
        f"{tot_bytes:.4g} B/worker on the wire"
        + (f", {sps:.1f} steps/s" if sps else ""))
    extra = []
    for rtype in ("fault_event", "resize_event", "checkpoint_event"):
        n = len(log.of_type(rtype))
        if n:
            extra.append(f"{n} {rtype}")
    if extra:
        lines.append("events: " + ", ".join(extra))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.report",
        description="Render a telemetry JSONL run log as a per-phase "
                    "table.")
    ap.add_argument("path", help="telemetry JSONL file "
                                 "(train.py --telemetry <path>)")
    args = ap.parse_args(argv)
    print(render(RunLog.load(args.path)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
