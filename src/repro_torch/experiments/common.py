"""What the experiment scripts share: their JSON payloads, their CSV line,
their timer and their command line.

The counterpart of the reference's ``benchmarks/common.py`` (stdlib
only), kept here so that the port imports nothing of it:

- :func:`save` writes ``results/<name>_torch.json`` beside the
  reference's ``results/<name>.json``, which it never touches;
- :func:`emit` prints the reference's ``name,us_per_call,derived`` line;
- :func:`timeit` is the reference's timer, but it waits for the card
  (``torch.cuda.synchronize()``) before each read of the clock, so a
  time on the card holds the work and not only its launches;
- :func:`cli` is each script's ``python -m`` entry: ``--device`` (the
  card by default; without one it refuses to start unless ``--device
  cpu``).
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from repro_torch.device import resolve_device

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results"


def save(name: str, payload: dict):
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    with open(RESULTS_DIR / f"{name}_torch.json", "w") as f:
        json.dump(payload, f, indent=1, default=float)


def _sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit(fn, *args, reps: int = 3, warmup: int = 1):
    """(microseconds a call, the last call's result), as the reference's:
    ``warmup`` calls first, then ``reps`` timed ones."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    _sync()
    dt = (time.perf_counter() - t0) / reps
    return dt * 1e6, out


def emit(name: str, us_per_call: float, derived: str):
    print(f"{name},{us_per_call:.1f},{derived}")


def parse_device(argv=None, description: str | None = None):
    """``--device`` from ``argv``, resolved: exits 2 (argparse's error)
    when it names CUDA and there is no card."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda by default; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        ap.error(f"--device {args.device}: {e}")


def cli(run, argv=None, description: str | None = None):
    """``python -m repro_torch.experiments.<name>``: ``run(device=)``."""
    run(device=str(parse_device(argv, description)))
