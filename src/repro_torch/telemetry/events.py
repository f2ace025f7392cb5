"""Structured run events: versioned JSONL records, sinks and RunLog.

The reference package's schema (``repro.telemetry.events``), record for
record: environment provenance (``run_meta``), per-phase aggregates
(``phase_metrics``) and the point events (``averaging_event``,
``fault_event``, ``resize_event``, ``checkpoint_event``). Records are
flat JSON dicts stamped ``{"v": TELEMETRY_VERSION, "type": ...}``; a
reader refuses records of a newer writer and unknown types, so either
package's reader takes the other's log.

:class:`RunLog` reads a stream back, and :meth:`RunLog.history` rebuilds
the history dict :meth:`repro_torch.core.PhaseEngine.run` returns, key
for key: the traces, the averaging events, the resizes and
``phase_wall``, the port's per-phase host seconds, from the
``phase_metrics`` records' ``(t0, t1, wall_s)``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

TELEMETRY_VERSION = 1

RECORD_TYPES = (
    "run_meta",
    "phase_metrics",
    "averaging_event",
    "fault_event",
    "resize_event",
    "checkpoint_event",
)


def init_history(*, resizes: bool = False) -> dict:
    """The run history dict, keyed as the reference's, plus
    ``phase_wall``: (first step, last step, host seconds) per phase (per
    step in ``run_host``), from the request for the phase's batches to a
    device synchronize. ``resizes`` adds ``run_elastic``'s list."""
    hist = {"loss": [], "dispersion": [], "disp_trace": [],
            "averages": 0, "eval": [], "worker_eval": [], "phase_wall": []}
    if resizes:
        hist["resizes"] = []
    return hist


def make_record(rtype: str, **fields) -> dict:
    """A versioned record dict. ``rtype`` must be one of
    :data:`RECORD_TYPES`; field values must be JSON-serializable."""
    if rtype not in RECORD_TYPES:
        raise ValueError(
            f"unknown telemetry record type {rtype!r} (expected one of "
            f"{RECORD_TYPES})")
    rec = {"v": TELEMETRY_VERSION, "type": rtype}
    rec.update(fields)
    return rec


def parse_record(obj) -> dict:
    """Validate one record (a dict, or a JSON line to parse). Refuses
    records written by a newer telemetry version and unknown types."""
    if isinstance(obj, (str, bytes)):
        obj = json.loads(obj)
    if not isinstance(obj, dict):
        raise ValueError(f"telemetry record must be a dict, got "
                         f"{type(obj).__name__}")
    v = obj.get("v")
    if not isinstance(v, int):
        raise ValueError("telemetry record has no integer 'v' version "
                         f"field: {obj!r}")
    if v > TELEMETRY_VERSION:
        raise ValueError(
            f"telemetry record version {v} is newer than this reader "
            f"(TELEMETRY_VERSION={TELEMETRY_VERSION}) — read it with "
            "the build that wrote it")
    rtype = obj.get("type")
    if rtype not in RECORD_TYPES:
        raise ValueError(
            f"unknown telemetry record type {rtype!r} (expected one of "
            f"{RECORD_TYPES})")
    return obj


def _git_sha() -> str | None:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def run_meta_record(config: dict | None = None, *, device=None,
                    **extra) -> dict:
    """The provenance record a stream starts with: the torch version, the
    backend (``"cuda"`` or ``"cpu"``, of ``device``: the card when one
    is available and no device is named), the device kind and count
    (``torch.cuda``'s on the card; ``"cpu"`` and 1 on the CPU), python,
    git sha, and the run's ``config`` dict verbatim."""
    import torch
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    backend = torch.device(device).type
    if backend == "cuda":
        kind = torch.cuda.get_device_name(torch.device(device))
        count = torch.cuda.device_count()
    else:
        kind, count = "cpu", 1
    return make_record(
        "run_meta",
        torch_version=torch.__version__,
        backend=backend,
        device_kind=kind,
        device_count=count,
        python_version=sys.version.split()[0],
        platform=sys.platform,
        git_sha=_git_sha(),
        config=dict(config or {}),
        **extra)


# --------------------------------------------------------------------------
# Sinks
# --------------------------------------------------------------------------

class TelemetrySink:
    """Protocol: ``emit(record)`` accepts one :func:`make_record` dict;
    ``close()`` releases resources. Usable as a context manager."""

    def emit(self, record: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class NullSink(TelemetrySink):
    """Drops every record."""

    def emit(self, record: dict) -> None:
        pass


class MemorySink(TelemetrySink):
    """Collects records in :attr:`records` (tests, in-process use)."""

    def __init__(self):
        self.records: list = []

    def emit(self, record: dict) -> None:
        self.records.append(parse_record(record))


class JsonlSink(TelemetrySink):
    """Writes one JSON line per record to ``path`` (parent directories
    created), flushed on every emit so that a crashed run keeps its
    telemetry."""

    def __init__(self, path):
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._f = open(path, "w")

    def emit(self, record: dict) -> None:
        self._f.write(json.dumps(parse_record(record), default=float))
        self._f.write("\n")
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


# --------------------------------------------------------------------------
# Reader
# --------------------------------------------------------------------------

class RunLog:
    """A validated, in-order view over one run's records."""

    def __init__(self, records):
        self.records = [parse_record(r) for r in records]

    @classmethod
    def load(cls, path) -> "RunLog":
        with open(path) as f:
            return cls(line for line in f if line.strip())

    def of_type(self, rtype: str) -> list:
        if rtype not in RECORD_TYPES:
            raise ValueError(f"unknown record type {rtype!r}")
        return [r for r in self.records if r["type"] == rtype]

    @property
    def meta(self) -> dict | None:
        metas = self.of_type("run_meta")
        return metas[0] if metas else None

    @property
    def phases(self) -> list:
        return self.of_type("phase_metrics")

    def history(self) -> dict:
        """The engine's history dict, rebuilt: the phases' ``loss_trace``
        / ``disp_trace`` concatenate into the traces and their ``(t0, t1,
        wall_s)`` into ``phase_wall``, averaging events give the event
        dispersions and count, resize events the membership changes.
        ``eval`` / ``worker_eval`` hold host callbacks' results, which
        never serialize: they come back empty."""
        resizes = self.of_type("resize_event")
        hist = init_history(resizes=bool(resizes))
        for ph in self.phases:
            hist["loss"].extend(tuple(e) for e in ph.get("loss_trace", []))
            hist["disp_trace"].extend(
                tuple(e) for e in ph.get("disp_trace", []))
            hist["phase_wall"].append((ph["t0"], ph["t1"], ph["wall_s"]))
        for ev in self.of_type("averaging_event"):
            hist["dispersion"].append((ev["step"], ev["dispersion"]))
            hist["averages"] += 1
        for ev in resizes:
            hist["resizes"].append((ev["step"], ev["old_m"], ev["new_m"]))
        return hist
