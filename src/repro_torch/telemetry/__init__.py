"""Telemetry: the metrics accumulator, structured run events, timing.

The reference package's three layers (``repro.telemetry``):

- :mod:`repro_torch.telemetry.metrics`: a fixed-layout float32
  accumulator per phase, folded on the host from the values the engine's
  phase already reads, so telemetry on vs off is bitwise and adds no
  host read of a device tensor;
- :mod:`repro_torch.telemetry.events`: versioned JSONL records
  (``run_meta`` / ``phase_metrics`` / ``averaging_event`` /
  ``fault_event`` / ``resize_event`` / ``checkpoint_event``) behind the
  :class:`TelemetrySink` protocol, and :class:`RunLog` reading them back
  into the engine's history dict;
- :mod:`repro_torch.telemetry.timing`: warm-up / best-of-reps wall-clock
  helpers that synchronize the card, and the ``torch.profiler`` hook.

``python -m repro_torch.telemetry.report <run.jsonl>`` renders a run log
as a per-phase table.
"""
from repro_torch.telemetry.events import (TELEMETRY_VERSION, JsonlSink,
                                          MemorySink, NullSink, RunLog,
                                          TelemetrySink, init_history,
                                          make_record, parse_record,
                                          run_meta_record)
from repro_torch.telemetry.metrics import (FLUSH_FUNCTIONS, NUM_SLOTS,
                                           SLOT_NAMES, accumulate,
                                           flush_metrics, init_metrics)
from repro_torch.telemetry.timing import profile_trace, time_run, timed

__all__ = ["FLUSH_FUNCTIONS", "JsonlSink", "MemorySink", "NUM_SLOTS",
           "NullSink", "RunLog", "SLOT_NAMES", "TELEMETRY_VERSION",
           "TelemetrySink", "accumulate", "flush_metrics", "init_history",
           "init_metrics", "make_record", "parse_record", "profile_trace",
           "run_meta_record", "time_run", "timed"]
