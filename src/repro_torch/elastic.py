"""Elastic membership: the worker plane resized on a running engine.

The counterpart of ``repro.elastic``. An :class:`ElasticPlan` scripts
M -> M' changes at step boundaries, and :func:`run_elastic` executes
them by repacking the engine state's planes — the (M, P) param plane,
every optimizer-state plane, the error-feedback residual and the fault
rows — into freshly allocated (M', P) planes, so the dropped rows'
memory is freed, and by rebuilding the :class:`~repro_torch.topology.
Topology` for the new M. Between resizes the unmodified
``PhaseEngine.run`` drives each segment, so a plan without an effective
resize or curriculum is the plain (fault) engine bit for bit: a segment
boundary is a phase cut, and phase blocking never changes a result.

Semantics (the reference's):

* ``shrink`` at step t: rows ``M'..M-1`` are dropped before step t runs;
  the kept rows are copied bit for bit.
* ``grow`` at step t: rows ``M..M'-1`` are appended before step t runs,
  warm-started from the mixing cohort's mean of step t-1 (rounded
  through the plane's codes, as a fault-plan rejoin is), with their
  optimizer planes and residual rows zeroed, alive and fresh. With
  ``curriculum=c > 0`` each grown row trains c solo steps — out of
  every event, the loss and the dispersion — before it re-enters the
  mix (``FaultPlan`` solo windows).
* a base :class:`~repro_torch.faults.FaultPlan` composes with the plan:
  each segment keeps the base events of the rows that exist in it. Row
  indices are stable identities across resizes.

On a sharded engine (``PhaseEngine(mesh=...)``) every rank of the world
runs :func:`run_elastic` alike: each segment's engine gets the worker
mesh rebuilt for its M' (:func:`repro_torch.launch.mesh.make_worker_mesh`,
collective over the whole world, so a rank that sits a segment out
calls it too), and before a resize the state is unsharded
(:func:`repro_torch.sharding.specs.unshard_engine_state`) on every rank,
so the repack runs on the full planes and the next segment cuts its
rows from them.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import faults as faults_mod
from repro_torch.faults import FaultPlan, FaultState
from repro_torch.kernels.ref import round_to_codes
from repro_torch.telemetry.events import init_history, make_record
from repro_torch.topology import Topology


class ResizeEvent(NamedTuple):
    """One scripted membership change: the plane is resized to
    ``num_workers`` rows immediately BEFORE local step ``step`` runs
    (1-based, as ``FaultEvent``)."""
    step: int
    num_workers: int


class Segment(NamedTuple):
    """A maximal fixed-membership run of steps ``start <= t < stop``."""
    start: int
    stop: int
    num_workers: int


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """A deterministic resize script for a run starting at
    ``num_workers`` rows.

    resizes:    :class:`ResizeEvent` tuples, strictly increasing steps
                >= 2. ``num_workers`` equal to the current size is a
                no-op resize: a pure phase cut.
    curriculum: c > 0 gives every GROWN row c solo steps before its
                iterate re-enters averaging.
    """
    num_workers: int
    resizes: tuple = ()
    curriculum: int = 0

    def __post_init__(self):
        if self.num_workers < 1:
            raise ValueError(
                f"num_workers must be >= 1, got {self.num_workers}")
        if self.curriculum < 0:
            raise ValueError(
                f"curriculum must be >= 0, got {self.curriculum}")
        resizes = tuple(ResizeEvent(int(s), int(m)) for s, m in self.resizes)
        prev_step = 1
        for ev in resizes:
            if ev.step <= prev_step:
                raise ValueError(
                    f"resize steps must be strictly increasing and >= 2, "
                    f"got t={ev.step} after t={prev_step}")
            if ev.num_workers < 1:
                raise ValueError(
                    f"resize target M'={ev.num_workers} at t={ev.step} "
                    "must be >= 1")
            prev_step = ev.step
        object.__setattr__(self, "resizes", resizes)

    @classmethod
    def parse(cls, num_workers: int, *, shrink_at=(), grow_at=(),
              curriculum: int = 0) -> "ElasticPlan":
        """A plan from CLI ``step:M'`` terms, each validated against the
        membership it applies to: shrinks must shrink, grows must grow
        (an equal M' is a scripted no-op on either)."""
        events = []
        for kind, terms in (("shrink", shrink_at), ("grow", grow_at)):
            for term in terms:
                try:
                    step_s, m_s = str(term).split(":")
                    step, m = int(step_s), int(m_s)
                except ValueError:
                    raise ValueError(
                        f"cannot parse --{kind}-at {term!r} (expected "
                        "step:M', e.g. 128:12)") from None
                events.append((step, m, kind))
        events.sort()
        cur = num_workers
        resizes = []
        for step, m, kind in events:
            if kind == "shrink" and m > cur:
                raise ValueError(
                    f"--shrink-at {step}:{m} would grow the plane "
                    f"({cur} -> {m} workers) — use --grow-at")
            if kind == "grow" and m < cur:
                raise ValueError(
                    f"--grow-at {step}:{m} would shrink the plane "
                    f"({cur} -> {m} workers) — use --shrink-at")
            resizes.append((step, m))
            cur = m
        return cls(num_workers, tuple(resizes), curriculum)

    @property
    def is_trivial(self) -> bool:
        """True when no resize ever changes the plane (so no curriculum
        window exists): the plan is pure phase cuts."""
        cur = self.num_workers
        for ev in self.resizes:
            if ev.num_workers != cur:
                return False
            cur = ev.num_workers
        return True

    def sizes(self) -> tuple:
        """Every membership the run passes through, in order."""
        out = [self.num_workers]
        for ev in self.resizes:
            if ev.num_workers != out[-1]:
                out.append(ev.num_workers)
        return tuple(out)

    def segments(self, total_steps: int) -> list:
        """The maximal fixed-membership :class:`Segment` list covering
        local steps ``1..total_steps``."""
        if total_steps < 1:
            raise ValueError(f"total_steps must be >= 1, got {total_steps}")
        bounds, ms = [1], [self.num_workers]
        for ev in self.resizes:
            if ev.step > total_steps:
                break
            bounds.append(ev.step)
            ms.append(ev.num_workers)
        bounds.append(total_steps + 1)
        return [Segment(bounds[i], bounds[i + 1], ms[i])
                for i in range(len(ms))]

    def solo_windows(self) -> tuple:
        """Global ``(row, start, stop)`` curriculum windows: every grown
        row trains ``curriculum`` solo steps from its grow step; a row
        re-grown after a later shrink gets a fresh window."""
        if self.curriculum <= 0:
            return ()
        out, cur = [], self.num_workers
        for ev in self.resizes:
            for row in range(cur, ev.num_workers):
                out.append((row, ev.step, ev.step + self.curriculum))
            cur = ev.num_workers
        return tuple(out)

    def segment_faults(self, base: FaultPlan | None, m: int,
                       start: int = 1, stop: int | None = None):
        """The fault plan an ``m``-row segment engine runs: the base
        plan's events, straggle and rejoin curriculum on the rows that
        exist, plus the grow-curriculum windows of those rows that
        overlap steps ``[start, stop)``. None when that is trivial (the
        segment is the no-fault engine)."""
        if base is not None and base.num_workers != self.num_workers:
            raise ValueError(
                f"base fault plan has {base.num_workers} workers but the "
                f"elastic plan starts at {self.num_workers}")
        events = tuple(ev for ev in (base.events if base else ())
                       if ev.worker < m)
        solo = tuple(w for w in self.solo_windows()
                     if w[0] < m and w[2] > start
                     and (stop is None or w[1] < stop))
        plan = FaultPlan(
            m, events, base.straggle_prob if base else 0.0, solo=solo,
            rejoin_curriculum=base.rejoin_curriculum if base else 0)
        return None if plan.is_trivial else plan


# --------------------------------------------------------------------------
# Row repack: the engine state's planes, M -> M'
# --------------------------------------------------------------------------

def _state_m(state) -> int:
    if state.plane is None or getattr(state, "opt_state", None) is not None:
        raise ValueError(
            "elastic resizes repack the (M, P) planes; this EngineState "
            "keeps its params or its optimizer state as a tree (leaves "
            "FlatSpec cannot embed, or a state that is not float32 copies "
            "of the params)")
    return int(state.plane.shape[0])


def shrink_state(state, new_m: int):
    """The state at ``new_m`` <= M rows: rows ``new_m..M-1`` dropped from
    the param plane, every state plane, the residual and the fault rows;
    the kept rows copied bit for bit into fresh planes."""
    old_m = _state_m(state)
    if not 1 <= new_m <= old_m:
        raise ValueError(
            f"cannot shrink a {old_m}-row plane to {new_m} rows")
    fault = state.fault
    if isinstance(fault, FaultState):
        if not np.any(fault.alive[:new_m] > 0):
            raise ValueError(
                f"shrinking to {new_m} rows would keep no alive worker "
                "— every kept row is dead under the fault plan")
        fault = FaultState(fault.alive[:new_m].copy(),
                           fault.staleness[:new_m].copy())
    return state._replace(
        plane=state.plane[:new_m].clone(),
        opt_planes=tuple(t[:new_m].clone() for t in state.opt_planes),
        resid=None if state.resid is None else state.resid[:new_m].clone(),
        fault=fault)


def grow_state(state, new_m: int, *, faults=None):
    """The state at ``new_m`` >= M rows: the appended rows warm-start
    from the mean over the mixing cohort of the last completed step
    under ``faults`` (the plain worker mean otherwise), rounded through
    the plane's codes; their state planes and residual rows are zero,
    they are alive and their staleness 0 — a fault-plan rejoin."""
    old_m = _state_m(state)
    if not old_m <= new_m:
        raise ValueError(
            f"cannot grow a {old_m}-row plane to {new_m} rows")
    if new_m == old_m:
        return state
    if isinstance(state.fault, FaultState):
        mask = state.fault.alive
    else:
        mask = np.ones(old_m, np.float32)
    if faults is not None:
        mask = faults.mix_at(mask, int(state.step))
    glob = faults_mod.masked_mean(state.plane, mask)
    if state.codes is not None:
        glob = round_to_codes(glob, state.codes)

    def grown(t, new_rows):
        out = t.new_empty((new_m,) + tuple(t.shape[1:]))
        out[:old_m] = t
        out[old_m:] = new_rows
        return out

    k = new_m - old_m
    fault = state.fault
    if isinstance(fault, FaultState):
        fault = FaultState(
            np.concatenate([fault.alive, np.ones(k, np.float32)]),
            np.concatenate([fault.staleness, np.zeros(k, np.int32)]))
    return state._replace(
        plane=grown(state.plane, glob),
        opt_planes=tuple(grown(t, 0.0) for t in state.opt_planes),
        resid=None if state.resid is None else grown(state.resid, 0.0),
        fault=fault)


def resize_state(state, new_m: int, *, faults=None):
    """:func:`shrink_state` or :func:`grow_state` (nothing when the plane
    has ``new_m`` rows already). ``faults`` is the plan of the segment
    that just ENDED: its cohort is what grown rows warm-start from."""
    old_m = _state_m(state)
    if new_m < old_m:
        return shrink_state(state, new_m)
    if new_m > old_m:
        return grow_state(state, new_m, faults=faults)
    return state


def resize_engine(engine, new_m: int, *, faults=None):
    """A segment engine for ``new_m`` rows: the topology validated and
    rebuilt at the new size, the worker mesh rebuilt over the ranks
    dividing ``new_m`` (every rank of the world calls this) and the
    segment's fault plan swapped in."""
    kw = {"faults": faults}
    t = engine.topology
    if t is not None:
        kw["topology"] = Topology.build(
            t.kind, new_m, groups=t.groups if t.kind == "groups" else None)
    if engine.mesh is not None:
        from repro_torch.launch.mesh import make_worker_mesh
        kw["mesh"] = make_worker_mesh(new_m, backend=engine.mesh.backend,
                                      device=engine.mesh.device)
    return dataclasses.replace(engine, **kw)


def segment_engine(engine, plan: ElasticPlan, step: int,
                   total_steps: int | None = None):
    """The ``(engine, num_workers)`` in effect at local step ``step``
    (0 before the first step): the resized engine whose segment holds
    it, for the like-state a mid-run checkpoint resumes into."""
    m, start, stop = plan.num_workers, 1, None
    for ev in plan.resizes:
        if total_steps is not None and ev.step > total_steps:
            break
        if ev.step <= max(step, 1):
            m, start = ev.num_workers, ev.step
        elif stop is None:
            stop = ev.step
    if total_steps is not None and stop is None:
        stop = total_steps + 1
    fp = plan.segment_faults(engine.faults, m, start, stop)
    return resize_engine(engine, m, faults=fp), m


def _validate(engine, plan: ElasticPlan):
    if engine.outer is not None:
        raise ValueError(
            "elastic membership is incompatible with the outer "
            "optimizer (its consensus step assumes a fixed membership) "
            "— drop --outer or the resize plan")
    base = engine.faults
    if base is not None and base.num_workers != plan.num_workers:
        raise ValueError(
            f"fault plan covers {base.num_workers} workers but the "
            f"elastic plan starts at {plan.num_workers}")
    g = engine.schedule.inner_groups
    for m in plan.sizes():
        if engine.schedule.kind == "hierarchical" and m % g:
            raise ValueError(
                f"resize target M'={m} is not divisible by "
                f"inner_groups={g} — hierarchical averaging needs every "
                "membership the run passes through to split evenly")
        t = engine.topology
        if t is not None:
            Topology.build(t.kind, m,
                           groups=t.groups if t.kind == "groups" else None)
        plan.segment_faults(base, m)  # eager solo / event validation


def run_elastic(engine, params, data_factory, plan: ElasticPlan, *,
                steps: int, seed: int = 0, record_every: int = 0,
                eval_fn=None, worker_eval_fn=None, state=None,
                return_state: bool = False, phase_len: int | None = None,
                prefetch: bool = True, sink=None):
    """Drive ``engine`` through ``plan`` for ``steps`` local steps.

    ``data_factory(m, t0, k)`` gives the data of ``k`` steps from local
    step ``t0`` for an ``m``-row plane (what ``PhaseEngine.run`` takes);
    it must be a pure function of its arguments, so that a resume
    replays the same batches. ``state`` resumes a checkpointed engine
    state (its row count says whether a resize at exactly ``state.step
    + 1`` was applied before the save). ``phase_len`` and ``prefetch``
    go to every segment's run.

    Returns ``(final consensus params, history)`` as ``PhaseEngine.run``
    does, the history with ``resizes`` as ``(step, old_m, new_m)`` too;
    ``return_state`` appends the final state.

    ``sink`` (needs ``PhaseEngine(telemetry=True)``) goes to every
    segment's run; each applied resize also emits one ``resize_event``
    record."""
    _validate(engine, plan)
    segs = plan.segments(steps)
    done = 0 if state is None else int(state.step)
    if done >= steps:
        raise ValueError(
            f"state has already completed {done} of {steps} steps")
    hist = init_history(resizes=True)
    if engine.mesh is not None and engine.mesh.world_rank != 0:
        sink = None
    prev_faults = None
    params_final = None
    # while ``state`` holds this rank's rows of a sharded plane: the
    # (mesh, M) it is sharded over
    sharded_by = None
    for seg in segs:
        fp = plan.segment_faults(engine.faults, seg.num_workers,
                                 seg.start, seg.stop)
        if seg.stop - 1 <= done:  # completed before the resume
            prev_faults = fp
            continue
        eng = resize_engine(engine, seg.num_workers, faults=fp)
        if state is not None:
            old_m = (_state_m(state) if sharded_by is None
                     else sharded_by[1])
            if old_m != seg.num_workers:
                if done + 1 != seg.start:
                    raise ValueError(
                        f"resumed state has {old_m} worker rows but the "
                        f"segment covering step {done + 1} runs "
                        f"{seg.num_workers} — the checkpoint does not "
                        "match the elastic plan")
                if sharded_by is not None:
                    from repro_torch.sharding.specs import (
                        unshard_engine_state)
                    state = unshard_engine_state(state, sharded_by[0])
                    sharded_by = None
                state = resize_state(state, seg.num_workers,
                                     faults=prev_faults)
                hist["resizes"].append((seg.start, old_m,
                                        seg.num_workers))
                if sink is not None:
                    sink.emit(make_record(
                        "resize_event", step=seg.start, old_m=old_m,
                        new_m=seg.num_workers))
        t0 = max(done + 1, seg.start)
        k = seg.stop - t0
        params_final, h, state = eng.run(
            params, data_factory(seg.num_workers, t0, k),
            num_workers=seg.num_workers, seed=seed,
            record_every=record_every, eval_fn=eval_fn,
            worker_eval_fn=worker_eval_fn, phase_len=phase_len, steps=k,
            prefetch=prefetch, state=state, return_state=True, sink=sink)
        if eng.mesh is not None:
            sharded_by = (eng.mesh, seg.num_workers)
        for key in ("loss", "dispersion", "disp_trace", "eval",
                    "worker_eval", "phase_wall"):
            hist[key].extend(h[key])
        hist["averages"] += h["averages"]
        done = seg.stop - 1
        prev_faults = fp
    if return_state:
        return params_final, hist, state
    return params_final, hist
