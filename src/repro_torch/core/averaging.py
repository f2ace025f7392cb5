"""Averaging schedules — WHEN the M workers' models are averaged.

The counterpart of ``repro.core.averaging``'s schedules:
  - oneshot     : only at the very end
  - minibatch   : every step
  - periodic(K) : every K steps — the paper's main subject
  - hierarchical: inner groups every K_inner, all workers every K_outer
  - adaptive_threshold : average when the running EMA of the Eq. 4
                  dispersion crosses ``disp_threshold``
  - stochastic(ζ): average with probability ζ each step, a Bernoulli
                  draw on ``fold_in(dec_key, step)`` — the reference's
                  draws, bit for bit (:mod:`repro_torch.rng`)
  - adaptive_budget : spend at most ``comm_budget`` events over
                  ``budget_horizon`` steps, paced by the dispersion
  - adaptive_bytes : the same pacing with the budget in bytes per
                  worker, each event priced by the engine
                  (``topology.comm_bytes`` at the wire format)

``straggle_aware`` (adaptive kinds, under a fault plan with stragglers)
multiplies the dispersion that feeds the EMA and the budget by the
engine's ``FaultPlan.disp_scale``, the fraction of the mixing cohort
that applied its update. :class:`OuterOptimizer` is the reference's
DiLoCo-style outer Nesterov momentum at averaging events.

The PyTorch engine decides on the host, once per step, so the
transition below runs on numpy float32 / int32 scalars with the same
operation order as the reference: for the same dispersion stream the
codes and the :class:`SchedState` agree bit for bit.

The tree operators :func:`average_all`, :func:`average_inner` and
:func:`worker_dispersion` (the engine's ``tree`` carry, ``LocalSGD``,
``launch.steps``) act on every leaf's leading worker axis in float32
and cast back to the leaf dtype. Their means sum the rows in row order
and divide by the row count, the plane twins' arithmetic
(:mod:`repro_torch.kernels.ref`), so a tree event and a plane event
agree bit for bit column by column.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core.flat import tree_flatten, tree_map

_F32, _I32 = np.float32, np.int32


class SchedState(NamedTuple):
    """The stateful-schedule carry (see the reference's ``SchedState``):
    dispersion EMA (reset at every event), cumulative dispersion, pacing
    credit, events so far, steps since the last event."""
    disp_ema: np.float32
    cum_disp: np.float32
    credit: np.float32
    comm_spent: np.int32
    since_avg: np.int32


@dataclass(frozen=True)
class AveragingSchedule:
    kind: str = "periodic"
    phase_len: int = 128        # K for periodic
    zeta: float = 0.0           # for stochastic
    inner_phase_len: int = 16   # hierarchical: average inner groups every K_i
    outer_phase_len: int = 512  # hierarchical: average everyone every K_o
    inner_groups: int = 1       # hierarchical: number of inner groups
    disp_threshold: float = 0.0  # adaptive_threshold: EMA trip level
    disp_ema_beta: float = 0.9  # adaptive: dispersion EMA decay
    comm_budget: int = 0        # adaptive_budget: max averaging events
    budget_horizon: int = 0     # adaptive_*: steps the budget spans
    byte_budget: int = 0        # adaptive_bytes: max bytes per worker
    straggle_aware: bool = False

    _KINDS = ("oneshot", "minibatch", "periodic", "stochastic",
              "hierarchical", "adaptive_threshold", "adaptive_budget",
              "adaptive_bytes")
    _ADAPTIVE = ("adaptive_threshold", "adaptive_budget",
                 "adaptive_bytes")
    def __post_init__(self):
        if self.kind not in self._KINDS:
            raise ValueError(f"unknown schedule kind {self.kind!r}")
        if self.kind == "periodic" and self.phase_len < 1:
            raise ValueError(f"periodic needs phase_len >= 1, "
                             f"got {self.phase_len}")
        if self.kind == "stochastic" and not 0.0 < self.zeta <= 1.0:
            raise ValueError(f"stochastic needs 0 < zeta <= 1, "
                             f"got {self.zeta}")
        if self.kind == "hierarchical" and (
                self.inner_phase_len < 1 or self.outer_phase_len < 1
                or self.inner_groups < 1):
            raise ValueError(
                "hierarchical needs inner_phase_len/outer_phase_len/"
                f"inner_groups >= 1, got ({self.inner_phase_len}, "
                f"{self.outer_phase_len}, {self.inner_groups})")
        if self.is_adaptive and not 0.0 <= self.disp_ema_beta < 1.0:
            raise ValueError(f"adaptive schedules need 0 <= disp_ema_beta "
                             f"< 1, got {self.disp_ema_beta}")
        if self.kind == "adaptive_threshold" and self.disp_threshold <= 0.0:
            raise ValueError(f"adaptive_threshold needs disp_threshold > 0, "
                             f"got {self.disp_threshold}")
        if self.kind == "adaptive_budget":
            if self.comm_budget < 1 or self.budget_horizon < 1:
                raise ValueError(
                    "adaptive_budget needs comm_budget >= 1 and "
                    f"budget_horizon >= 1, got ({self.comm_budget}, "
                    f"{self.budget_horizon})")
            if self.comm_budget > self.budget_horizon:
                raise ValueError(
                    f"adaptive_budget cannot spend {self.comm_budget} "
                    f"events in {self.budget_horizon} steps (at most one "
                    "averaging event per step)")
        if self.kind == "adaptive_bytes":
            if self.byte_budget < 1 or self.budget_horizon < 1:
                raise ValueError(
                    "adaptive_bytes needs byte_budget >= 1 and "
                    f"budget_horizon >= 1, got ({self.byte_budget}, "
                    f"{self.budget_horizon})")
        if self.straggle_aware and not self.is_adaptive:
            raise ValueError(
                f"straggle_aware discounts the dispersion fed to the "
                f"adaptive schedules; {self.kind!r} never consumes "
                "dispersion — drop straggle_aware or use one of "
                f"{self._ADAPTIVE}")

    @property
    def is_adaptive(self) -> bool:
        return self.kind in self._ADAPTIVE

    def expected_phase_len(self) -> float:
        """A-priori expected steps between communication events (any
        event, inner or outer, for ``hierarchical``; NaN for
        ``adaptive_threshold``, whose interval is data-dependent)."""
        if self.kind == "oneshot":
            return float("inf")
        if self.kind == "minibatch":
            return 1.0
        if self.kind == "periodic":
            return float(self.phase_len)
        if self.kind == "stochastic":
            return 1.0 / max(self.zeta, 1e-12)
        if self.kind == "hierarchical":
            ki, ko = self.inner_phase_len, self.outer_phase_len
            rate = 1.0 / ki + 1.0 / ko - 1.0 / math.lcm(ki, ko)
            return 1.0 / rate
        if self.kind == "adaptive_budget":
            return self.budget_horizon / self.comm_budget
        # adaptive_threshold: data-dependent; adaptive_bytes: the cost of
        # an event depends on (topology, wire, P), which only the engine
        # knows
        return float("nan")

    def init_sched_state(self) -> SchedState:
        return SchedState(_F32(0), _F32(0), _F32(0), _I32(0), _I32(0))

    def decision_code(self, step: int, key=None) -> int:
        """Decision for step ``step`` (1-indexed steps done) of a static
        kind: 0 none, 1 inner, 2 all. ``stochastic`` draws
        ``bernoulli(fold_in(key, step), zeta)`` from the decision key."""
        if self.is_adaptive:
            raise ValueError(
                f"{self.kind} decisions depend on SchedState; use "
                "decision_state(step, sched_state, disp)")
        if self.kind == "oneshot":
            return 0
        if self.kind == "minibatch":
            return 2
        if self.kind == "periodic":
            return 2 if step % self.phase_len == 0 else 0
        if self.kind == "stochastic":
            if key is None:
                raise ValueError("the stochastic schedule needs the "
                                 "decision key")
            return 2 if bool(rng.bernoulli(rng.fold_in(key, step),
                                           self.zeta)) else 0
        # hierarchical
        if step % self.outer_phase_len == 0:
            return 2
        return 1 if step % self.inner_phase_len == 0 else 0

    def decision_state(self, step: int, sched_state: SchedState, disp,
                       key=None, event_cost=None, disp_scale=None):
        """One transition ``(step, state, dispersion) -> (code, new
        state)``: ``disp`` is the Eq. 4 dispersion measured at THIS step,
        after the local update and before any averaging. The EMA advances
        by ``disp_ema_beta`` and resets to 0 at every event;
        ``adaptive_threshold`` fires when the EMA crosses
        ``disp_threshold``; ``adaptive_budget`` accrues credit at the rate
        ``comm_budget / budget_horizon`` scaled by the EMA over the
        long-run mean dispersion, fires on a whole credit, and never
        exceeds ``comm_budget`` events; ``adaptive_bytes`` accrues
        ``byte_budget / budget_horizon`` bytes per step the same way,
        fires when the credit covers ``event_cost`` (one event's bytes
        per worker) and never lets ``(events + 1) * event_cost`` exceed
        ``byte_budget``. Static kinds defer to :meth:`decision_code`
        (``key``: the decision key) and only update the bookkeeping.
        With ``straggle_aware`` the engine passes ``disp_scale``
        (``FaultPlan.disp_scale``), multiplied into ``disp`` in float32
        before the EMA and the budget see it; the recorded trace stays
        unscaled."""
        s = sched_state
        disp = _F32(disp)
        if self.straggle_aware and disp_scale is not None:
            disp = disp * _F32(disp_scale)
        beta = _F32(self.disp_ema_beta)
        ema = beta * s.disp_ema + (_F32(1.0) - beta) * disp
        cum = s.cum_disp + disp
        credit = s.credit
        if self.kind == "adaptive_threshold":
            code = 2 if ema > _F32(self.disp_threshold) else 0
        elif self.kind in ("adaptive_budget", "adaptive_bytes"):
            if self.kind == "adaptive_budget":
                cost = _F32(1.0)
                rate = _F32(self.comm_budget / self.budget_horizon)
                room = s.comm_spent < self.comm_budget
            else:
                if event_cost is None:
                    raise ValueError(
                        "adaptive_bytes needs event_cost (bytes one event "
                        "puts on the wire per worker) — the engine passes "
                        "comm_bytes(topology, 1, P, wire)")
                cost = _F32(event_cost)
                rate = _F32(self.byte_budget / self.budget_horizon)
                room = _F32(s.comm_spent + 1) * cost <= _F32(
                    self.byte_budget)
            mean = cum / max(_F32(step), _F32(1.0))
            w = ema / max(mean, _F32(1e-30)) if mean > 0 else _F32(0.0)
            credit = credit + rate * w
            fire = credit >= cost and room
            code = 2 if fire else 0
            if fire:
                credit = credit - cost
        else:
            code = self.decision_code(step, key)
        avg = code > 0
        new = SchedState(
            disp_ema=_F32(0.0) if avg else _F32(ema),
            cum_disp=_F32(cum),
            credit=_F32(credit),
            comm_spent=_I32(s.comm_spent + int(avg)),
            since_avg=_I32(0) if avg else _I32(s.since_avg + 1))
        return code, new


# --------------------------------------------------------------------------
# Tree operators (worker axis = leading dim 0 of every leaf)
# --------------------------------------------------------------------------

def _rows(x: torch.Tensor) -> torch.Tensor:
    """A worker-axis leaf as (M, n) float32 rows."""
    return x.float().reshape(x.shape[0], -1)


def average_all(worker_tree):
    """Mean over the worker axis, broadcast back — the paper's operator
    (a new tree: every leaf a fresh (M, ...) tensor)."""
    from repro_torch.kernels.ref import _div, _row_sum

    def avg(x):
        glob = _div(_row_sum(_rows(x)), x.shape[0]).to(x.dtype)
        return glob.reshape(x.shape[1:]).expand(x.shape).contiguous()
    return tree_map(avg, worker_tree)


def average_inner(worker_tree, inner_groups: int):
    """Hierarchical inner average: the M workers as ``inner_groups``
    contiguous groups, each row the mean of its group only."""
    from repro_torch.kernels.ref import _group_means

    def avg(x):
        m = x.shape[0]
        if inner_groups < 1 or m % inner_groups:
            raise ValueError(f"inner_groups={inner_groups} must divide "
                             f"the {m} workers")
        gm = _group_means(_rows(x), inner_groups).to(x.dtype)
        return gm.expand(inner_groups, m // inner_groups, gm.shape[-1]) \
            .reshape(x.shape).contiguous()
    return tree_map(avg, worker_tree)


def worker_dispersion(worker_tree) -> torch.Tensor:
    """Mean squared distance of workers from their average — the paper's
    E||w_i - w̄||² diagnostic (Eq. 4): per leaf a float32 sum, the leaves
    added in flatten order (a 0-dim float32 tensor)."""
    from repro_torch.kernels.ref import _plane_dispersion
    return sum(_plane_dispersion(_rows(x))
               for x in tree_flatten(worker_tree)[0])


@dataclass(frozen=True)
class OuterOptimizer:
    """DiLoCo-style outer Nesterov momentum applied at averaging steps.
    With lr=1, momentum=0 this reduces exactly to the paper's plain mean.
    The engine runs it on the flat plane (``avg_disp_outer``);
    :meth:`apply` is the tree form."""
    lr: float = 1.0
    momentum: float = 0.0
    nesterov: bool = True

    def init(self, avg_tree):
        return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                        avg_tree)

    def apply(self, prev_avg, new_avg, velocity):
        """prev_avg/new_avg: trees WITHOUT the worker axis. Returns
        (updated average in the leaf dtypes, velocity)."""
        def outer_grad(p, n):
            return p.float() - n.float()

        velocity = tree_map(
            lambda p, n, v: self.momentum * v + outer_grad(p, n),
            prev_avg, new_avg, velocity)
        updated = tree_map(
            lambda p, n, v: (p.float() - self.lr * (
                self.momentum * v + outer_grad(p, n) if self.nesterov else v
            )).to(p.dtype),
            prev_avg, new_avg, velocity)
        return updated, velocity
