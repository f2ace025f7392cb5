"""Local-SGD runtime: M workers × independent steps × periodic averaging.

The counterpart of ``repro.core.local_sgd``: the paper's algorithm (Eq. 3
and the phase-end average) as a training strategy, over the worker tree
(every leaf with the worker axis first):

    worker_params, opt_state, outer = LocalSGD(...).init(params, M)
    for t in steps:
        worker_params, opt_state, m = sgd.local_step(worker_params,
                                                     opt_state, batch, t)
        worker_params, outer, disp = sgd.average(worker_params, outer)

:class:`LocalSGD` is the stable public API: ``run`` is a thin wrapper
over :meth:`repro_torch.core.PhaseEngine.run` (the flat-native planes
and the CUDA kernels on the card), and ``local_step`` / ``average``
expose the engine's building blocks — :func:`make_worker_step` and the
tree averages — for callers that drive steps themselves.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Any, Callable

import torch

from repro_torch.core.averaging import (AveragingSchedule, OuterOptimizer,
                                        average_inner, worker_dispersion)
from repro_torch.core.engine import (PhaseEngine, consensus,
                                     make_worker_step, replicate)
from repro_torch.core.flat import tree_flatten, tree_map
from repro_torch.device import resolve_device


@dataclass(frozen=True, eq=False)
class LocalSGD:
    """loss_fn(params, batch, rng) -> (loss, metrics); optimizer from
    :mod:`repro_torch.optim` (``init`` / ``apply``); ``device`` where the
    workers live ("cuda" by default)."""
    loss_fn: Callable
    optimizer: Any
    schedule: AveragingSchedule
    outer: OuterOptimizer | None = None
    faults: Any = None  # repro_torch.faults.FaultPlan | None
    device: str = "cuda"

    @cached_property
    def engine(self) -> PhaseEngine:
        return PhaseEngine(self.loss_fn, self.optimizer, self.schedule,
                           device=self.device, outer=self.outer,
                           faults=self.faults)

    @cached_property
    def worker_step(self) -> Callable:
        return make_worker_step(self.loss_fn, self.optimizer)

    def init(self, params, num_workers: int):
        """(worker params, optimizer state, outer state or None): every
        worker at ``params`` on the device, the state zero, the outer
        optimizer at the consensus with zero velocity."""
        self.engine._check_workers(num_workers)
        dev = resolve_device(self.device)
        wp = replicate(tree_map(lambda x: x.to(dev), params), num_workers)
        outer_state = None
        if self.outer is not None:
            avg = consensus(wp)
            outer_state = (avg, self.outer.init(avg))
        return wp, self.optimizer.init(wp), outer_state

    def local_step(self, worker_params, opt_state, batch, step, rngs=None):
        """One independent SGD step in every worker (paper Eq. 3); batch
        leaves carry the worker axis first. Returns (worker params,
        optimizer state, {"loss": the mean loss, "metrics": each row's
        aux})."""
        dev = tree_flatten(worker_params)[0][0].device
        batch = tree_map(lambda x: torch.as_tensor(x, device=dev), batch)
        wp, opt_state, losses, metrics = self.worker_step(
            worker_params, opt_state, batch, step, rngs)
        return wp, opt_state, {"loss": torch.mean(losses),
                               "metrics": metrics}

    def average(self, worker_params, outer_state=None, scope: str = "all"):
        """scope: "all" | "inner". Returns (worker params, outer state,
        the dispersion before the average)."""
        disp = worker_dispersion(worker_params)
        if scope == "inner" and self.schedule.inner_groups > 1:
            wp = average_inner(worker_params, self.schedule.inner_groups)
            return wp, outer_state, disp
        if self.outer is not None and outer_state is not None:
            wp, outer_state = self.engine._apply_all_average(
                worker_params, outer_state)
            return wp, outer_state, disp
        # no outer optimizer (or no state yet): the paper's plain mean
        m = tree_flatten(worker_params)[0][0].shape[0]
        return replicate(consensus(worker_params), m), outer_state, disp

    def run(self, params, batches, *, num_workers: int, seed: int = 0,
            record_every: int = 0, eval_fn=None):
        """batches: an iterable of per-step worker batches (leading axis
        M). Returns (final averaged params, history dict) of
        :meth:`PhaseEngine.run`."""
        return self.engine.run(params, batches, num_workers=num_workers,
                               seed=seed, record_every=record_every,
                               eval_fn=eval_fn)
