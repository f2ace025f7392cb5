"""Phase engine: M workers, K local steps, averaging — on the flat plane.

The counterpart of ``repro.core.engine.PhaseEngine`` on its flat-native,
unsharded path. The M workers' params and optimizer state live as
(M, P) float32 planes (:mod:`repro_torch.core.flat`) for the whole run;
each step is

    grads_fn(plane, batch)                 # loss + grad of every row
    opt_step(plane, grads, state planes)   # ONE fused pass: update,
                                           #   Eq. 4 dispersion (+ mean)
    schedule.decision_state(step, ...)     # none / inner / all
    [avg_disp(plane)]                      # the averaging event

exactly as the reference's scan body orders it: the every-step
schedule (minibatch) fuses the mean into the update pass (mode "mean");
the rare ones update first and run the event pass only on the steps the
decision picks. On the card ``opt_step`` and ``avg_disp`` are the
hand-written CUDA kernels; on the CPU their plain versions run. Planes
whose columns carry bf16/f16 rounding codes take the plain
``plane_average_ref`` for the event, as the reference does
(``avg_disp`` has no codes input).

PyTorch runs eagerly, so a "phase" here is a Python loop over a staged
block of steps: the engine decides on the host each step (one device
read of the dispersion per step) and fetches the loss trace once per
phase. On the card ``opt_step`` updates the plane and the state planes
in place, so a state handed to ``run_phase`` is consumed, as the
reference's donated state is. The losses take no randomness, so
``EngineState.key`` and ``dec_key`` are plain seeds until the threefry
port lands.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.averaging import AveragingSchedule, SchedState
from repro_torch.core.flat import FlatSpec, tree_map, tree_unflatten
from repro_torch.device import resolve_device
from repro_torch.kernels.avg_disp import avg_disp
from repro_torch.kernels.opt_step import MAX_WORKERS, opt_step
from repro_torch.kernels.ref import _div, _row_sum, plane_average_ref


def init_history() -> dict:
    """The run history dict, keyed as the reference's
    ``repro.telemetry.events.init_history`` (``eval`` / ``worker_eval``
    stay empty: the eval hooks are not ported yet), plus ``phase_wall``:
    (first step, last step, host seconds) per phase, each ending in a
    device synchronize."""
    return {"loss": [], "dispersion": [], "disp_trace": [],
            "averages": 0, "eval": [], "worker_eval": [], "phase_wall": []}


def make_plane_step(loss_fn: Callable, spec: FlatSpec) -> Callable:
    """The flat-native local step: per-row losses and the (M, P) f32
    gradient plane.

    For each worker row: unpack the row into leaf *copies* in the leaf
    dtype with ``requires_grad``, run the loss, ``backward()``, and write
    each ``leaf.grad`` (cast to f32) straight into row i of the gradient
    plane. A Python loop over the M rows computes what the reference's
    ``vmap(value_and_grad)`` computes; at full width a vmap over a few
    bf16 copies of a 362M-parameter model would buy nothing but memory.

    Returns grads_fn(plane, batch, out=None) -> (losses (M,), aux list,
    grad plane); ``batch`` leaves carry the worker axis first, ``out``
    is an optional preallocated (M, P) f32 gradient plane."""
    sizes = [math.prod(s) for s in spec.shapes]

    def grads_fn(plane, batch, out=None):
        m = plane.shape[0]
        gplane = torch.empty_like(plane) if out is None else out
        losses, auxes = [], []
        for i in range(m):
            leaves = [plane[i, o:o + n].reshape(s).to(dt, copy=True)
                      .requires_grad_()
                      for o, n, s, dt in zip(spec.offsets, sizes,
                                             spec.shapes, spec.dtypes)]
            params = tree_unflatten(spec.treedef, leaves)
            loss, aux = loss_fn(params, tree_map(lambda x: x[i], batch),
                                None)
            loss.backward()
            for leaf, o, n in zip(leaves, spec.offsets, sizes):
                if leaf.grad is None:
                    gplane[i, o:o + n].zero_()
                else:
                    gplane[i, o:o + n].copy_(leaf.grad.reshape(-1))
            losses.append(loss.detach().float())
            auxes.append(aux)
        return torch.stack(losses), auxes, gplane

    return grads_fn


class EngineState(NamedTuple):
    """Everything a phase consumes and produces."""
    spec: FlatSpec       # plane layout (static)
    plane: Any           # (M, P) f32 worker params
    opt_planes: tuple    # S (M, P) f32 optimizer-state planes
    codes: Any           # (P,) f32 rounding codes on the device, or None
    key: int             # data seed (no per-step randomness yet)
    dec_key: int         # decision seed (no stochastic kind yet)
    step: int            # steps completed
    sched: SchedState    # adaptive-schedule carry


@dataclass(frozen=True, eq=False)
class PhaseEngine:
    """loss_fn(params, batch, rng) -> (loss, aux) over a params tree of
    tensors; optimizer from :mod:`repro_torch.optim` (plane protocol);
    ``device`` where the planes live ("cuda" by default; "cpu" runs the
    kernels' plain versions)."""
    loss_fn: Callable
    optimizer: Any
    schedule: AveragingSchedule
    device: str = "cuda"

    def __post_init__(self):
        resolve_device(self.device)
        if getattr(self.optimizer, "plane_kind", None) is None:
            raise TypeError(
                f"{type(self.optimizer).__name__} does not speak the plane "
                "protocol (plane_kind / plane_hypers / plane_scalars)")
        if not isinstance(self.schedule, AveragingSchedule):
            raise TypeError("schedule must be a repro_torch "
                            "AveragingSchedule")

    @property
    def _dev(self) -> torch.device:
        return resolve_device(self.device)

    # ---- state -----------------------------------------------------------
    def _check_workers(self, num_workers: int):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        if self._dev.type == "cuda" and num_workers > MAX_WORKERS:
            raise ValueError(f"the CUDA plane kernels take at most "
                             f"{MAX_WORKERS} workers, got {num_workers}")
        g = self.schedule.inner_groups
        if self.schedule.kind == "hierarchical" and num_workers % g:
            raise ValueError(
                f"hierarchical inner averaging splits the worker axis "
                f"into inner_groups={g} contiguous groups, but "
                f"num_workers={num_workers} is not divisible by it — "
                "pick inner_groups dividing the worker count")

    def init(self, params, num_workers: int, seed: int = 0) -> EngineState:
        """All workers start at ``params`` (as the paper prescribes);
        optimizer-state planes start at zero."""
        self._check_workers(num_workers)
        dev = self._dev
        params = tree_map(lambda x: x.to(dev), params)
        spec = FlatSpec.of(params, worker_axis=False)
        plane = spec.pack1(params).expand(num_workers, spec.width)
        plane = plane.contiguous()
        opt_planes = tuple(torch.zeros_like(plane)
                           for _ in range(self.optimizer.state_planes))
        return EngineState(spec, plane, opt_planes,
                           spec.rounding_codes(device=dev), seed, seed, 0,
                           self.schedule.init_sched_state())

    # ---- one step ----------------------------------------------------------
    def _plane_avg_event(self, state: EngineState, plane, scope: str):
        """The averaging event alone on the plane: the fused ``avg_disp``
        pass on f32 planes; on planes with rounding codes the plain
        ``plane_average_ref`` (the mean rounds through the leaf dtypes),
        as in the reference. Returns the averaged plane."""
        groups = (max(self.schedule.inner_groups, 1) if scope == "inner"
                  else 1)
        if state.codes is None:
            return avg_disp(plane, groups=groups)[0]
        return plane_average_ref(plane, groups=groups, codes=state.codes)[0]

    def _step(self, state: EngineState, batch, grads_fn, gbuf):
        """One step; returns (state, mean loss tensor, dispersion,
        decision code)."""
        sched = self.schedule
        step = state.step + 1
        losses, _, gplane = grads_fn(state.plane, batch, out=gbuf)
        kw = dict(kind=self.optimizer.plane_kind, codes=state.codes,
                  **self.optimizer.plane_hypers())
        scal = self.optimizer.plane_scalars(step)
        mode = "mean" if sched.kind == "minibatch" else "none"
        plane, planes, disp = opt_step(state.plane, gplane,
                                       state.opt_planes, scal, mode=mode,
                                       **kw)
        disp = float(disp)
        code, sst = sched.decision_state(step, state.sched, disp)
        if code and sched.kind != "minibatch":
            plane = self._plane_avg_event(state, plane,
                                          "inner" if code == 1 else "all")
        state = state._replace(plane=plane, opt_planes=planes, step=step,
                               sched=sst)
        return state, torch.mean(losses), disp, code

    def _stage(self, batch):
        return tree_map(lambda x: torch.as_tensor(x, device=self._dev),
                        batch)

    def run_phase(self, state: EngineState, batches):
        """Run the staged per-step batches of one phase. Returns the new
        state and the per-step traces {loss, dispersion, avg_code} as
        host lists (one device fetch for the losses)."""
        spec = state.spec
        grads_fn = make_plane_step(self.loss_fn, spec)
        gbuf = torch.empty_like(state.plane)
        losses, disps, codes = [], [], []
        for batch in batches:
            state, loss, disp, code = self._step(state, self._stage(batch),
                                                 grads_fn, gbuf)
            losses.append(loss)
            disps.append(disp)
            codes.append(code)
        loss_h = torch.stack(losses).tolist() if losses else []
        return state, {"loss": loss_h, "dispersion": disps,
                       "avg_code": codes}

    def default_phase_len(self) -> int:
        """Block size aligned with the schedule's natural period
        (correctness never depends on it — decisions are per step)."""
        s = self.schedule
        if s.kind == "periodic":
            return max(1, min(s.phase_len, 512))
        if s.kind == "hierarchical":
            return max(1, min(s.inner_phase_len, 512))
        if s.kind == "adaptive_budget":
            return int(min(max(s.budget_horizon / max(s.comm_budget, 1), 8),
                           128))
        return 64

    def consensus(self, state: EngineState):
        """The paper's final estimate: the worker average, in the leaf
        dtypes."""
        plane = state.plane
        return state.spec.unpack1(_div(_row_sum(plane), plane.shape[0]))

    def _sync(self):
        if self._dev.type == "cuda":
            torch.cuda.synchronize(self._dev)

    # ---- run loop ----------------------------------------------------------
    def run(self, params, data, *, num_workers: int, seed: int = 0,
            record_every: int = 0, phase_len: int | None = None, steps: int | None = None,
            state: EngineState | None = None, return_state: bool = False):
        """Training loop: one phase per block of steps.

        data: an iterable of per-step worker batches (leaves with the
        worker axis first, numpy arrays or tensors), staged to the
        device block by block. Returns (final averaged params, history
        dict).

        The history records ``loss`` and ``disp_trace`` (the per-step
        Eq. 4 dispersion, after the local update and before any
        averaging) every ``record_every`` steps, ``dispersion`` at every
        averaging event, the event count ``averages``, and
        ``phase_wall``. ``state`` resumes an :class:`EngineState`;
        ``steps`` bounds the steps run in this call."""
        self._check_workers(num_workers)
        if state is None:
            state = self.init(params, num_workers, seed)
        t0 = state.step
        block = phase_len or self.default_phase_len()
        hist = init_history()
        total = None if steps is None else t0 + steps

        def take_at(t):
            return block if total is None else min(block, total - t)

        it = iter(data)
        t = t0
        while True:
            take = take_at(t)
            if take <= 0:
                break
            chunk = []
            for _ in range(take):
                nxt = next(it, None)
                if nxt is None:
                    break
                chunk.append(nxt)
            if not chunk:
                break
            tw0 = time.perf_counter()
            state, trace = self.run_phase(state, chunk)
            self._sync()
            hist["phase_wall"].append((t + 1, t + len(chunk),
                                       time.perf_counter() - tw0))
            for i in range(len(chunk)):
                t += 1
                code = trace["avg_code"][i]
                if code:
                    hist["dispersion"].append((t, trace["dispersion"][i]))
                    hist["averages"] += 1
                if record_every and t % record_every == 0:
                    hist["loss"].append((t, trace["loss"][i]))
                    hist["disp_trace"].append((t, trace["dispersion"][i]))
            if len(chunk) < take:
                break
        final = self.consensus(state)
        return (final, hist, state) if return_state else (final, hist)
