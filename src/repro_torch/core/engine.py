"""Phase engine: M workers, K local steps, averaging — on the flat plane.

The counterpart of ``repro.core.engine.PhaseEngine`` on its flat-native
path, unsharded or sharded over ranks (``mesh``, below). The M workers'
params and optimizer state live as (M, P) float32 planes
(:mod:`repro_torch.core.flat`) for the whole run; each step is

    grads_fn(plane, batch)                 # loss + grad of every row
    opt_step(plane, grads, state planes)   # ONE fused pass: update,
                                           #   Eq. 4 dispersion (+ event)
    schedule.decision_state(step, ...)     # none / inner / all
    [the averaging event]                  # rare schedules only

with the reference's dispatch: the every-step schedule (minibatch) fuses
its event into the update pass — the mean (mode "mean"), the group mean
of a ``groups`` topology (mode "group"), the gossip mix of a mixing
topology (mode "mix"), or the compressed event of a wire format; with
the outer optimizer the update runs alone and ``avg_disp_outer`` follows.
The rare schedules update first and run the event pass on the steps the
decision picks: ``avg_disp`` (mean / group mean), ``mix_disp`` (``W @``),
``avg_disp_outer``, or ``compressed_mix`` with a wire format. On the
card those are the hand-written CUDA kernels; on the CPU their plain
versions run. On a plane whose columns carry bf16/f16 rounding codes,
``avg_disp``, ``mix_disp`` and ``avg_disp_outer`` take the codes in
their kernels (the reference takes its jnp twins there: the same
function), so no event runs a plain version on the card.

Randomness is the reference's: ``init`` makes ``key, dec_key =
split(PRNGKey(seed))`` with :mod:`repro_torch.rng`, the data key splits
once per step, and every per-event draw (the stochastic schedule, the
gossip matchings, int8 stochastic rounding) folds ``dec_key`` with the
1-indexed step, so decisions, matchings and quantizations equal the
reference's bit for bit.

PyTorch runs eagerly, so a "phase" here is a Python loop over a block
of steps: the engine decides on the host each step (one device read of
the dispersion per step) and fetches the loss trace once per phase. A
block is either staged batches (``run_phase``) or, from a
:class:`~repro_torch.data.DeviceDataset`, one int index block copied to
the device once, each step's batches gathered there with
``index_select`` (``run_phase_indexed``, the reference's ``jnp.take``
inside its scan). On the card ``opt_step`` and ``compressed_mix`` update
the plane, the state planes and the residual in place, so a state
handed to a phase is consumed, as the reference's donated state is.

``kernel_impl`` picks the plane passes as the reference's does
(``auto | ref | pallas``): ``"auto"`` launches the CUDA kernels on a
CUDA device and runs their plain versions on the CPU, ``"ref"`` runs the
plain versions on either, and ``"cuda"`` launches the kernels and
refuses a CPU engine.

``faults`` (a :class:`~repro_torch.faults.FaultPlan`) carries the
reference's fault state ``(alive, staleness)`` in ``EngineState.fault``
and advances it on the host each step (``FaultPlan.transition``): rows
outside the step's update mask keep their params and state planes,
events and the dispersion are masked over the mixing cohort (the plane
passes' ``alive`` paths), a rejoining row is warm-started — in place —
from the previous step's cohort mean with its state planes and residual
zeroed, ``straggle_aware`` schedules decide on the discounted
dispersion, and the loss and the consensus are the cohort's. A trivial
plan is lowered away: the no-fault engine, bit for bit.

``mesh`` (a :class:`~repro_torch.launch.mesh.WorkerMesh`) splits the
worker rows over ``torch.distributed`` ranks: every rank of the mesh
holds its contiguous block of M/n rows of the plane, of every
optimizer-state plane, of the residual and of the fault rows
(:mod:`repro_torch.sharding.specs`), and a copy of the rest, and runs
the same Python loop on them. ``collective`` picks how a step spans the
ranks, as the reference's does:

* ``"gather"``: every step all-gathers the plane, the state planes, the
  batch, the residual and the fault rows (one collective, their rows'
  bytes side by side), runs the unsharded step on the full plane — with
  every kernel that step launches — and keeps this rank's rows: bitwise
  the unsharded run (validation);
* ``"psum"`` (the default): ``opt_step`` updates this rank's rows alone
  (mode none), one all-reduce of the column sums gives the global mean
  and the summed squared distances (gathered and added in rank order,
  so every rank decides on the same bytes) the Eq. 4 dispersion; each
  event takes the unsharded event's route: the all-worker mean event
  writes the mean to the rows (the outer step: ``avg_disp_outer`` on
  the one-row plane of the mean), while group (over several groups)
  and mixing events all-gather the rows (a compressed event its encoded
  rows) and keep this rank's rows of the result; a
  compressed mean encodes row-locally with the global rows' uniforms and
  all-reduces the encoded sums, its residual never leaving the rank.
  These reductions are plain torch, as the reference's are jnp outside
  its kernels; the results agree with the unsharded run to float32
  rounding, with the same decisions.

Each rank reads the full (M, ...) batches (or index blocks) the data
gives it and keeps its rows. Ranks of the world outside the mesh hold
no rows: their :meth:`PhaseEngine.run` waits for the mesh's result.

``telemetry`` adds the metrics plane (:mod:`repro_torch.telemetry`): per
phase, a float32 accumulator folded on the host from the losses,
dispersions and decisions the phase already reads, the events priced in
``topology.comm_bytes`` wire bytes, and the fault plan's alive and
straggling counts from the rows its transition already drew. It reads
no device tensor the phase does not read anyway, and the trained state
never consumes it, so telemetry on vs off is bitwise.
:meth:`PhaseEngine.run` flushes it into structured records when handed
a ``sink``.

Beside the flat-native carry, the engine runs the reference's two
further carries (``PhaseEngine(flat=, fused_opt=)``), picked per phase
as the reference's ``_phase`` picks them:

* ``flat`` (``fused_opt=False``, or an optimizer without the plane
  protocol): the params plane, each step unpacked to the params tree,
  one :func:`make_worker_step` (the per-row gradients and the optimizer's
  tree-mapped ``apply``) and packed again; the optimizer state rides as
  its tree. The dispersion and every event are the flat-native carry's
  plane passes: ``avg_disp``, ``mix_disp``, ``avg_disp_outer`` and
  ``compressed_mix`` on the card.
* ``tree`` (``flat=False``, or a params tree with leaves
  :meth:`FlatSpec.supports` refuses): the params tree itself, the tree
  averages of :mod:`repro_torch.core.averaging`,
  :func:`repro_torch.topology.mix_tree` and the ``*_tree`` helpers of
  :mod:`repro_torch.faults` (plain torch, as the reference's are jnp
  outside its kernels); a compressed event packs the plane around the
  event alone and runs ``compressed_mix``.

The three agree bit for bit on the CPU where the update and the event
arithmetic are elementwise the same (the tree ``apply`` is the plane
update's operations, the tree means the plane means' row sums); only
the dispersion's float32 sum runs per leaf in the tree carry. Between
phases an :class:`EngineState` is always in the flat-native layout (the
plane and the state planes) when the tree embeds, so ``return_state``,
checkpoints and elastic resizes take every carry; a tree that does not
embed keeps its ``params`` (and an optimizer state that rides no planes
its ``opt_state``) as trees, which neither checkpoints nor resizes
take. A mesh runs the flat-native carry only, as the reference's
sharded phase does.
"""
from __future__ import annotations

import itertools
import math
import time
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch import faults as faults_mod
from repro_torch import rng
from repro_torch.core.averaging import (AveragingSchedule, OuterOptimizer,
                                        SchedState, average_inner,
                                        worker_dispersion)
from repro_torch.core.compress import (Compression, encode_decode,
                                       row_uniforms, wire_row_bytes)
from repro_torch.core.flat import (FlatOptSpec, FlatSpec, tree_flatten,
                                   tree_map, tree_unflatten)
from repro_torch.device import resolve_device
from repro_torch.faults import FaultPlan, FaultState
from repro_torch.kernels._build import MAX_WORKERS
from repro_torch.kernels.avg_disp import (avg_disp, avg_disp_outer,
                                          compressed_mix,
                                          compressed_mix_plain, mix_disp)
from repro_torch.kernels.opt_step import opt_step
from repro_torch.kernels.ref import (_div, _plane_dispersion, _row_sum,
                                     avg_disp_outer_ref, mix_disp_ref,
                                     opt_step_ref, plane_average_ref,
                                     round_to_codes)
from repro_torch.sharding.specs import mesh_worker_axes, shard_engine_state
from repro_torch.telemetry import metrics as tele_metrics
from repro_torch.telemetry.events import init_history, make_record
from repro_torch.topology import MIX_KINDS, Topology, comm_bytes, mix_tree

KERNEL_IMPLS = ("auto", "ref", "cuda")
COLLECTIVES = ("psum", "gather")
#: the plane passes: the wrappers (kernel on CUDA tensors, plain version
#: on CPU tensors) and the plain versions on any device
_KERNEL_OPS = {"opt_step": opt_step, "avg_disp": avg_disp,
               "mix_disp": mix_disp, "avg_disp_outer": avg_disp_outer,
               "compressed_mix": compressed_mix}
_PLAIN_OPS = {"opt_step": opt_step_ref, "avg_disp": plane_average_ref,
              "mix_disp": mix_disp_ref, "avg_disp_outer": avg_disp_outer_ref,
              "compressed_mix": compressed_mix_plain}


# --------------------------------------------------------------------------
# Worker-axis utilities (leading axis = worker index on every leaf)
# --------------------------------------------------------------------------

def replicate(tree, num_workers: int):
    """Every leaf with a leading worker axis of ``num_workers`` copies
    (all workers start at w_0, as the paper prescribes); new tensors."""
    return tree_map(lambda x: x[None].expand(
        (num_workers,) + tuple(x.shape)).contiguous(), tree)


def unreplicate(tree):
    """Worker 0's leaves."""
    return tree_map(lambda x: x[0], tree)


def consensus(tree):
    """The paper's final estimate: every leaf's worker mean (rows summed
    in order in float32, the plane twins' arithmetic), in its dtype."""
    def mean(x):
        r = x.float().reshape(x.shape[0], -1)
        return _div(_row_sum(r), r.shape[0]).reshape(x.shape[1:]).to(
            x.dtype)
    return tree_map(mean, tree)


def tree_stack(trees):
    """Stack a list of per-step batches into one (K, ...) block."""
    trees = list(trees)
    return tree_map(lambda *xs: torch.stack([torch.as_tensor(x)
                                             for x in xs]),
                    trees[0], *trees[1:])


def _detached(aux):
    return tree_map(lambda a: a.detach() if isinstance(a, torch.Tensor)
                    else a, aux)


def make_worker_step(loss_fn: Callable, optimizer) -> Callable:
    """The local-SGD step (paper Eq. 3) of the ``flat`` and ``tree``
    carries, ``LocalSGD`` and ``launch.steps.make_train_step``: the
    reference's vmapped ``value_and_grad`` + ``optimizer.apply``.

    For each worker row: the row's leaves copied with ``requires_grad``
    (floating leaves only), the loss, ``backward()``, the leaf grads —
    the per-row autograd loop of :func:`make_plane_step`, so the same
    numbers; then ONE ``optimizer.apply`` over the stacked (M, ...)
    grads (elementwise, so the same as M row updates).

    Returns step_fn(worker_params, opt_state, batch, step, rngs=None)
    -> (worker_params, opt_state, losses (M,) f32, per-row aux list);
    ``batch`` leaves carry the worker axis first, ``rngs[i]`` (if given)
    goes to row i's loss."""
    def grads_fn(worker_params, batch, rngs=None):
        leaves, td = tree_flatten(worker_params)
        m = leaves[0].shape[0]
        per_leaf = [[] for _ in leaves]
        losses, auxes = [], []
        for i in range(m):
            row = [x[i].detach().clone().requires_grad_(
                x.is_floating_point()) for x in leaves]
            loss, aux = loss_fn(tree_unflatten(td, row),
                                tree_map(lambda b: b[i], batch),
                                None if rngs is None else rngs[i])
            loss.backward()
            for acc, r in zip(per_leaf, row):
                acc.append(torch.zeros_like(r) if r.grad is None
                           else r.grad)
            losses.append(loss.detach().float())
            auxes.append(_detached(aux))
        grads = tree_unflatten(td, [torch.stack(g) for g in per_leaf])
        return torch.stack(losses), auxes, grads

    def step_fn(worker_params, opt_state, batch, step, rngs=None):
        losses, auxes, grads = grads_fn(worker_params, batch, rngs)
        worker_params, opt_state = optimizer.apply(worker_params, grads,
                                                   opt_state, step)
        return worker_params, opt_state, losses, auxes

    return step_fn


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
    key: Any             # threefry data key, split once per step
    dec_key: Any         # threefry decision root key (constant)
    step: int            # steps completed
    sched: SchedState    # adaptive-schedule carry
    outer_state: tuple = ()  # (prev_avg, vel) (P,) f32, or ()
    resid: Any = None    # (M, P) f32 error-feedback residual, or None
    fault: Any = ()      # FaultState (host numpy rows) under a fault plan
    # the tree forms (module note): the worker params tree, leaves (M,
    # ...), where FlatSpec cannot embed it (spec and plane None; the
    # outer state then holds trees too), and inside a tree-carry phase
    params: Any = None
    # the optimizer state tree where it rides no planes (opt_planes ()),
    # and inside a flat- or tree-carry phase
    opt_state: Any = None


@dataclass(frozen=True, eq=False)
class PhaseEngine:
    """loss_fn(params, batch, rng) -> (loss, aux) over a params tree of
    tensors; optimizer from :mod:`repro_torch.optim` (plane protocol);
    ``device`` where the planes live ("cuda" by default; "cpu" runs the
    kernels' plain versions). ``outer``: the DiLoCo-style outer
    optimizer at all-worker events; ``topology``: the mixing graph of
    every all-worker event (:mod:`repro_torch.topology`);
    ``compression``: the wire format of every event
    (:mod:`repro_torch.core.compress`); ``kernel_impl``: ``"auto"`` (the
    CUDA kernels on a CUDA device, their plain versions on the CPU),
    ``"ref"`` (the plain versions) or ``"cuda"`` (the kernels; a CPU
    engine is refused); ``faults``: worker crashes, rejoins and
    stragglers (:mod:`repro_torch.faults`, module note); ``telemetry``:
    the metrics plane (module note); ``mesh`` / ``collective``: the
    worker rows split over the ranks of a
    :class:`~repro_torch.launch.mesh.WorkerMesh` (module note);
    ``flat`` / ``fused_opt``: the carry (module note) — the flat-native
    planes by default, the ``flat`` carry with ``fused_opt=False`` (or
    an optimizer with ``init`` / ``apply`` and no plane protocol), the
    ``tree`` carry with ``flat=False``."""
    loss_fn: Callable
    optimizer: Any
    schedule: AveragingSchedule
    device: str = "cuda"
    outer: OuterOptimizer | None = None
    topology: Topology | None = None
    compression: Compression | None = None
    kernel_impl: str = "auto"
    faults: FaultPlan | None = None
    telemetry: bool = False
    mesh: Any = None
    collective: str = "psum"
    flat: bool = True
    fused_opt: bool = True

    def __post_init__(self):
        dev = resolve_device(self.device)
        if not self._plane_opt() and not callable(
                getattr(self.optimizer, "apply", None)):
            raise TypeError(
                f"{type(self.optimizer).__name__} speaks neither the plane "
                "protocol (plane_kind / plane_hypers / plane_scalars) nor "
                "the tree one (init / apply)")
        if self.mesh is not None and not (self.flat and self.fused_opt
                                          and self._plane_opt()):
            raise ValueError(
                "sharded runs carry the flat-native (M, P) planes: they "
                "need flat=True, fused_opt=True and a plane-protocol "
                "optimizer (SGD / Momentum / AdamW)")
        if self.collective not in COLLECTIVES:
            raise ValueError(f"collective must be one of {COLLECTIVES}, "
                             f"got {self.collective!r}")
        if self.mesh is not None:
            axes = mesh_worker_axes(self.mesh)
            other = {a: n for a, n in self.mesh.shape.items()
                     if a not in axes and n > 1}
            if other:
                raise ValueError(
                    f"the port splits only the worker rows over a mesh; "
                    f"its axes {other} outside the worker axes {axes} "
                    "must have size 1")
            if self.mesh.backend == "nccl" and dev.type != "cuda":
                raise ValueError("an NCCL mesh communicates CUDA tensors; "
                                 f"a {dev.type} engine needs a gloo mesh")
        if self.kernel_impl not in KERNEL_IMPLS:
            raise ValueError(f"kernel_impl must be one of {KERNEL_IMPLS}, "
                             f"got {self.kernel_impl!r}")
        if self.kernel_impl == "cuda" and dev.type != "cuda":
            raise ValueError(
                f"kernel_impl='cuda' launches the CUDA kernels, which a "
                f"{dev.type} engine cannot — use 'auto' or 'ref' there")

        if not isinstance(self.schedule, AveragingSchedule):
            raise TypeError("schedule must be a repro_torch "
                            "AveragingSchedule")
        for name, t, cls in (("outer", self.outer, OuterOptimizer),
                             ("topology", self.topology, Topology),
                             ("compression", self.compression, Compression),
                             ("faults", self.faults, FaultPlan)):
            if t is not None and not isinstance(t, cls):
                raise TypeError(f"{name} must be a repro_torch "
                                f"{cls.__name__}")

    @property
    def _dev(self) -> torch.device:
        return resolve_device(self.device)

    def _plane_opt(self) -> bool:
        return getattr(self.optimizer, "plane_kind", None) is not None

    def carry(self, state: EngineState) -> str:
        """The carry a phase of ``state`` runs, as the reference names it:
        ``"tree"`` with ``flat=False`` or a tree without a plane;
        ``"flat"`` with ``fused_opt=False``, an optimizer without the
        plane protocol or a state that rides no planes; else
        ``"flat_native"``."""
        if state.plane is None or not self.flat:
            return "tree"
        if (not self.fused_opt or not self._plane_opt()
                or state.opt_state is not None):
            return "flat"
        return "flat_native"

    def _op(self, name: str) -> Callable:
        """The plane pass ``name`` under ``kernel_impl``."""
        return (_PLAIN_OPS if self.kernel_impl == "ref"
                else _KERNEL_OPS)[name]

    # ---- state -----------------------------------------------------------
    def _check_workers(self, num_workers: int):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        if self.mesh is not None and num_workers % self.mesh.size:
            raise ValueError(
                f"num_workers={num_workers} is not a multiple of the "
                f"mesh's {self.mesh.size} worker shards — every shard "
                "holds the same number of rows; build the mesh with "
                "make_worker_mesh(num_workers)")
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
        t = self.topology
        if t is not None:
            if t.num_workers != num_workers:
                raise ValueError(
                    f"topology '{t.kind}' was built for "
                    f"{t.num_workers} workers but the engine runs "
                    f"{num_workers} — build the Topology with the run's "
                    "worker count")
            if self.outer is not None and t.kind != "full":
                raise ValueError(
                    f"the outer optimizer steps on the consensus mean, "
                    f"which topology '{t.kind}' never forms (partial "
                    "mixing keeps per-worker rows) — use topology "
                    "'full', or drop the outer optimizer")
        if self._comp() is not None and self.outer is not None:
            raise ValueError(
                "the outer optimizer steps on the exact consensus mean, "
                f"which the '{self.compression.wire}' wire format never "
                "ships — use the f32 wire, or drop the outer optimizer")
        fp = self.faults
        if fp is not None:
            if fp.num_workers != num_workers:
                raise ValueError(
                    f"FaultPlan was built for {fp.num_workers} workers "
                    f"but the engine runs {num_workers} — build the plan "
                    "with the run's worker count")
            if self._faults() is not None and self.outer is not None:
                raise ValueError(
                    "the outer optimizer steps on the full-membership "
                    "consensus mean, which a fault plan (crashes / "
                    "stragglers changing the alive set) never preserves "
                    "— drop the outer optimizer, or run without faults")

    def _faults(self) -> FaultPlan | None:
        """The active (non-trivial) fault plan, or None: a plan with no
        events, straggles or solo windows IS the no-fault engine."""
        fp = self.faults
        if fp is None or fp.is_trivial:
            return None
        return fp

    def _comp(self) -> Compression | None:
        """The active (non-identity) compression, or None: the ``f32``
        wire IS the uncompressed path."""
        c = self.compression
        if c is None or c.is_identity:
            return None
        return c

    def _mix_topology(self) -> Topology | None:
        """The topology whose events need the generic ``W @ plane`` mix,
        or None when events take the mean / group-mean paths (no
        topology, ``full``, or ``groups``)."""
        t = self.topology
        if t is None or t.kind not in MIX_KINDS:
            return None
        return t

    def _all_groups(self) -> int:
        """Group count of an all-scope mean event: 1 unless the
        ``groups`` topology narrows it to its block mean."""
        t = self.topology
        if t is not None and t.kind == "groups":
            return t.groups
        return 1

    def _event_W(self, step: int, dec_key):
        """This event's (M, M) f32 mixing matrix on the device, or None
        when events take the mean path; ``gossip_pairs`` draws its
        matching from (dec_key, step)."""
        t = self._mix_topology()
        if t is None:
            return None
        return t.mixing_matrix(step, dec_key, device=self._dev)

    def _sched_event_cost(self, p: int, num_workers: int):
        """The bytes ONE worker ships per event, the currency of the
        ``adaptive_bytes`` budget; None for every other kind."""
        if self.schedule.kind != "adaptive_bytes":
            return None
        topo = self.topology or Topology.full(num_workers)
        wire = self.compression.wire if self.compression else "f32"
        return float(comm_bytes(topo, 1, p, wire))

    def _event_bytes(self, p: int, num_workers: int):
        """Telemetry pricing of one averaging event: the (all-scope,
        inner) nominal wire bytes ONE worker ships, in the currency of
        the ``adaptive_bytes`` budget; an inner (group-mean) event ships
        within its group."""
        topo = self.topology or Topology.full(num_workers)
        wire = self.compression.wire if self.compression else "f32"
        eb_all = float(comm_bytes(topo, 1, p, wire))
        g = max(self.schedule.inner_groups, 1)
        eb_inner = float(
            max(num_workers // g - 1, 0) * wire_row_bytes(p, wire))
        return eb_all, eb_inner

    def init(self, params, num_workers: int, seed: int = 0) -> EngineState:
        """All workers start at ``params`` (as the paper prescribes);
        optimizer-state planes and the residual start at zero; the outer
        optimizer starts at the consensus with zero velocity; ``key,
        dec_key = split(PRNGKey(seed))`` as in the reference. With a mesh
        the state holds this rank's rows only (none outside the mesh):
        the full plane is never made."""
        self._check_workers(num_workers)
        dev = self._dev
        params = tree_map(lambda x: x.to(dev), params)
        key, dec_key = rng.split(rng.PRNGKey(seed))
        if not FlatSpec.supports(params):
            return self._init_tree(params, num_workers, key, dec_key)
        spec = FlatSpec.of(params, worker_axis=False)
        full = spec.pack1(params).expand(num_workers, spec.width)
        r0, r1 = self._row_range(num_workers)
        plane = full[r0:r1].contiguous()
        opt_state = None
        if self._plane_opt():
            opt_planes = tuple(torch.zeros_like(plane)
                               for _ in range(self.optimizer.state_planes))
        else:
            # the optimizer's own init; its state rides planes where it
            # is S float32 copies of the params tree
            opt_state = self.optimizer.init(spec.unpack(plane))
            ospec = FlatOptSpec.of(spec, opt_state)
            opt_planes = ()
            if ospec is not None:
                opt_planes, opt_state = ospec.pack(opt_state), None
        codes = spec.rounding_codes(device=dev)
        outer_state = ()
        if self.outer is not None:
            avg = _div(_row_sum(full), num_workers)
            if codes is not None:
                avg = round_to_codes(avg, codes)
            outer_state = (avg, torch.zeros_like(avg))
        resid = torch.zeros_like(plane) if self._comp() else None
        fault = (faults_mod.init_fault_state(r1 - r0)
                 if self._faults() is not None else ())
        return EngineState(spec, plane, opt_planes, codes, key, dec_key, 0,
                           self.schedule.init_sched_state(), outer_state,
                           resid, fault, opt_state=opt_state)

    def _init_tree(self, params, num_workers: int, key, dec_key):
        """:meth:`init` for a params tree FlatSpec cannot embed: the
        state holds the worker tree and the optimizer's state tree (the
        reference's ``EngineState``), the outer state as trees."""
        if self._comp() is not None:
            raise ValueError(
                "compressed communication encodes averaging events on "
                "the flat (M, P) plane, but this params tree has leaves "
                "FlatSpec cannot embed in float32 — use the f32 wire "
                "for such trees")
        if self.mesh is not None:
            raise ValueError("sharded runs carry the (M, P) plane, which "
                             "this params tree (leaves FlatSpec cannot "
                             "embed) has none of")
        wp = replicate(params, num_workers)
        outer_state = ()
        if self.outer is not None:
            avg = consensus(wp)
            outer_state = (avg, self.outer.init(avg))
        fault = (faults_mod.init_fault_state(num_workers)
                 if self._faults() is not None else ())
        return EngineState(None, None, (), None, key, dec_key, 0,
                           self.schedule.init_sched_state(), outer_state,
                           None, fault, params=wp,
                           opt_state=self.optimizer.init(wp))

    # ---- the carries' state forms -------------------------------------------
    @staticmethod
    def _state_rows(state: EngineState) -> int:
        """The worker rows a state holds."""
        if state.plane is not None:
            return int(state.plane.shape[0])
        return int(tree_flatten(state.params)[0][0].shape[0])

    @staticmethod
    def _state_cols(state: EngineState) -> int:
        """P: the columns of the plane, or the tree's per-row entries."""
        if state.spec is not None:
            return state.spec.width
        return sum(math.prod(x.shape[1:])
                   for x in tree_flatten(state.params)[0])

    @staticmethod
    def _state_device(state: EngineState) -> torch.device:
        if state.plane is not None:
            return state.plane.device
        return tree_flatten(state.params)[0][0].device

    def _opt_layout(self, spec: FlatSpec) -> FlatOptSpec:
        """The optimizer state's plane layout over ``spec``: its ``init``
        run on meta tensors gives the tree structure."""
        meta = spec.unpack(torch.empty((1, spec.width), device="meta"))
        return FlatOptSpec.of(spec, self.optimizer.init(meta))

    def _enter_carry(self, state: EngineState, carry: str) -> EngineState:
        """``state`` in the form ``carry``'s steps take: the optimizer
        state as its tree (flat and tree), and the params and the outer
        state as trees (tree)."""
        if carry == "flat_native":
            return state
        spec = state.spec
        opt = state.opt_state
        if opt is None:
            opt = self._opt_layout(spec).unpack(state.opt_planes)
        state = state._replace(opt_planes=(), opt_state=opt)
        if carry == "flat" or state.params is not None:
            return state
        outer = state.outer_state
        if outer != ():
            outer = (spec.unpack1(outer[0]),
                     spec.unpack1(outer[1], dtypes=torch.float32))
        return state._replace(plane=None, params=spec.unpack(state.plane),
                              outer_state=outer)

    @staticmethod
    def _leave_carry(state: EngineState) -> EngineState:
        """A carry's state back in the flat-native layout, where the tree
        embeds (bit for bit: packing is exact); the optimizer state into
        planes where it is S float32 copies of the params tree."""
        spec = state.spec
        if spec is None:
            return state
        if state.params is not None:
            outer = state.outer_state
            if outer != ():
                outer = (spec.pack1(outer[0]), spec.pack1(outer[1]))
            state = state._replace(plane=spec.pack(state.params),
                                   params=None, outer_state=outer)
        ospec = (FlatOptSpec.of(spec, state.opt_state)
                 if state.opt_state is not None else None)
        if ospec is not None:
            state = state._replace(opt_planes=ospec.pack(state.opt_state),
                                   opt_state=None)
        return state

    # ---- the sharded plane -------------------------------------------------
    def _row_range(self, num_workers: int) -> tuple[int, int]:
        """The global rows ``[r0, r1)`` this rank holds."""
        if self.mesh is None:
            return 0, num_workers
        return self.mesh.row_range(num_workers)

    def _global_m(self, state: EngineState) -> int:
        """The run's worker count M of a (possibly sharded) state."""
        m = self._state_rows(state)
        return m if self.mesh is None else m * self.mesh.size

    def shard_state(self, state: EngineState,
                    num_workers: int) -> EngineState:
        """This rank's rows of a full ``num_workers``-row state
        (:func:`repro_torch.sharding.specs.shard_engine_state`); a state
        that holds them already passes through."""
        if self.mesh is None:
            return state
        return shard_engine_state(state, self.mesh, num_workers)

    # ---- the averaging events ----------------------------------------------
    def _outer_kw(self) -> dict:
        o = self.outer
        return dict(lr=o.lr, momentum=o.momentum, nesterov=o.nesterov)

    def _event_route(self, scope: str, W=None, outer_c=()):
        """How an averaging event of ``scope`` ("inner" or "all") runs:
        ``("mix", 1)`` with a mixing matrix ``W``, ``("group", g)`` for
        a mean over g > 1 contiguous groups (an inner event, or the
        ``groups`` topology's all-scope), ``("outer", 1)`` for the
        all-scope with an outer optimizer, else ``("mean", 1)``. An
        inner event over one group is a plain mean: it never steps the
        outer optimizer."""
        if W is not None:
            return "mix", 1
        groups = (max(self.schedule.inner_groups, 1) if scope == "inner"
                  else self._all_groups())
        if groups > 1:
            return "group", groups
        if scope == "all" and self.outer is not None and outer_c != ():
            return "outer", 1
        return "mean", 1

    def _plane_avg_event(self, state: EngineState, plane, outer_c,
                         scope: str, W=None, alive=None):
        """The averaging event alone on the plane (rare schedules): ONE
        fused pass, ``avg_disp`` (mean or group mean) or ``mix_disp``
        with a mixing topology, rounded through the plane's codes and
        masked over ``alive`` under faults; or, for the all-scope with an
        outer optimizer (never under faults), ``avg_disp_outer``, rounded
        through the codes. Returns (plane, outer state)."""
        codes = state.codes
        route, groups = self._event_route(scope, W, outer_c)
        if route == "mix":
            return self._op("mix_disp")(plane, W, codes=codes,
                                        alive=alive)[0], outer_c
        if route == "outer":
            plane, prev, vel, _ = self._op("avg_disp_outer")(
                plane, *outer_c, codes=codes, **self._outer_kw())
            return plane, (prev, vel)
        return self._op("avg_disp")(plane, groups=groups, codes=codes,
                                    alive=alive)[0], outer_c

    def _event_uniforms(self, m: int, p: int, step: int, dec_key):
        """The int8 stochastic-rounding uniforms of this event's rows, or
        None for the deterministic wire formats."""
        comp = self._comp()
        if comp is None or not comp.stochastic:
            return None
        return row_uniforms(dec_key, step, range(m), p, device=self._dev)

    def _compressed_plane_event(self, state: EngineState, plane, resid,
                                scope: str, step: int, W=None, alive=None):
        """One compressed averaging / mixing event: the error-feedback
        encode of the plane, the mean / group mean / ``W @`` of the
        decoded plane, the residual; masked over ``alive`` under faults.
        Returns (plane, residual)."""
        comp = self._comp()
        m, p = plane.shape
        mode, groups = self._event_route(scope, W)
        plane, resid, _ = self._op("compressed_mix")(
            plane, resid, wire=comp.wire, mode=mode, groups=groups, W=W,
            u=self._event_uniforms(m, p, step, state.dec_key),
            codes=state.codes, error_feedback=comp.error_feedback,
            alive=alive)
        return plane, resid

    def _fused_step_average(self, state: EngineState, gplane, scalars,
                            scope: str, step: int, W=None, fmask=None):
        """The local update and, per ``scope``, the averaging event in
        one ``opt_step`` pass: mode none / mean / group / mix, or the
        compressed event with a wire format. The all-scope with an outer
        optimizer runs the update alone and then ``avg_disp_outer``.
        ``fmask``: the step's
        ``(mix, umask)`` under faults. Returns (plane, state planes,
        outer state, residual, dispersion)."""
        codes = state.codes
        kw = dict(kind=self.optimizer.plane_kind, codes=codes,
                  **self.optimizer.plane_hypers())
        if fmask is not None:
            kw.update(alive=fmask[0], umask=fmask[1])
        plane, planes = state.plane, state.opt_planes
        outer_c, resid = state.outer_state, state.resid
        if scope == "none":
            plane, planes, disp = self._op("opt_step")(
                plane, gplane, planes, scalars, mode="none", **kw)
            return plane, planes, outer_c, resid, disp
        mode, groups = self._event_route(scope, W, outer_c)
        comp = self._comp()
        if comp is not None:
            m, p = plane.shape
            plane, planes, resid, disp = self._op("opt_step")(
                plane, gplane, planes, scalars, mode=mode, W=W,
                groups=groups, wire=comp.wire, resid=resid,
                u=self._event_uniforms(m, p, step, state.dec_key),
                error_feedback=comp.error_feedback, **kw)
            return plane, planes, outer_c, resid, disp
        if mode == "outer":
            plane, planes, _ = self._op("opt_step")(
                plane, gplane, planes, scalars, mode="none", **kw)
            plane, prev, vel, disp = self._op("avg_disp_outer")(
                plane, *outer_c, codes=codes, **self._outer_kw())
            return plane, planes, (prev, vel), resid, disp
        plane, planes, disp = self._op("opt_step")(
            plane, gplane, planes, scalars, mode=mode, W=W, groups=groups,
            **kw)
        return plane, planes, outer_c, resid, disp

    # ---- one step ----------------------------------------------------------
    def _fault_transition(self, state: EngineState, step: int):
        """The fault plan's step: the state with its rejoining rows
        warm-started, the new fault state, ``(mix, umask)``, the
        straggle-aware discount (or None) and the telemetry's
        ``(n_alive, n_straggle)`` of the full plane, counted from the
        rows the transition drew. A rejoining row restarts, before the
        step's gradient, from the previous step's mixing cohort (rounded
        to the codes; in place on a plane, :func:`~repro_torch.faults.
        warm_start_tree` on a tree), its optimizer state and residual
        zeroed."""
        fp = self._faults()
        fst = (state.fault if isinstance(state.fault, FaultState)
               else faults_mod.init_fault_state(fp.num_workers))
        alive_prev = fst.alive
        fst, _, mix, umask, rejoined = fp.transition(fst, step,
                                                     state.dec_key)
        rows = faults_mod.rows_where(rejoined)
        if rows:
            mix_prev = fp.mix_at(alive_prev, step - 1)
            if state.plane is not None:
                self._warm_start(state, rows, faults_mod.masked_mean(
                    state.plane, mix_prev))
            else:
                state = state._replace(params=faults_mod.warm_start_tree(
                    state.params, mix_prev, rejoined))
                if state.resid is not None:
                    for i in rows:
                        state.resid[i].zero_()
            if state.opt_state is not None:
                state = state._replace(opt_state=faults_mod.zero_rows_tree(
                    state.opt_state, rejoined))
        dscale = (fp.disp_scale(mix, state.dec_key, step)
                  if self.schedule.straggle_aware else None)
        # the scripted liveness and, of it, the rows that straggle: the
        # alive rows outside the update mask (0/1 values: exact in f32)
        n_alive = np.sum(fst.alive, dtype=np.float32)
        occ = (n_alive, n_alive - np.sum(umask, dtype=np.float32))
        return state, fst, (mix, umask), dscale, occ

    @staticmethod
    def _warm_start(state: EngineState, rows, glob):
        """The rejoining ``rows`` of ``state`` restart from the cohort
        mean ``glob`` (rounded to the codes), their state planes and
        residual zeroed; in place."""
        if state.codes is not None:
            glob = round_to_codes(glob, state.codes)
        for i in rows:
            state.plane[i] = glob
            for t in state.opt_planes:
                t[i].zero_()
            if state.resid is not None:
                state.resid[i].zero_()

    def _step(self, state: EngineState, batch, grads_fn, gbuf):
        """One step, dispatched as the reference's flat-native step;
        returns (state, mean loss tensor, dispersion, decision code,
        (n_alive, n_straggle))."""
        sched = self.schedule
        step = state.step + 1
        # the reference splits the data key every step; the losses here
        # take no randomness, but the key advances the same way
        key = rng.split(state.key)[0]
        fst, fmask, dscale = state.fault, None, None
        occ = (state.plane.shape[0], 0.0)
        if self._faults() is not None:
            state, fst, fmask, dscale, occ = self._fault_transition(state,
                                                                    step)
        alive = None if fmask is None else fmask[0]
        losses, _, gplane = grads_fn(state.plane, batch, out=gbuf)
        scal = self.optimizer.plane_scalars(step)
        m, p = state.plane.shape
        dec = state.dec_key
        ec = self._sched_event_cost(p, m)
        if sched.kind == "minibatch":
            plane, planes, outer_c, resid, disp = self._fused_step_average(
                state, gplane, scal, "all", step, W=self._event_W(step, dec),
                fmask=fmask)
            disp = float(disp)
            code, sst = sched.decision_state(step, state.sched, disp, dec,
                                             event_cost=ec,
                                             disp_scale=dscale)
        else:
            plane, planes, outer_c, resid, disp = self._fused_step_average(
                state, gplane, scal, "none", step, fmask=fmask)
            disp = float(disp)
            code, sst = sched.decision_state(step, state.sched, disp, dec,
                                             event_cost=ec,
                                             disp_scale=dscale)
            if code:
                scope = "inner" if code == 1 else "all"
                W = self._event_W(step, dec) if code == 2 else None
                if self._comp() is not None:
                    plane, resid = self._compressed_plane_event(
                        state, plane, resid, scope, step, W, alive)
                else:
                    plane, outer_c = self._plane_avg_event(
                        state, plane, outer_c, scope, W, alive)
        state = state._replace(plane=plane, opt_planes=planes, key=key,
                               step=step, sched=sst, outer_state=outer_c,
                               resid=resid, fault=fst)
        return state, self._mean_loss(losses, alive), disp, code, occ

    @staticmethod
    def _mean_loss(losses, alive=None):
        """The step's loss: the mean of the (M,) worker losses, under a
        fault plan over the mixing cohort ``alive``."""
        if alive is None:
            return torch.mean(losses)
        a = torch.from_numpy(alive).to(losses.device)
        return torch.sum(losses * a) / torch.sum(a)

    # ---- one step of the flat and tree carries ------------------------------
    def _apply_all_average(self, wp, outer_c):
        """The all-worker mean of a worker tree broadcast back; with the
        outer optimizer the mean is its target and the stepped average
        is broadcast. Returns (tree, outer state)."""
        m = tree_flatten(wp)[0][0].shape[0]
        avg = consensus(wp)
        if self.outer is not None and outer_c != ():
            avg, vel = self.outer.apply(outer_c[0], avg, outer_c[1])
            outer_c = (avg, vel)
        return replicate(avg, m), outer_c

    def _tree_average(self, wp, outer_c, scope: str, W=None, alive=None):
        """One averaging event on the worker tree (the reference's
        ``_tree_average``): the (group) mean, the ``W`` mix or the outer
        step, masked over ``alive`` under faults. Returns (tree, outer
        state)."""
        inner = max(self.schedule.inner_groups, 1)
        if alive is not None:
            if scope == "all" and W is not None:
                return faults_mod.masked_mix_tree(wp, W, alive), outer_c
            groups = inner if scope == "inner" else self._all_groups()
            return faults_mod.masked_average_all_tree(
                wp, alive, groups=groups), outer_c
        if scope == "inner":
            return average_inner(wp, inner), outer_c
        if W is not None:
            return mix_tree(wp, W), outer_c
        if self._all_groups() > 1:
            return average_inner(wp, self._all_groups()), outer_c
        return self._apply_all_average(wp, outer_c)

    def _step_unfused(self, state: EngineState, batch, wstep):
        """One step of the ``flat`` or ``tree`` carry (the reference's
        non-native scan body): the fault transition, :func:`make_worker_step`
        on the params tree (unpacked from the plane in the flat carry and
        packed again), rows outside the update mask kept, the Eq. 4
        dispersion, the decision, and the event — the plane passes in the
        flat carry, the tree averages in the tree carry, the compressed
        event on the plane in both. Returns what :meth:`_step` returns."""
        sched = self.schedule
        step = state.step + 1
        key = rng.split(state.key)[0]
        dec = state.dec_key
        tree = state.plane is None
        spec = state.spec
        fst, fmask, dscale = state.fault, None, None
        m = self._state_rows(state)
        occ = (m, 0.0)
        if self._faults() is not None:
            state, fst, fmask, dscale, occ = self._fault_transition(state,
                                                                    step)
        alive = None if fmask is None else fmask[0]
        wp = state.params if tree else spec.unpack(state.plane)
        wp_new, opt, losses, _ = wstep(wp, state.opt_state, batch, step)
        if fmask is not None:
            # rows outside the update mask keep their params AND their
            # optimizer state
            opt = faults_mod.select_rows_tree(opt, state.opt_state,
                                              fmask[1])
        params = plane = None
        if tree:
            params = (wp_new if fmask is None else
                      faults_mod.select_rows_tree(wp_new, wp, fmask[1]))
            disp = (worker_dispersion(params) if alive is None else
                    faults_mod.masked_dispersion_tree(params, alive))
        else:
            plane = spec.pack(wp_new)
            if fmask is not None:
                faults_mod.keep_rows_(plane, state.plane, fmask[1])
            disp = (_plane_dispersion(plane) if alive is None else
                    faults_mod.masked_dispersion(plane, alive))
        del wp, wp_new
        disp = float(disp)
        code, sst = sched.decision_state(
            step, state.sched, disp, dec,
            event_cost=self._sched_event_cost(self._state_cols(state), m),
            disp_scale=dscale)
        outer_c, resid = state.outer_state, state.resid
        if sched.kind == "minibatch" or code:
            scope = "inner" if code == 1 else "all"
            W = self._event_W(step, dec) if scope == "all" else None
            if self._comp() is not None:
                # the wire encodes the plane: a tree packs around the
                # event alone
                pl = spec.pack(params) if tree else plane
                pl, resid = self._compressed_plane_event(
                    state, pl, resid, scope, step, W, alive)
                if tree:
                    params = spec.unpack(pl)
                else:
                    plane = pl
            elif tree:
                params, outer_c = self._tree_average(params, outer_c, scope,
                                                     W, alive)
            else:
                plane, outer_c = self._plane_avg_event(
                    state, plane, outer_c, scope, W, alive)
        state = state._replace(plane=plane, params=params, opt_state=opt,
                               key=key, step=step, sched=sst,
                               outer_state=outer_c, resid=resid, fault=fst)
        return state, self._mean_loss(losses, alive), disp, code, occ

    # ---- one sharded step ---------------------------------------------------
    def _step_gather(self, state: EngineState, batch, grads_fn, gbuf):
        """``collective="gather"``: the rows, the state planes, the
        residual, the fault rows and the batch of every rank gathered in
        one collective, :meth:`_step` on the full plane, this rank's rows
        kept. Returns what :meth:`_step` returns."""
        dev = state.plane.device
        leaves, tdef = tree_flatten(batch)
        fault = state.fault if isinstance(state.fault, FaultState) else ()
        resid = () if state.resid is None else (state.resid,)
        k = len(state.opt_planes)
        got = self.mesh.all_gather_rows_packed(
            [state.plane, *state.opt_planes, *resid, *leaves,
             *(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
               for a in fault)])
        plane, planes = got[0], tuple(got[1:1 + k])
        rest = got[1 + k:]
        resid_f = rest.pop(0) if resid else None
        batch_f = tree_unflatten(tdef, rest[:len(leaves)])
        fault_f = (FaultState(*(x.cpu().numpy() for x in rest[len(leaves):]))
                   if fault else state.fault)
        full = state._replace(plane=plane, opt_planes=planes, resid=resid_f,
                              fault=fault_f)
        full, loss, disp, code, occ = self._step(full, batch_f, grads_fn,
                                                 gbuf)
        r0, r1 = self.mesh.row_range(full.plane.shape[0])
        fault = full.fault
        if isinstance(fault, FaultState):
            fault = FaultState(*(x[r0:r1].copy() for x in fault))
        state = full._replace(
            plane=full.plane[r0:r1].clone(),
            opt_planes=tuple(t[r0:r1].clone() for t in full.opt_planes),
            resid=None if full.resid is None else full.resid[r0:r1].clone(),
            fault=fault)
        return state, loss, disp, code, occ

    @staticmethod
    def _col_sum(plane, mask=None):
        """The sum of ``plane``'s rows (those with ``mask > 0``) in row
        order, from 0."""
        s = torch.zeros_like(plane[0])
        for i in (range(plane.shape[0]) if mask is None
                  else faults_mod.rows_where(mask)):
            s += plane[i]
        return s

    def _psum_mean(self, plane, mask, n):
        """The global mean of the rows (with ``mask > 0``) over ``n``
        rows: one all-reduce of this rank's column sums."""
        return _div(self.mesh.all_reduce_(self._col_sum(plane, mask)), n)

    def _psum_dispersion(self, plane, glob, mask, n) -> float:
        """The Eq. 4 dispersion against the global mean ``glob``: this
        rank's squared distances summed one row at a time (no (M/n, P)
        temporary), the ranks' sums gathered and added in rank order, so
        every rank holds the same float."""
        acc = torch.zeros((), dtype=torch.float32, device=plane.device)
        for i in (range(plane.shape[0]) if mask is None
                  else faults_mod.rows_where(mask)):
            d = plane[i] - glob
            acc = acc + torch.dot(d, d)
        return float(_div(self.mesh.sum_scalars(acc), n))

    @staticmethod
    def _write_rows(plane, out, mask=None):
        """``out``'s rows (those with ``mask > 0``) into ``plane``, in
        place."""
        if mask is None:
            plane.copy_(out)
            return
        for i in faults_mod.rows_where(mask):
            plane[i] = out[i]

    def _psum_event(self, state: EngineState, plane, outer_c, resid,
                    scope: str, glob, step: int, fmask, m: int, r0: int):
        """One averaging event on this rank's rows under ``psum``
        (``fmask``: ``(mix_full, mix)`` under faults, else None), routed
        as the unsharded event (:meth:`_event_route`): a mix or a group
        mean on the gathered plane (``q`` under a wire), the mean from
        ``glob`` (the all-reduced sums of ``q`` under a wire), the outer
        step as ``avg_disp_outer`` on the one-row plane ``glob``; the
        rows written in place. Returns (plane, outer state, residual)."""
        ml, p = plane.shape
        codes = state.codes
        mix_full, mix = fmask if fmask is not None else (None, None)
        W = self._event_W(step, state.dec_key) if scope == "all" else None
        route, groups = self._event_route(scope, W, outer_c)
        comp = self._comp()
        if comp is None and route in ("mix", "group"):
            full, outer_c = self._plane_avg_event(
                state, self.mesh.all_gather_rows(plane), outer_c, scope, W,
                mix_full)
            plane.copy_(full[r0:r0 + ml])
            return plane, outer_c, resid
        if route == "outer":
            one, prev, vel, _ = self._op("avg_disp_outer")(
                glob[None], *outer_c, codes=codes, **self._outer_kw())
            plane.copy_(one.expand(ml, p))
            return plane, (prev, vel), resid
        if comp is not None:
            u = (row_uniforms(state.dec_key, step, range(r0, r0 + ml), p,
                              device=self._dev)
                 if comp.stochastic else None)
            q, r_new = encode_decode(plane, resid, wire=comp.wire, u=u,
                                     error_feedback=comp.error_feedback)
            resid = (r_new if mix is None
                     else faults_mod.select_rows(r_new, resid, mix))
            if route == "mix":
                if mix_full is not None:
                    W = faults_mod.degraded_matrix(W, mix_full)
                out = torch.matmul(W[r0:r0 + ml],
                                   self.mesh.all_gather_rows(q))
            elif route == "group":
                a = mix_full if mix_full is not None else np.ones(
                    m, np.float32)
                out = faults_mod.masked_group_mean(
                    self.mesh.all_gather_rows(q), a, groups)[r0:r0 + ml]
            else:
                n = m if mix is None else float(np.sum(mix_full,
                                                       dtype=np.float32))
                out = self._psum_mean(q, mix, n)
        else:
            out = glob
        if codes is not None:
            out = round_to_codes(out, codes)
        self._write_rows(plane, out.expand(ml, p), mix)
        return plane, outer_c, resid

    def _step_psum(self, state: EngineState, batch, grads_fn, gbuf):
        """``collective="psum"``: the update of this rank's rows in one
        ``opt_step`` launch (mode none, masked under faults), the global
        mean and dispersion through collectives, the decision, the event
        (:meth:`_psum_event`). Returns (state, (this rank's losses, the
        loss mask or None), dispersion, decision code, (n_alive,
        n_straggle))."""
        sched = self.schedule
        step = state.step + 1
        key = rng.split(state.key)[0]
        dec = state.dec_key
        ml, p = state.plane.shape
        m = ml * self.mesh.size
        r0 = self.mesh.row_range(m)[0]
        plane, planes, resid = state.plane, state.opt_planes, state.resid
        fp = self._faults()
        fst, fmask, dscale, occ = state.fault, None, None, (m, 0.0)
        kw = dict(kind=self.optimizer.plane_kind, codes=state.codes,
                  **self.optimizer.plane_hypers())
        if fp is not None:
            fst0 = (fst if isinstance(fst, FaultState)
                    else faults_mod.init_fault_state(ml))
            fst, mix_full, mix, umask, rejoined = fp.transition(
                fst0, step, dec, row0=r0, num_rows=ml)
            if fp.has_rejoin:
                # the previous cohort's size and the rows coming back,
                # over every rank, in one gather; the cohort mean only
                # when a row comes back somewhere
                aprev = fp.mix_at(fst0.alive, step - 1, row0=r0,
                                  num_rows=ml)
                back = faults_mod.rows_where(rejoined)
                n_prev, n_back = self.mesh.sum_scalars(torch.tensor(
                    [np.sum(aprev, dtype=np.float32), len(back)],
                    dtype=torch.float32)).tolist()
                if n_back:
                    self._warm_start(state, back,
                                     self._psum_mean(plane, aprev, n_prev))
            fmask = (mix_full, mix)
            kw.update(alive=mix, umask=umask)
            if sched.straggle_aware:
                dscale = fp.disp_scale(mix_full, dec, step)
            if self.telemetry:
                alive_f = fp.alive_at(step)
                straggle = fp.straggle_mask(dec, step, np.arange(m))
                n_alive = np.sum(alive_f, dtype=np.float32)
                occ = (n_alive, n_alive - np.sum(
                    alive_f * (np.float32(1.0) - straggle),
                    dtype=np.float32))
        losses, _, gplane = grads_fn(plane, batch, out=gbuf)
        scal = self.optimizer.plane_scalars(step)
        # this rank's rows alone: the kernel's dispersion covers them only
        plane, planes, _ = self._op("opt_step")(plane, gplane, planes, scal,
                                                mode="none", **kw)
        mix = None if fmask is None else fmask[1]
        n = m if fmask is None else float(np.sum(fmask[0],
                                                 dtype=np.float32))
        glob = self._psum_mean(plane, mix, n)
        disp = self._psum_dispersion(plane, glob, mix, n)
        code, sst = sched.decision_state(
            step, state.sched, disp, dec,
            event_cost=self._sched_event_cost(p, m), disp_scale=dscale)
        outer_c = state.outer_state
        if sched.kind == "minibatch" or code:
            scope = "inner" if code == 1 else "all"
            plane, outer_c, resid = self._psum_event(
                state, plane, outer_c, resid, scope, glob, step, fmask, m,
                r0)
        state = state._replace(plane=plane, opt_planes=planes, key=key,
                               step=step, sched=sst, outer_state=outer_c,
                               resid=resid, fault=fst)
        return (state, (losses, None if fmask is None else fmask[0]), disp,
                code, occ)

    def _stage(self, batch, rows=None):
        """A batch on the engine's device; ``rows``: the ``[r0, r1)``
        worker rows of it to keep (a sharded rank's)."""
        if rows is not None:
            batch = tree_map(lambda x: x[rows[0]:rows[1]], batch)
        return tree_map(lambda x: torch.as_tensor(x, device=self._dev),
                        batch)

    def _phase(self, state: EngineState, batches):
        """Run the device-resident per-step batches of one phase. Returns
        the new state and the per-step traces {loss, dispersion,
        avg_code} as host lists (one device fetch for the losses), with
        telemetry the phase's ``metrics`` accumulator too, folded from
        those host values. With a mesh each step is
        :meth:`_step_gather` or :meth:`_step_psum`; under ``psum`` the
        ranks' per-worker losses are gathered once, at the phase's
        end. The ``flat`` and ``tree`` carries run
        :meth:`_phase_unfused`."""
        carry = self.carry(state)
        if carry != "flat_native":
            return self._phase_unfused(state, batches, carry)
        grads_fn = make_plane_step(self.loss_fn, state.spec)
        m, p = self._global_m(state), state.plane.shape[1]
        step_fn = self._step
        gbuf = torch.empty_like(state.plane)
        if self.mesh is not None and self.collective == "gather":
            step_fn = self._step_gather
            gbuf = state.plane.new_empty((m, p))
        elif self.mesh is not None:
            step_fn = self._step_psum
        losses, disps, codes, occs = [], [], [], []
        for batch in batches:
            state, loss, disp, code, occ = step_fn(state, batch, grads_fn,
                                                   gbuf)
            losses.append(loss)
            disps.append(disp)
            codes.append(code)
            occs.append(occ)
        if step_fn == self._step_psum and losses:
            per = self.mesh.all_gather_rows(
                torch.stack([x for x, _ in losses], dim=1))
            losses = [self._mean_loss(per[:, k], a)
                      for k, (_, a) in enumerate(losses)]
        return state, self._traces(losses, disps, codes, occs, p, m)

    def _phase_unfused(self, state: EngineState, batches, carry: str):
        """:meth:`_phase` of the ``flat`` or ``tree`` carry: the state in
        the carry's form, one :meth:`_step_unfused` a batch, the state
        back in the flat-native layout."""
        wstep = make_worker_step(self.loss_fn, self.optimizer)
        m, p = self._state_rows(state), self._state_cols(state)
        state = self._enter_carry(state, carry)
        losses, disps, codes, occs = [], [], [], []
        for batch in batches:
            state, loss, disp, code, occ = self._step_unfused(state, batch,
                                                              wstep)
            losses.append(loss)
            disps.append(disp)
            codes.append(code)
            occs.append(occ)
        state = self._leave_carry(state)
        return state, self._traces(losses, disps, codes, occs, p, m)

    def _traces(self, losses, disps, codes, occs, p: int, m: int) -> dict:
        """The phase's per-step traces as host lists (one device fetch for
        the losses), with telemetry its ``metrics`` accumulator, folded
        from those host values."""
        loss_h = torch.stack(losses).tolist() if losses else []
        trace = {"loss": loss_h, "dispersion": disps, "avg_code": codes}
        if self.telemetry:
            eb_all, eb_inner = self._event_bytes(p, m)
            acc = tele_metrics.init_metrics()
            for loss, disp, code, (n_alive, n_straggle) in zip(
                    loss_h, disps, codes, occs):
                acc = tele_metrics.accumulate(
                    acc, loss=loss, disp=disp, code=code,
                    event_bytes_all=eb_all, event_bytes_inner=eb_inner,
                    n_alive=n_alive, n_straggle=n_straggle)
            trace["metrics"] = acc
        return trace

    def _rows(self, state: EngineState):
        """The ``[r0, r1)`` rows of the full batches this rank keeps, or
        None unsharded."""
        if self.mesh is None:
            return None
        return self.mesh.row_range(self._global_m(state))

    def run_phase(self, state: EngineState, batches):
        """One phase over per-step batches (numpy arrays or tensors),
        each staged to the engine's device before its step (a sharded
        rank keeps its rows of each)."""
        rows = self._rows(state)
        return self._phase(state, (self._stage(b, rows) for b in batches))

    def run_phase_indexed(self, state: EngineState, arrays, idx_block):
        """One phase over a (K, M, B) or (K, M) int index block into the
        device-resident ``arrays`` (a tree of (N, ...) tensors on the
        plane's device): the block is copied to the device once, and
        each step's (M, B, ...) or (M, ...) batch is gathered there
        (``index_select``); then the same step as :meth:`run_phase`."""
        dev = self._state_device(state)
        for a in tree_flatten(arrays)[0]:
            if a.device != dev:
                raise ValueError(f"the dataset lives on {a.device}, the "
                                 f"planes on {dev}: gather where they are")
        idx_block = np.asarray(idx_block, np.int32)
        rows = self._rows(state)
        if rows is not None:
            idx_block = idx_block[:, rows[0]:rows[1]]
        idx = torch.as_tensor(idx_block).to(dev)

        def gather(i):
            flat = i.reshape(-1)
            return tree_map(lambda a: a.index_select(0, flat).reshape(
                tuple(i.shape) + tuple(a.shape[1:])), arrays)

        return self._phase(state, (gather(idx[k]) for k in range(len(idx))))

    def default_phase_len(self) -> int:
        """Block size aligned with the schedule's natural period
        (correctness never depends on it — decisions are per step)."""
        s = self.schedule
        if s.kind == "periodic":
            return max(1, min(s.phase_len, 512))
        if s.kind == "hierarchical":
            return max(1, min(s.inner_phase_len, 512))
        if s.kind == "stochastic":
            return int(min(max(1.0 / max(s.zeta, 1e-12), 8), 128))
        if s.kind == "adaptive_budget":
            return int(min(max(s.budget_horizon / max(s.comm_budget, 1), 8),
                           128))
        return 64

    def consensus(self, state: EngineState):
        """The paper's final estimate: the worker average, in the leaf
        dtypes; under a fault plan the mean over the mixing cohort of the
        state's step. With a mesh the rows are summed across the ranks in
        global row order (``WorkerMesh.chain_row_sum``): the unsharded
        consensus bit for bit, on every rank of the mesh."""
        plane = state.plane
        fp = self._faults()
        mix = None
        if fp is not None and isinstance(state.fault, FaultState):
            r0, r1 = self._row_range(self._global_m(state))
            mix = fp.mix_at(state.fault.alive, state.step, row0=r0,
                            num_rows=r1 - r0)
        if plane is None:  # a tree FlatSpec cannot embed
            if mix is not None:
                return faults_mod.masked_mean_tree(state.params, mix)
            return consensus(state.params)
        if self.mesh is None:
            if mix is not None:
                return state.spec.unpack1(faults_mod.masked_mean(plane, mix))
            return state.spec.unpack1(_div(_row_sum(plane), plane.shape[0]))
        n = self._global_m(state)
        if mix is not None:
            n = int(np.sum(self.mesh.gather_rows_host(mix) > 0))
        return state.spec.unpack1(
            _div(self.mesh.chain_row_sum(plane, mix), n))

    def worker_params(self, state: EngineState):
        """Every worker's params, leaves (M, *shape) in the leaf dtypes
        (copies: the plane is updated in place); with a mesh gathered
        from the ranks."""
        if self.mesh is not None:
            return state.spec.unpack(self.mesh.all_gather_rows(state.plane))
        if state.plane is None:
            return tree_map(lambda x: x.clone(), state.params)
        return tree_map(lambda x: x.clone(), state.spec.unpack(state.plane))

    def _sync(self):
        if self._dev.type == "cuda":
            torch.cuda.synchronize(self._dev)

    def _record_evals(self, hist, t, state, eval_fn, worker_eval_fn):
        if eval_fn is not None:
            hist["eval"].append((t, eval_fn(self.consensus(state))))
        if worker_eval_fn is not None:
            hist["worker_eval"].append(
                (t, worker_eval_fn(self.worker_params(state))))

    # ---- run loop ----------------------------------------------------------
    def run(self, params, data, *, num_workers: int, seed: int = 0,
            record_every: int = 0, eval_fn=None, worker_eval_fn=None,
            phase_len: int | None = None, steps: int | None = None,
            prefetch: bool = True, state: EngineState | None = None,
            return_state: bool = False, sink=None):
        """Training loop: one phase per block of steps.

        data: an iterable of per-step worker batches (leaves with the
        worker axis first, numpy arrays or tensors), staged to the
        device block by block — by a background :class:`Prefetcher`
        thread for a true stream (``prefetch=False`` stages in line;
        lists and tuples always stage in line) — or a
        :class:`~repro_torch.data.DeviceDataset`, whose index blocks the
        engine gathers on the device. With a dataset, ``steps`` bounds
        the run (a precomputed index list ends it too, and its cursor
        advances across calls); a sampler without ``steps`` is refused.

        ``eval_fn(consensus params)`` and ``worker_eval_fn(worker params,
        leaves (M, ...))`` run every ``record_every`` steps into
        ``eval`` / ``worker_eval``; phase blocks are cut so that record
        boundaries end a phase.

        Returns (final averaged params, history dict). The history
        records ``loss`` and ``disp_trace`` (the per-step Eq. 4
        dispersion, after the local update and before any averaging)
        every ``record_every`` steps, ``dispersion`` at every averaging
        event, the event count ``averages``, and ``phase_wall``.
        ``state`` resumes an :class:`EngineState`; ``steps`` bounds the
        steps run in this call.

        ``sink`` (a :class:`repro_torch.telemetry.TelemetrySink`; needs
        ``PhaseEngine(telemetry=True)``) receives per phase an
        ``averaging_event`` per event step, a ``fault_event`` per
        scripted crash or rejoin in the phase, and one ``phase_metrics``
        record: the flushed accumulator, the phase's traces and its
        ``phase_wall`` seconds.

        With a mesh every rank of the world calls it alike. The ranks of
        the mesh run the phases on their rows; a full ``state`` is cut to
        them first. The consensus (and ``eval_fn``'s) comes through
        :meth:`consensus`, ``worker_eval_fn``'s params through an
        all-gather, and every rank returns the same history (but
        ``phase_wall``, its own clock); only the world's rank 0 emits to
        ``sink``. A rank outside the mesh runs nothing and returns the
        mesh's consensus, history and replicated state fields, with no
        rows."""
        # imported here: the data plane's module imports core.flat, which
        # loads this package
        from repro_torch.data.pipeline import DeviceDataset, Prefetcher
        self._check_workers(num_workers)
        if sink is not None and not self.telemetry:
            raise ValueError(
                "run(sink=...) flushes the metrics accumulator, which "
                "this engine does not carry — construct it with "
                "PhaseEngine(..., telemetry=True)")
        mesh = self.mesh
        if mesh is not None and mesh.world_rank != 0:
            sink = None
        if state is None:
            state = self.init(params, num_workers, seed)
        else:
            state = self.shard_state(state, num_workers)
        if mesh is not None and not mesh.member:
            # no rows here, but a stateful source (a stream, a dataset's
            # cursor) advances as on the ranks that use it
            if isinstance(data, DeviceDataset):
                n = steps if steps is not None else data.num_steps
                if n is not None and data.num_steps is not None:
                    n = min(n, data.num_steps)
                if n:
                    data.index_block(n)
            else:
                for _ in itertools.islice(iter(data), steps):
                    pass
            return self._join_mesh(state, init_history(), None,
                                   return_state)
        rows = self._rows(state)
        t0 = state.step
        block = phase_len or self.default_phase_len()
        needs_eval = bool(record_every and (eval_fn or worker_eval_fn))
        hist = init_history()
        total = None if steps is None else t0 + steps

        def take_at(t):
            take = block
            if needs_eval:
                take = min(take, record_every - t % record_every)
            if total is not None:
                take = min(take, total - t)
            return take

        def consume(t, k, trace, tw0):
            self._sync()
            wall = time.perf_counter() - tw0
            hist["phase_wall"].append((t + 1, t + k, wall))
            t_first = t
            n_loss, n_disp = len(hist["loss"]), len(hist["disp_trace"])
            events = []
            for i in range(k):
                t += 1
                code = trace["avg_code"][i]
                if code:
                    hist["dispersion"].append((t, trace["dispersion"][i]))
                    hist["averages"] += 1
                    events.append((t, trace["dispersion"][i], code))
                if record_every and t % record_every == 0:
                    hist["loss"].append((t, trace["loss"][i]))
                    hist["disp_trace"].append((t, trace["dispersion"][i]))
            if needs_eval and t % record_every == 0:
                self._record_evals(hist, t, state, eval_fn, worker_eval_fn)
            if sink is not None:
                for t_ev, d_ev, c_ev in events:
                    sink.emit(make_record(
                        "averaging_event", step=t_ev, dispersion=d_ev,
                        scope="inner" if c_ev == 1 else "all"))
                fp = self._faults()
                if fp is not None:
                    for ev in fp.events_in(t_first, t):
                        sink.emit(make_record(
                            "fault_event", step=ev.step, kind=ev.kind,
                            worker=ev.worker))
                flushed = tele_metrics.flush_metrics(trace["metrics"])
                sink.emit(make_record(
                    "phase_metrics", t0=t_first + 1, t1=t, wall_s=wall,
                    steps_per_s=(k / wall if wall > 0 else None),
                    loss_trace=hist["loss"][n_loss:],
                    disp_trace=hist["disp_trace"][n_disp:], **flushed))
            return t

        if isinstance(data, DeviceDataset):
            if data.num_workers != num_workers:
                raise ValueError(f"the dataset draws for {data.num_workers} "
                                 f"workers, the run has {num_workers}")
            remaining = steps if steps is not None else data.num_steps
            if remaining is None:
                raise ValueError("a DeviceDataset with a sampler needs "
                                 "steps=")
            if data.num_steps is not None:
                # a precomputed index list ends the run when exhausted
                remaining = min(remaining, data.num_steps)
            total = t0 + remaining
            t = t0
            while t < total:
                take = take_at(t)
                tw0 = time.perf_counter()
                state, trace = self.run_phase_indexed(
                    state, data.arrays, data.index_block(take))
                t = consume(t, take, trace, tw0)
            return self._join_mesh(state, hist, self.consensus(state),
                                   return_state)

        def staged_blocks():
            it = iter(data)
            t, done = t0, False
            while not done:
                take = take_at(t)
                if take <= 0:
                    return
                chunk = []
                while len(chunk) < take:
                    nxt = next(it, None)
                    if nxt is None:
                        done = True
                        break
                    chunk.append(self._stage(nxt, rows))
                if not chunk:
                    return
                t += len(chunk)
                yield chunk

        # an in-memory source gains nothing from background staging
        prefetch = prefetch and not isinstance(data, (list, tuple))
        pf = Prefetcher(staged_blocks()) if prefetch else None
        blocks = pf if pf is not None else staged_blocks()
        t = t0
        try:
            while True:
                # the phase's wall includes the wait for its block: the
                # staging in line, or what the prefetch thread left
                tw0 = time.perf_counter()
                chunk = next(blocks, None)
                if chunk is None:
                    break
                state, trace = self._phase(state, chunk)
                t = consume(t, len(chunk), trace, tw0)
        finally:
            if pf is not None:
                pf.close()
        return self._join_mesh(state, hist, self.consensus(state),
                               return_state)

    def _join_mesh(self, state: EngineState, hist, final, return_state):
        """:meth:`run`'s return. Where the world has ranks outside the
        mesh, the mesh's first rank hands them its consensus, history and
        replicated state fields (every rank of the world takes part)."""
        mesh = self.mesh
        if mesh is not None and mesh.world_size > mesh.size:
            out = None
            if mesh.world_rank == mesh.ranks[0]:
                out = (tree_map(lambda x: x.cpu(), final), hist, state.key,
                       state.step, state.sched,
                       tuple(x.cpu() for x in state.outer_state))
            out = mesh.world_broadcast_object(out)
            if not mesh.member:
                dev = self._dev
                final, hist = tree_map(lambda x: x.to(dev), out[0]), out[1]
                state = state._replace(
                    key=out[2], step=out[3], sched=out[4],
                    outer_state=tuple(x.to(dev) for x in out[5]))
        return (final, hist, state) if return_state else (final, hist)

    def run_host(self, params, batches, *, num_workers: int, seed: int = 0,
                 record_every: int = 0, eval_fn=None, worker_eval_fn=None):
        """Per-step host-driven loop: :meth:`run` with one step per
        phase, each batch staged in line, so the averaging decision is
        read on the host after every dispatch and ``phase_wall`` holds
        one entry per step. The result is bitwise :meth:`run`'s. Returns
        (final averaged params, history dict)."""
        return self.run(params, batches, num_workers=num_workers, seed=seed,
                        record_every=record_every, eval_fn=eval_fn,
                        worker_eval_fn=worker_eval_fn, phase_len=1,
                        prefetch=False)
