"""Deterministic fault injection: worker failure as a scenario axis.

The counterpart of ``repro.faults``. A :class:`FaultPlan` scripts crash
and rejoin events, an optional per-step straggle probability and solo
windows (steps in which a row trains but stays out of every averaging
event, the loss and the dispersion; ``rejoin_curriculum=c`` derives a
c-step window after every scripted rejoin). Its eager validation and
messages are the reference's.

The streams are pure functions of the step, computed on the host in
numpy float32 / int32, as the engine decides on the host: scripted
liveness and solo windows from the events, straggles from
``uniform(fold_in(fold_in(fold_in(dec_key, salt), step), row))`` — the
reference's draws bit for bit, all M rows in one vectorized hash
(:func:`repro_torch.rng.fold_in_uniforms`). :meth:`FaultPlan.transition`
advances the :class:`FaultState` ``(alive, staleness)`` carry one step.

The masked plane primitives (:func:`masked_mean`,
:func:`masked_dispersion`, :func:`masked_group_mean`,
:func:`masked_event_matrix`, :func:`degraded_matrix`,
:func:`select_rows` and its in-place form :func:`keep_rows_`,
:func:`zero_rows`) take torch planes on any device
and (M,) 0/1 masks as numpy arrays or tensors. Means sum the alive rows
in row order, as the reference's sums do, so they agree with it bit for
bit; the dispersion is a float32 sum over the alive entries in column
chunks, so it holds no (M, P) temporary (a full-width plane is 5.8 GB)
and agrees with the reference's to rounding. They make the plain
versions' masked events and the engine's warm start; on the card the
plane kernels take the masks as 64-bit row words and mask their one
pass themselves (of these primitives only :func:`degraded_matrix` goes
to a kernel, as the mixing matrix).

The pytree twins (:func:`select_rows_tree`, :func:`zero_rows_tree`,
:func:`masked_mean_tree`, :func:`masked_dispersion_tree`,
:func:`warm_start_tree`, :func:`masked_average_all_tree`,
:func:`masked_mix_tree`) serve the engine's ``tree`` carry: per leaf,
in float32 and cast back, with the plane primitives' sums, so a tree
event and a plane event agree bit for bit column by column (the
dispersion to rounding: its sums run per leaf).

A trivial plan (no events, no straggles, no windows) is lowered away by
the engine, so an all-alive plan is the no-fault engine bit for bit.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import rng

#: fold_in salt for the straggle uniforms ("str"), independent of the
#: gossip-partner (0x676F73) and stochastic-rounding (0x656E63) streams
#: that hang off the same dec_key
_STRAGGLE_SALT = 0x737472

EVENT_KINDS = ("crash", "rejoin")

_EVENT_RE = re.compile(
    r"^\s*(\w+)\s*:\s*m\s*=\s*(\d+)\s*@\s*t\s*=\s*(\d+)\s*$")

#: columns per chunk of :func:`masked_dispersion` (64 MB per row)
_DISP_COLS = 1 << 24

_F32 = np.float32


class FaultEvent(NamedTuple):
    """One scripted liveness change: ``worker`` crashes or rejoins at the
    local step ``step`` (1-based, as ``EngineState.step``); it takes
    effect during that step."""
    kind: str
    worker: int
    step: int


class FaultState(NamedTuple):
    """The per-worker fault carry: ``alive`` (M,) float32, 1.0 for the
    scripted-alive rows (what rejoin detection diffs against), and
    ``staleness`` (M,) int32, steps since the row last applied a local
    update. Host numpy arrays."""
    alive: Any
    staleness: Any


def init_fault_state(num_workers: int) -> FaultState:
    return FaultState(np.ones(num_workers, _F32),
                      np.zeros(num_workers, np.int32))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic fault script for a ``num_workers``-row plane.

    events:        scripted :class:`FaultEvent` crashes / rejoins,
                   validated (rows in range, steps >= 1, per-worker
                   crash/rejoin alternation, one worker alive at every
                   point).
    straggle_prob: per-step probability that an alive worker skips its
                   local update (it still receives the event).
    solo:          ``(worker, start, stop)`` windows: during steps
                   ``start <= t < stop`` the row updates but stays out
                   of every event, the loss and the dispersion.
    rejoin_curriculum: c > 0 derives a ``(worker, t, t + c)`` solo
                   window after every scripted rejoin at ``t``.
    """
    num_workers: int
    events: tuple = ()
    straggle_prob: float = 0.0
    solo: tuple = ()
    rejoin_curriculum: int = 0

    def __post_init__(self):
        if self.num_workers < 1:
            raise ValueError(
                f"num_workers must be >= 1, got {self.num_workers}")
        if not 0.0 <= self.straggle_prob <= 1.0:
            raise ValueError(
                f"straggle_prob must be in [0, 1], got {self.straggle_prob}")
        events = tuple(FaultEvent(*e) for e in self.events)
        for ev in events:
            if ev.kind not in EVENT_KINDS:
                raise ValueError(
                    f"unknown fault kind {ev.kind!r} (expected one of "
                    f"{EVENT_KINDS})")
            if not 0 <= ev.worker < self.num_workers:
                raise ValueError(
                    f"fault event row m={ev.worker} out of range for "
                    f"{self.num_workers} workers")
            if ev.step < 1:
                raise ValueError(
                    f"fault event step t={ev.step} must be >= 1")
        events = tuple(sorted(events, key=lambda e: (e.step, e.worker)))
        seen = set()
        for ev in events:
            if (ev.worker, ev.step) in seen:
                raise ValueError(
                    f"multiple fault events for worker {ev.worker} at "
                    f"step {ev.step} are ambiguous")
            seen.add((ev.worker, ev.step))
        alive = [True] * self.num_workers
        for ev in events:
            if ev.kind == "crash":
                if not alive[ev.worker]:
                    raise ValueError(
                        f"worker {ev.worker} crashes at step {ev.step} "
                        "but is already dead (crash requires an alive "
                        "worker)")
                alive[ev.worker] = False
            else:
                if alive[ev.worker]:
                    raise ValueError(
                        f"worker {ev.worker} rejoins at step {ev.step} "
                        "without a prior crash (rejoin requires a dead "
                        "worker)")
                alive[ev.worker] = True
            if not any(alive):
                raise ValueError(
                    f"all {self.num_workers} workers are dead from step "
                    f"{ev.step} — at least one must stay alive")
        object.__setattr__(self, "events", events)
        if self.rejoin_curriculum < 0:
            raise ValueError(
                f"rejoin_curriculum must be >= 0, got "
                f"{self.rejoin_curriculum}")
        solo = tuple(tuple(int(v) for v in w) for w in self.solo)
        for w in solo:
            if len(w) != 3:
                raise ValueError(
                    f"solo window {w!r} must be (worker, start, stop)")
            worker, start, stop = w
            if not 0 <= worker < self.num_workers:
                raise ValueError(
                    f"solo window row m={worker} out of range for "
                    f"{self.num_workers} workers")
            if not 1 <= start < stop:
                raise ValueError(
                    f"solo window {w!r} needs 1 <= start < stop")
        object.__setattr__(self, "solo", solo)
        derived = tuple((ev.worker, ev.step, ev.step + self.rejoin_curriculum)
                        for ev in events
                        if ev.kind == "rejoin" and self.rejoin_curriculum > 0)
        windows = solo + tuple(w for w in derived if w not in solo)
        object.__setattr__(self, "_solo_windows", windows)
        if windows:
            # at every liveness / solo breakpoint some row must stay in
            # the mix: events and the dispersion divide by its count
            breaks = sorted({1} | {ev.step for ev in events}
                            | {t for _, a, b in windows for t in (a, b)})
            for t in breaks:
                alive = [True] * self.num_workers
                for ev in events:
                    if ev.step <= t:
                        alive[ev.worker] = ev.kind == "rejoin"
                in_solo = [any(w == i and a <= t < b
                               for i, a, b in windows)
                           for w in range(self.num_workers)]
                if not any(a and not s for a, s in zip(alive, in_solo)):
                    raise ValueError(
                        f"no worker left in the mix at step {t}: every "
                        "alive row is inside a solo window — at least "
                        "one must keep averaging")

    # -- static structure ------------------------------------------------

    @property
    def is_trivial(self) -> bool:
        """True when the engine can lower the plan away entirely."""
        return (not self.events and self.straggle_prob == 0.0
                and not self._solo_windows)

    @property
    def has_rejoin(self) -> bool:
        return any(ev.kind == "rejoin" for ev in self.events)

    @classmethod
    def parse(cls, text: str, num_workers: int, *,
              straggle_prob: float = 0.0, rejoin_after: int = 0,
              rejoin_curriculum: int = 0) -> "FaultPlan":
        """Parse a CLI fault script: comma-separated
        ``kind:m=<row>@t=<step>`` terms, e.g.
        ``"crash:m=3@t=100,rejoin:m=3@t=200"``. ``rejoin_after > 0``
        appends a rejoin N steps after every crash with no later event
        for the same worker; ``rejoin_curriculum`` passes through."""
        events = []
        for part in text.split(","):
            if not part.strip():
                continue
            match = _EVENT_RE.match(part)
            if not match:
                raise ValueError(
                    f"cannot parse fault event {part.strip()!r} "
                    "(expected kind:m=<row>@t=<step>, e.g. "
                    "crash:m=3@t=100)")
            kind, worker, step = match.groups()
            if kind not in EVENT_KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r} in {part.strip()!r} "
                    f"(expected one of {EVENT_KINDS})")
            events.append(FaultEvent(kind, int(worker), int(step)))
        if rejoin_after > 0:
            for ev in list(events):
                if ev.kind != "crash":
                    continue
                later = [e for e in events
                         if e.worker == ev.worker and e.step > ev.step]
                if not later:
                    events.append(FaultEvent("rejoin", ev.worker,
                                             ev.step + rejoin_after))
        return cls(num_workers, tuple(events), straggle_prob,
                   rejoin_curriculum=rejoin_curriculum)

    @classmethod
    def shrink(cls, num_workers: int, new_num_workers: int, step: int,
               **kw) -> "FaultPlan":
        """Membership M -> M' at ``step``: rows ``new_num_workers ..
        num_workers - 1`` crash together."""
        if not 1 <= new_num_workers <= num_workers:
            raise ValueError(
                f"cannot shrink {num_workers} workers to {new_num_workers}")
        events = tuple(FaultEvent("crash", m, step)
                       for m in range(new_num_workers, num_workers))
        return cls(num_workers, events, **kw)

    @classmethod
    def grow(cls, num_workers: int, new_num_workers: int, step: int,
             **kw) -> "FaultPlan":
        """Membership M -> M' (M' >= M) at ``step``: a plan for the grown
        M'-row plane whose new rows are dead from step 1 and rejoin at
        ``step``."""
        if not 1 <= num_workers <= new_num_workers:
            raise ValueError(
                f"cannot grow {num_workers} workers to {new_num_workers}")
        if step < 2:
            raise ValueError(
                f"grow step t={step} must be >= 2 (the joining rows "
                "crash at t=1 and rejoin at t)")
        events = tuple(ev for m in range(num_workers, new_num_workers)
                       for ev in (FaultEvent("crash", m, 1),
                                  FaultEvent("rejoin", m, step)))
        return cls(new_num_workers, events, **kw)

    def events_in(self, t0: int, t1: int) -> tuple:
        """Scripted events with ``t0 < step <= t1``, in script order."""
        return tuple(ev for ev in self.events if t0 < ev.step <= t1)

    # -- per-step streams (host numpy) -------------------------------------

    def alive_at(self, step: int) -> np.ndarray:
        """(M,) float32 scripted liveness at local step ``step``."""
        alive = np.ones(self.num_workers, _F32)
        for ev in self.events:  # sorted by step: later events override
            if step >= ev.step:
                alive[ev.worker] = 0.0 if ev.kind == "crash" else 1.0
        return alive

    def straggle_mask(self, dec_key, step: int, rows) -> np.ndarray:
        """(len(rows),) float32, 1.0 where the row straggles this step:
        ``uniform(fold_in(fold_in(fold_in(dec_key, salt), step), row))
        < straggle_prob``, bit for bit the reference's draw."""
        rows = np.asarray(rows, np.int64)
        if self.straggle_prob <= 0.0:
            return np.zeros(rows.shape, _F32)
        base = rng.fold_in(rng.fold_in(dec_key, _STRAGGLE_SALT), step)
        u = rng.fold_in_uniforms(base, rows)
        return (u < _F32(self.straggle_prob)).astype(_F32)

    def solo_at(self, step: int) -> np.ndarray:
        """(M,) float32, 1.0 where the row is inside a solo window."""
        out = np.zeros(self.num_workers, _F32)
        for worker, start, stop in self._solo_windows:
            if start <= step < stop:
                out[worker] = 1.0
        return out

    def mix_at(self, alive, step: int, *, row0: int = 0,
               num_rows: int | None = None):
        """``alive`` masked down to the mixing cohort at ``step``: alive
        rows not inside a solo window. Without solo windows it returns
        ``alive`` itself. ``alive`` spans the full plane by default; a
        shard passes its rows ``[row0, row0 + num_rows)``."""
        if not self._solo_windows:
            return alive
        solo = self.solo_at(step)
        if num_rows is not None:
            solo = solo[row0:row0 + num_rows]
        return alive * (_F32(1.0) - solo)

    def disp_scale(self, mix_full, dec_key, step: int) -> np.float32:
        """The fraction of the mixing cohort that applied its local
        update this step, by which ``straggle_aware`` schedules discount
        the dispersion they decide on."""
        rows = np.arange(self.num_workers)
        straggle = self.straggle_mask(dec_key, step, rows)
        updated = np.sum(mix_full * (_F32(1.0) - straggle), dtype=_F32)
        return updated / max(np.sum(mix_full, dtype=_F32), _F32(1.0))

    def transition(self, state: FaultState, step: int, dec_key, *,
                   row0: int = 0, num_rows: int | None = None):
        """One fault-state step for the rows ``[row0, row0 + num_rows)``
        (the full plane by default; a shard passes its rows, and
        ``state`` holds those rows). Returns ``(new_state, mix_full, mix,
        umask, rejoined)``: ``mix_full`` the global (M,) mixing cohort
        (every shard computes it: mixing matrices need all rows),
        ``mix`` / ``umask`` / ``rejoined`` the given rows' masks —
        ``umask`` the rows that apply their local update (alive and not
        straggling; solo rows update), ``rejoined`` the rows alive now
        and dead before. The carried state keeps the scripted
        liveness."""
        r1 = self.num_workers if num_rows is None else row0 + num_rows
        alive_full = self.alive_at(step)
        mix_full = self.mix_at(alive_full, step)
        alive, mix = alive_full[row0:r1], mix_full[row0:r1]
        straggle = self.straggle_mask(dec_key, step, np.arange(row0, r1))
        umask = alive * (_F32(1.0) - straggle)
        rejoined = alive * (_F32(1.0) - state.alive)
        staleness = np.where(umask > 0, np.int32(0),
                             state.staleness + np.int32(1)).astype(np.int32)
        return FaultState(alive, staleness), mix_full, mix, umask, rejoined


# --------------------------------------------------------------------------
# Masked plane primitives
# --------------------------------------------------------------------------

def host_mask(mask) -> np.ndarray:
    """An (M,) mask as a float32 numpy array (a CUDA tensor is copied
    back)."""
    if isinstance(mask, torch.Tensor):
        mask = mask.detach().cpu().numpy()
    return np.asarray(mask, _F32)


def rows_where(mask, on: bool = True) -> list:
    """The rows with ``mask > 0`` (``on``) or ``mask <= 0``, as ints."""
    keep = host_mask(mask) > 0
    return np.flatnonzero(keep if on else ~keep).tolist()


def _per(x: torch.Tensor, n) -> torch.Tensor:
    """``x / n`` as an IEEE float32 division on every device (a host
    scalar divisor would be multiplied in as its reciprocal on CUDA)."""
    return x / torch.full((), float(n), dtype=x.dtype, device=x.device)


def _sum_rows(plane: torch.Tensor, rows) -> torch.Tensor:
    """Sum of ``plane[rows]`` in row order, starting from 0."""
    s = torch.zeros_like(plane[0])
    for i in rows:
        s += plane[i]
    return s


def masked_mean(plane, alive) -> torch.Tensor:
    """Exact mean over the alive rows: (M, P), (M,) -> (P,)."""
    rows = rows_where(alive)
    return _per(_sum_rows(plane, rows), len(rows))


def masked_dispersion(plane, alive) -> torch.Tensor:
    """Eq. 4 dispersion over the alive rows, a 0-dim float32 tensor:
    ``sum_i alive_i ||w_i - w̄_alive||² / n_alive``, summed in column
    chunks of the alive rows (no (M, P) temporary)."""
    rows = rows_where(alive)
    glob = masked_mean(plane, alive)
    idx = torch.as_tensor(rows, dtype=torch.int64, device=plane.device)
    acc = torch.zeros((), dtype=torch.float32, device=plane.device)
    for c0 in range(0, plane.shape[1], _DISP_COLS):
        c1 = c0 + _DISP_COLS
        d = plane[:, c0:c1].index_select(0, idx) - glob[c0:c1]
        acc = acc + torch.sum(d * d)
    return _per(acc, len(rows))


def masked_group_mean(plane, alive, groups: int) -> torch.Tensor:
    """Per-group alive means broadcast back to a new (M, P) plane; a
    group with no alive member broadcasts zeros (callers keep dead rows
    with :func:`select_rows`)."""
    m, p = plane.shape
    mg = m // groups
    a = host_mask(alive)
    means = []
    for g in range(groups):
        rows = [i for i in range(g * mg, (g + 1) * mg) if a[i] > 0]
        means.append(_per(_sum_rows(plane, rows), max(len(rows), 1)))
    gm = torch.stack(means)[:, None]
    return gm.expand(groups, mg, p).reshape(m, p).contiguous()


def masked_event_matrix(alive, groups: int = 1, device=None) -> torch.Tensor:
    """The masked (group) mean event as a doubly-stochastic (M, M)
    float32 matrix on ``device``: alive rows average the alive members
    of their group (``A[i, j] = a_i a_j / n_g``), dead rows are
    identity — the matrix through which the reference's wrappers run a
    masked mean as one ``A @ plane`` pass (equal to the exact-sum mean
    up to rounding; the port's kernels take the exact sum)."""
    a = torch.from_numpy(host_mask(alive))
    m = a.shape[0]
    gid = torch.arange(m) // (m // groups)
    same = (gid[:, None] == gid[None, :]).float()
    cnt = torch.sum(same * a[None, :], dim=1)  # alive count of my group
    A = same * a[:, None] * a[None, :] / torch.clamp_min(cnt, 1.0)[:, None]
    return (A + torch.diag(1.0 - a)).to(device)


def degraded_matrix(W, alive) -> torch.Tensor:
    """``W`` renormalized over the alive workers: off-diagonal mass to or
    from a dead row is dropped and folded back onto the diagonal, so
    dead rows and columns are identity and a symmetric ``W`` stays
    doubly stochastic. All alive returns ``W`` itself."""
    a_host = host_mask(alive)
    if bool((a_host > 0).all()):
        return W
    a = torch.from_numpy(a_host).to(W.device, W.dtype)
    eye = torch.eye(W.shape[0], dtype=W.dtype, device=W.device)
    off = W * (1.0 - eye) * a[:, None] * a[None, :]
    row = torch.zeros_like(off[:, 0])
    for j in range(off.shape[1]):  # summed in column order from 0
        row = row + off[:, j]
    return off + torch.diag(1.0 - row)


def keep_rows_(out, old, mask):
    """:func:`select_rows` in place on ``out``, a tensor the caller owns:
    the rows with ``mask <= 0`` copied from ``old``, no second plane.
    Returns ``out``."""
    for i in rows_where(mask, on=False):
        out[i] = old[i]
    return out


def select_rows(new, old, mask) -> torch.Tensor:
    """Rows with ``mask > 0`` from ``new``, the others from ``old``: a new
    tensor. On (M, ...) tensors."""
    return keep_rows_(new.clone(), old, mask)


def zero_rows(x, mask) -> torch.Tensor:
    """``x`` with the rows where ``mask > 0`` zeroed: a new tensor."""
    out = x.clone()
    for i in rows_where(mask):
        out[i].zero_()
    return out


# --------------------------------------------------------------------------
# Pytree twins (the engine's tree carry): leaves with the worker axis first
# --------------------------------------------------------------------------

def _tree_map(fn, tree, *rest):
    from repro_torch.core.flat import tree_map
    return tree_map(fn, tree, *rest)


def _leaf_rows(x: torch.Tensor) -> torch.Tensor:
    """A worker-axis leaf as (M, n) float32 rows."""
    return x.float().reshape(x.shape[0], -1)


def select_rows_tree(new_tree, old_tree, mask):
    """:func:`select_rows` on every leaf: rows with ``mask > 0`` from
    ``new_tree``, the others from ``old_tree`` (new tensors)."""
    return _tree_map(lambda n, o: select_rows(n, o, mask), new_tree,
                     old_tree)


def zero_rows_tree(tree, mask):
    """:func:`zero_rows` on every leaf (new tensors)."""
    return _tree_map(lambda x: zero_rows(x, mask), tree)


def masked_mean_tree(tree, alive):
    """Per-leaf exact mean over the alive rows in float32, cast back to
    the leaf dtype: leaves (M, ...) -> (...)."""
    return _tree_map(
        lambda x: masked_mean(_leaf_rows(x), alive).reshape(x.shape[1:])
        .to(x.dtype), tree)


def masked_dispersion_tree(tree, alive) -> torch.Tensor:
    """Tree twin of :func:`masked_dispersion`: the alive rows' squared
    distances from their mean summed per leaf in float32, the leaves
    added in flatten order, over the alive count (0-dim float32)."""
    from repro_torch.core.flat import tree_flatten
    rows = rows_where(alive)

    def leaf(x):
        r = _leaf_rows(x)
        idx = torch.as_tensor(rows, dtype=torch.int64, device=r.device)
        d = r.index_select(0, idx) - masked_mean(r, alive)
        return torch.sum(d * d)
    return _per(sum(leaf(x) for x in tree_flatten(tree)[0]), len(rows))


def warm_start_tree(tree, alive_prev, rejoined):
    """The ``rejoined`` rows take the mean over ``alive_prev`` (the
    previous step's mixing cohort, the rejoiner itself outside it), in
    the leaf dtype; the other rows keep theirs (new tensors)."""
    mean = masked_mean_tree(tree, alive_prev)
    return _tree_map(
        lambda x, g: select_rows(g.expand(x.shape), x, rejoined), tree,
        mean)


def masked_average_all_tree(tree, alive, *, groups: int = 1):
    """Masked averaging event on a tree: alive rows take the exact
    (group) mean over the alive rows (of their group), cast to the leaf
    dtype; dead rows keep their stale params."""
    def leaf(x):
        r = _leaf_rows(x)
        if groups > 1:
            out = masked_group_mean(r, alive, groups)
        else:
            out = masked_mean(r, alive)[None].expand(r.shape)
        out = out.reshape(x.shape).to(x.dtype)
        return select_rows(out, x, alive)
    return _tree_map(leaf, tree)


def masked_mix_tree(tree, W, alive):
    """Masked gossip mix on a tree: ``W`` degraded over the alive rows
    (:func:`degraded_matrix`) mixes every leaf's rows with the plane
    twin's arithmetic, cast to the leaf dtype; dead rows keep their
    stale params."""
    from repro_torch.kernels.ref import _mix

    def leaf(x):
        wm = degraded_matrix(torch.as_tensor(W).to(x.device, torch.float32),
                             alive)
        out = _mix(wm, _leaf_rows(x)).reshape(x.shape).to(x.dtype)
        return select_rows(out, x, alive)
    return _tree_map(leaf, tree)
