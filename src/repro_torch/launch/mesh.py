"""Worker meshes over ``torch.distributed`` ranks.

The counterpart of ``repro.launch.mesh``. Where the reference lays a
``jax.sharding.Mesh`` over the devices of one process, the port lays a
:class:`WorkerMesh` over processes: one rank per mesh position, row-major
over ``axis_names`` / ``shape``, the mesh being the first ``size`` ranks
of the default process group, with a process group of its own for its
collectives. Ranks start the usual way (``torchrun`` sets their
environment; tests and ``chip_smoke.py`` spawn them and rendezvous over
a ``file://`` store) and call ``torch.distributed.init_process_group``
before a mesh is made; without a process group the world is one rank
and every collective is the identity.

The production shapes (``(16, 16)`` over ("data", "model") for one pod,
``(2, 16, 16)`` over ("pod", "data", "model") for two) need a world of
256 or 512 ranks. The local-SGD worker axis is "data" (with "pod" in
front on two pods, unless averaging is hierarchical).

The mesh's collectives (:meth:`WorkerMesh.all_reduce_`,
:meth:`WorkerMesh.all_gather_rows`, :meth:`WorkerMesh.broadcast_`, ...)
run over its process group. NCCL takes CUDA tensors (host arrays go to
the mesh's device first); gloo takes CPU tensors and CUDA tensors
directly, staging the latter through the host itself. Each
collective's calls, seconds and bytes (also by dtype) add up in
``WorkerMesh.read_stats()[name]`` (``all_reduce``, ``all_gather``,
``broadcast``): a collective on CUDA tensors is timed by a pair of CUDA
events on the current stream, read only when the stats are (no host
synchronization in the step), one on the host by the host's clock.

On torch's ``fake`` backend (``dist.init_process_group("fake", ...)``
with ``torch.testing._internal.distributed.fake_pg.FakeStore``) one
process stands for every rank: the collectives move no data, ``meta``
tensors included, and the stats count what each call would send. The
dry run (:mod:`repro_torch.launch.dryrun`) builds the production mesh
so.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.sharding.specs import set_axis_sizes

def _world() -> tuple[int, int]:
    """(world size, this rank) of the default process group; (1, 0)
    without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@dataclass(frozen=True, eq=False)
class WorkerMesh:
    """A mesh of ``torch.distributed`` ranks.

    ``axis_names`` and ``shape`` (axis -> size, in axis order) as the
    reference's mesh; ``rank`` this process's position in the mesh
    (row-major), None on a rank outside it; ``ranks`` the default
    group's ranks that form the mesh, in mesh order; ``group`` their
    process group (None for a world of one); ``backend`` its backend;
    ``device`` the device whose tensors the mesh's users hand it."""
    axis_names: tuple
    shape: dict
    rank: int | None
    ranks: tuple
    group: object
    backend: str
    device: torch.device
    world_size: int = 1
    world_rank: int = 0
    stats: dict = field(default_factory=dict)
    _events: dict = field(default_factory=dict)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def member(self) -> bool:
        return self.rank is not None

    def row_range(self, num_workers: int) -> tuple[int, int]:
        """The global rows ``[r0, r1)`` this rank holds of ``num_workers``
        split in contiguous blocks over the mesh; ``(0, 0)`` outside."""
        if num_workers % self.size:
            raise ValueError(
                f"{num_workers} worker rows do not split evenly over a "
                f"mesh of {self.size} ranks")
        if not self.member:
            return 0, 0
        ml = num_workers // self.size
        return self.rank * ml, (self.rank + 1) * ml

    # ---- collectives over the mesh ---------------------------------------
    def _on(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` on a device the backend communicates through."""
        if self.backend == "nccl" and not t.is_cuda:
            return t.to(self.device)
        return t

    def _timed(self, name: str, t: torch.Tensor, nbytes: int, op):
        """``op()``, with its call and ``nbytes`` added to
        ``stats[name]`` (and to ``stats[name]["dtype_bytes"]`` under
        ``t``'s dtype, so a reader can price f32 payloads apart from
        encoded ones); its time by CUDA events on ``t``'s stream (kept
        until :meth:`read_stats`) or by the host's clock."""
        st = self.stats.setdefault(name, dict(calls=0, seconds=0.0,
                                              bytes=0, dtype_bytes={}))
        st["calls"] += 1
        st["bytes"] += nbytes
        dt = str(t.dtype).removeprefix("torch.")
        st["dtype_bytes"][dt] = st["dtype_bytes"].get(dt, 0) + nbytes
        if not t.is_cuda:
            t0 = time.perf_counter()
            out = op()
            st["seconds"] += time.perf_counter() - t0
            return out
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = op()
        b.record()
        evs = self._events.setdefault(name, [])
        evs.append((a, b))
        if len(evs) >= 64:  # fold the finished ones; never wait here
            self._fold(name, wait=False)
        return out

    def _fold(self, name: str, *, wait: bool) -> None:
        """Add the seconds of ``name``'s event pairs, in order, to its
        stats: all of them (``wait``), or those whose end has passed."""
        evs = self._events[name]
        done = 0
        for a, b in evs:
            if wait:
                b.synchronize()
            elif not b.query():
                break
            self.stats[name]["seconds"] += a.elapsed_time(b) / 1e3
            done += 1
        del evs[:done]

    def read_stats(self) -> dict:
        """``stats`` with the CUDA-timed collectives' seconds folded in
        (waits for their end events)."""
        for name in self._events:
            self._fold(name, wait=True)
        return self.stats

    def reset_stats(self) -> None:
        self.stats.clear()
        self._events.clear()

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the mesh, in place; returns ``t``."""
        if self.group is None:
            return t
        c = self._on(t)

        def op():
            dist.all_reduce(c, group=self.group)
            if c is not t:
                t.copy_(c)
        self._timed("all_reduce", t, t.numel() * t.element_size(), op)
        return t

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every mesh rank's ``t`` (equal shapes) concatenated along dim
        0 in mesh order: a new tensor on ``t``'s device."""
        if self.group is None:
            return t.clone()
        c = self._on(t.contiguous())
        parts = [torch.empty_like(c) for _ in range(self.size)]

        def op():
            dist.all_gather(parts, c, group=self.group)
            return torch.cat(parts).to(t.device)
        return self._timed("all_gather", t,
                           t.numel() * t.element_size() * self.size, op)

    def all_gather_rows_packed(self, tensors: list) -> list:
        """:meth:`all_gather_rows` of several tensors of one device whose
        first dimension is this rank's rows, in ONE collective: each
        row's bytes side by side in a uint8 buffer, gathered, then cut
        and viewed back (bit for bit; any dtypes)."""
        if self.group is None:
            return [t.clone() for t in tensors]
        n = tensors[0].shape[0]
        rows = [t.contiguous().reshape(n, -1).view(torch.uint8)
                for t in tensors]
        full = self.all_gather_rows(torch.cat(rows, dim=1))
        out = []
        for t, piece in zip(tensors, full.split([r.shape[1] for r in rows],
                                                dim=1)):
            out.append(piece.contiguous().view(t.dtype).reshape(
                (full.shape[0],) + tuple(t.shape[1:])))
        return out

    def broadcast_(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """``t`` of mesh rank ``src`` on every mesh rank, in place."""
        if self.group is None:
            return t
        c = self._on(t)

        def op():
            dist.broadcast(c, src=self.ranks[src], group=self.group)
            if c is not t:
                t.copy_(c)
        self._timed("broadcast", t, t.numel() * t.element_size(), op)
        return t

    def gather_rows_host(self, a: np.ndarray) -> np.ndarray:
        """:meth:`all_gather_rows` of a host numpy array."""
        if self.group is None:
            return a.copy()
        return self.all_gather_rows(torch.from_numpy(
            np.ascontiguousarray(a))).numpy()

    def sum_scalars(self, x: torch.Tensor) -> torch.Tensor:
        """The mesh ranks' small float32 ``x`` (0-dim or a few values)
        summed in mesh order from the first: the same bytes on every
        rank, on the host, in ``x``'s shape."""
        parts = self.all_gather_rows(x.reshape(1, -1).float()).cpu()
        acc = parts[0]
        for v in parts[1:]:
            acc = acc + v
        return acc.reshape(x.shape)

    def chain_row_sum(self, rows: torch.Tensor, mask=None) -> torch.Tensor:
        """The sum of the global rows (with ``mask > 0``: this rank's
        (M/n,) 0/1 mask) in global row order, starting from 0 — the
        unsharded ``_row_sum`` bit for bit — without the full plane on
        any rank: mesh rank r adds its rows to the partial sum of ranks
        0..r-1, then hands it on. Every mesh rank returns it."""
        acc = torch.zeros_like(rows[0]) if len(rows) else None
        keep = (range(len(rows)) if mask is None else
                np.flatnonzero(np.asarray(mask) > 0).tolist())
        for r in range(self.size):
            if r == self.rank:
                for i in keep:
                    acc += rows[i]
            self.broadcast_(acc, r)
        return acc

    # ---- over the whole world (ranks outside the mesh too) --------------
    def _world_device(self) -> torch.device:
        if dist.get_backend() == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def world_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """:meth:`all_gather_rows` delivered to every rank of the world:
        a rank outside the mesh (holding no rows) receives the full
        tensor too. Every rank of the world calls it."""
        if self.world_size == self.size:
            return self.all_gather_rows(t)
        wdev = self._world_device()
        shape = torch.tensor(list(t.shape), dtype=torch.int64, device=wdev)
        dist.broadcast(shape, src=self.ranks[0])
        shape = tuple(shape.tolist())
        parts = []
        for r in range(self.size):
            buf = (t.to(wdev) if r == self.rank
                   else torch.empty(shape, dtype=t.dtype, device=wdev))
            dist.broadcast(buf, src=self.ranks[r])
            parts.append(buf.to(t.device))
        return torch.cat(parts)

    def world_gather_rows_host(self, a: np.ndarray) -> np.ndarray:
        """:meth:`world_gather_rows` of a host numpy array."""
        return self.world_gather_rows(torch.from_numpy(
            np.ascontiguousarray(a))).cpu().numpy()

    def world_broadcast_object(self, obj):
        """The mesh's first rank's ``obj`` on every rank of the world
        (picklable; tensors on the host)."""
        if self.world_size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=self.ranks[0],
                                   device=self._world_device())
        return box[0]


def _mesh(shape: tuple, axes: tuple, backend, device, what: str):
    """The mesh of the first ``prod(shape)`` ranks of the world."""
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    size = math.prod(shape)
    world, wrank = _world()
    if size > world:
        raise ValueError(
            f"{what} {tuple(shape)} needs a group of {size} ranks; this "
            f"process group has {world}")
    set_axis_sizes(dict(zip(axes, shape)))
    ranks = tuple(range(size))
    group = None
    if dist.is_available() and dist.is_initialized():
        # collective over the default group: every rank of the world
        # makes its meshes in the same order
        group = dist.new_group(ranks=list(ranks), backend=backend)
    return WorkerMesh(tuple(axes), dict(zip(axes, shape)),
                      wrank if wrank < size else None, ranks, group,
                      backend, dev, world, wrank)


def make_production_mesh(*, multi_pod: bool = False, backend=None,
                         device="cuda") -> WorkerMesh:
    """One pod ``(16, 16)`` over ("data", "model"), or two pods
    ``(2, 16, 16)`` over ("pod", "data", "model"): 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, backend, device, "the production mesh")


def make_host_mesh(data: int = 2, model: int = 2, pod: int = 0, *,
                   backend=None, device="cpu") -> WorkerMesh:
    """A small mesh over the first ranks of the world for tests
    (``data * model`` ranks, times ``pod`` when given)."""
    if pod:
        shape, axes = (pod, data, model), ("pod", "data", "model")
    else:
        shape, axes = (data, model), ("data", "model")
    return _mesh(shape, axes, backend, device, "the host mesh")


def make_worker_mesh(num_workers: int, backend=None,
                     device="cuda") -> WorkerMesh:
    """1-D ("data",) mesh for the sharded engine over the largest count
    n of ranks, at most the world's size, that divides ``num_workers``
    (every rank holds the same number of worker rows): the first n ranks;
    the others hold no rows and wait. Every rank of the world calls it
    (``new_group`` is collective).

    ``backend=None`` takes NCCL for a CUDA ``device`` and gloo for the
    CPU. Ranks that share one card pass ``backend="gloo"``: NCCL refuses
    two ranks on one device."""
    world, _ = _world()
    n = min(num_workers, world)
    while num_workers % n:
        n -= 1
    return _mesh((n,), ("data",), backend, device, "the worker mesh")


def worker_axes(mesh, *, hierarchical: bool = False) -> tuple:
    """Mesh axes that form the local-SGD worker axis."""
    if "pod" in mesh.axis_names:
        return ("data",) if hierarchical else ("pod", "data")
    return ("data",)


def num_workers(mesh, *, hierarchical: bool = False) -> int:
    n = 1
    for a in worker_axes(mesh, hierarchical=hierarchical):
        n *= mesh.shape[a]
    return n
