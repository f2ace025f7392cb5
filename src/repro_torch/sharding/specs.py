"""PartitionSpec rules, and the row layout of the sharded (M, P) plane.

The counterpart of ``repro.sharding.specs``. The first half is pure
shape arithmetic, the reference's rules case for case:

Train (local SGD): every state leaf carries a leading worker axis split
over the worker mesh axes; within a worker group the largest
model-divisible dim of each tensor goes over "model". Batches split
their first model-divisible dim over "model" too.

Serve: params have no worker axis; the same within-group rule; the
batch splits over the data axes and KV caches split sequence
(long-context) or head dims over "model".

:class:`PartitionSpec` is a tuple of the port's own that canonicalizes
its entries as ``jax.sharding.PartitionSpec`` does (a 1-tuple of axes
is the axis, ``()`` is None), so that a spec computed here equals the
reference's ``P(...)`` as a tuple.

The second half describes the port's sharded plane
(``PhaseEngine(mesh=...)``, :mod:`repro_torch.launch.mesh`): the worker
rows M split in contiguous blocks over the ranks of a worker mesh, every
rank holding its (M/n, P) rows of the plane, of every optimizer-state
plane, of the error-feedback residual and of the fault rows, and a copy
of everything else (keys, step, schedule state, rounding codes, outer
state). :func:`shard_engine_state` cuts a full state to this rank's
rows; :func:`unshard_engine_state` puts the full (M, P) planes back
together with collectives over the mesh.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch


class PartitionSpec(tuple):
    """A tuple of per-dim axis entries (an axis name, a tuple of names,
    or None), canonicalized as the reference's ``PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_canonical(p) for p in parts))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _canonical(part):
    if isinstance(part, (list, tuple)):
        part = tuple(part)
        if not part:
            return None
        if len(part) == 1:
            return part[0]
    return part


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over the dicts, lists, tuples and named tuples
    of ``tree``; a path entry is the dict key or the field name, and None
    for a list or tuple position (the reference's ``SequenceKey`` has no
    name)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        out = [_map_with_path(fn, v, path + (None,)) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    return fn(path, tree)


def _names(path) -> list:
    return ["" if p is None else str(p) for p in path]


def leaf_spec(shape, msize: int, *, model_axis="model", prefix=(),
              prefer_axis: int | None = None) -> PartitionSpec:
    """Shard the largest dim divisible by ``msize`` over the model axis
    (``prefer_axis`` overrides). ``prefix`` are specs for leading
    dims."""
    n = len(shape) - len(prefix)
    dims = shape[len(prefix):]
    best = None
    if prefer_axis is not None and dims[prefer_axis] % msize == 0:
        best = prefer_axis
    else:
        for i, s in enumerate(dims):
            if s % msize == 0 and s >= msize:
                if best is None or s > dims[best]:
                    best = i
    spec = [None] * n
    if best is not None:
        spec[best] = model_axis
    return P(*prefix, *spec)


def first_divisible_spec(shape, msize: int, *, model_axis="model",
                         prefix=()) -> PartitionSpec:
    """Shard the leading (batch) dim over the model axis when divisible;
    otherwise replicate within the worker group (a sequence dim is never
    split: see the reference's note)."""
    n = len(shape) - len(prefix)
    dims = shape[len(prefix):]
    spec = [None] * n
    if dims and dims[0] % msize == 0 and dims[0] >= msize:
        spec[0] = model_axis
    return P(*prefix, *spec)


def tree_specs(template, msize: int, *, prefix=(), rule=leaf_spec,
               moe_expert_parallel: bool = False):
    """Map a tree of objects with a ``shape`` to PartitionSpecs."""
    def spec_of(path, leaf):
        shape = tuple(leaf.shape)
        prefer = None
        if moe_expert_parallel:
            if any(n in ("w_in", "w_out", "w_gate") for n in _names(path)) \
                    and len(shape) - len(prefix) == 3:
                prefer = 0  # expert dim
        if rule is leaf_spec:
            return leaf_spec(shape, msize, prefix=prefix, prefer_axis=prefer)
        return rule(shape, msize, prefix=prefix)
    return _map_with_path(spec_of, template)


def param_specs(params_template, msize: int, *, worker_axes=None,
                moe_expert_parallel: bool = False):
    prefix = (worker_axes,) if worker_axes is not None else ()
    return tree_specs(params_template, msize, prefix=prefix,
                      moe_expert_parallel=moe_expert_parallel)


def batch_specs(batch_template, msize: int, *, worker_axes=None):
    """Inputs: leading worker axis (train) then the first-divisible
    rule."""
    prefix = (worker_axes,) if worker_axes is not None else ()
    return tree_specs(batch_template, msize, prefix=prefix,
                      rule=first_divisible_spec)


def cache_specs(cache_template, msize: int, *, data_axes,
                long_layout: str = "seq"):
    """Decode caches: batch over the data axes when divisible; otherwise
    (batch 1, long context) the k/v layout follows ``long_layout``:
    ``"seq"`` splits the sequence dim over data and model jointly,
    ``"heads"`` keeps the sequence whole and splits the largest head /
    head-dim dim over model."""
    def spec_of(path, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return P()
        names = _names(path)
        dsize = _axes_size(data_axes)
        if shape[0] % dsize == 0 and shape[0] >= dsize:
            # batch over data; the biggest remaining dim over model
            if long_layout == "heads" and ("k" in names or "v" in names) \
                    and len(shape) == 4:
                sub = leaf_spec(shape[2:], msize, prefix=())
                return P(data_axes, None, *sub)
            sub = leaf_spec(shape[1:], msize, prefix=())
            return P(data_axes, *sub)
        # batch=1 long-context k/v
        if "k" in names or "v" in names:
            if (long_layout == "seq" and len(shape) >= 2
                    and shape[1] % (dsize * msize) == 0):
                return P(None, (_flat(data_axes) + ("model",)),
                         *([None] * (len(shape) - 2)))
            if long_layout == "heads" and len(shape) == 4:
                sub = leaf_spec(shape[2:], msize, prefix=())
                return P(None, None, *sub)
        return leaf_spec(shape, msize, prefix=())
    return _map_with_path(spec_of, cache_template)


def _flat(axes):
    if isinstance(axes, str):
        return (axes,)
    out = []
    for a in axes:
        out.extend(_flat(a))
    return tuple(out)


_SIZES: dict = {}


def set_axis_sizes(sizes: dict):
    """Record mesh axis sizes for the divisibility rules (set by
    :mod:`repro_torch.launch.mesh`)."""
    _SIZES.clear()
    _SIZES.update(sizes)


def _axes_size(axes) -> int:
    n = 1
    for a in _flat(axes):
        n *= _SIZES.get(a, 1)
    return n


# --------------------------------------------------------------------------
# The sharded (M, P) plane: the engine state's row layout
# --------------------------------------------------------------------------

class NamedSharding(NamedTuple):
    """A layout over a :class:`~repro_torch.launch.mesh.WorkerMesh`:
    ``spec`` names the mesh axes dim 0 is split over (``P()``:
    replicated)."""
    mesh: Any
    spec: PartitionSpec


def mesh_worker_axes(mesh) -> tuple:
    """The mesh axes that form the local-SGD worker axis: ("pod","data")
    when both exist, else ("data",), else the mesh's first axis."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return axes or tuple(mesh.axis_names[:1])


def plane_sharding(mesh, *, axes=None) -> NamedSharding:
    """The layout of the (M, P) plane and of every engine leaf with a
    leading worker axis: M split over the worker mesh axes, the P
    columns whole on each rank."""
    axes = tuple(axes) if axes else mesh_worker_axes(mesh)
    return NamedSharding(mesh, P(axes))


def engine_state_sharding(mesh, state, *, axes=None):
    """The layout of each field of a ``repro_torch.core.EngineState``:
    the plane, the optimizer-state planes, the residual and the fault
    rows split by worker rows (:func:`plane_sharding`); the rounding
    codes, keys, step, schedule state and outer state replicated. The
    static ``spec`` field maps to None."""
    ws = plane_sharding(mesh, axes=axes)
    repl = NamedSharding(mesh, P())
    fault = state.fault
    return type(state)(
        None, ws, tuple(ws for _ in state.opt_planes),
        None if state.codes is None else repl, repl, repl, repl,
        type(state.sched)(*(repl for _ in state.sched)),
        tuple(repl for _ in state.outer_state),
        None if state.resid is None else ws,
        type(fault)(*(ws for _ in fault)) if fault != () else ())


def _each(fn, val):
    """``fn`` over a leaf, or over the members of a (named) tuple."""
    if isinstance(val, tuple):
        out = [fn(x) for x in val]
        return type(val)(*out) if hasattr(val, "_fields") else tuple(out)
    return fn(val)


def _row_fields(state):
    """(name, value) of the row-split fields that hold rows."""
    out = [("plane", state.plane), ("opt_planes", state.opt_planes)]
    if state.resid is not None:
        out.append(("resid", state.resid))
    if state.fault != ():
        out.append(("fault", state.fault))
    return out


def shard_engine_state(state, mesh, num_workers: int):
    """This rank's rows of a full ``num_workers``-row state (a state
    holding this rank's rows already is returned as it is): contiguous
    blocks of M/n rows, in mesh order; a rank outside the mesh keeps no
    rows. The kept rows are copies, so the full planes can be freed."""
    rows = int(state.plane.shape[0])
    r0, r1 = mesh.row_range(num_workers)
    if rows == r1 - r0:
        return state
    if rows != num_workers:
        raise ValueError(
            f"the state holds {rows} worker rows: neither the run's "
            f"{num_workers} nor this rank's {r1 - r0}")

    def cut(x):
        if isinstance(x, np.ndarray):
            return x[r0:r1].copy()
        return x[r0:r1].clone()

    return state._replace(**{name: _each(cut, val)
                             for name, val in _row_fields(state)})


def unshard_engine_state(state, mesh, *, to=None):
    """The full state of a sharded one: every row-split leaf gathered
    from the mesh's ranks into its full (M, ...) array, leaf by leaf,
    on every rank of the world (ranks outside the mesh too: they call
    this as well). ``to="cpu"`` moves each gathered tensor to the host
    before the next leaf is gathered. The replicated fields are left as
    they are (:meth:`PhaseEngine.run` gives ranks outside the mesh the
    mesh's copy of them)."""
    def full(x):
        if isinstance(x, np.ndarray):
            return mesh.world_gather_rows_host(x)
        out = mesh.world_gather_rows(x)
        return out if to is None else out.to(to)

    return state._replace(**{name: _each(full, val)
                             for name, val in _row_fields(state)})
