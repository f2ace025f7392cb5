"""Checkpoints: flat ``.npz`` + json metadata, in the reference's format.

The counterpart of ``repro.checkpoint.io``. A checkpoint at ``path`` is
two files: ``path.npz`` holds one ``leaf_i`` array per leaf, in
``jax.tree.flatten`` order (:func:`repro_torch.core.flat.tree_flatten`
gives it), and ``path.json`` the metadata — an informational treedef
string, the leaf count, shapes and dtype names, the step and ``extra``.
Both go through a temp file, ``fsync`` and ``os.replace``, the json
LAST: it is the commit point loaders read first, so an interrupted save
leaves the previous checkpoint or none, never a torn one. Torn or
missing files are refused with the reference's actionable messages.
Loaders check the leaf count and shapes, never the treedef string.

The arrays are written one leaf at a time into the zip ``np.savez``
writes (stored, ZIP64), so a save holds one leaf on the host at a time.
A bfloat16 leaf is stored as the reference's ``np.savez`` stores it: two
bytes of void per element (the int16 bits viewed as ``np.dtype("V2")``),
its dtype named ``"bfloat16"`` in the metadata; it is read back by
viewing those bytes as int16 and then as ``torch.bfloat16`` — no
numpy extension dtype, and none of the reference's ``astype`` cast,
which numpy cannot do from void (R3 in ROADMAP.md).

Engine states (:func:`save_engine_state` / :func:`load_engine_state`)
are written in the layout of the reference's ``EngineState`` tree, so
either package resumes the other's checkpoints; the port's planes are
translated in both directions:

  worker_params  leaves (M, ...) in their leaf dtypes (``FlatSpec``)
  opt_state      () for SGD, the f32 velocity tree for Momentum,
                 {"m": tree, "v": tree} for AdamW (``FlatOptSpec``)
  outer_state    (prev in the leaf dtypes, vel in f32), or ()
  key, dec_key   uint32[2]  (the port's (2,) int64 keys)
  step           int32
  sched          the five SchedState scalars (f32, f32, f32, i32, i32)
  resid          (M, P) f32, or ()
  fault          alive (M,) f32, staleness (M,) int32, or ()

with the version ladder of ``ENGINE_STATE_VERSION`` (see there).
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.averaging import SchedState
from repro_torch.core.flat import tree_flatten, tree_unflatten
from repro_torch.faults import FaultState

#: EngineState checkpoint layout versions (the reference's ladder):
#:   0 — no ``sched`` leaves
#:   1 — with the SchedState carry, version field not yet written
#:       (v0-vs-v1 is sniffed by leaf count)
#:   2 — the v1 layout with the version recorded
#:   3 — with the error-feedback residual plane ``resid``
#:   4 — with the per-worker fault rows ``fault``; ``has_resid`` says
#:       whether the residual is there too
#:   5 — elastic saves (``repro_torch.elastic``): the metadata declares
#:       ``has_sched`` / ``has_resid`` / ``has_fault`` and the row count
#:       ``num_workers``. Fixed-membership runs keep writing the lowest
#:       version that describes their layout
ENGINE_STATE_VERSION = 5
_VERSION_KEY = "engine_state_version"
_HAS_RESID_KEY = "has_resid"
_HAS_FAULT_KEY = "has_fault"
_HAS_SCHED_KEY = "has_sched"
_NUM_WORKERS_KEY = "num_workers"
#: optional EngineState fields, in the order they were added
_OPTIONAL_FIELDS = ("sched", "resid", "fault")


# --------------------------------------------------------------------------
# Leaves <-> numpy
# --------------------------------------------------------------------------

def _to_numpy(x) -> tuple[np.ndarray, str]:
    """A leaf as the array the ``.npz`` holds and its dtype name: a
    bfloat16 tensor as its int16 bits viewed as two bytes of void."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), \
                "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(x)
    return a, str(a.dtype)


def _to_torch(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A loaded array as a CPU tensor: two bytes of void (or a leaf the
    metadata names ``bfloat16``) viewed as int16, then as bfloat16."""
    if a.dtype.kind == "V" or dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# The two files
# --------------------------------------------------------------------------

def _save(path: str, leaves, *, treedef: str, step: int, extra: dict | None):
    """Write ``leaves`` (arrays or zero-argument callables giving one) to
    ``path.npz`` one at a time, then the metadata to ``path.json``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    shapes, dtypes = [], []
    npz_tmp = path + ".npz.tmp"
    with open(npz_tmp, "wb") as f:
        # the container np.savez writes: .npy members, stored, ZIP64
        with zipfile.ZipFile(f, "w", compression=zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for i, leaf in enumerate(leaves):
                a, dt = _to_numpy(leaf() if callable(leaf) else leaf)
                with zf.open(f"leaf_{i}.npy", "w", force_zip64=True) as fh:
                    np.lib.format.write_array(fh, a, allow_pickle=False)
                shapes.append(list(a.shape))
                dtypes.append(dt)
                del a
        f.flush()
        os.fsync(f.fileno())
    os.replace(npz_tmp, path + ".npz")
    meta = {"treedef": treedef, "num_leaves": len(shapes), "step": step,
            "dtypes": dtypes, "shapes": shapes, "extra": extra or {}}
    json_tmp = path + ".json.tmp"
    with open(json_tmp, "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(json_tmp, path + ".json")


def _read_meta(path: str) -> dict:
    try:
        with open(path + ".json") as f:
            return json.load(f)
    except json.JSONDecodeError as e:
        raise ValueError(
            f"checkpoint {path!r} has torn/partial metadata "
            f"({path}.json: {e}) — the save that wrote it was "
            "interrupted; delete this checkpoint and resume from an "
            "earlier one") from e


class _LayoutMismatch(ValueError):
    """The checkpoint's leaves do not fit the target's layout."""


def _check_layout(path: str, meta: dict, shapes: list) -> None:
    if meta["num_leaves"] != len(shapes):
        raise _LayoutMismatch(
            f"checkpoint {path!r} holds {meta['num_leaves']} leaves but "
            f"the target has {len(shapes)} — checkpoint/model mismatch")
    for i, (got, want) in enumerate(zip(meta["shapes"], shapes)):
        if tuple(got) != tuple(want):
            raise _LayoutMismatch(
                f"checkpoint {path!r} leaf {i} has shape {tuple(got)}, "
                f"the target {tuple(want)} — checkpoint/model mismatch")


def _read_leaves(path: str, meta: dict):
    """Yield (array, dtype name) per leaf, one at a time; a missing or
    torn array file is refused with an actionable error."""
    try:
        data = np.load(path + ".npz")
    except FileNotFoundError as e:
        raise ValueError(
            f"checkpoint {path!r} has metadata but no array file "
            f"({path}.npz missing) — the save that wrote it was "
            "interrupted or the file was removed; delete this "
            "checkpoint and resume from an earlier one") from e
    except (zipfile.BadZipFile, EOFError, OSError, ValueError) as e:
        raise _torn(path, e) from e
    with data:
        for i in range(meta["num_leaves"]):
            try:
                a = data[f"leaf_{i}"]
            except (zipfile.BadZipFile, EOFError, KeyError, OSError,
                    ValueError) as e:
                raise _torn(path, e) from e
            yield a, meta["dtypes"][i]


def _torn(path: str, e: Exception) -> ValueError:
    return ValueError(
        f"checkpoint {path!r} has a torn/partial array file "
        f"({path}.npz: {e}) — the save that wrote it was "
        "interrupted; delete this checkpoint and resume from an "
        "earlier one")


# --------------------------------------------------------------------------
# Params trees
# --------------------------------------------------------------------------

def save_checkpoint(path: str, tree, *, step: int = 0,
                    extra: dict | None = None):
    """Write ``tree`` (tensors or numpy arrays) to ``path.npz`` +
    ``path.json`` (module note)."""
    leaves, treedef = tree_flatten(tree)
    _save(path, leaves, treedef=repr(treedef), step=int(step), extra=extra)


def load_checkpoint(path: str, like_tree):
    """Restore into the structure of ``like_tree``, a tree of tensors:
    each leaf in the dtype and on the device of its ``like_tree`` leaf
    (count and shapes checked). Returns (tree, step). Refuses
    torn/partial files."""
    meta = _read_meta(path)
    like, treedef = tree_flatten(like_tree)
    _check_layout(path, meta, [tuple(x.shape) for x in like])
    leaves = [_to_torch(a, dt).to(device=want.device, dtype=want.dtype)
              for (a, dt), want in zip(_read_leaves(path, meta), like)]
    return tree_unflatten(treedef, leaves), meta["step"]


# --------------------------------------------------------------------------
# Engine states: the port's planes in the reference's EngineState layout
# --------------------------------------------------------------------------

class _Leaf(NamedTuple):
    """One leaf of the reference's layout: its shape, a getter of the
    array to save, and a setter that restores a loaded array into the
    port's state."""
    shape: tuple
    get: Callable
    put: Callable


def _column_leaves(t, spec, dtypes) -> list:
    """The leaves of an (M, P) plane, as (M, *shape), or of a (P,) vector
    (the outer state), as (*shape), in ``dtypes`` (one per leaf);
    restoring writes their f32 image into ``t``'s columns."""
    lead = tuple(t.shape[:-1])
    out = []
    for o, s, dt in zip(spec.offsets, spec.shapes, dtypes):
        n = int(np.prod(s, dtype=np.int64))

        def get(o=o, n=n, s=s, dt=dt):
            return t[..., o:o + n].reshape(lead + s).to(dt)

        def put(a, dn, o=o, n=n):
            t[..., o:o + n].copy_(_to_torch(a, dn).reshape(lead + (n,)))
        out.append(_Leaf(lead + s, get, put))
    return out


def _engine_layout(state, fields, got: dict) -> list:
    """(field, leaves) of ``state`` in the reference's ``EngineState``
    order, for the fields in ``fields`` (the optional ones absent from it
    are left out). Setters write planes in place and scalars into
    ``got``."""
    spec, f32 = state.spec, (torch.float32,) * len(state.spec.shapes)
    layout = [("worker_params", _column_leaves(state.plane, spec,
                                               spec.dtypes)),
              ("opt_state", [lf for pl in state.opt_planes
                             for lf in _column_leaves(pl, spec, f32)])]
    outer = []
    if state.outer_state != ():
        prev, vel = state.outer_state
        outer = _column_leaves(prev, spec, spec.dtypes) + _column_leaves(
            vel, spec, f32)
    layout.append(("outer_state", outer))

    def scalar(name, np_dtype, shape=()):
        def put(a, dn):
            got[name] = np.asarray(a, np_dtype).reshape(shape)
        return put

    for name in ("key", "dec_key"):
        layout.append((name, [_Leaf(
            (2,), lambda v=getattr(state, name): np.asarray(
                v.tolist(), np.uint32), scalar(name, np.uint32, (2,)))]))
    layout.append(("step", [_Leaf((), lambda: np.int32(state.step),
                                  scalar("step", np.int32))]))
    if "sched" in fields:
        dts = (np.float32,) * 3 + (np.int32,) * 2
        layout.append(("sched", [
            _Leaf((), lambda v=v, dt=dt: np.asarray(v, dt),
                  scalar(f"sched{k}", dt))
            for k, (v, dt) in enumerate(zip(state.sched, dts))]))
    if "resid" in fields:
        r = state.resid

        def put_resid(a, dn):
            r.copy_(_to_torch(a, dn).reshape(r.shape))
        layout.append(("resid", [_Leaf(tuple(r.shape), lambda: r,
                                       put_resid)]))
    if "fault" in fields:
        m = state.plane.shape[0]
        layout.append(("fault", [
            _Leaf((m,), lambda: np.asarray(state.fault.alive, np.float32),
                  scalar("alive", np.float32, (m,))),
            _Leaf((m,), lambda: np.asarray(state.fault.staleness,
                                           np.int32),
                  scalar("staleness", np.int32, (m,)))]))
    return layout


def _present_fields(state) -> set:
    """The optional fields ``state`` carries."""
    out = set()
    if isinstance(state.sched, SchedState):
        out.add("sched")
    if state.resid is not None:
        out.add("resid")
    if isinstance(state.fault, FaultState):
        out.add("fault")
    return out


def _check_plane_layout(state, what: str) -> None:
    """Checkpoints hold the plane layout: a state that keeps its params
    or its optimizer state as a tree (a params tree FlatSpec cannot
    embed, an optimizer state that rides no planes) is refused."""
    if state.plane is None or getattr(state, "opt_state", None) is not None:
        raise ValueError(
            f"cannot {what} this EngineState: it keeps its params or its "
            "optimizer state as a tree (leaves FlatSpec cannot embed, or "
            "a state that is not float32 copies of the params), and the "
            "port's checkpoints hold the (M, P) plane layout only")


def save_engine_state(path: str, state, *, extra: dict | None = None,
                      elastic: bool = False):
    """Checkpoint a full ``repro_torch.core.EngineState`` in the
    reference's layout (module note), so that ``PhaseEngine.run(...,
    state=loaded)`` — here or in the reference — continues the run as
    one that was never interrupted. The metadata records
    ``engine_state_version``: the lowest version that describes the
    layout, or 5 for ``elastic`` saves, which also declare their
    optional fields. ``num_workers`` (the plane's rows) is always
    recorded."""
    _check_plane_layout(state, "save")
    extra = dict(extra or {})
    present = _present_fields(state)
    extra[_NUM_WORKERS_KEY] = int(state.plane.shape[0])
    if elastic:
        extra[_VERSION_KEY] = ENGINE_STATE_VERSION
        extra[_HAS_SCHED_KEY] = "sched" in present
        extra[_HAS_RESID_KEY] = "resid" in present
        extra[_HAS_FAULT_KEY] = "fault" in present
    elif "sched" not in present:
        extra[_VERSION_KEY] = 0
    elif "fault" in present:
        # the fault-row layout is v4; v5 marks elastic saves only
        extra[_VERSION_KEY] = 4
        extra[_HAS_RESID_KEY] = "resid" in present
    elif "resid" in present:
        extra[_VERSION_KEY] = 3
    else:
        extra[_VERSION_KEY] = 2
    layout = _engine_layout(state, present, {})
    treedef = "EngineState(" + ", ".join(
        f"{name}: {len(leaves)} leaves" for name, leaves in layout) + ")"
    _save(path, [lf.get for _, leaves in layout for lf in leaves],
          treedef=treedef, step=int(state.step), extra=extra)


def _load_subset(path: str, meta: dict, like_state, present):
    """Load a checkpoint whose layout carries the optional fields in
    ``present``: fields the target has but the checkpoint lacks keep
    ``like_state``'s values (fresh bookkeeping, zero residual, all-alive
    rows); fields the checkpoint has but the target lacks are refused.
    The planes of ``like_state`` are overwritten in place and returned
    in the new state (a fresh copy would double the device memory a
    full-width resume needs)."""
    have = _present_fields(like_state)
    if "resid" in present and "resid" not in have:
        raise ValueError(
            f"checkpoint {path!r} carries an error-feedback residual "
            "plane but the target engine has no active compression — "
            "init the engine with the run's Compression before loading")
    if "fault" in present and "fault" not in have:
        raise ValueError(
            f"checkpoint {path!r} carries per-worker fault rows "
            "(engine-state v4) but the target engine has no fault "
            "plan — init the engine with the run's FaultPlan before "
            "loading")
    got: dict = {}
    layout = _engine_layout(like_state, present, got)
    leaves = [lf for _, lvs in layout for lf in lvs]
    _check_layout(path, meta, [lf.shape for lf in leaves])
    for (a, dt), lf in zip(_read_leaves(path, meta), leaves):
        lf.put(a, dt)
    new = dict(key=torch.tensor(got["key"].astype(np.int64)),
               dec_key=torch.tensor(got["dec_key"].astype(np.int64)),
               step=int(got["step"]))
    if "sched" in present:
        new["sched"] = SchedState(*(
            np.float32(got[f"sched{k}"]) if k < 3
            else np.int32(got[f"sched{k}"]) for k in range(5)))
    if "fault" in present:
        new["fault"] = FaultState(got["alive"].copy(),
                                  got["staleness"].copy())
    return like_state._replace(**new), meta["step"]


def load_engine_state(path: str, like_state):
    """Restore an engine state saved by :func:`save_engine_state` (or by
    the reference's) into the structure of ``like_state`` (e.g.
    ``engine.init(params, M)``, on the engine's device). Returns
    (state, step).

    A checkpoint whose worker plane has another row count than
    ``like_state`` is refused first, both counts named. Then the
    declared ``engine_state_version`` picks the layout (v5 declares its
    optional fields, v4 carries the fault rows and per ``has_resid`` the
    residual, v3 the residual, v1/v2 the SchedState leaves, v0 none of
    them); a checkpoint without the field falls back to the reference's
    leaf-count sniff of v1 against v0. Every field the checkpoint lacks
    keeps ``like_state``'s value."""
    _check_plane_layout(like_state, "load into")
    meta = _read_meta(path)
    extra = meta.get("extra") or {}
    got_m = extra.get(_NUM_WORKERS_KEY)
    if got_m is None and meta.get("shapes") and meta["shapes"][0]:
        # pre-v5 saves: the first leaf is a worker-params plane
        got_m = meta["shapes"][0][0]
    want_m = int(like_state.plane.shape[0])
    if got_m is not None and int(got_m) != want_m:
        raise ValueError(
            f"checkpoint {path!r} holds a {int(got_m)}-row worker "
            f"plane but the target engine state has {want_m} rows — "
            "membership changed between save and resume. Resume "
            "through repro_torch.elastic instead: replay the run's "
            "--shrink-at/--grow-at plan (run_elastic applies the "
            "resizes), or build the matching like-state with "
            "repro_torch.elastic.segment_engine(engine, plan, step) — "
            "loading into a fixed-M engine of the wrong size would "
            "scramble the worker rows")
    version = extra.get(_VERSION_KEY)
    if version is None:
        try:
            return _load_subset(path, meta, like_state, {"sched"})
        except _LayoutMismatch:
            return _load_subset(path, meta, like_state, set())
    if isinstance(version, bool) or not isinstance(version, int) \
            or version < 0:
        raise ValueError(
            f"checkpoint {path!r} declares an invalid engine-state "
            f"version {version!r} (expected an int in "
            f"[0, {ENGINE_STATE_VERSION}])")
    if version > ENGINE_STATE_VERSION:
        raise ValueError(
            f"checkpoint {path!r} declares engine-state version "
            f"{version}, newer than this build's {ENGINE_STATE_VERSION} "
            "— load it with the build that wrote it")
    if version == 0:
        present = set()
    elif version in (1, 2):
        present = {"sched"}
    elif version == 3:
        present = {"sched", "resid"}
    elif version == 4:
        present = {"sched", "fault"}
        if extra.get(_HAS_RESID_KEY, True):
            present.add("resid")
    else:
        declared = {"sched": extra.get(_HAS_SCHED_KEY, True),
                    "resid": extra.get(_HAS_RESID_KEY, False),
                    "fault": extra.get(_HAS_FAULT_KEY, False)}
        present = {f for f in _OPTIONAL_FIELDS if declared[f]}
    return _load_subset(path, meta, like_state, present)
