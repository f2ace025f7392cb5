"""Flat parameter plane: the whole worker model as ONE (M, P) buffer.

The counterpart of ``repro.core.flat`` over nested dicts / lists /
tuples of tensors. :class:`FlatSpec` records the leaf layout (structure,
shapes, dtypes, column offsets) so packing is invertible:

    spec  = FlatSpec.of(worker_params)        # leaves (M, *shape)
    plane = spec.pack(worker_params)          # (M, P) float32
    tree  = spec.unpack(plane)                # == worker_params bit-exact

Leaves are ordered exactly as ``jax.tree.flatten`` orders them — dict
keys sorted, lists and tuples in index order — so a plane packed here
and one packed by the reference are column-for-column comparable.

The plane dtype is float32: float32 leaves are stored verbatim,
bfloat16/float16 leaves as their exact float32 image, rounded back on
unpack. :meth:`FlatSpec.rounding_codes` gives the per-column codes that
let a plane-resident update round exactly like a leaf-dtype update.
:class:`FlatOptSpec` lays an optimizer state of S structural copies of
the params tree out as S more (M, P) planes whose columns align 1:1 with
the param plane — the layout ``repro_torch.kernels.opt_step`` updates.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

_PACKABLE = (torch.float32, torch.bfloat16, torch.float16)

#: per-column dtype codes for plane-resident rounding (0 = float32
#: verbatim, 1 = round through bfloat16, 2 = round through float16)
ROUND_F32, ROUND_BF16, ROUND_F16 = 0, 1, 2


# --------------------------------------------------------------------------
# Minimal pytree: dicts (sorted keys), lists, tuples; anything else a leaf
# --------------------------------------------------------------------------

def tree_flatten(tree) -> tuple[list, Any]:
    """(leaves, treedef) in ``jax.tree.flatten`` order."""
    leaves: list = []

    def walk(t):
        if isinstance(t, dict):
            keys = sorted(t)
            return ("dict", tuple(keys), tuple(walk(t[k]) for k in keys))
        if isinstance(t, (list, tuple)):
            return (type(t).__name__, None, tuple(walk(x) for x in t))
        leaves.append(t)
        return ("leaf", None, ())

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves) -> Any:
    it = iter(leaves)

    def build(d):
        kind, keys, children = d
        if kind == "leaf":
            return next(it)
        built = [build(c) for c in children]
        if kind == "dict":
            return dict(zip(keys, built))
        return built if kind == "list" else tuple(built)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def tree_map(fn, tree, *rest):
    leaves, td = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(td, [fn(x, *ys) for x, *ys in zip(leaves, *others)])


def _packable(dtype) -> bool:
    return dtype in _PACKABLE


@dataclass(frozen=True)
class FlatSpec:
    """Layout of a params tree inside a flat float32 plane."""
    treedef: Any
    shapes: tuple          # per-leaf shapes WITHOUT the worker axis
    dtypes: tuple          # per-leaf original torch dtypes
    offsets: tuple         # per-leaf first column
    width: int             # P: total columns

    @classmethod
    def of(cls, tree, *, worker_axis: bool = True) -> "FlatSpec":
        """Build the spec from a tree of tensors. With ``worker_axis`` the
        leading dim of every leaf is the worker axis and is excluded."""
        leaves, treedef = tree_flatten(tree)
        shapes, dtypes, offsets = [], [], []
        off = 0
        for x in leaves:
            if not _packable(x.dtype):
                raise TypeError(
                    f"FlatSpec: dtype {x.dtype} has no exact float32 image")
            shape = tuple(x.shape[1:] if worker_axis else x.shape)
            shapes.append(shape)
            dtypes.append(x.dtype)
            offsets.append(off)
            off += math.prod(shape)
        return cls(treedef, tuple(shapes), tuple(dtypes), tuple(offsets), off)

    @staticmethod
    def supports(tree) -> bool:
        """True iff every leaf dtype embeds exactly in float32."""
        return all(_packable(x.dtype) for x in tree_flatten(tree)[0])

    def _leaves(self, tree) -> list:
        leaves, td = tree_flatten(tree)
        if td != self.treedef:
            raise ValueError("tree structure does not match this FlatSpec")
        return leaves

    def _dtypes(self, dtypes) -> tuple:
        if dtypes is None:
            return self.dtypes
        if isinstance(dtypes, tuple):
            return dtypes
        return (dtypes,) * len(self.shapes)

    # ---- (M, P) plane <-> worker tree ------------------------------------
    def pack(self, tree) -> torch.Tensor:
        """Leaves (M, *shape) -> (M, P) float32, columns in leaf order."""
        leaves = self._leaves(tree)
        m = leaves[0].shape[0]
        return torch.cat([x.float().reshape(m, -1) for x in leaves], dim=1)

    def unpack(self, plane: torch.Tensor, *, dtypes=None):
        """(M, P) float32 -> leaves (M, *shape) in their original dtype
        (or ``dtypes``, e.g. ``torch.float32`` for optimizer moments)."""
        m = plane.shape[0]
        leaves = [plane[:, o:o + math.prod(s)].reshape((m,) + s).to(dt)
                  for o, s, dt in zip(self.offsets, self.shapes,
                                      self._dtypes(dtypes))]
        return tree_unflatten(self.treedef, leaves)

    # ---- (P,) vector <-> consensus tree ----------------------------------
    def pack1(self, tree) -> torch.Tensor:
        """Leaves of exactly ``shape`` (no worker axis) -> (P,) float32."""
        return torch.cat([x.float().reshape(-1) for x in self._leaves(tree)])

    def unpack1(self, vec: torch.Tensor, *, dtypes=None):
        """(P,) float32 -> tree in the leaf dtypes (or ``dtypes``)."""
        leaves = [vec[o:o + math.prod(s)].reshape(s).to(dt)
                  for o, s, dt in zip(self.offsets, self.shapes,
                                      self._dtypes(dtypes))]
        return tree_unflatten(self.treedef, leaves)

    # ---- per-column dtype rounding ----------------------------------------
    def rounding_codes(self, device=None) -> torch.Tensor | None:
        """(P,) float32 per-column rounding codes (``ROUND_*``) on
        ``device``, or None when every leaf is float32. A bf16/f16 leaf's
        columns round through their dtype after every update, so the
        plane always holds the exact float32 image of the tree."""
        if all(dt == torch.float32 for dt in self.dtypes):
            return None
        codes = torch.zeros(self.width, dtype=torch.float32, device=device)
        for o, s, dt in zip(self.offsets, self.shapes, self.dtypes):
            if dt == torch.bfloat16:
                codes[o:o + math.prod(s)] = ROUND_BF16
            elif dt == torch.float16:
                codes[o:o + math.prod(s)] = ROUND_F16
        return codes


@dataclass(frozen=True)
class FlatOptSpec:
    """Layout of an optimizer-state tree as S extra (M, P) planes.

    Applies when the state is S structural copies of the params tree —
    float32 leaves of the param shapes, grouped copy-by-copy in flatten
    order (Momentum velocity S=1; AdamW ``{"m": .., "v": ..}`` S=2; SGD
    ``()`` S=0). :meth:`of` returns None for states that don't align."""
    treedef: Any
    num_planes: int        # S
    param: FlatSpec

    @classmethod
    def of(cls, param: FlatSpec, opt_state) -> "FlatOptSpec | None":
        leaves, treedef = tree_flatten(opt_state)
        n = len(param.shapes)
        if n == 0:
            return None
        if not leaves:
            return cls(treedef, 0, param)
        if len(leaves) % n:
            return None
        s = len(leaves) // n
        for k in range(s):
            for j in range(n):
                x = leaves[k * n + j]
                if (x.dtype != torch.float32
                        or tuple(x.shape[1:]) != param.shapes[j]):
                    return None
        return cls(treedef, s, param)

    def pack(self, opt_state) -> tuple:
        """State tree -> tuple of S (M, P) float32 planes."""
        leaves, _ = tree_flatten(opt_state)
        n = len(self.param.shapes)
        return tuple(
            self.param.pack(tree_unflatten(self.param.treedef,
                                           leaves[k * n:(k + 1) * n]))
            for k in range(self.num_planes))

    def unpack(self, planes: tuple):
        """Tuple of S (M, P) planes -> state tree (float32 leaves)."""
        leaves = []
        for pl in planes:
            leaves.extend(tree_flatten(
                self.param.unpack(pl, dtypes=torch.float32))[0])
        return tree_unflatten(self.treedef, leaves)
