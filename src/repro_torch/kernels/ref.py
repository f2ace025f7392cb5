"""Plain PyTorch versions of the port's kernels — straightforward,
obviously-correct eager code. The CPU tests use them, the wrappers take
them for tensors that lie on the CPU, and ``chip_smoke.py`` holds each
CUDA kernel against them on the card.

Column means are summed over the worker rows in row order (0, 1, ...,
M-1, starting from 0) and then divided by the row count, the order the
CUDA kernels use, so a plain and a kernel mean agree bitwise. The count
is a 0-dim tensor, not a Python number: PyTorch's CUDA division by a
host scalar multiplies by its reciprocal, which is not the IEEE quotient
for counts such as 24.
"""
from __future__ import annotations

import torch

_KINDS = ("sgd", "momentum", "adamw")
_MODES = ("none", "mean", "group")


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 in row order, starting from 0."""
    s = torch.zeros_like(x[0])
    for i in range(x.shape[0]):
        s += x[i]
    return s


def _div(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x / n`` as an IEEE float32 division on every device."""
    return x / torch.full((), float(n), dtype=x.dtype, device=x.device)


def _group_means(plane: torch.Tensor, groups: int) -> torch.Tensor:
    """(groups, 1, P) means of ``groups`` contiguous row groups."""
    m, p = plane.shape
    xg = plane.reshape(groups, m // groups, p)
    return _div(_row_sum(xg.transpose(0, 1)), m // groups)[:, None]


def _dispersion(plane: torch.Tensor, glob: torch.Tensor) -> torch.Tensor:
    """Eq. 4: mean over workers of ||w_i - w̄||², as a 0-dim f32 tensor."""
    return _div(torch.sum(torch.square(plane - glob[None])), plane.shape[0])


def round_to_codes(x: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Round each column of ``x`` through its original dtype (codes from
    ``FlatSpec.rounding_codes``: 0 f32, 1 bf16, 2 f16) and back to f32,
    round-to-nearest-even. ``codes`` broadcasts over leading axes."""
    out = x
    is_bf, is_f16 = codes == 1.0, codes == 2.0
    if bool(is_bf.any()):
        out = torch.where(is_bf, x.to(torch.bfloat16).float(), out)
    if bool(is_f16.any()):
        out = torch.where(is_f16, x.to(torch.float16).float(), out)
    return out


def plane_update_ref(plane, grads, planes, scalars, *, kind, mu=0.9,
                     nesterov=False, b1=0.9, b2=0.95, eps=1e-8,
                     weight_decay=0.0, codes=None):
    """The local optimizer step on the flat (M, P) plane: SGD, Momentum
    (± Nesterov) or AdamW, then the per-column dtype rounding.

    plane/grads: (M, P) f32; planes: tuple of S state planes; scalars:
    (4,) f32 [lr, c1, c2, _]. Returns (updated plane, new state planes)."""
    scalars = scalars.to(plane.device)
    lr, c1, c2 = scalars[0], scalars[1], scalars[2]
    g = grads
    if kind == "sgd":
        upd, planes = plane - lr * g, ()
    elif kind == "momentum":
        v = mu * planes[0] + g
        upd = plane - lr * (g + mu * v if nesterov else v)
        planes = (v,)
    elif kind == "adamw":
        m2 = b1 * planes[0] + (1 - b1) * g
        v2 = b2 * planes[1] + (1 - b2) * g * g
        d = (m2 / c1) / (torch.sqrt(v2 / c2) + eps)
        upd = plane - lr * (d + weight_decay * plane)
        planes = (m2, v2)
    else:
        raise ValueError(f"unknown plane optimizer kind {kind!r}")
    if codes is not None:
        upd = round_to_codes(upd, codes[None])
    return upd, planes


def plane_average_ref(plane, *, groups: int = 1, codes=None):
    """Worker mean (global, or per contiguous group) + Eq. 4 dispersion
    + broadcast on the (M, P) plane, with the per-column dtype rounding
    of the broadcast mean. The dispersion is always against the global
    mean. Returns (averaged plane, dispersion)."""
    m, p = plane.shape
    if groups < 1 or m % groups:
        raise ValueError(f"groups={groups} must divide the {m} rows")
    glob = _div(_row_sum(plane), m)
    disp = _dispersion(plane, glob)
    out = _group_means(plane, groups) if groups > 1 else glob[None, None]
    if codes is not None:
        out = round_to_codes(out, codes)
    out = out.expand(groups, m // groups, p).reshape(m, p)
    return out.contiguous(), disp  # reshape of a broadcast may be a view


def avg_disp_ref(plane, *, groups: int = 1):
    """Fused worker-average + dispersion on the flat (M, P) float32 plane
    (no rounding codes). Returns (averaged plane, dispersion)."""
    return plane_average_ref(plane, groups=groups)


def opt_step_ref(plane, grads, planes, scalars, *, kind, mode="none",
                 groups: int = 1, mu=0.9, nesterov=False, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.0, codes=None):
    """Fused local optimizer step + optional averaging event on the flat
    (M, P) plane. mode: "none" (local step), "mean" (step + worker mean
    + broadcast) or "group" (per-group means). The Eq. 4 dispersion of
    the post-update plane is emitted in every mode. Returns
    (plane, new state planes, dispersion)."""
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    upd, planes = plane_update_ref(
        plane, grads, planes, scalars, kind=kind, mu=mu, nesterov=nesterov,
        b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, codes=codes)
    if mode == "none":
        return upd, planes, _dispersion(upd, _div(_row_sum(upd), upd.shape[0]))
    out, disp = plane_average_ref(
        upd, groups=groups if mode == "group" else 1, codes=codes)
    return out, planes, disp
