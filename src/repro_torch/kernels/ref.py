"""Plain PyTorch versions of the port's kernels — straightforward,
obviously-correct eager code. The CPU tests use them, the wrappers take
them for tensors that lie on the CPU, and ``chip_smoke.py`` holds each
CUDA kernel against them on the card. The serving kernels' versions,
:func:`flash_attention_ref` and :func:`rglru_scan_ref`, are ports of the
reference's oracles of the same names.

Column means are summed over the worker rows in row order (0, 1, ...,
M-1, starting from 0) and then divided by the row count, the order the
CUDA kernels use, so a plain and a kernel mean agree bitwise. The count
is a 0-dim tensor, not a Python number: PyTorch's CUDA division by a
host scalar multiplies by its reciprocal, which is not the IEEE quotient
for counts such as 24.

Mixing products ``W @ x`` are an explicit loop over j in order, one
multiply and one add each, starting from 0 — not ``torch.matmul`` — the
arithmetic of the CUDA kernels, which build with ``-fmad=false``, so a
plain and a kernel mix agree bitwise too.
"""
from __future__ import annotations

import math

import torch

from repro_torch import faults as _faults

_KINDS = ("sgd", "momentum", "adamw")
_MODES = ("none", "mean", "group", "mix")
#: wire formats of the compressed event (``f32`` lowers to no wire)
_WIRES = ("bf16", "int8", "one_bit")


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


def _plane_dispersion(plane: torch.Tensor) -> torch.Tensor:
    """Eq. 4 against the plane's own worker mean."""
    return _dispersion(plane, _div(_row_sum(plane), plane.shape[0]))


def _mix(W: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``W @ x`` for (M, M) ``W`` and (M, P) ``x``: each output row summed
    over j in order from 0, one rounded multiply and add per term. Row
    by row, so the temporaries are (P,) rows, not planes."""
    m = x.shape[0]
    out = torch.empty_like(x)
    for i in range(m):
        acc = torch.zeros_like(x[0])
        for j in range(m):
            acc += W[i, j] * x[j]
        out[i] = acc
    return out


def _mean_event(q: torch.Tensor, groups: int, codes=None) -> torch.Tensor:
    """The (group) mean of ``q``, rounded through ``codes``, broadcast
    back to a new (M, P) plane."""
    m, p = q.shape
    out = (_group_means(q, groups) if groups > 1
           else _div(_row_sum(q), m)[None, None])
    if codes is not None:
        out = round_to_codes(out, codes)
    return out.expand(groups, m // groups, p).reshape(m, p).contiguous()


def _masked_event(q: torch.Tensor, alive, groups: int,
                  codes=None) -> torch.Tensor:
    """The exact (group) mean of ``q`` over the alive rows, rounded
    through ``codes``, on a new (M, P) plane (dead rows not yet kept)."""
    m, p = q.shape
    if groups > 1:
        out = _faults.masked_group_mean(q, alive, groups)
        return out if codes is None else round_to_codes(out, codes[None])
    glob = _faults.masked_mean(q, alive)
    if codes is not None:
        glob = round_to_codes(glob, codes)
    return glob[None].expand(m, p).contiguous()


def round_to_codes(x: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Round each column of ``x`` through its original dtype (codes from
    ``FlatSpec.rounding_codes``: 0 f32, 1 bf16, 2 f16) and back to f32,
    round-to-nearest-even. ``codes`` broadcasts over leading axes. On
    ``meta`` tensors, whose codes hold no values, both roundings run (a
    dry run counts them both)."""
    out = x
    is_bf, is_f16 = codes == 1.0, codes == 2.0
    if codes.is_meta or bool(is_bf.any()):
        out = torch.where(is_bf, x.to(torch.bfloat16).float(), out)
    if codes.is_meta or bool(is_f16.any()):
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


def plane_average_ref(plane, *, groups: int = 1, codes=None, alive=None):
    """Worker mean (global, or per contiguous group) + Eq. 4 dispersion
    + broadcast on the (M, P) plane, with the per-column dtype rounding
    of the broadcast mean. The dispersion is always against the global
    mean. ``alive`` ((M,) 0/1, :mod:`repro_torch.faults`) makes the
    event a masked one: the exact mean over the alive rows (of their
    group) to the alive rows, dead rows keeping their values, the
    dispersion over the alive set. Returns (averaged plane,
    dispersion)."""
    m, p = plane.shape
    if groups < 1 or m % groups:
        raise ValueError(f"groups={groups} must divide the {m} rows")
    if alive is not None:
        disp = _faults.masked_dispersion(plane, alive)
        out = _masked_event(plane, alive, groups, codes)
        return _faults.keep_rows_(out, plane, alive), disp
    glob = _div(_row_sum(plane), m)
    disp = _dispersion(plane, glob)
    out = _group_means(plane, groups) if groups > 1 else glob[None, None]
    if codes is not None:
        out = round_to_codes(out, codes)
    out = out.expand(groups, m // groups, p).reshape(m, p)
    return out.contiguous(), disp  # reshape of a broadcast may be a view


def mix_disp_ref(plane, W, *, codes=None, alive=None):
    """Gossip mixing event on the (M, P) plane: ``W @ plane`` for a
    doubly-stochastic (M, M) ``W`` (each worker keeps its own mixed row,
    no broadcast), the mixed rows rounded through ``codes``, plus the
    Eq. 4 dispersion of the INPUT plane. ``alive`` renormalizes ``W``
    over the alive rows (``faults.degraded_matrix``): dead rows keep
    their values and the dispersion is over the alive set. Returns
    (mixed plane, dispersion)."""
    W = W.to(plane.device, torch.float32)
    if alive is not None:
        disp = _faults.masked_dispersion(plane, alive)
        W = _faults.degraded_matrix(W, alive)
    else:
        disp = _plane_dispersion(plane)
    out = _mix(W, plane)
    if codes is not None:
        out = round_to_codes(out, codes[None])
    if alive is not None:
        _faults.keep_rows_(out, plane, alive)
    return out, disp


def avg_disp_outer_ref(plane, prev_avg, vel, *, lr: float, momentum: float,
                       nesterov: bool = True, codes=None):
    """All-average + dispersion + the outer optimizer's momentum step:
    the consensus mean is the outer gradient target (rounded through
    ``codes`` first, as the tree path's leaf-dtype mean is), the updated
    average (rounded through ``codes``) is broadcast back. The
    dispersion is against the unrounded mean. plane: (M, P);
    prev_avg/vel: (P,). Returns (plane, new_avg, new_vel, dispersion)."""
    m = plane.shape[0]
    avg = _div(_row_sum(plane), m)
    disp = _dispersion(plane, avg)
    if codes is not None:
        avg = round_to_codes(avg, codes)
    g = prev_avg - avg
    vel = momentum * vel + g
    step = momentum * vel + g if nesterov else vel
    upd = prev_avg - lr * step
    if codes is not None:
        upd = round_to_codes(upd, codes)
    return upd[None].expand(plane.shape).contiguous(), upd, vel, disp


def compressed_avg_ref(plane, resid, *, wire, groups: int = 1, u=None,
                       codes=None, error_feedback: bool = True, alive=None):
    """Compressed averaging event: error-feedback encode of the plane
    (``repro_torch.core.compress.encode_decode``), the (group) mean of
    the decoded ``q`` broadcast back and rounded through ``codes``; the
    Eq. 4 dispersion of the input plane. ``alive`` masks the event: the
    mean is over the alive rows' ``q``, and dead rows ship nothing —
    they keep their params and their residual. Returns (plane, new
    residual, dispersion)."""
    from repro_torch.core.compress import encode_decode
    if alive is not None:
        disp = _faults.masked_dispersion(plane, alive)
        q, r_new = encode_decode(plane, resid, wire=wire, u=u,
                                 error_feedback=error_feedback)
        out = _masked_event(q, alive, groups, codes)
        return (_faults.keep_rows_(out, plane, alive),
                _faults.keep_rows_(r_new, resid, alive), disp)
    disp = _plane_dispersion(plane)
    q, resid = encode_decode(plane, resid, wire=wire, u=u,
                             error_feedback=error_feedback)
    return _mean_event(q, groups, codes), resid, disp


def compressed_mix_ref(plane, resid, W, *, wire, u=None, codes=None,
                       error_feedback: bool = True, alive=None):
    """Compressed gossip mixing event: error-feedback encode, then
    ``W @ q`` on the decoded plane, rounded through ``codes``; the Eq. 4
    dispersion of the input plane. ``alive`` degrades ``W`` over the
    alive rows; dead rows keep their params and their residual. Returns
    (mixed plane, new residual, dispersion)."""
    from repro_torch.core.compress import encode_decode
    W = W.to(plane.device, torch.float32)
    if alive is not None:
        disp = _faults.masked_dispersion(plane, alive)
        W = _faults.degraded_matrix(W, alive)
    else:
        disp = _plane_dispersion(plane)
    q, r_new = encode_decode(plane, resid, wire=wire, u=u,
                             error_feedback=error_feedback)
    out = _mix(W, q)
    if codes is not None:
        out = round_to_codes(out, codes[None])
    if alive is not None:
        return (_faults.keep_rows_(out, plane, alive),
                _faults.keep_rows_(r_new, resid, alive), disp)
    return out, r_new, disp


def opt_step_ref(plane, grads, planes, scalars, *, kind, mode="none",
                 groups: int = 1, W=None, mu=0.9, nesterov=False, b1=0.9,
                 b2=0.95, eps=1e-8, weight_decay=0.0, codes=None,
                 wire=None, resid=None, u=None,
                 error_feedback: bool = True, alive=None, umask=None):
    """Fused local optimizer step + optional averaging event on the flat
    (M, P) plane. mode: "none" (local step), "mean" (step + worker mean
    + broadcast), "group" (per-group means) or "mix" (step + ``W @``
    the updated plane, each worker keeping its own mixed row). The Eq. 4
    dispersion of the post-update plane is emitted in every mode.
    Returns (plane, new state planes, dispersion).

    ``wire`` (``bf16`` / ``int8`` / ``one_bit``) makes the event the
    compressed one: the error-feedback encode of the post-update plane
    (``resid`` the residual, ``u`` the int8 uniforms), the event on the
    decoded ``q``; the return gains the residual: (plane, new state
    planes, new residual, dispersion).

    ``alive`` / ``umask`` ((M,) 0/1, :mod:`repro_torch.faults`) make the
    pass a fault-degraded one: only rows with ``umask > 0`` (``alive``
    when not given) apply the update — the others keep their params and
    their state planes — and the event and the dispersion are masked
    over ``alive``."""
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    upd, new_planes = plane_update_ref(
        plane, grads, planes, scalars, kind=kind, mu=mu, nesterov=nesterov,
        b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, codes=codes)
    if alive is not None:
        umask = alive if umask is None else umask
        _faults.keep_rows_(upd, plane, umask)
        for n, o in zip(new_planes, planes):
            _faults.keep_rows_(n, o, umask)
    planes = new_planes
    if wire is not None and mode != "none":
        kw = dict(wire=wire, u=u, codes=codes, error_feedback=error_feedback,
                  alive=alive)
        if mode == "mix":
            out, resid, disp = compressed_mix_ref(upd, resid, W, **kw)
        else:
            out, resid, disp = compressed_avg_ref(
                upd, resid, groups=groups if mode == "group" else 1, **kw)
        return out, planes, resid, disp
    if mode == "mix":
        out, disp = mix_disp_ref(upd, W, codes=codes, alive=alive)
        return out, planes, disp
    if mode == "none":
        return upd, planes, (_plane_dispersion(upd) if alive is None else
                             _faults.masked_dispersion(upd, alive))
    out, disp = plane_average_ref(
        upd, groups=groups if mode == "group" else 1, codes=codes,
        alive=alive)
    return out, planes, disp


def flash_attention_ref(q, k, v, *, causal: bool, window: int = 0,
                        scale: float | None = None):
    """q: (B,S,H,hd), k/v: (B,S,Hkv,hd) -> (B,S,H,hd) in ``q.dtype``.

    Softmax attention in float32 with a ``-inf`` mask (causal: key <=
    query; ``window`` > 0: key > query - window) and GQA by repeating
    each key/value head over its H / Hkv query heads. Fully masked rows
    give 0."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kr = torch.repeat_interleave(k.float(), g, dim=2)
    vr = torch.repeat_interleave(v.float(), g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * scale
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    scores = scores.masked_fill(~mask, -math.inf)
    p = torch.softmax(scores, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)  # fully masked rows
    out = torch.einsum("bhqk,bkhd->bqhd", p, vr)
    return out.to(q.dtype)


def rglru_scan_ref(a, b):
    """h_t = a_t h_{t-1} + b_t, h_0 = 0. a, b: (B,S,W) float32 -> (B,S,W)
    float32. Sequential over S: one multiply and one add per step, each
    rounded on its own."""
    h = torch.zeros_like(a[:, 0])
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def rwkv6_scan_ref(r, k, v, log_w, u, dtype=torch.float32):
    """Exact sequential WKV6 in ``dtype`` (float32 by default; float64
    gives the yardstick a reassociated kernel is held to). r, k, v, log_w:
    (B,S,H,n) (r, k, v in any float type); u: (H*n,) or (H,n). Returns
    (B,S,H,n) in ``dtype``:
      y_t = r_t · (S_{t-1} + (u∘k_t) v_tᵀ);  S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
    with w = exp(log_w) and S_0 = 0; each product and sum of the state
    update rounded on its own."""
    bsz, s, h, n = r.shape
    u = u.to(dtype).reshape(h, n)
    rf, kf, vf = (t.to(dtype) for t in (r, k, v))
    w = torch.exp(log_w.to(dtype))
    S = torch.zeros((bsz, h, n, n), dtype=dtype, device=r.device)
    out = torch.empty((bsz, s, h, n), dtype=dtype, device=r.device)
    for t in range(s):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # (B,H,n,n)
        out[:, t] = torch.einsum("bhi,bhij->bhj", rf[:, t],
                                 S + u[None, :, :, None] * kv)
        S = w[:, t, :, :, None] * S + kv
    return out
