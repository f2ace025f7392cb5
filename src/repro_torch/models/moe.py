"""Mixture-of-Experts FFN: a top-k router with capacity-bounded
GShard-style einsum dispatch — the counterpart of ``repro.models.moe``.

The reference computes the dispatch, the experts and the combine as XLA
einsums outside any Pallas kernel, and so does the port (``torch.einsum``
and ``torch.matmul``). The load-balance auxiliary loss (Shazeer / GShard)
and the router z-loss come back beside the output, for the training loss
to add.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import rng
from repro_torch.configs import ModelConfig
from repro_torch.models.layers import (activate, apply_mlp, cdtype,
                                       dense_init, init_mlp)


def init_moe(cfg: ModelConfig, key, device="cpu"):
    """The reference's five keys, in its order: router (d, E) float32;
    ``w_in`` / ``w_gate`` (E, d, f) and ``w_out`` (E, f, d), fan-in on
    axis 1; the shared expert, a dense MLP of width ``moe_d_ff``."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    dt = cdtype(cfg)
    ks = rng.split(key, 5)
    p = {"router": dense_init(ks[0], (d, e), 0, torch.float32, device),
         "w_in": dense_init(ks[1], (e, d, f), 1, dt, device),
         "w_out": dense_init(ks[2], (e, f, d), 1, dt, device)}
    if cfg.gated_mlp:
        p["w_gate"] = dense_init(ks[3], (e, d, f), 1, dt, device)
    if cfg.shared_expert:
        p["shared"] = init_mlp(cfg, ks[4], device, d_ff=cfg.moe_d_ff)
    return p


def _capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert: ceil(tokens * k * capacity_factor / E), padded to
    a multiple of 4, at least 4."""
    c = int(np.ceil(tokens * cfg.top_k * cfg.capacity_factor
                    / cfg.num_experts))
    return max(4, -(-c // 4) * 4)


def top_k(probs, k: int):
    """(values, indices) of the ``k`` largest entries over the last axis,
    ties to the lower index, as ``jax.lax.top_k`` breaks them
    (``torch.topk`` promises no order among equal values; a stable
    descending sort keeps the lower index first)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_combine(cfg: ModelConfig, probs, cap: int):
    """Top-k combine weights with per-expert capacity over the token axis
    (the second last; any leading axes are groups). probs: (..., T, E)
    float32 -> combine (..., T, E, C) float32. Each of the k slot passes
    places its tokens after the slots earlier passes took; a token past
    its expert's capacity is dropped, in token order."""
    e, k = probs.shape[-1], cfg.top_k
    gate_vals, gate_idx = top_k(probs, k)                    # (..., T, k)
    gate_vals = gate_vals / (torch.sum(gate_vals, dim=-1, keepdim=True)
                             + 1e-9)
    slots = torch.arange(cap, device=probs.device, dtype=torch.float32)
    combine = torch.zeros(probs.shape + (cap,), dtype=torch.float32,
                          device=probs.device)
    # slots used by earlier k-slots
    offset = torch.zeros(probs.shape[:-2] + (1, e), dtype=torch.float32,
                         device=probs.device)
    for slot in range(k):
        onehot = torch.nn.functional.one_hot(gate_idx[..., slot], e).float()
        # position of each token within its expert's buffer
        pos = torch.cumsum(onehot, dim=-2) - 1.0 + offset
        offset = offset + torch.sum(onehot, dim=-2, keepdim=True)
        keep = (pos < cap) & (onehot > 0)                    # over capacity
        # one_hot(pos, cap) (zero where pos is outside [0, cap)), masked
        pos_oh = ((pos[..., None] == slots) & keep[..., None]).float()
        combine = combine + gate_vals[..., slot, None, None] * pos_oh
    return combine


def _expert_ffn(cfg: ModelConfig, p, combine, xt):
    """combine: (..., T, E, C); xt: (..., T, d). GShard dispatch, compute
    and combine; the combine weights are cast to the activations' dtype
    first, as the reference casts them."""
    dispatch = (combine > 0).to(xt.dtype)
    xe = torch.einsum("...tec,...td->...ecd", dispatch, xt)     # (E,C,d)
    h = torch.einsum("...ecd,edf->...ecf", xe, p["w_in"])
    if cfg.gated_mlp:
        g = torch.einsum("...ecd,edf->...ecf", xe, p["w_gate"])
        h = activate(cfg, g) * h
    else:
        h = activate(cfg, h)
    ye = torch.einsum("...ecf,efd->...ecd", h, p["w_out"])      # (E,C,d)
    return torch.einsum("...tec,...ecd->...td", combine.to(xt.dtype), ye)


def apply_moe(cfg: ModelConfig, p, x):
    """x: (B, S, d) -> (y, {"load_balance", "router_z"}).

    ``moe_group_size`` = 0: one capacity buffer over all T = B * S
    tokens. G > 0 (and G < T): tokens routed in independent groups of G,
    the tail padded with zero tokens (a zero token gives a zero output),
    each group with the capacity of G tokens. The auxiliary losses are
    taken over the full router probabilities."""
    b, s, d = x.shape
    e = cfg.num_experts
    t = b * s
    xt = x.reshape(t, d)

    logits = xt.float() @ p["router"]                           # (T, E)
    probs = torch.softmax(logits, dim=-1)

    density = torch.mean(probs, dim=0)                          # (E,)
    # argmax takes the first of equal maxima, as jnp.argmax does
    top1 = torch.argmax(probs, dim=-1)
    frac = torch.mean(torch.nn.functional.one_hot(top1, e).float(), dim=0)
    load_balance = e * torch.sum(density * frac)
    router_z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    g = cfg.moe_group_size
    if g and g < t:
        t_pad = -(-t // g) * g
        xt_p = torch.nn.functional.pad(xt, (0, 0, 0, t_pad - t))
        probs_p = torch.nn.functional.pad(probs, (0, 0, 0, t_pad - t))
        cap = _capacity(cfg, g)
        combine = _dispatch_combine(cfg, probs_p.reshape(t_pad // g, g, e),
                                    cap)
        y = _expert_ffn(cfg, p, combine, xt_p.reshape(t_pad // g, g, d))
        y = y.reshape(t_pad, d)[:t]
    else:
        cap = _capacity(cfg, t)
        y = _expert_ffn(cfg, p, _dispatch_combine(cfg, probs, cap), xt)

    if cfg.shared_expert:
        y = y + apply_mlp(cfg, p["shared"], xt)

    aux = {"load_balance": load_balance, "router_z": router_z}
    return y.reshape(b, s, d), aux
