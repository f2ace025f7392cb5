"""Shared building blocks: norms, activations, MLPs, embeddings, RoPE —
the counterparts of ``repro.models.layers``, over dicts of tensors in
the reference's layout (weights stored (in, out), applied as ``x @ w``).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.configs import ModelConfig


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def dense_init(key, shape, in_axis: int = 0, dtype=torch.float32,
               device="cpu") -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) truncated to [-2, 2], times
    1/sqrt(fan_in) — the reference's draw from the same key
    (:func:`repro_torch.rng.truncated_normal`), scaled in float32 and
    cast to ``dtype``."""
    fan_in = shape[in_axis] if in_axis is not None else 1
    std = np.float32(1.0 / np.sqrt(max(fan_in, 1)))
    t = rng.truncated_normal(key, -2.0, 2.0, shape, device=device)
    return t.mul_(float(std)).to(dtype)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, device="cpu", d: int | None = None):
    """RMSNorm: a scale; layernorm: a scale and a bias (both zero)."""
    d = d or cfg.d_model
    if cfg.norm not in ("rmsnorm", "layernorm"):
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported yet")
    p = {"scale": torch.zeros((d,), dtype=cdtype(cfg), device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=cdtype(cfg), device=device)
    return p


def apply_norm(cfg: ModelConfig, p, x):
    """RMSNorm / LayerNorm with fp32 statistics and a gemma-style
    (1 + scale); layernorm centres first and adds its bias last."""
    xf = x.float()
    if cfg.norm == "layernorm":
        xf = xf - torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + 1e-6)
    out = xf * (1.0 + p["scale"].float())
    if cfg.norm == "layernorm":
        out = out + p["bias"].float()
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Activations / MLP
# --------------------------------------------------------------------------

def activate(cfg: ModelConfig, x):
    if cfg.act == "silu":
        return F.silu(x)
    if cfg.act == "gelu":
        return F.gelu(x, approximate="tanh")
    if cfg.act == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(cfg.act)


def init_mlp(cfg: ModelConfig, key, device="cpu", d_ff: int | None = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = cdtype(cfg)
    ks = rng.split(key, 3)
    p = {"w_in": dense_init(ks[0], (d, f), 0, dt, device),
         "w_out": dense_init(ks[1], (f, d), 0, dt, device)}
    if cfg.gated_mlp:
        p["w_gate"] = dense_init(ks[2], (d, f), 0, dt, device)
    return p


def apply_mlp(cfg: ModelConfig, p, x):
    h = x @ p["w_in"]
    if cfg.gated_mlp:
        h = activate(cfg, x @ p["w_gate"]) * h
    else:
        h = activate(cfg, h)
    return h @ p["w_out"]


# --------------------------------------------------------------------------
# Embedding / unembedding (padded vocab, see ModelConfig.padded_vocab)
# --------------------------------------------------------------------------

def init_embed(cfg: ModelConfig, key, device="cpu"):
    """The token table (V, d), an untied unembedding (d, V) where the
    config unties them, and a learned-position table (max_seq_len, d)
    where ``pos_emb`` is "learned" (fan-in on axis 1, as the token
    table's)."""
    ks = rng.split(key, 3)
    dt = cdtype(cfg)
    p = {"tok": dense_init(ks[0], (cfg.padded_vocab, cfg.d_model), 1, dt,
                           device)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(ks[1], (cfg.d_model, cfg.padded_vocab), 0,
                                  dt, device)
    if cfg.pos_emb == "learned":
        p["pos"] = dense_init(ks[2], (cfg.max_seq_len, cfg.d_model), 1, dt,
                              device)
    return p


def embed(cfg: ModelConfig, p, tokens, pos_offset: int = 0):
    """Token embeddings (B, S, d), plus the learned positions pos_offset
    .. pos_offset + S - 1 where the config learns them; a position at or
    past ``max_seq_len`` raises a ``ValueError`` (checked on the host,
    before any indexing on the device)."""
    x = p["tok"][tokens]
    if cfg.family != "ssm":  # gemma-style sqrt(d) scaling for attn models
        # sqrt(d) rounded to the activation dtype first, as the reference
        # does; a Python scalar keeps the stream free of host copies
        x = x * float(torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype))
    if cfg.pos_emb == "learned":
        s = tokens.shape[-1]
        if pos_offset < 0 or pos_offset + s > cfg.max_seq_len:
            raise ValueError(
                f"positions {pos_offset}..{pos_offset + s - 1} past the "
                f"learned-position table of {cfg.max_seq_len}")
        x = x + p["pos"][pos_offset:pos_offset + s]
    return x


def unembed(cfg: ModelConfig, p, x):
    w = p["tok"].T if cfg.tie_embeddings else p["unembed"]
    logits = (x @ w).float()
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    # mask padded vocab rows so they can never win a softmax/argmax
    pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
    return torch.where(pad, -1e9, logits)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _inv_freqs(half: int, theta: float, device: torch.device):
    """1 / theta^(i / half) in float64 numpy, rounded to float32 — built
    once per device (a host-to-card copy synchronizes the stream)."""
    inv = 1.0 / (theta ** (np.arange(0, half) / half))
    return torch.tensor(inv, dtype=torch.float32, device=device)


def rope_freqs(cfg: ModelConfig, positions: torch.Tensor):
    """positions: (...,) int -> cos/sin of shape (..., head_dim // 2)."""
    inv = _inv_freqs(cfg.head_dim // 2, cfg.rope_theta, positions.device)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, hd); cos/sin: (S, hd//2), broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
