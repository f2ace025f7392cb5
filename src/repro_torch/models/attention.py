"""GQA self-attention for training (full or sliding-window causal): the
plain-einsum path of ``repro.models.attention`` (its ``impl="xla"``
branch). The flash-attention kernel path is not ported yet."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.models.layers import (apply_rope, cdtype, dense_init,
                                       rope_freqs)


def init_attn(cfg: ModelConfig, gen, device="cpu"):
    d, dt = cfg.d_model, cdtype(cfg)
    return {
        "wq": dense_init(gen, (d, cfg.q_dim), 0, dt, device),
        "wk": dense_init(gen, (d, cfg.kv_dim), 0, dt, device),
        "wv": dense_init(gen, (d, cfg.kv_dim), 0, dt, device),
        "wo": dense_init(gen, (cfg.q_dim, d), 0, dt, device),
    }


def _as_dtype(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype`` (as the reference's ``jnp.asarray(v,
    dtype)``), returned as a Python float."""
    return float(torch.tensor(v, dtype=dtype))


def _split_heads(x, n, hd):
    return x.reshape(x.shape[:-1] + (n, hd))


def _sdpa_xla(q, k, v, mask, scale, score_dtype=torch.float32):
    """q: (B,Sq,H,hd)  k/v: (B,Sk,Hkv,hd)  mask: broadcastable (B,1,Sq,Sk).

    score_dtype: dtype of the materialized (Sq, Sk) score/prob traffic —
    the softmax statistics themselves are always fp32."""
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(score_dtype)
    # Python scalars, not host tensors: a host tensor moved to the card
    # synchronizes the stream on every call
    scores = scores * _as_dtype(scale, score_dtype)
    scores = torch.where(mask[:, :, None] if mask.ndim == 4 else mask,
                         scores, _as_dtype(-1e30, score_dtype))
    m = torch.amax(scores.float(), dim=-1, keepdim=True)
    p = torch.exp(scores.float() - m).to(score_dtype)
    denom = torch.sum(p.float(), dim=-1, keepdim=True)
    p = (p.float() / torch.clamp(denom, min=1e-30)).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v)
    return out.reshape(b, sq, h, hd)


def make_mask(sq: int, sk: int, *, causal: bool, window: int = 0,
              q_offset: int = 0, device="cpu"):
    """Boolean mask (sq, sk), True = attend. q position i maps to absolute
    position q_offset + i; k position j is absolute j."""
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m


def attention(cfg: ModelConfig, p, x, *, layer):
    """Full-sequence causal self-attention (training). Returns
    (B, S, d_model)."""
    b, sq, _ = x.shape
    q = _split_heads(x @ p["wq"], cfg.num_heads, cfg.head_dim)
    k = _split_heads(x @ p["wk"], cfg.num_kv_heads, cfg.head_dim)
    v = _split_heads(x @ p["wv"], cfg.num_kv_heads, cfg.head_dim)
    if cfg.pos_emb == "rope":
        cos, sin = rope_freqs(cfg, torch.arange(sq, device=x.device))
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    window = cfg.sliding_window if layer.mixer == "attn_local" else 0
    scale = 1.0 / np.sqrt(cfg.head_dim)
    mask = make_mask(sq, sq, causal=layer.causal, window=window,
                     device=x.device)[None, None]
    out = _sdpa_xla(q, k, v, mask, scale, getattr(torch, cfg.score_dtype))
    return out.reshape(b, sq, cfg.q_dim) @ p["wo"]
