"""GQA attention: training / prefill (full or sliding-window causal, or
unmasked for an encoder), single-token decode against a KV cache, and
cross-attention over an encoder's or a vision stub's memory — the
counterpart of ``repro.models.attention``.

Two interchangeable compute paths for the full sequence (``impl``):
  - "plain":  einsum attention (the reference's ``impl="xla"``);
  - "kernel": ``repro_torch.kernels.flash_attention`` (the reference's
    ``impl="pallas"``): the CUDA kernel on the card, its plain twin on
    the CPU.
Cross-attention (queries and keys of different lengths) and decode
always take the einsum path, as the reference's do. Under
``cfg.attn_banded`` a sliding-window causal self-attention of the einsum
path runs band-wise (:func:`_banded_attention`), under the reference's
condition; the kernel path takes ``flash_attention`` first, as the
reference's dispatch does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.configs import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (apply_rope, cdtype, dense_init,
                                       rope_freqs)


def init_attn(cfg: ModelConfig, key, device="cpu", cross: bool = False):
    """wq, wk, wv, wo; a cross-attention sublayer (``cross``) has the same
    four, its keys and values projected from the memory."""
    d, dt = cfg.d_model, cdtype(cfg)
    ks = rng.split(key, 4)
    return {
        "wq": dense_init(ks[0], (d, cfg.q_dim), 0, dt, device),
        "wk": dense_init(ks[1], (d, cfg.kv_dim), 0, dt, device),
        "wv": dense_init(ks[2], (d, cfg.kv_dim), 0, dt, device),
        "wo": dense_init(ks[3], (cfg.q_dim, d), 0, dt, device),
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


def _banded_attention(q, k, v, *, window: int, scale, score_dtype):
    """Sliding-window causal attention computed band-wise (the
    reference's ``_banded_attention``): with the chunk c = min(window,
    S), queries padded to a multiple of c and keys and values padded by
    one chunk on the left, query chunk i sees the static 2c-key slice
    [i c, i c + 2c) of the padded keys (absolute positions (i - 1) c to
    (i + 1) c - 1) under the band mask, through :func:`_sdpa_xla`. The
    scores a head moves are ceil(S / c) · 2c² instead of the masked
    path's S², so the band pays past S = 2 · window."""
    b, s, h, hd = q.shape
    c = min(window, s)
    s_pad = -(-s // c) * c
    qp = F.pad(q, (0, 0, 0, 0, 0, s_pad - s))
    kp = F.pad(k, (0, 0, 0, 0, c, s_pad - s))
    vp = F.pad(v, (0, 0, 0, 0, c, s_pad - s))
    ar_q = torch.arange(c, device=q.device)[:, None]
    ar_k = torch.arange(2 * c, device=q.device)[None, :]
    outs = []
    for i in range(s_pad // c):
        qpos = i * c + ar_q                 # absolute query positions
        kpos = (i - 1) * c + ar_k           # absolute key positions
        msk = ((kpos <= qpos) & (kpos > qpos - window) & (kpos >= 0)
               & (qpos < s))
        outs.append(_sdpa_xla(qp[:, i * c:(i + 1) * c],
                              kp[:, i * c:i * c + 2 * c],
                              vp[:, i * c:i * c + 2 * c],
                              msk[None, None], scale, score_dtype))
    return torch.cat(outs, dim=1)[:, :s]


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


def attention(cfg: ModelConfig, p, x, *, layer, kv_x=None, impl="plain",
              pos_offset: int = 0, return_kv: bool = False):
    """Full-sequence attention (training / prefill): (B, S, d_model), or
    (out, (k, v)) with the post-RoPE k / v when ``return_kv`` (prefill
    cache capture). Query i sits at absolute position pos_offset + i.

    ``kv_x``: the memory (B, Sm, d) that keys and values are projected
    from (cross-attention: no RoPE, no mask, no window, always the einsum
    path, as the reference reaches its kernel only for self-attention);
    None: self-attention, where ``impl="kernel"`` takes the
    flash_attention kernel and anything else the einsum path
    (``forward`` checks the name)."""
    b, sq, _ = x.shape
    self_attn = kv_x is None
    src = x if self_attn else kv_x
    sk = src.shape[1]
    q = _split_heads(x @ p["wq"], cfg.num_heads, cfg.head_dim)
    k = _split_heads(src @ p["wk"], cfg.num_kv_heads, cfg.head_dim)
    v = _split_heads(src @ p["wv"], cfg.num_kv_heads, cfg.head_dim)
    if self_attn and cfg.pos_emb == "rope":
        cos_k, sin_k = rope_freqs(cfg, torch.arange(sq, device=x.device))
        cos_q, sin_q = (rope_freqs(cfg, pos_offset + torch.arange(
            sq, device=x.device)) if pos_offset else (cos_k, sin_k))
        q = apply_rope(q, cos_q, sin_q)
        k = apply_rope(k, cos_k, sin_k)
    causal = layer.causal and self_attn
    window = cfg.sliding_window if (layer.mixer == "attn_local"
                                    and self_attn) else 0
    scale = 1.0 / np.sqrt(cfg.head_dim)
    score_dt = getattr(torch, cfg.score_dtype)
    if impl == "kernel" and self_attn:
        out = flash_attention(q, k, v, causal=causal, window=window,
                              scale=scale)
    elif (cfg.attn_banded and window > 0 and causal and self_attn
          and sq == sk and pos_offset == 0):
        out = _banded_attention(q, k, v, window=window, scale=scale,
                                score_dtype=score_dt)
    else:
        mask = make_mask(sq, sk, causal=causal, window=window,
                         q_offset=pos_offset, device=x.device)[None, None]
        out = _sdpa_xla(q, k, v, mask, scale, score_dt)
    out = out.reshape(b, sq, cfg.q_dim) @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


# --------------------------------------------------------------------------
# Decode path (single token, KV cache)
# --------------------------------------------------------------------------

def init_attn_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype,
                    device="cpu"):
    shape = (batch, seq_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(cfg: ModelConfig, p, x, cache, pos: int, *, layer):
    """x: (B, 1, d). cache: {"k","v"} (B, S, Hkv, hd). pos: the index at
    which the new token is written; it attends to [0, pos]. The new K/V
    are written into the cache tensors in place (the reference returns
    updated copies); returns (out, cache).

    Sliding-window layers attend only to the last ``window`` positions
    through a slice of static size ``window`` (O(window), not O(S))."""
    b = x.shape[0]
    s_cache = cache["k"].shape[1]
    q = _split_heads(x @ p["wq"], cfg.num_heads, cfg.head_dim)
    k = _split_heads(x @ p["wk"], cfg.num_kv_heads, cfg.head_dim)
    v = _split_heads(x @ p["wv"], cfg.num_kv_heads, cfg.head_dim)
    if cfg.pos_emb == "rope":
        cos, sin = rope_freqs(cfg, torch.full((1,), pos, device=x.device))
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    ck, cv = cache["k"], cache["v"]
    ck[:, pos] = k[:, 0].to(ck.dtype)
    cv[:, pos] = v[:, 0].to(cv.dtype)

    window = cfg.sliding_window if layer.mixer == "attn_local" else 0
    scale = 1.0 / np.sqrt(cfg.head_dim)
    if window and window < s_cache:
        start = min(max(pos - window + 1, 0), s_cache - window)
        ks, vs = ck[:, start:start + window], cv[:, start:start + window]
        kpos = torch.arange(start, start + window, device=x.device)
    else:
        ks, vs = ck, cv
        kpos = torch.arange(s_cache, device=x.device)
    mask = (kpos <= pos)[None, None, None, :]
    out = _sdpa_xla(q, ks, vs, mask, scale)
    return out.reshape(b, 1, cfg.q_dim) @ p["wo"], {"k": ck, "v": cv}


def decode_cross_attention(cfg: ModelConfig, p, x, cache):
    """Cross-attention of one token (B, 1, d) over the memory's K / V,
    projected once at prefill and kept in ``cache`` as {"k", "v"}: (B,
    Sm, Hkv, hd). Every memory position is seen."""
    b = x.shape[0]
    q = _split_heads(x @ p["wq"], cfg.num_heads, cfg.head_dim)
    sm = cache["k"].shape[1]
    mask = torch.ones((1, 1, 1, sm), dtype=torch.bool, device=x.device)
    out = _sdpa_xla(q, cache["k"], cache["v"], mask,
                    1.0 / np.sqrt(cfg.head_dim))
    return out.reshape(b, 1, cfg.q_dim) @ p["wo"]


def cross_cache_from_memory(cfg: ModelConfig, p, memory):
    """The cross-attention K / V of ``memory`` (B, Sm, d): {"k", "v"},
    each (B, Sm, Hkv, hd)."""
    k = _split_heads(memory @ p["wk"], cfg.num_kv_heads, cfg.head_dim)
    v = _split_heads(memory @ p["wv"], cfg.num_kv_heads, cfg.head_dim)
    return {"k": k, "v": v}
