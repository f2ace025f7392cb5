"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427) —
the counterpart of ``repro.models.recurrent``.

Block structure:
  x -> [gate branch: linear -> GeLU] ----------------\\
  x -> [linear -> causal conv1d(width 4) -> RG-LRU] --⊙--> linear -> out

RG-LRU recurrence (all elementwise over rnn_width channels):
  r_t = sigmoid(block_diag(W_a) u_t)          recurrence gate
  i_t = sigmoid(block_diag(W_i) u_t)          input gate
  a_t = exp(-c * softplus(Lambda) * r_t)      c = 8
  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The full sequence takes ``impl="plain"`` (the reference's log-depth
associative scan, :func:`rglru_scan`) or ``impl="kernel"``
(``repro_torch.kernels.rglru_scan``: the CUDA kernel on the card, its
sequential plain twin on the CPU); decode carries (h, conv buffer) state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.configs import ModelConfig
from repro_torch.kernels import rglru_scan as rglru_kernel
from repro_torch.models.layers import cdtype, dense_init
from repro_torch.models.scan import associative_scan

_C = 8.0


def init_rglru(cfg: ModelConfig, key, device="cpu"):
    d, w, h = cfg.d_model, cfg.rnn_width or cfg.d_model, cfg.num_heads
    bw = w // h  # block size of the block-diagonal gates
    dt = cdtype(cfg)
    ks = rng.split(key, 7)
    p = {
        "w_gate": dense_init(ks[0], (d, w), 0, dt, device),
        "w_x": dense_init(ks[1], (d, w), 0, dt, device),
        "conv": dense_init(ks[2], (cfg.conv_width, w), 0, dt, device),
        "conv_b": torch.zeros((w,), dtype=dt, device=device),
        "wa": dense_init(ks[3], (h, bw, bw), 1, dt, device),
        "wi": dense_init(ks[4], (h, bw, bw), 1, dt, device),
    }
    # Lambda so that a ~ Uniform(0.9, 0.999) at r = 1 (Griffin appendix),
    # kept in float32 in a bf16 model, as the reference keeps it
    u = rng.uniform(ks[5], (w,), minval=0.9, maxval=0.999, device=device)
    p["lam"] = torch.log(torch.expm1(-torch.log(u) / _C))
    p["w_out"] = dense_init(ks[6], (w, d), 0, dt, device)
    return p


def _block_gate(p_w, u, h):
    """Block-diagonal projection: u (B,S,W) -> (B,S,W) with H blocks."""
    b, s, w = u.shape
    ub = u.reshape(b, s, h, w // h)
    return torch.einsum("bshi,hij->bshj", ub, p_w).reshape(b, s, w)


def _causal_conv(p, u, prev=None):
    """Per-channel causal conv1d of width cw. u: (B,S,W). prev: (B, cw-1,
    W) history for decode; None => zero left-pad. The taps are summed in
    order 0 .. cw-1 and the bias added last, as the reference sums.
    Returns (out, the last cw-1 inputs)."""
    cw = p["conv"].shape[0]
    if prev is None:
        prev = torch.zeros((u.shape[0], cw - 1, u.shape[2]), dtype=u.dtype,
                           device=u.device)
    up = torch.cat([prev.to(u.dtype), u], dim=1)
    s = u.shape[1]
    out = up[:, 0:s] * p["conv"][0]
    for i in range(1, cw):
        out = out + up[:, i:i + s] * p["conv"][i]
    return out + p["conv_b"], up[:, -(cw - 1):]


def _gates(cfg: ModelConfig, p, u):
    """(a, b) of the recurrence, float32 (B,S,W)."""
    h = cfg.num_heads
    r = torch.sigmoid(_block_gate(p["wa"], u, h).float())
    i = torch.sigmoid(_block_gate(p["wi"], u, h).float())
    # jax.nn.softplus is logaddexp(x, 0)
    softplus = torch.logaddexp(p["lam"], torch.zeros_like(p["lam"]))
    log_a = -_C * softplus * r  # <= 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-12, 1.0))
    b = b * i * u.float()
    return a, b


def rglru_scan(a, b):
    """h_t = a_t h_{t-1} + b_t over axis 1: the reference's
    ``jax.lax.associative_scan`` (odd / even recursion, log depth) with
    the combine (a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)."""
    def combine(x, y):
        return [x[0] * y[0], y[0] * x[1] + y[1]]

    return associative_scan(combine, [a, b], axis=1)[1]


def apply_rglru(cfg: ModelConfig, p, x, *, impl="plain",
                return_state: bool = False):
    """x: (B,S,d) -> (B,S,d) (+ the decode state when ``return_state``).
    ``impl="kernel"`` takes the scan kernel, anything else the plain
    scan (``forward`` checks the name)."""
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    u = x @ p["w_x"]
    u, conv_tail = _causal_conv(p, u)
    a, b = _gates(cfg, p, u)
    if impl == "kernel":
        h = rglru_kernel.rglru_scan(a.contiguous(), b.contiguous())
    else:
        h = rglru_scan(a, b)
    out = (h.to(x.dtype) * gate) @ p["w_out"]
    if return_state:
        return out, {"h": h[:, -1].float(), "conv": conv_tail}
    return out


# ---- decode (single token, carried state) --------------------------------

def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, device="cpu"):
    w = cfg.rnn_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                                device=device)}


def decode_rglru(cfg: ModelConfig, p, x, cache):
    """x: (B,1,d); cache {"h": (B,W) f32, "conv": (B,cw-1,W)}. Returns
    (out, new cache)."""
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    u = x @ p["w_x"]
    u, conv_state = _causal_conv(p, u, prev=cache["conv"])
    a, b = _gates(cfg, p, u)  # (B,1,W)
    h = a[:, 0] * cache["h"] + b[:, 0]
    out = (h[:, None].to(x.dtype) * gate) @ p["w_out"]
    return out, {"h": h, "conv": conv_state}
