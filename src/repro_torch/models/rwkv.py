"""RWKV6 "Finch" time-mix + channel-mix (arXiv:2404.05892) — the
counterpart of ``repro.models.rwkv``.

Per head (head_dim n), with data-dependent per-channel decay w_t:
  S_t[i,j] = w_t[i] * S_{t-1}[i,j] + k_t[i] * v_t[j]
  y_t[j]   = sum_i r_t[i] * (S_{t-1}[i,j] + u[i] * k_t[i] * v_t[j])

The full sequence takes the reference's dispatch: ``impl="kernel"``
without a decode state runs ``repro_torch.kernels.rwkv6_scan`` (the CUDA
kernel on the card, its sequential plain twin on the CPU); anything else,
and every prefill that captures the decode state, takes the CHUNKED plain
path (:func:`rwkv_attention`): within a chunk the output is a quadratic
"decay attention" with relative decays, and chunk boundary states are
combined with the log-depth associative scan. Decode carries (wkv state,
token-shift inputs).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.configs import ModelConfig
from repro_torch.kernels import rwkv6_scan as wkv_kernel
from repro_torch.models.layers import cdtype, dense_init
from repro_torch.models.scan import associative_scan

# Chunk size / decay floor are coupled: every intra-chunk exponent is
# bounded by (CHUNK-1) * |log_w|_max = 15 * 5 = 75 < log(fp32 max) ~ 88,
# so the quadratic decay-attention form never overflows in fp32.
CHUNK = 16
LOG_W_MIN = -5.0


def init_rwkv(cfg: ModelConfig, key, device="cpu"):
    """Time-mix params in the config's dtype; ``w0``, ``u`` and ``ln_out``
    in float32, as the reference keeps them."""
    d = cfg.d_model
    lora = max(32, d // 64)
    dt = cdtype(cfg)

    def half():
        return torch.full((d,), 0.5, dtype=dt, device=device)

    ks = rng.split(key, 10)
    p = {"mu_r": half(), "mu_k": half(), "mu_v": half(), "mu_w": half(),
         "mu_g": half()}
    for k, name in enumerate(("wr", "wk", "wv", "wg", "wo")):
        p[name] = dense_init(ks[k], (d, d), 0, dt, device)
    # data-dependent decay LoRA: w_t = exp(-exp(w0 + tanh(x A) B))
    ramp = torch.arange(d, dtype=torch.float32, device=device) / max(d - 1, 1)
    p["w0"] = -6.0 + 8.0 * ramp ** 3
    p["wA"] = dense_init(ks[5], (d, lora), 0, dt, device)
    p["wB"] = dense_init(ks[6], (lora, d), 0, dt, device)
    p["u"] = dense_init(ks[7], (d,), None, torch.float32, device)  # bonus
    p["ln_out"] = torch.ones((d,), dtype=torch.float32, device=device)
    return p


def _token_shift(x, mu, prev=None):
    """lerp(x_t, x_{t-1}, mu); prev: (B,1,d) last token of previous step."""
    if prev is None:
        prev_x = F.pad(x, (0, 0, 1, 0))[:, :-1]
    else:
        prev_x = torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)
    return x + (prev_x - x) * mu


def _project(cfg, p, x, prev=None):
    """Returns r,k,v: (B,S,H,n), g: (B,S,d); log_w: (B,S,H,n) fp32 (<0)."""
    n = cfg.rwkv_head_dim
    b, s, d = x.shape
    h = d // n
    r = _token_shift(x, p["mu_r"], prev) @ p["wr"]
    k = _token_shift(x, p["mu_k"], prev) @ p["wk"]
    v = _token_shift(x, p["mu_v"], prev) @ p["wv"]
    g = F.silu(_token_shift(x, p["mu_g"], prev) @ p["wg"])
    xw = _token_shift(x, p["mu_w"], prev)
    dw = torch.tanh(xw @ p["wA"]) @ p["wB"]
    log_w = -torch.exp(torch.clamp(p["w0"] + dw.float(), -20.0, 8.0))
    log_w = torch.clamp(log_w, LOG_W_MIN, -1e-5)

    def hsplit(t):
        return t.reshape(b, s, h, n)

    return hsplit(r), hsplit(k), hsplit(v), g, hsplit(log_w)


def _chunk_scan(A, S):
    """Combine per-chunk (decay, state) across chunks.
    A: (B,H,N,n) total per-channel decay of each chunk (key dim)
    S: (B,H,N,n,n) chunk-local state contribution.
    Returns prefix states BEFORE each chunk (exclusive scan)."""
    def combine(x, y):
        a1, s1 = x
        a2, s2 = y
        return [a1 * a2, a2[..., None] * s1 + s2]

    s = associative_scan(combine, [A, S], axis=2)[1]
    # exclusive: state entering chunk c = scanned state of chunk c-1
    return torch.cat([torch.zeros_like(s[:, :, :1]), s[:, :, :-1]], dim=2)


def rwkv_attention(cfg: ModelConfig, r, k, v, log_w, u, *,
                   return_state=False):
    """Chunked WKV6. r,k,v,log_w: (B,S,H,n) (log_w fp32). u: (H*n,) or
    (H,n). Returns (B,S,H,n) fp32 (and the final state (B,H,n,n) with
    ``return_state``)."""
    b, s_orig, h, n = r.shape
    c = min(CHUNK, s_orig)
    if s_orig % c:  # pad to a chunk multiple: k=0 adds no state and
        pad = (0, 0, 0, 0, 0, c - s_orig % c)  # log_w=0 (decay 1) leaves
        r, k, v = (F.pad(t, pad) for t in (r, k, v))  # the state intact
        log_w = F.pad(log_w, pad, value=0.0)
    s = r.shape[1]
    nchunk = s // c
    u = u.reshape(h, n)

    def to_chunks(t):  # (B,H,N,c,n) layout
        return t.permute(0, 2, 1, 3).reshape(b, h, nchunk, c, n).float()

    r_, k_, v_, lw = map(to_chunks, (r, k, v, log_w))

    # cumulative decay within chunk: L[t] = sum_{u<=t} log_w[u]
    L = torch.cumsum(lw, dim=3)                      # (B,H,N,c,n)
    Ltot = L[:, :, :, -1]                            # (B,H,N,n)

    # ---- intra-chunk: y_t += sum_{s<t} r_t ⊙ exp(L_{t-1}-L_s) k_s · v_s
    rd = r_ * torch.exp(L - lw)                      # r_t e^{L_{t-1}}
    kd = k_ * torch.exp(-L)                          # k_s e^{-L_s}
    scores = torch.einsum("bhnti,bhnsi->bhnts", rd, kd)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     diagonal=-1)
    scores = torch.where(tri, scores, 0.0)
    # diagonal bonus: u ⊙ k_t
    diag = torch.einsum("bhnti,bhnti->bhnt", r_ * u[None, :, None, None], k_)
    y = torch.einsum("bhnts,bhnsj->bhntj", scores, v_) + diag[..., None] * v_

    # ---- inter-chunk: contribution of the state entering the chunk
    # chunk-local state: S_c[i,j] = sum_t exp(Ltot - L_t)[i] k_t[i] v_t[j]
    kS = k_ * torch.exp(Ltot[:, :, :, None] - L)
    S_local = torch.einsum("bhnti,bhntj->bhnij", kS, v_)
    S_in = _chunk_scan(torch.exp(Ltot), S_local)     # (B,H,N,n,n)
    y = y + torch.einsum("bhnti,bhnij->bhntj", rd, S_in)

    out = y.reshape(b, h, s, n).permute(0, 2, 1, 3)[:, :s_orig]
    if return_state:
        S_final = (torch.exp(Ltot[:, :, -1])[..., None] * S_in[:, :, -1]
                   + S_local[:, :, -1])              # (B,H,n,n)
        return out, S_final
    return out


def _group_norm(y, scale, h, n, eps=64e-5):
    """RWKV's per-head group norm on the wkv output."""
    mu = torch.mean(y, dim=-1, keepdim=True)
    var = torch.mean(torch.square(y - mu), dim=-1, keepdim=True)
    yn = (y - mu) * torch.rsqrt(var + eps)
    return yn.reshape(y.shape[:2] + (h * n,)) * scale


def apply_rwkv(cfg: ModelConfig, p, x, *, impl="plain", return_state=False):
    """Time-mix layer. x: (B,S,d) -> (B,S,d) (+ the decode state
    ``{"wkv", "shift_t"}`` when ``return_state``). ``impl="kernel"``
    without the state takes the scan kernel, anything else the chunked
    path (``forward`` checks the name)."""
    n = cfg.rwkv_head_dim
    h = x.shape[-1] // n
    r, k, v, g, log_w = _project(cfg, p, x)
    state = None
    if impl == "kernel" and not return_state:
        y = wkv_kernel.rwkv6_scan(r, k, v, log_w, p["u"])
    elif return_state:
        y, state = rwkv_attention(cfg, r, k, v, log_w, p["u"],
                                  return_state=True)
    else:
        y = rwkv_attention(cfg, r, k, v, log_w, p["u"])
    y = _group_norm(y, p["ln_out"], h, n).to(x.dtype)
    out = (y * g) @ p["wo"]
    if return_state:
        return out, {"wkv": state, "shift_t": x[:, -1:]}
    return out


# ---- channel mix ----------------------------------------------------------

def init_rwkv_cmix(cfg: ModelConfig, key, device="cpu"):
    d, f = cfg.d_model, cfg.d_ff
    dt = cdtype(cfg)
    ks = rng.split(key, 2)
    return {"mu_k": torch.full((d,), 0.5, dtype=dt, device=device),
            "wk": dense_init(ks[0], (d, f), 0, dt, device),
            "wv": dense_init(ks[1], (f, d), 0, dt, device)}


def apply_rwkv_cmix(cfg: ModelConfig, p, x, prev=None):
    xk = _token_shift(x, p["mu_k"], prev)
    hdn = F.relu(xk @ p["wk"])
    return (hdn * hdn) @ p["wv"]


# ---- decode (single token) ------------------------------------------------

def init_rwkv_cache(cfg: ModelConfig, batch: int, dtype, device="cpu"):
    d = cfg.d_model
    n = cfg.rwkv_head_dim
    h = d // n
    return {
        "wkv": torch.zeros((batch, h, n, n), dtype=torch.float32,
                           device=device),
        "shift_t": torch.zeros((batch, 1, d), dtype=dtype, device=device),
        "shift_c": torch.zeros((batch, 1, d), dtype=dtype, device=device),
    }


def decode_rwkv(cfg: ModelConfig, p, x, cache):
    """x: (B,1,d). One recurrence step; returns (out, new cache)."""
    d = x.shape[-1]
    n = cfg.rwkv_head_dim
    h = d // n
    r, k, v, g, log_w = _project(cfg, p, x, prev=cache["shift_t"])
    r, k, v = (t[:, 0].float() for t in (r, k, v))  # (B,H,n)
    w = torch.exp(log_w[:, 0])
    u = p["u"].reshape(h, n)
    S = cache["wkv"]
    kv = k[..., None] * v[..., None, :]              # (B,H,n,n)
    y = torch.einsum("bhi,bhij->bhj", r, S + u[None, :, :, None] * kv)
    S = w[..., None] * S + kv
    y = _group_norm(y[:, None], p["ln_out"], h, n).to(x.dtype)
    out = (y * g) @ p["wo"]
    return out, {"wkv": S, "shift_t": x, "shift_c": cache["shift_c"]}


def decode_rwkv_cmix(cfg: ModelConfig, p, x, cache):
    out = apply_rwkv_cmix(cfg, p, x, prev=cache["shift_c"])
    return out, dict(cache, shift_c=x)
