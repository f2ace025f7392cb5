"""Model assembly: block stacks of dense attention, local (sliding-window)
attention, RG-LRU and RWKV6 time-mix mixers (or none) with dense,
mixture-of-experts or RWKV channel-mix FFNs (or none), cross-attention
sublayers over an encoder's output (whisper) or a vision stub's
embeddings (the VLM), and the encoder stack; init, the full-sequence
forward (training, and prefill with cache capture), the next-token loss
(with the MoE auxiliary losses) and single-token decode with per-layer
caches — the counterpart of ``repro.models.transformer``, over the same
nested-dict params layout (so params convert 1:1, see
``repro_torch.convert``).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import rng
from repro_torch.configs import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec_mod
from repro_torch.models import rwkv as rwkv_mod

#: compute paths of the full-sequence forward: the reference's "xla" and
#: "pallas"
IMPLS = ("plain", "kernel")
#: the encoder's blocks: unmasked self-attention and a dense FFN
ENCODER_SPEC = LayerSpec(mixer="attn", causal=False)


def _init_block(cfg: ModelConfig, spec: LayerSpec, key, device):
    # the reference's four keys: mixer, cross-attention, FFN (one unused)
    ks = rng.split(key, 4)
    p = {"norm1": L.init_norm(cfg, device)}
    if spec.mixer in ("attn", "attn_local"):
        p["mixer"] = attn_mod.init_attn(cfg, ks[0], device)
    elif spec.mixer == "rglru":
        p["mixer"] = rec_mod.init_rglru(cfg, ks[0], device)
    elif spec.mixer == "rwkv":
        p["mixer"] = rwkv_mod.init_rwkv(cfg, ks[0], device)
    if spec.cross_attn:
        p["norm_cross"] = L.init_norm(cfg, device)
        p["cross"] = attn_mod.init_attn(cfg, ks[1], device, cross=True)
    p["norm2"] = L.init_norm(cfg, device)
    if spec.ffn == "dense":
        p["ffn"] = L.init_mlp(cfg, ks[2], device)
    elif spec.ffn == "moe":
        p["ffn"] = moe_mod.init_moe(cfg, ks[2], device)
    elif spec.ffn == "rwkv_cmix":
        p["ffn"] = rwkv_mod.init_rwkv_cmix(cfg, ks[2], device)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda"):
    """Random params in the config's dtype (RG-LRU ``lam``, RWKV ``w0``,
    ``u`` and ``ln_out`` in float32) on ``device``: the reference's
    ``init_params(cfg, PRNGKey(seed))``, split for split (the encoder's
    blocks from the keys after the decoder's), drawn with
    :mod:`repro_torch.rng` (within a few float32 ulps of its draws)."""
    dev = resolve_device(device)
    ks = rng.split(rng.PRNGKey(seed), cfg.num_layers + cfg.encoder_layers
                   + 2)
    params = {
        "embed": L.init_embed(cfg, ks[0], dev),
        "final_norm": L.init_norm(cfg, dev),
        "layers": [_init_block(cfg, spec, ks[1 + i], dev)
                   for i, spec in enumerate(cfg.layers)],
    }
    if cfg.encoder_layers:
        params["encoder"] = {
            "layers": [_init_block(cfg, ENCODER_SPEC,
                                   ks[1 + cfg.num_layers + i], dev)
                       for i in range(cfg.encoder_layers)],
            "final_norm": L.init_norm(cfg, dev),
        }
    return params


# --------------------------------------------------------------------------
# Full-sequence block / forward (train & prefill)
# --------------------------------------------------------------------------

def _apply_block(cfg: ModelConfig, spec: LayerSpec, p, x, memory, impl,
                 capture: int = 0):
    """Returns (x, aux, cache): aux the MoE FFN's auxiliary losses ({}
    for the other FFNs), cache the decode cache of this block when
    capture > 0, with the attention K/V padded to ``capture`` positions
    (prefill) and a cross-attention block's memory K/V. An RWKV layer's
    mixer and channel mix share one cache dict."""
    cache, aux = {}, {}
    if spec.mixer != "none":
        h = L.apply_norm(cfg, p["norm1"], x)
        if spec.mixer == "rglru":
            if capture:
                h, cache["rglru"] = rec_mod.apply_rglru(
                    cfg, p["mixer"], h, impl=impl, return_state=True)
            else:
                h = rec_mod.apply_rglru(cfg, p["mixer"], h, impl=impl)
        elif spec.mixer == "rwkv":
            if capture:
                h, cache["rwkv"] = rwkv_mod.apply_rwkv(
                    cfg, p["mixer"], h, impl=impl, return_state=True)
            else:
                h = rwkv_mod.apply_rwkv(cfg, p["mixer"], h, impl=impl)
        elif capture:
            h, (k, v) = attn_mod.attention(cfg, p["mixer"], h, layer=spec,
                                           impl=impl, return_kv=True)
            pad = (0, 0, 0, 0, 0, capture - k.shape[1])
            cache["attn"] = {"k": F.pad(k, pad), "v": F.pad(v, pad)}
        else:
            h = attn_mod.attention(cfg, p["mixer"], h, layer=spec,
                                   impl=impl)
        x = x + h
    if spec.cross_attn:
        h = L.apply_norm(cfg, p["norm_cross"], x)
        h = attn_mod.attention(cfg, p["cross"], h, layer=spec, kv_x=memory,
                               impl=impl)
        if capture:
            cache["cross"] = attn_mod.cross_cache_from_memory(
                cfg, p["cross"], memory)
        x = x + h
    if spec.ffn == "none":
        return x, aux, cache
    h = L.apply_norm(cfg, p["norm2"], x)
    if spec.ffn == "rwkv_cmix":
        if capture:  # the channel mix's token shift: its last normed input
            cache.setdefault("rwkv", {})["shift_c"] = h[:, -1:]
        h = rwkv_mod.apply_rwkv_cmix(cfg, p["ffn"], h)
    elif spec.ffn == "moe":
        h, aux = moe_mod.apply_moe(cfg, p["ffn"], h)
    else:
        h = L.apply_mlp(cfg, p["ffn"], h)
    return x + h, aux, cache


def encode(cfg: ModelConfig, params, memory_embed, impl="plain"):
    """The encoder (whisper) over stubbed frame embeddings (B, T, d): its
    blocks' unmasked self-attention (the flash_attention kernel with
    ``impl="kernel"``) and dense FFNs, then its final norm; the input is
    cast to the compute dtype first."""
    x = memory_embed.to(L.cdtype(cfg))
    for p in params["encoder"]["layers"]:
        x, _, _ = _apply_block(cfg, ENCODER_SPEC, p, x, None, impl)
    return L.apply_norm(cfg, params["encoder"]["final_norm"], x)


def _get_memory(cfg: ModelConfig, params, batch, impl):
    """What cross-attention attends to: the encoder's output over
    ``batch["audio"]`` (family audio), ``batch["media"]`` in the compute
    dtype (family vlm), else None."""
    if cfg.family == "audio":
        return encode(cfg, params, batch["audio"], impl)
    if cfg.family == "vlm":
        return batch["media"].to(L.cdtype(cfg))
    return None


def _forward(cfg: ModelConfig, params, batch, impl, capture: int,
             remat: bool = False):
    """(fp32 logits (B, S, V), the MoE auxiliary losses summed over the
    layers — {"load_balance", "router_z"}, 0.0 without MoE layers, as the
    reference's forward sums them — and, where ``capture`` > 0, the
    decode cache). ``remat`` checkpoints each decoder block
    (``torch.utils.checkpoint``, non-reentrant: the block's activations
    are recomputed in the backward pass), the reference's per-block
    ``jax.checkpoint``; the same operations run, so losses and gradients
    are bitwise those without it."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {IMPLS}")
    if remat and capture:
        raise ValueError("prefill cache capture is a no-remat path")
    memory = _get_memory(cfg, params, batch, impl)
    tokens = batch["tokens"]
    x = L.embed(cfg, params["embed"], tokens)
    aux_sum = {"load_balance": 0.0, "router_z": 0.0}
    caches = []
    for spec, p in zip(cfg.layers, params["layers"]):
        if remat:
            # the block's static arguments bound by keyword: only the
            # params, the activations and the memory pass through
            block = functools.partial(_apply_block, cfg=cfg, spec=spec,
                                      impl=impl, capture=0)
            x, aux, c = checkpoint(block, p=p, x=x, memory=memory,
                                   use_reentrant=False)
        else:
            x, aux, c = _apply_block(cfg, spec, p, x, memory, impl, capture)
        caches.append(c)
        for k, v in aux.items():
            aux_sum[k] = aux_sum[k] + v
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.unembed(cfg, params["embed"], x)
    return logits, aux_sum, {"pos": tokens.shape[1], "layers": caches}


def forward(cfg: ModelConfig, params, batch, *, impl="plain",
            return_cache: bool = False, cache_len: int = 0):
    """batch: {"tokens": (B, S) int, and "audio" (B, T, d) frames for an
    audio config or "media" (B, T, d) embeddings for a vlm one}. Returns
    fp32 logits (B, S, V); with
    ``return_cache`` (prefill) also a decode cache sized ``cache_len``
    (>= S), ready for :func:`decode_step`. ``impl``: "plain" (einsum
    attention, the associative scan, the chunked WKV) or "kernel" (the
    flash_attention and rglru_scan kernels, and rwkv6_scan where no cache
    is captured: the cache-capturing prefill takes the chunked WKV, as the
    reference's does)."""
    capture = max(cache_len, batch["tokens"].shape[1]) if return_cache else 0
    logits, _, cache = _forward(cfg, params, batch, impl, capture)
    return (logits, cache) if return_cache else logits


def _requires_grad(params) -> bool:
    from repro_torch.core.flat import tree_flatten
    return any(isinstance(x, torch.Tensor) and x.requires_grad
               for x in tree_flatten(params)[0])


def lm_loss(cfg: ModelConfig, params, batch, *, impl: str = "plain",
            remat: bool = False):
    """Next-token cross-entropy, plus the MoE auxiliary losses where the
    config has experts (``router_aux_coef`` x load balance + 1e-3 x router
    z, each over the MoE layers); labels default to the shifted tokens,
    positions with label < 0 are masked. Returns (loss, metrics): the
    reference's dict, whose "ce" holds the loss with the auxiliary terms
    added, beside the summed "load_balance" and "router_z".

    ``remat`` checkpoints each block (:func:`_forward`). ``impl="kernel"``
    runs the forward through the kernels and is a forward-only loss: the
    kernels have no backward, as the reference's have none (``jax.grad``
    through its Pallas ``flash_attention`` or ``rglru_scan`` fails in
    ``_pallas_call_jvp_rule``), so a loss whose params require grad under
    grad mode is refused."""
    if (impl == "kernel" and torch.is_grad_enabled()
            and _requires_grad(params)):
        raise NotImplementedError(
            "lm_loss(impl='kernel') is forward-only: the kernels have no "
            "backward (the reference's Pallas kernels have none either: "
            "jax.grad through them fails in _pallas_call_jvp_rule) — "
            "train with impl='plain', or evaluate under torch.no_grad()")
    tokens = batch["tokens"]
    logits, aux, _ = _forward(cfg, params, batch, impl, 0, remat)
    if "labels" in batch:
        labels = batch["labels"]
    else:
        labels = F.pad(tokens[:, 1:], (0, 1), value=-1)
    mask = (labels >= 0).float()
    labels_c = torch.clamp(labels, 0, cfg.padded_vocab - 1).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels_c[..., None])[..., 0]
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    if cfg.num_experts:
        moe_layers = max(1, sum(1 for s in cfg.layers if s.ffn == "moe"))
        aux_loss = cfg.router_aux_coef * aux["load_balance"] / moe_layers \
            + 1e-3 * aux["router_z"] / moe_layers
        loss = loss + aux_loss
    return loss, {"ce": loss, **aux}


# --------------------------------------------------------------------------
# Decode (single token, per-layer caches)
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *, memory=None,
               params=None, device="cuda"):
    """The per-layer decode cache: {"pos": 0, "layers": [...]}, attention
    K/V of ``seq_len`` positions, RG-LRU state and conv history, RWKV wkv
    state and token-shift inputs (one dict for a layer's mixer and
    channel mix), and a cross-attention block's K/V projected from
    ``memory`` (B, T, d) — the encoder's output or the media embeddings —
    through ``params`` (as a serving runtime does at prefill)."""
    dt = L.cdtype(cfg)
    layers = []
    for i, spec in enumerate(cfg.layers):
        c = {}
        if spec.mixer in ("attn", "attn_local"):
            c["attn"] = attn_mod.init_attn_cache(cfg, batch, seq_len, dt,
                                                 device)
        elif spec.mixer == "rglru":
            c["rglru"] = rec_mod.init_rglru_cache(cfg, batch, dt, device)
        elif spec.mixer == "rwkv":
            c["rwkv"] = rwkv_mod.init_rwkv_cache(cfg, batch, dt, device)
        if spec.cross_attn:
            if memory is None or params is None:
                raise ValueError(f"layer {i} cross-attends: init_cache "
                                 "needs memory= and params=")
            c["cross"] = attn_mod.cross_cache_from_memory(
                cfg, params["layers"][i]["cross"], memory)
        if spec.ffn == "rwkv_cmix" and "rwkv" not in c:
            c["rwkv"] = rwkv_mod.init_rwkv_cache(cfg, batch, dt, device)
        layers.append(c)
    return {"pos": 0, "layers": layers}


def _decode_block(cfg: ModelConfig, spec: LayerSpec, p, x, cache, pos):
    if spec.mixer != "none":
        h = L.apply_norm(cfg, p["norm1"], x)
        if spec.mixer == "rglru":
            h, cache["rglru"] = rec_mod.decode_rglru(cfg, p["mixer"], h,
                                                     cache["rglru"])
        elif spec.mixer == "rwkv":
            h, cache["rwkv"] = rwkv_mod.decode_rwkv(cfg, p["mixer"], h,
                                                   cache["rwkv"])
        else:
            h, cache["attn"] = attn_mod.decode_attention(
                cfg, p["mixer"], h, cache["attn"], pos, layer=spec)
        x = x + h
    if spec.cross_attn:
        h = L.apply_norm(cfg, p["norm_cross"], x)
        x = x + attn_mod.decode_cross_attention(cfg, p["cross"], h,
                                                cache["cross"])
    if spec.ffn == "none":
        return x, cache
    h = L.apply_norm(cfg, p["norm2"], x)
    if spec.ffn == "rwkv_cmix":
        h, cache["rwkv"] = rwkv_mod.decode_rwkv_cmix(cfg, p["ffn"], h,
                                                    cache["rwkv"])
    elif spec.ffn == "moe":
        h, _ = moe_mod.apply_moe(cfg, p["ffn"], h)
    else:
        h = L.apply_mlp(cfg, p["ffn"], h)
    return x + h, cache


def decode_step(cfg: ModelConfig, params, tokens, cache):
    """tokens: (B, 1) int. Returns (logits (B, 1, V) fp32, new cache).
    The token sits at position ``cache["pos"]`` (its learned position,
    where the config learns them). The attention K/V are written into
    the given cache's tensors in place and the new cache shares them, so
    the given cache is consumed: a caller that decodes twice from one
    cache copies it first."""
    pos = cache["pos"]
    x = L.embed(cfg, params["embed"], tokens, pos_offset=pos)
    new_layers = []
    for spec, p, c in zip(cfg.layers, params["layers"], cache["layers"]):
        x, c = _decode_block(cfg, spec, p, x, dict(c), pos)
        new_layers.append(c)
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.unembed(cfg, params["embed"], x)
    return logits, {"pos": pos + 1, "layers": new_layers}
