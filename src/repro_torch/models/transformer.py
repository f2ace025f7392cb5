"""Dense decoder-only transformer: init, full-sequence forward and the
next-token loss — the ``attn`` + dense-FFN blocks of
``repro.models.transformer``, over the same nested-dict params layout
(so params convert 1:1, see ``repro_torch.convert``). Other mixers
(recurrent, rwkv, moe, cross-attention) are not ported yet and raise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L


def _check_ported(cfg: ModelConfig) -> None:
    for spec in cfg.layers:
        if spec.mixer not in ("attn", "attn_local") or spec.ffn != "dense" \
                or spec.cross_attn:
            raise NotImplementedError(
                f"layer {spec} is not ported yet: repro_torch runs dense "
                "attention blocks (ROADMAP queue 1, item 18)")
    if cfg.encoder_layers or cfg.family in ("audio", "vlm"):
        raise NotImplementedError("encoder / media stacks are not ported")


def _init_block(cfg: ModelConfig, gen, device):
    return {"norm1": L.init_norm(cfg, device),
            "mixer": attn_mod.init_attn(cfg, gen, device),
            "norm2": L.init_norm(cfg, device),
            "ffn": L.init_mlp(cfg, gen, device)}


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda"):
    """Random params in the config's dtype, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    _check_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {
        "embed": L.init_embed(cfg, gen, dev),
        "final_norm": L.init_norm(cfg, dev),
        "layers": [_init_block(cfg, gen, dev) for _ in cfg.layers],
    }


def _apply_block(cfg: ModelConfig, spec: LayerSpec, p, x):
    h = L.apply_norm(cfg, p["norm1"], x)
    x = x + attn_mod.attention(cfg, p["mixer"], h, layer=spec)
    h = L.apply_norm(cfg, p["norm2"], x)
    return x + L.apply_mlp(cfg, p["ffn"], h)


def forward(cfg: ModelConfig, params, batch):
    """batch: {"tokens": (B, S) int}. Returns fp32 logits (B, S, V)."""
    _check_ported(cfg)
    x = L.embed(cfg, params["embed"], batch["tokens"])
    for spec, p in zip(cfg.layers, params["layers"]):
        x = _apply_block(cfg, spec, p, x)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return L.unembed(cfg, params["embed"], x)


def lm_loss(cfg: ModelConfig, params, batch):
    """Next-token cross-entropy; labels default to the shifted tokens,
    positions with label < 0 are masked. Returns (loss, metrics)."""
    logits = forward(cfg, params, batch)
    tokens = batch["tokens"]
    if "labels" in batch:
        labels = batch["labels"]
    else:
        labels = F.pad(tokens[:, 1:], (0, 1), value=-1)
    mask = (labels >= 0).float()
    labels_c = torch.clamp(labels, 0, cfg.padded_vocab - 1).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels_c[..., None])[..., 0]
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return loss, {"ce": loss}
