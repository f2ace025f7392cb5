"""Step functions of the serving path: the counterparts of
``repro.launch.steps.make_prefill_step`` and ``make_decode_step``. (The
reference's mesh, abstract-input and phase-step machinery is not on
this path.)"""
from __future__ import annotations

from repro_torch.configs import ModelConfig
from repro_torch.models import transformer as tfm


def make_prefill_step(cfg: ModelConfig, *, impl: str = "kernel"):
    """(params, batch) -> the last position's fp32 logits (B, V), through
    the cacheless full-sequence forward of the whole batch (its "audio"
    or "media" frames included): with ``impl="kernel"`` every
    mixer's kernel runs, ``rwkv6_scan`` included (the cache-capturing
    prefill of ``serve.prefill`` takes the chunked WKV instead)."""
    def prefill_step(params, batch):
        return tfm.forward(cfg, params, batch, impl=impl)[:, -1]
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """(params, tokens (B, 1), cache) -> (logits (B, 1, V), new cache)."""
    def decode_step(params, tokens, cache):
        return tfm.decode_step(cfg, params, tokens, cache)
    return decode_step
