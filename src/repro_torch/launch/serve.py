"""Serving CLI: batched decoding with per-layer KV / recurrent-state
caches — the counterpart of ``repro.launch.serve``.

A true prefill (one full-sequence forward that captures the decode
cache) gives the first token, then auto-regressive decode gives the
rest: greedy, or with ``--sample`` drawn as ``jax.random.categorical``
draws it (argmax of the logits plus Gumbel noise from threefry keys
split once per step, ``repro_torch.rng``). The prefill takes the
reference's dispatch with ``impl="kernel"``: attention runs the
``flash_attention`` kernel and RG-LRU the ``rglru_scan`` kernel, while
RWKV6 captures its state through the chunked WKV and launches no kernel
(``rwkv6_scan`` runs in the cacheless prefill step,
``steps.make_prefill_step``); decode is plain PyTorch, as the reference's
decode is plain jnp. An audio config (whisper-small) runs its encoder
over ``batch_extra["audio"]`` frames in the prefill, its self-attention
unmasked through the same kernel, and a vlm config cross-attends to
``batch_extra["media"]``; the CLI draws either as the reference's CLI
does, standard normal times 0.3 (``frames``), and cross-attention takes
the einsum path. Runs on CUDA unless ``--device cpu``, where the
kernels' plain versions run.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \\
      --batch 4 --prompt-len 8 --gen 24
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
      --batch 4 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \\
      --batch 16 --prompt-len 384 --gen 64
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import rng
from repro_torch.configs import ARCHS, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_decode_step
from repro_torch.models import forward, init_params

_TINY = float(np.finfo(np.float32).tiny)


def categorical(key, logits):
    """``jax.random.categorical(key, logits)`` over the last axis (its
    default "low" Gumbel mode): argmax(logits + g), g = -log(-log(u)),
    u the float32 uniform on [tiny, 1) of ``jax.random.uniform``."""
    u = rng.uniform(key, tuple(logits.shape), device=logits.device)
    u = torch.clamp(u * (1.0 - _TINY) + _TINY, min=_TINY)
    return torch.argmax(-torch.log(-torch.log(u)) + logits, dim=-1)


def prefill(cfg, params, prompt, *, max_len: int, impl: str = "kernel",
            batch_extra=None):
    """prompt: (B, P) int. One full-sequence forward with cache capture
    (the cache sized P + max_len; ``impl`` as ``models.forward`` takes
    it), ``batch_extra`` ({"audio": frames} or {"media": embeddings}, as
    the config's family needs) added to its batch. Returns (the last
    position's logits (B, 1, V), cache)."""
    plen = prompt.shape[1]
    logits, cache = forward(cfg, params, {"tokens": prompt,
                                          **(batch_extra or {})},
                            impl=impl, return_cache=True,
                            cache_len=plen + max_len)
    # a copy, so that the full (B, P, V) logits are freed on return
    return logits[:, -1:].clone(), cache


def decode(cfg, params, logits, cache, *, max_len: int, greedy: bool = True,
           seed: int = 0):
    """From the prefill's last logits and cache: ``max_len`` tokens (B,
    max_len), the first the prefill's argmax, each next one from a
    decode step. Consumes ``cache``: its attention K/V tensors are
    written in place (``decode_step``)."""
    step = make_decode_step(cfg)
    key = rng.PRNGKey(seed)
    tok = torch.argmax(logits[:, -1], -1, keepdim=True)
    out = []
    for _ in range(max_len):
        out.append(tok[:, 0])
        logits, cache = step(params, tok, cache)
        if greedy:
            tok = torch.argmax(logits[:, -1], -1, keepdim=True)
        else:
            key, sub = rng.split(key)
            tok = categorical(sub, logits[:, -1])[:, None]
    return torch.stack(out, dim=1)


def generate(cfg, params, prompt, *, max_len: int, greedy: bool = True,
             seed: int = 0, impl: str = "kernel", batch_extra=None):
    """prompt: (B, P) int -> (B, max_len) tokens: :func:`prefill` (with
    ``batch_extra``) then :func:`decode`, the production path."""
    logits, cache = prefill(cfg, params, prompt, max_len=max_len, impl=impl,
                            batch_extra=batch_extra)
    return decode(cfg, params, logits, cache, max_len=max_len,
                  greedy=greedy, seed=seed)


def frames(cfg, batch: int, seed: int, device) -> dict:
    """The stubbed frontend's input the config's family needs, drawn on
    ``device`` from ``seed`` in the config's dtype: {"audio": (B,
    encoder_seq, d)} for audio, {"media": (B, num_media_tokens, d)} for
    vlm, standard normal times 0.3 (the reference CLI's scale); {} for
    the other families."""
    if cfg.family == "audio":
        name, n = "audio", cfg.encoder_seq
    elif cfg.family == "vlm":
        name, n = "media", cfg.num_media_tokens
    else:
        return {}
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((batch, n, cfg.d_model), generator=gen, device=dev)
    return {name: (x * 0.3).to(getattr(torch, cfg.dtype))}


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=ARCHS)
    ap.add_argument("--reduced", action="store_true",
                    help="2-layer, d_model 256 variant in float32")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--sample", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda by default; cpu runs the "
                         "kernels' plain versions)")
    return ap


def setup(args, ap):
    """The run ``args`` asks for (``ap.error`` without its device, or
    with a prompt and continuation past the config's ``max_seq_len``):
    (config, random params, random prompt (B, P), the batch's frames
    (:func:`frames`)), all drawn from ``--seed``."""
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(f"--device {args.device}: {e}")
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.reduced:
        cfg = dataclasses.replace(cfg, dtype="float32")
    if args.prompt_len + args.gen > cfg.max_seq_len:
        ap.error(f"--prompt-len {args.prompt_len} + --gen {args.gen} runs "
                 f"past {cfg.name}'s max_seq_len of {cfg.max_seq_len}")
    params = init_params(cfg, args.seed, device=device)
    gen = torch.Generator().manual_seed(args.seed)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen).to(device)
    return cfg, params, prompt, frames(cfg, args.batch, args.seed, device)


def main(argv=None):
    """Parse ``argv``, serve one batch of random prompts from random
    weights (both from ``--seed``), print the ``[serve]`` lines. Returns
    the generated tokens (B, gen)."""
    ap = make_parser()
    args = ap.parse_args(argv)
    cfg, params, prompt, extra = setup(args, ap)

    t0 = time.time()
    toks = generate(cfg, params, prompt, max_len=args.gen,
                    greedy=not args.sample, seed=args.seed,
                    batch_extra=extra)
    toks = toks.cpu()  # waits for the device
    dt = time.time() - t0
    print(f"[serve] {cfg.name}: batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} in {dt:.1f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print(f"[serve] sample output ids: {toks[0][:12].tolist()}")
    if int(toks.max()) >= cfg.vocab_size:  # padded vocab never sampled
        raise RuntimeError(f"token {int(toks.max())} beyond the vocabulary "
                           f"({cfg.vocab_size})")
    return toks


if __name__ == "__main__":
    main()
