"""Where a served batch's time goes, on the card.

Takes the serving CLI's flags (``repro_torch.launch.serve``), runs one
warm-up ``generate`` and one cacheless prefill step, then times the
prefill, the ``--gen`` decode steps and the cacheless prefill step
(``steps.make_prefill_step``) without the profiler, then profiles each
again under ``torch.profiler``, and prints one JSON line with a
``prefill``, a ``decode`` (per token) and a ``prefill_step`` entry. Each
holds ``ms`` (host clock, ending in a synchronize) and the fields of
``repro_torch.launch.profile``'s breakdown: device busy time, idle share
against ``ms``, kernel groups (flash_attention, rglru_scan and
rwkv6_scan among them), top kernels and CPU ops. The decode is profiled
from a fresh prefill, since it consumes its cache. For rwkv6-7b the
serve prefill takes the chunked WKV and the prefill step the
``rwkv6_scan`` kernel. An audio or vlm arch gets the serving CLI's
frames (``serve.frames``) in each of the three.

Example (one card):
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      --arch recurrentgemma-2b --batch 4 --prompt-len 3072 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      --arch rwkv6-7b --batch 4 --prompt-len 2048 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      --arch whisper-small --batch 16 --prompt-len 384 --gen 8
"""
from __future__ import annotations

import json
import time

import torch

from repro_torch.launch import serve, steps
from repro_torch.launch.profile import _breakdown, _profiler


def phases(cfg, params, prompt, extra, gen: int) -> dict:
    """The three profiled units, each (units, fn, takes_prefill): the
    serve prefill, ``gen`` decode steps (``fn`` takes a fresh prefill's
    (logits, cache), which it consumes) and the cacheless prefill step,
    each given the batch's frames ``extra``."""
    prefill_step = steps.make_prefill_step(cfg)

    def prefill():
        return serve.prefill(cfg, params, prompt, max_len=gen,
                             batch_extra=extra)

    def decode(logits, cache):
        return serve.decode(cfg, params, logits, cache, max_len=gen)

    def step():
        return prefill_step(params, {"tokens": prompt, **extra})

    return {"prefill": (1, prefill, False), "decode": (gen, decode, True),
            "prefill_step": (1, step, False)}


def main(argv=None):
    """Profile serving (module note); returns the printed dict."""
    ap = serve.make_parser()
    args = ap.parse_args(argv)
    cfg, params, prompt, extra = serve.setup(args, ap)
    if prompt.device.type != "cuda":
        ap.error("the profile reads device time: run it on a CUDA device")
    gen = args.gen
    units = phases(cfg, params, prompt, extra, gen)
    serve.generate(cfg, params, prompt, max_len=gen,
                   batch_extra=extra)  # warm-up
    units["prefill_step"][1]()
    prefill = units["prefill"][1]

    out = {"arch": cfg.name, "batch": args.batch, "prompt": args.prompt_len,
           "gen": gen, "device": torch.cuda.get_device_name(0)}
    for phase, (n, fn, takes_prefill) in units.items():
        arg = prefill() if takes_prefill else ()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*arg)
        torch.cuda.synchronize()
        unit_us = (time.perf_counter() - t0) * 1e6 / n
        arg = prefill() if takes_prefill else ()
        torch.cuda.synchronize()
        with _profiler() as prof:
            fn(*arg)
            torch.cuda.synchronize()
        out[phase] = {"ms": unit_us / 1e3, **_breakdown(prof, n, unit_us)}
        del arg
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
