"""Where a training step's time goes, on the card.

Takes the training CLI's flags (``repro_torch.launch.train``; the fault
flags too, so a step under ``--faults`` is profiled the same way, and
``--tree-engine`` / ``--no-fused-opt`` for the engine's carries), runs
``--warmup`` steps, times ``--profile-steps`` more without the profiler,
then profiles as many again under ``torch.profiler`` (CPU + CUDA
activities) and prints one JSON line. Give ``--profile-steps`` a
multiple of the averaging period, so both windows hold the same events.

- ``step_ms``: host clock per unprofiled step, ending in a synchronize;
  ``profiled_step_ms`` the same under the profiler, which slows the host
  several-fold and so is not a step time;
- ``device_busy_ms`` / ``idle_share``: the union of kernel intervals per
  profiled step (kernel durations are not slowed by the profiler), and
  the share of the unprofiled step with no kernel running;
- ``by_group_ms``: kernel time per step grouped as flash_attention /
  rglru_scan / rwkv6_scan / opt_step / avg_disp / mix_disp / avg_disp_outer /
  compressed_mix / matmul / copy / other (elementwise, reductions,
  softmax);
- ``top_kernels`` and ``top_cpu_ops``: the ten largest by time per step.

Example (one card):
  PYTHONPATH=src python -m repro_torch.launch.profile --arch smollm-360m \
      --workers 4 --avg periodic --phase-len 2 --warmup 2 --profile-steps 2
"""
from __future__ import annotations

import json
import time
from collections import defaultdict

import torch

from repro_torch.launch import train

GROUPS = (("flash_attention", ("flash_fwd",)),
          ("rglru_scan", ("rglru_scan_cols",)),
          ("rwkv6_scan", ("rwkv6_chunk_mma",)),
          ("opt_step", ("opt_step_cols",)),
          ("avg_disp", ("avg_disp_cols",)),
          ("mix_disp", ("mix_disp_cols",)),
          ("avg_disp_outer", ("avg_disp_outer_cols",)),
          ("compressed_mix", ("row_stats", "row_scales", "emit_cols")),
          ("dispersion_sum", ("sum_partials",)),
          ("matmul", ("gemm", "sm90", "sm80", "cutlass", "xmma", "cublas",
                      "nvjet")),
          ("copy", ("memcpy", "memset", "copy", "cat")))


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def _device_time(e) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(e, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def main(argv=None):
    ap = train.make_parser()
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--profile-steps", type=int, default=2)
    args = ap.parse_args(argv)
    n = args.profile_steps
    args.steps = args.warmup + 2 * n
    _, engine, params, batches = train.setup(args, ap)
    if engine._dev.type != "cuda":
        ap.error("the profile reads device time: run it on a CUDA device")
    data = batches()
    prefetch = not args.no_prefetch
    _, _, state = engine.run(params, data, num_workers=args.workers,
                             seed=args.seed, steps=args.warmup,
                             record_every=1, prefetch=prefetch,
                             return_state=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, state = engine.run(None, data, num_workers=args.workers, steps=n,
                             state=state, record_every=1, prefetch=prefetch,
                             return_state=True)
    torch.cuda.synchronize()
    step_us = (time.perf_counter() - t0) * 1e6 / n
    with _profiler() as prof:
        t0 = time.perf_counter()
        _, hist, state = engine.run(None, data, num_workers=args.workers,
                                    steps=n, state=state, record_every=1,
                                    prefetch=prefetch, return_state=True)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out = {
        "arch": args.arch, "workers": args.workers, "batch": args.batch,
        "seq": args.seq, "avg": args.avg, "topology": args.topology,
        "comm_dtype": args.comm_dtype, "kernel_impl": args.kernel_impl,
        "carry": ("tree" if args.tree_engine else
                  "flat" if args.no_fused_opt else "flat_native"),
        "prefetch": prefetch, "profiled_steps": n,
        "averages": hist["averages"],
        "device": torch.cuda.get_device_name(0),
        "step_ms": step_us / 1e3,
        "profiled_step_ms": wall_us / n / 1e3,
        **_breakdown(prof, n, step_us),
    }
    print(json.dumps(out), flush=True)
    return out


def _profiler():
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def _breakdown(prof, n: int, unit_us: float) -> dict:
    """Device busy time, idle share against ``unit_us`` (an unprofiled
    step, prefill or token), kernels, kernel groups and the top kernels
    and CPU ops, each per one of the ``n`` profiled units."""
    kernels, spans = defaultdict(float), []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] += _device_time(e)
            spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    groups = defaultdict(float)
    for name, us in kernels.items():
        groups[_group(name)] += us
    cpu = sorted(((a.key, a.self_cpu_time_total) for a in
                  prof.key_averages()), key=lambda kv: -kv[1])[:10]
    return {
        "device_busy_ms": busy / n / 1e3,
        "idle_share": (1.0 - busy / n / unit_us) if spans else None,
        "kernels_per_step": len(spans) / n,
        "by_group_ms": {k: v / n / 1e3 for k, v in
                        sorted(groups.items(), key=lambda kv: -kv[1])},
        "top_kernels": [(k[:80], v / n / 1e3) for k, v in
                        sorted(kernels.items(), key=lambda kv: -kv[1])[:10]],
        "top_cpu_ops": [(k[:80], v / n / 1e3) for k, v in cpu],
    }


if __name__ == "__main__":
    main()
