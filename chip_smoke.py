#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each printing one JSON line:
  1. card + build: the device, ``nvidia-smi`` name and power limit, and
     the build of every CUDA kernel under src/repro_torch/kernels/csrc/;
  2. kernels vs plain: ``opt_step`` and ``avg_disp`` against their plain
     PyTorch versions over the shape sweep of
     ``repro_torch.kernels.card_check`` and at full width (M=4 workers x
     P=361,821,120, smollm-360m), bitwise reproducible across two runs,
     timed with CUDA events beside their memory bound;
  3. the main path at full width: ``repro_torch.launch.train`` trains
     smollm-360m (bf16, 4 workers, Momentum) — periodic K=2 for 6 steps,
     then minibatch for 2 — with ``opt_step`` launched on every step;
  4. the f32 path: the paper's least-squares ``synth-ls-sparse-highrho``
     (4096 x 1024, 24 workers, SGD on lr0 / (t - 1 + d)) under periodic
     K=128 and hierarchical averaging, with ``avg_disp`` on every event;
     then small runs of both paths on the card and on the CPU (the
     kernels' plain versions), which must agree;
  5. summary: a ``kernels`` line, then ``{"ok": true, "device": ...}``
     as the last line.

Any failed check raises, so the script exits non-zero without the ``ok``
line; it also refuses to run without a CUDA device. All of its work
happens under ``if __name__ == "__main__"``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores
FULL_M, FULL_P = 4, 361_821_120
NSTATE = {"sgd": 0, "momentum": 1, "adamw": 2}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def steady_step_ms(phase_wall) -> float:
    """ms per step over every phase but the first, which warms up."""
    steady = phase_wall[1:]
    return 1e3 * sum(w for *_, w in steady) / sum(
        t1 - t0 + 1 for t0, t1, _ in steady)


def opt_step_cost(m, p, kind, has_codes):
    """(bytes, flops): x, g and the S state planes read once, the codes
    row read once, x and the state planes written once; per element the
    update (sgd 2, momentum 4, adamw 14 flops) plus 4 for the column sum
    and the dispersion term."""
    s = NSTATE[kind]
    nbytes = (2 + s) * m * p * 4 + (p * 4 if has_codes else 0) \
        + (1 + s) * m * p * 4
    per = {"sgd": 2, "momentum": 4, "adamw": 14}[kind] + 4
    return nbytes, per * m * p


def avg_disp_cost(m, p):
    """(bytes, flops): the plane read once, the output written once; a
    sum, a difference, a square and an add per element."""
    return 2 * m * p * 4, 4 * m * p


def main() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script runs only on a CUDA device")
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.kernels import card_check as cc
    from repro_torch.kernels import ref
    from repro_torch.kernels.avg_disp import avg_disp
    from repro_torch.kernels.opt_step import opt_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind_name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]

    # ---- 1. card and build -------------------------------------------------
    print(smi, flush=True)
    t0 = time.perf_counter()
    info = _build.build_all()
    emit({"phase": "build", "device": kind_name,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "build_s": time.perf_counter() - t0, "built": info["built"],
          "ptxas": info.get("ptxas", {})})

    # ---- 2. kernels against their plain versions ---------------------------
    # the sweep and its criteria: repro_torch.kernels.card_check
    n_cases, err = cc.sweep(dev)

    def cuda_time(fn, iters):
        """ms per call of ``fn`` with CUDA events, after one warm-up."""
        fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    full = {}
    kw_full = dict(kind="momentum", mu=0.9)
    x, g, st, scal, codes = cc.make_inputs(dev, FULL_M, FULL_P, "momentum",
                                           "bf16", seed=7, scale=1e-3)
    for mode in ("none", "mean"):
        kw = dict(kw_full, mode=mode)
        e, disp = cc.check_opt_step(f"opt_step/full-momentum-bf16-{mode}",
                                    x, g, st, scal, codes, **kw)
        err["opt_step"] = max(err["opt_step"], e)
        torch.cuda.empty_cache()
        xk, sk = x.clone(), tuple(s.clone() for s in st)
        k_ms = cuda_time(lambda: opt_step(xk, g, sk, scal, codes=codes,
                                          **kw), 10)
        del xk, sk
        torch.cuda.empty_cache()
        p_ms = cuda_time(lambda: ref.opt_step_ref(x, g, st, scal,
                                                  codes=codes, **kw), 3)
        torch.cuda.empty_cache()
        nb, fl = opt_step_cost(FULL_M, FULL_P, "momentum", True)
        b_ms, b_by = bound_ms(nb, fl)
        full[f"opt_step/{mode}"] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                        bound_by=b_by, bytes=nb, disp=disp)
    del g, st, codes
    torch.cuda.empty_cache()
    for grp in (1, 2):
        e = cc.check_avg_disp(f"avg_disp/full-g{grp}", x, grp)
        err["avg_disp"] = max(err["avg_disp"], e)
        torch.cuda.empty_cache()
        k_ms = cuda_time(lambda: avg_disp(x, groups=grp), 10)
        torch.cuda.empty_cache()
        p_ms = cuda_time(lambda: ref.avg_disp_ref(x, groups=grp), 3)
        torch.cuda.empty_cache()
        nb, fl = avg_disp_cost(FULL_M, FULL_P)
        b_ms, b_by = bound_ms(nb, fl)
        full[f"avg_disp/g{grp}"] = dict(ms=k_ms, plain_ms=p_ms,
                                        bound_ms=b_ms, bound_by=b_by,
                                        bytes=nb)
    del x
    torch.cuda.empty_cache()
    emit({"phase": "kernels_vs_plain", "sweep_cases": n_cases,
          "max_abs_err": err, "full_width": {"M": FULL_M, "P": FULL_P,
                                             **full},
          "card": smi})

    # ---- 3. the main path at full width (bf16 smollm-360m) ----------------
    from repro_torch.launch import train

    def train_run(argv, phase_len):
        """The CLI's run, with the loss recorded every step and phases of
        ``phase_len`` steps (None: the schedule's period), so that the
        first phase, which warms up, can be left out of the step time."""
        torch.cuda.reset_peak_memory_stats(dev)
        ap = train.make_parser()
        args = ap.parse_args(argv)
        _, engine, params, batches = train.setup(args, ap)
        t = time.perf_counter()
        final, hist, state = engine.run(
            params, batches(), num_workers=args.workers, seed=args.seed,
            record_every=1, phase_len=phase_len, return_state=True)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t
        return final, hist, state, wall

    opt_step.launches = avg_disp.launches = 0
    common = ["--arch", "smollm-360m", "--workers", "4", "--batch", "4",
              "--seq", "64", "--optimizer", "momentum", "--lr", "0.01",
              "--device", "cuda"]
    runs = {}
    for name, extra, phase_len, steps, events in (
            ("periodic", ["--avg", "periodic", "--phase-len", "2"], None, 6,
             3),
            ("minibatch", ["--avg", "minibatch"], 1, 2, 2)):
        n0 = opt_step.launches
        a0 = avg_disp.launches
        final, hist, state, wall = train_run(
            common + ["--steps", str(steps)] + extra, phase_len)
        losses = [v for _, v in hist["loss"]]
        check(len(losses) == steps and all(map(math.isfinite, losses)),
              f"{name}: losses {losses}")
        check(hist["averages"] == events,
              f"{name}: {hist['averages']} averaging ops, want {events}")
        check(opt_step.launches - n0 == steps,
              f"{name}: opt_step launched {opt_step.launches - n0} times "
              f"in {steps} steps")
        check(avg_disp.launches == a0,
              f"{name}: avg_disp launched on the bf16 path")
        plane = state.plane
        check(plane.shape == (FULL_M, FULL_P), f"plane {plane.shape}")
        on_grid = all(torch.equal(r, r.to(torch.bfloat16).float())
                      for r in plane)
        check(on_grid, f"{name}: plane left the bf16 grid")
        step_ms = steady_step_ms(hist["phase_wall"])
        runs[name] = dict(steps=steps, averages=hist["averages"],
                          loss_first=losses[0], loss_last=losses[-1],
                          opt_step_launches=opt_step.launches - n0,
                          step_ms=step_ms, wall_s=wall,
                          max_memory_gb=torch.cuda.max_memory_allocated(dev)
                          / 1e9)
        del final, hist, state, plane
        torch.cuda.empty_cache()
    emit({"phase": "main_path_bf16", "arch": "smollm-360m",
          "params": FULL_P, "workers": FULL_M, **runs, "card": smi})

    # ---- 4. the f32 path: the paper's least squares ------------------------
    from repro_torch.configs import get_config
    from repro_torch.configs.paper import CONVEX_SUITE
    from repro_torch.core import AveragingSchedule, PhaseEngine
    from repro_torch.data import convex_dataset, token_stream
    from repro_torch.models import init_params, lm_loss
    from repro_torch.optim import SGD, Momentum

    c = CONVEX_SUITE[0]
    check(c.name == "synth-ls-sparse-highrho", c.name)
    X, y, _ = convex_dataset(c.model, c.num_samples, c.num_dims,
                             sparsity=c.sparsity, noise=c.noise, seed=0)
    lr_d = 200.0
    lr0 = 0.8 * lr_d / float(np.mean(np.sum(X * X, axis=1)))
    opt = SGD(lr=lambda t: lr0 / (t - 1.0 + lr_d))
    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)

    def ls_loss(p, b, r):
        return 0.5 * torch.square(b["x"] @ p["w"] - b["y"]), {}

    def objective(w):
        res = Xd @ w.to(dev) - yd
        return float(0.5 * torch.mean(res * res))

    def convex_run(sched, steps, device):
        idx = np.random.default_rng(1).integers(
            0, c.num_samples, (steps, c.num_workers))
        Xs, ys = Xd.to(device), yd.to(device)
        data = ({"x": Xs[idx[t]], "y": ys[idx[t]]} for t in range(steps))
        eng = PhaseEngine(ls_loss, opt, sched, device=device)
        w0 = {"w": torch.zeros(c.num_dims, device=device)}
        return eng.run(w0, data, num_workers=c.num_workers, seed=0,
                       record_every=1, return_state=True)

    hier = AveragingSchedule("hierarchical", inner_groups=4,
                             inner_phase_len=8, outer_phase_len=32)
    f32 = {}
    for name, sched, steps, events in (
            ("periodic", AveragingSchedule("periodic", phase_len=128), 256,
             2),
            ("hierarchical", hier, 64, 8)):
        n0, a0 = opt_step.launches, avg_disp.launches
        final, hist, _ = convex_run(sched, steps, "cuda")
        losses = [v for _, v in hist["loss"]]
        check(all(map(math.isfinite, losses)), f"{name}: losses")
        check(hist["averages"] == events,
              f"{name}: {hist['averages']} events, want {events}")
        check(avg_disp.launches - a0 == events,
              f"{name}: avg_disp launched {avg_disp.launches - a0} times "
              f"for {events} events")
        check(opt_step.launches - n0 == steps, f"{name}: opt_step count")
        f0, f1 = objective(torch.zeros(c.num_dims)), objective(final["w"])
        check(f1 < f0, f"{name}: objective {f0} -> {f1}")
        f32[name] = dict(steps=steps, events=hist["averages"],
                         avg_disp_launches=avg_disp.launches - a0,
                         opt_step_launches=opt_step.launches - n0,
                         objective_start=f0, objective_end=f1,
                         step_ms=steady_step_ms(hist["phase_wall"]))
    launches = {"opt_step": opt_step.launches,
                "avg_disp": avg_disp.launches}

    # the same runs on the CPU (the kernels' plain versions) as reference
    final_c, hist_c, _ = convex_run(hier, 64, "cpu")
    final_g, hist_g, _ = convex_run(hier, 64, "cuda")
    check([t for t, _ in hist_c["dispersion"]]
          == [t for t, _ in hist_g["dispersion"]], "event steps cuda vs cpu")
    np.testing.assert_allclose(final_g["w"].cpu().numpy(),
                               final_c["w"].numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose([v for _, v in hist_g["loss"]],
                               [v for _, v in hist_c["loss"]], rtol=1e-4,
                               atol=1e-7)
    # the LM path at a small size: CPU-initialized f32 params, the same
    # batches, on the card and on the CPU
    rcfg = dataclasses.replace(get_config("smollm-360m", reduced=True),
                               dtype="float32")
    rparams = init_params(rcfg, 0, device="cpu")
    streams = [token_stream(rcfg.vocab_size, 2, 16, seed=i)
               for i in range(4)]
    rbatches = [{"tokens": np.stack([next(st) for st in streams])}
                for _ in range(4)]

    def lm_run(device):
        eng = PhaseEngine(lambda p, b, r: lm_loss(rcfg, p, b),
                          Momentum(lr=0.01, mu=0.9),
                          AveragingSchedule("periodic", phase_len=2),
                          device=device)
        return eng.run(rparams, iter(rbatches), num_workers=4, seed=0,
                       record_every=1)

    (lm_g, hl_g), (lm_c, hl_c) = lm_run("cuda"), lm_run("cpu")
    check(hl_g["averages"] == hl_c["averages"] == 2, "reduced LM events")
    np.testing.assert_allclose([v for _, v in hl_g["loss"]],
                               [v for _, v in hl_c["loss"]], rtol=1e-4)
    for a, b in zip(torch.utils._pytree.tree_leaves(lm_g),
                    torch.utils._pytree.tree_leaves(lm_c)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4)
    emit({"phase": "f32_path", "config": c.name, "samples": c.num_samples,
          "dims": c.num_dims, "workers": c.num_workers, **f32,
          "cuda_vs_cpu": {"ls_hierarchical_64": "rtol 1e-4",
                          "reduced_lm_periodic_4": "rtol 1e-4 / atol 1e-4"},
          "card": smi})

    # ---- 5. summary --------------------------------------------------------
    o, a = full["opt_step/none"], full["avg_disp/g1"]
    emit({"kernels": [
        {"name": "opt_step", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/opt_step.cu",
         "replaces": "src/repro/kernels/opt_step.py:185",
         "launches": launches["opt_step"], "max_abs_err": err["opt_step"],
         "ms": o["ms"], "plain_ms": o["plain_ms"], "bound_ms": o["bound_ms"],
         "bound_by": o["bound_by"], "library_ms": None},
        {"name": "avg_disp", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/avg_disp.cu",
         "replaces": "src/repro/kernels/avg_disp.py:156",
         "launches": launches["avg_disp"], "max_abs_err": err["avg_disp"],
         "ms": a["ms"], "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
         "bound_by": a["bound_by"], "library_ms": None}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind_name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
