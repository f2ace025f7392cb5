"""Paper Figure 2: normalized suboptimality vs iteration for one-shot /
periodic(128) / periodic(1024->scaled) / minibatch averaging + single
worker, on the convex suite; derived speedup@0.1 of periodic vs one-shot
(the paper's speedup column).

The port of ``benchmarks/bench_fig2_convex.py``. Every curve runs
through the :class:`~repro_torch.core.PhaseEngine` (on the card:
``opt_step`` once a step, ``avg_disp`` once a periodic event) with
shared per-step sample draws for a fair, paired comparison, as the paper
shuffles identically. The dataset is put on the device once; each
curve's :class:`~repro_torch.data.DeviceDataset` wraps those tensors and
its (steps, workers) index list, and the engine gathers the batches on
the device.

    python -m repro_torch.experiments.fig2_convex [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.paper import CONVEX_SUITE
from repro_torch.core import AveragingSchedule, PhaseEngine
from repro_torch.data import DeviceDataset, convex_dataset
from repro_torch.device import resolve_device
from repro_torch.experiments.common import cli, emit, save, timeit
from repro_torch.models.convex import lr_objective, ls_objective, solve_optimum
from repro_torch.optim import SGD


def _schedule(phase_len: int) -> AveragingSchedule:
    if phase_len == 0:
        return AveragingSchedule("oneshot")
    if phase_len == 1:
        return AveragingSchedule("minibatch")
    return AveragingSchedule("periodic", phase_len)


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def sgd_curves(kind, X, y, *, workers, steps, phase_lens, lr0, lr_d,
               seed=0, record_every=20, device="cuda"):
    """Engine-driven multi-schedule parallel SGD (shared sample draws for
    a fair, paired comparison, as the paper shuffles identically).
    Returns {name: [(step, normalized suboptimality)]} for each phase
    length and ``single``."""
    dev = resolve_device(device)
    # put the dataset on the device once for all schedules and worker
    # counts; each curve's DeviceDataset shares these tensors
    X, y = torch.as_tensor(X, device=dev), torch.as_tensor(y, device=dev)
    n, d = X.shape
    obj = {"ls": ls_objective, "lr": lr_objective}[kind]

    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(steps, workers))
    w0 = torch.zeros(d, device=dev)
    f0 = float(obj(w0, X, y))
    fstar = float(obj(solve_optimum(kind, X, y), X, y))

    def loss_fn(params, batch, rng_):
        w, x, yv = params["w"], batch["x"], batch["y"]
        if kind == "ls":
            return 0.5 * torch.square(x @ w - yv), {}
        return _softplus(-yv * (x @ w)), {}

    # the paper's lr schedule counts steps from 0; engine steps are
    # 1-indexed, hence the -1
    opt = SGD(lr=lambda t: lr0 / (t - 1.0 + lr_d))
    arrays = {"x": X, "y": y}

    def curve(schedule, m):
        engine = PhaseEngine(loss_fn, opt, schedule, device=str(dev))
        # paired draws: worker w of every schedule sees idx[:, w]
        ds = DeviceDataset(arrays, m, indices=idx[:, :m], device=dev)
        _, hist = engine.run({"w": w0}, ds, num_workers=m,
                             seed=seed, record_every=record_every,
                             eval_fn=lambda p: float(obj(p["w"], X, y)))
        return hist["eval"]

    curves = {}
    for k in phase_lens:
        name = {0: "oneshot", 1: "minibatch"}.get(k, f"periodic_{k}")
        curves[name] = curve(_schedule(k), workers)

    # single worker curve (worker 0's draws, no averaging)
    curves["single"] = curve(AveragingSchedule("oneshot"), 1)

    # normalize so f(w0)=1, f*=0
    span = max(f0 - fstar, 1e-12)
    for name in curves:
        curves[name] = [(t, (v - fstar) / span) for t, v in curves[name]]
    return curves


def _steps_to(curve, level):
    for t, v in curve:
        if v <= level:
            return t
    return float("inf")


def grid_curves(kind, X, y, *, workers=8, steps=3000,
                phase_lens=(0, 1, 128, 1024),
                lr_mults=(0.4, 0.8, 1.6, 3.0, 6.0), lr_d=200.0,
                device="cuda"):
    """The paper's protocol: grid-search the lr schedule and report, at
    each iteration, the minimum objective over the grid (per schedule).
    This is what surfaces the averaging speedup — frequent averaging
    tolerates (and exploits) aggressive step sizes that make independent
    workers diverge transiently."""
    X = torch.as_tensor(X, device=resolve_device(device))
    y = torch.as_tensor(y, device=X.device)
    meansq = float(torch.mean(torch.sum(X * X, dim=1)))
    best = None
    for mult in lr_mults:
        cur = sgd_curves(kind, X, y, workers=workers, steps=steps,
                         phase_lens=list(phase_lens),
                         lr0=mult * lr_d / meansq, lr_d=lr_d, device=device)
        if best is None:
            best = cur
        else:
            for name in cur:
                best[name] = [(t, min(a, b)) for (t, a), (_, b)
                              in zip(best[name], cur[name])]
    return best


def run(device="cuda"):
    all_out = {}
    total_us = 0.0
    for c in CONVEX_SUITE:
        n = min(c.num_samples, 2048)
        d = min(c.num_dims, 256)
        X, y, _ = convex_dataset(c.model, n, d, sparsity=c.sparsity,
                                 noise=c.noise, seed=0)
        dt, curves = timeit(lambda: grid_curves(c.model, X, y,
                                                device=device), reps=1)
        total_us += dt
        s_per = _steps_to(curves["periodic_128"], 0.1)
        s_one = _steps_to(curves["oneshot"], 0.1)
        speedup = s_one / s_per if np.isfinite(s_per) else float("inf")
        final_gap = (curves["oneshot"][-1][1] /
                     max(curves["periodic_128"][-1][1], 1e-15))
        all_out[c.name] = {"curves": curves, "speedup_at_0.1": speedup,
                           "final_subopt_ratio": final_gap}
    save("bench_fig2_convex", all_out)
    emit("fig2_convex_curves", total_us,
         ";".join(f"{k}:speedup@0.1={v['speedup_at_0.1']:.2f},"
                  f"final_ratio={v['final_subopt_ratio']:.1f}"
                  for k, v in all_out.items()))


if __name__ == "__main__":
    cli(run, description=__doc__.split("\n\n")[0])
