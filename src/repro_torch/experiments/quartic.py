"""Paper §2.4 quartic example: f(w) = (w²-1)², ∇f̃ = 4(w³-w+u).
The paper reports (24 workers, α=.025, 10000 steps): one-shot 0.922,
0.1% averaging 0.274, 10% averaging 0.011.

The port of ``benchmarks/bench_quartic.py``. The noise ``u`` is
``rng.normal(PRNGKey(seed), (steps, workers))``, the reference's
``jax.random.normal`` draw within a few float32 ulps. Every averaging
fraction sees the same ``u``, so the fractions run together as the rows
of one (fractions, workers) float32 tensor: each step is one set of
launches for all of them, and each row is its fraction's run, with the
reference's update and its ``where`` on the row's averaging steps.

    python -m repro_torch.experiments.quartic [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import rng
from repro_torch.configs.paper import QuarticConfig
from repro_torch.device import resolve_device
from repro_torch.experiments.common import cli, emit, save, timeit


def _period(frac) -> int:
    return 0 if frac == 0 else max(1, int(round(1.0 / frac)))


def run_quartic(cfg: QuarticConfig, avg_fracs, seed=0, *, device="cuda",
                u=None):
    """[{"avg_frac", "objective"}] for each fraction, as the reference's.
    ``u``: a (steps, workers) array to use in place of the seed's draw
    (tests feed the reference's own)."""
    dev = resolve_device(device)
    shape = (cfg.num_steps, cfg.num_workers)
    if u is None:
        u = rng.normal(rng.PRNGKey(seed), shape, device=dev)
    else:
        u = torch.tensor(np.asarray(u, np.float32), device=dev)
        if tuple(u.shape) != shape:
            raise ValueError(f"u must be {shape}, got {tuple(u.shape)}")
    periods = [_period(f) for f in avg_fracs]
    # the rows that average at each step, known on the host; one (rows, 1)
    # mask on the device for each distinct set of them
    events = {t: tuple(bool(k) and t % k == 0 for k in periods)
              for t in range(1, cfg.num_steps + 1)}
    masks = {rows: torch.tensor(rows, device=dev)[:, None]
             for rows in set(events.values()) if any(rows)}
    alpha = float(np.float32(cfg.alpha))
    w = torch.zeros(len(periods), cfg.num_workers, device=dev)
    for t in range(1, cfg.num_steps + 1):
        g = 4.0 * (w * w * w - w + u[t - 1])
        w = w - alpha * g
        mask = masks.get(events[t])
        if mask is not None:
            w = torch.where(mask, torch.mean(w, dim=1, keepdim=True), w)
    wbar = torch.mean(w, dim=1).tolist()
    return [{"avg_frac": frac, "objective": float((wb ** 2 - 1.0) ** 2)}
            for frac, wb in zip(avg_fracs, wbar)]


def run(device="cuda"):
    cfg = QuarticConfig()
    dt, rows = timeit(lambda: run_quartic(cfg, [0.0, 0.001, 0.01, 0.1],
                                          device=device), reps=1)
    save("bench_quartic", {"rows": rows,
                           "paper": {"oneshot": 0.922, "0.001": 0.274,
                                     "0.1": 0.011}})
    d = {r["avg_frac"]: r["objective"] for r in rows}
    emit("quartic_nonconvex", dt,
         f"oneshot={d[0.0]:.3f};avg0.1%={d[0.001]:.3f};avg10%={d[0.1]:.3f}")


if __name__ == "__main__":
    cli(run, description=__doc__.split("\n\n")[0])
