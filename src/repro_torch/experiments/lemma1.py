"""Paper §2.3 / Lemma 1: asymptotic variance of the worker average vs
averaging rate ζ — closed form against Monte-Carlo simulation.

The port of ``benchmarks/bench_lemma1.py``, over
:mod:`repro_torch.core.theory` (the simulation on the device, the closed
form in numpy).

    python -m repro_torch.experiments.lemma1 [--device cpu]
"""
from __future__ import annotations

import time

from repro_torch.configs.paper import QuadraticConfig
from repro_torch.core.theory import (lemma1_asymptotic_variance,
                                     simulate_quadratic)
from repro_torch.experiments.common import cli, emit, save

ZETAS = (0.0, 0.001, 0.005, 0.02, 0.1, 0.3, 1.0)
STEPS = 3000


def lemma1_rows(cfg: QuadraticConfig, *, reps=2000, seed=0, device="cuda"):
    """The reference's rows, one a ζ of ``ZETAS``: {"zeta", "lemma1",
    "simulated", "rel_err"}; and the seconds each simulation took,
    synchronized."""
    rows, secs = [], []
    for z in ZETAS:
        pred = lemma1_asymptotic_variance(cfg.alpha, cfg.c, cfg.beta2,
                                          cfg.sigma2, cfg.num_workers, z)
        t0 = time.perf_counter()
        # a float: the simulation ends on the host, so the clock holds it
        sim = simulate_quadratic(cfg.alpha, cfg.c, cfg.beta2, cfg.sigma2,
                                 cfg.num_workers, z, STEPS, reps=reps,
                                 seed=seed, device=device)
        secs.append(time.perf_counter() - t0)
        rows.append({"zeta": z, "lemma1": pred, "simulated": float(sim),
                     "rel_err": abs(float(sim) - pred) / pred})
    return rows, secs


def run(device="cuda"):
    cfg = QuadraticConfig()
    rows, secs = lemma1_rows(cfg, device=device)
    worst = max(r["rel_err"] for r in rows)
    ratio = rows[0]["lemma1"] / rows[-1]["lemma1"]
    save("bench_lemma1", {"rows": rows, "config": cfg.__dict__})
    emit("lemma1_asymptotic_variance", sum(secs) * 1e6,
         f"worst_rel_err={worst:.3f};oneshot/minibatch_var_ratio={ratio:.3f}")


if __name__ == "__main__":
    cli(run, description=__doc__.split("\n\n")[0])
