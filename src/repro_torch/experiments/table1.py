"""Paper Table 1: per-dataset gradient-variance measurements (σ², β², ρ)
via the §3.1 procedure, on the synthetic convex suite (regime analogues
of the paper's libsvm datasets).

The port of ``benchmarks/bench_table1.py``, over
:mod:`repro_torch.core.variance_model`: the data on the device, the
measurement lines drawn from ``rng.PRNGKey(0)`` as the reference draws
them from ``jax.random.PRNGKey(0)``.

    python -m repro_torch.experiments.table1 [--device cpu]
"""
from __future__ import annotations

import torch

from repro_torch import rng
from repro_torch.configs.paper import CONVEX_SUITE, ConvexConfig
from repro_torch.core.variance_model import (empirical_variance_fn,
                                             measure_beta2, rho)
from repro_torch.data import convex_dataset
from repro_torch.device import resolve_device
from repro_torch.experiments.common import cli, emit, save, timeit
from repro_torch.models.convex import solve_optimum


def table1_row(c: ConvexConfig, n: int, d: int, *, device="cuda") -> dict:
    """One row of Table 1 for ``c``'s dataset drawn at n samples x d
    dims: {"dataset", "model", "n", "d", "sigma2", "beta2", "rho"}."""
    dev = resolve_device(device)
    X, y, _ = convex_dataset(c.model, n, d, sparsity=c.sparsity,
                             noise=c.noise, seed=0)
    X, y = torch.tensor(X, device=dev), torch.tensor(y, device=dev)
    ws = solve_optimum(c.model, X, y)
    vfn = empirical_variance_fn(c.model, X, y)
    b2, s2 = measure_beta2(vfn, ws, key=rng.PRNGKey(0), num_lines=6)
    r = rho(b2, s2, torch.zeros(d, device=dev), ws)
    return {"dataset": c.name, "model": c.model, "n": n, "d": d,
            "sigma2": s2, "beta2": b2, "rho": r}


def run(device="cuda"):
    rows = []
    total_us = 0.0
    for c in CONVEX_SUITE:
        n = min(c.num_samples, 2048)
        d = min(c.num_dims, 256)
        dt, row = timeit(lambda: table1_row(c, n, d, device=device), reps=1)
        total_us += dt
        rows.append(row)
    save("bench_table1", {"rows": rows})
    order = sorted(rows, key=lambda r: -r["rho"])
    emit("table1_variance_measurements", total_us,
         "rho_order=" + ">".join(r["dataset"].split("-")[1] for r in order))


if __name__ == "__main__":
    cli(run, description=__doc__.split("\n\n")[0])
