"""Paper Figure 1: PCA (Oja's rule) principal-component error vs total
number of averaging steps — one-shot (leftmost point) through frequent.

The port of ``benchmarks/bench_fig1_pca.py``, in float64 torch on the
device. The draws are the reference's numpy ones: the start from
``default_rng(seed)``, the samples from ``default_rng(1234)`` anew for
every phase length. Every phase length therefore sees the same start and
the same samples, so the phase lengths run together as the rows of one
(phase lengths, workers, dim) tensor: each step is one set of launches
for all of them, and each row is its phase length's run. The samples are
drawn on the host in blocks of steps (one ``standard_normal`` call gives
the draws of as many successive calls) and moved to the device a block
at a time.

    python -m repro_torch.experiments.fig1_pca [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.paper import PCAConfig
from repro_torch.device import resolve_device
from repro_torch.experiments.common import cli, emit, save, timeit

#: steps of samples drawn and moved to the device at a time
DRAW_BLOCK = 1000


def _normalize(w):
    return w / torch.clamp_min(torch.linalg.vector_norm(
        w, dim=-1, keepdim=True), 1e-9)


def pca_error_vs_avg_steps(cfg: PCAConfig, phase_lens, seed=0, *,
                           device="cuda"):
    """[{"phase_len", "num_avg_steps", "pc_error"}] for each phase length
    (0: one-shot), as the reference's."""
    dev = resolve_device(device)
    spec = np.full(cfg.dim, cfg.tail_eig)
    spec[0] = cfg.top_eig
    v1 = np.eye(cfg.dim)[0]
    ks = list(phase_lens)
    w0 = np.random.default_rng(seed).standard_normal((cfg.num_workers,
                                                      cfg.dim))
    w0 /= np.linalg.norm(w0, axis=1, keepdims=True)
    w = torch.tensor(w0, device=dev).expand(len(ks), -1, -1).contiguous()
    # the rows that average after each step, known on the host; one
    # (rows, 1, 1) mask on the device for each distinct set of them
    events = {t: tuple(bool(k) and t % k == 0 for k in ks)
              for t in range(1, cfg.num_samples + 1)}
    masks = {rows: torch.tensor(rows, device=dev)[:, None, None]
             for rows in set(events.values()) if any(rows)}
    rs = np.random.default_rng(1234)
    for t0 in range(0, cfg.num_samples, DRAW_BLOCK):
        n = min(DRAW_BLOCK, cfg.num_samples - t0)
        xs = torch.tensor(rs.standard_normal((n, cfg.num_workers, cfg.dim))
                          * np.sqrt(spec), device=dev)
        for i in range(n):
            x = xs[i]
            wx = torch.sum(w * x, dim=-1, keepdim=True)
            w = _normalize(w + cfg.alpha * wx * x)
            mask = masks.get(events[t0 + i + 1])
            if mask is not None:
                avg = _normalize(torch.mean(w, dim=1, keepdim=True))
                w = torch.where(mask, avg, w)
    wbar = torch.mean(w, dim=1).cpu().numpy()
    rows = []
    for k, wb in zip(ks, wbar):
        err = 1.0 - abs(wb @ v1) / (np.linalg.norm(wb) + 1e-12)
        rows.append({"phase_len": k,
                     "num_avg_steps": (cfg.num_samples // k if k else 0) + 1,
                     "pc_error": float(err)})
    return rows


def run(device="cuda"):
    cfg = PCAConfig(num_workers=24, num_samples=4000, alpha=0.02)
    dt, rows = timeit(
        lambda: pca_error_vs_avg_steps(cfg, [0, 2000, 500, 100, 25, 5],
                                       device=device),
        reps=1)
    save("bench_fig1_pca", {"rows": rows, "config": cfg.__dict__})
    one = rows[0]["pc_error"]
    best = min(r["pc_error"] for r in rows[1:])
    emit("fig1_pca_oja", dt, f"oneshot_err={one:.3f};best_periodic_err={best:.3f}")


if __name__ == "__main__":
    cli(run, description=__doc__.split("\n\n")[0])
