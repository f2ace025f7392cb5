"""Gradient-variance envelope estimation (paper §2.2 + §3.1).

The counterpart of ``repro.core.variance_model``. The paper's model:

    Δ(w) ≤ β² ||w - w*||² + σ²   (Eq. 5)

with ρ = β² ||w0 - w*||² / σ² predicting the benefit of frequent
averaging. The measurement follows §3.1:

  1. find (approximately) the optimizer w*;
  2. Δ(w*) gives σ²;
  3. draw a random line through w* (``rng.normal``, the reference's
     ``jax.random.normal`` draws);
  4. measure Δ at points along the line;
  5. fit the quadratic curvature -> one β² estimate;
  6. repeat 3-5 and average.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import rng


def measure_sigma2(variance_fn, w_star):
    """variance_fn(w) -> Δ(w) (Definition 1). σ² = Δ(w*)."""
    return float(variance_fn(w_star))


def measure_beta2(variance_fn, w_star, *, key, num_lines: int = 8,
                  num_points: int = 9, radius: float = 1.0):
    """Average curvature of Δ along random lines through w*: fits
    Δ(w* + t d) - σ² ≈ β² t² by least squares on t² (the paper takes 9
    measurements per line). ``key`` is a :mod:`repro_torch.rng` key,
    split once per line as the reference splits it. Returns (β², σ²)."""
    sigma2 = measure_sigma2(variance_fn, w_star)
    dim = w_star.shape[0]
    betas = []
    for _ in range(num_lines):
        key, sub = rng.split(key)
        d = rng.normal(sub, (dim,), device=w_star.device)
        d = d / torch.linalg.norm(d)
        ts = np.linspace(-radius, radius, num_points)
        ts = ts[np.abs(ts) > 1e-12]
        # t enters as a float32 scalar, as the reference's numpy float64
        # is taken with 64-bit mode off
        deltas = np.array([float(variance_fn(w_star + float(np.float32(t))
                                             * d)) for t in ts])
        t2 = ts ** 2
        beta2 = float(np.sum(t2 * (deltas - sigma2)) / np.sum(t2 * t2))
        betas.append(max(beta2, 0.0))
    return float(np.mean(np.array(betas))), sigma2


def rho(beta2: float, sigma2: float, w0, w_star) -> float:
    """ρ = β² ||w0 - w*||² / σ² — large ρ ⇒ frequent averaging helps."""
    d2 = float(torch.sum((w0 - w_star) ** 2))
    return beta2 * d2 / max(sigma2, 1e-30)


def predict_averaging_benefit(sigma2_workers, *, beta2: float = 0.0,
                              dist2: float = 0.0, alive=None,
                              lr: float | None = None,
                              steps: int | None = None,
                              momentum: float = 0.0,
                              drift2: float = 0.0,
                              curvature: float = 0.0) -> dict:
    """Predict what one averaging event buys from measured PER-WORKER
    gradient variances (paper §2.2, Lemma 1 asymptotics).

    Averaging n i.i.d.-noise workers divides the noise floor by n: with
    ``sigma2_bar`` the mean alive-worker variance the predicted per-step
    variance drops by ``sigma2_bar * (1 - 1/n)``. Dead workers (``alive``
    0) shrink n. ``rho = β² d² / σ̄²`` (Eq. 5).

    Returns ``n_alive``, ``sigma2_bar``, ``rho``, ``variance_reduction``
    (1/n) and ``benefit`` (the absolute predicted variance drop). With
    ``lr`` and ``steps`` both given, the fields of
    :func:`predict_post_resize_dispersion` are merged in."""
    if lr is not None and steps is not None:
        return predict_post_resize_dispersion(
            sigma2_workers, lr=lr, steps=steps, momentum=momentum,
            drift2=drift2, curvature=curvature, alive=alive)
    s2 = np.asarray(sigma2_workers, dtype=np.float64).reshape(-1)
    if alive is None:
        a = np.ones_like(s2)
    else:
        a = (np.asarray(alive, dtype=np.float64).reshape(-1) > 0)
        a = a.astype(np.float64)
        if a.shape != s2.shape:
            raise ValueError(f"alive {a.shape} vs sigma2 {s2.shape}")
    n = float(a.sum())
    if n < 1:
        raise ValueError("predict_averaging_benefit needs >=1 alive worker")
    sigma2_bar = float((s2 * a).sum() / n)
    return {
        "n_alive": n,
        "sigma2_bar": sigma2_bar,
        "rho": float(beta2) * float(dist2) / max(sigma2_bar, 1e-30),
        "variance_reduction": 1.0 / n,
        "benefit": sigma2_bar * (1.0 - 1.0 / n),
    }


def predict_post_resize_dispersion(sigma2_workers, *, lr: float,
                                   steps: int, momentum: float = 0.0,
                                   drift2: float = 0.0,
                                   curvature: float = 0.0,
                                   alive=None) -> dict:
    """Predict the Eq. 4 dispersion ``steps`` local steps after a
    consensus point (an averaging event, a resize) from the K-weighted
    drift budget of Parallel Restarted SGD (arXiv 1807.06629, Thm. 2).

    A gradient taken at step j of K is still being applied at step K
    with weight c_j = lr (1 - mu^(K - j + 1)) / (1 - mu) (lr for plain
    SGD). Independent noise adds in quadrature and loses the 1/n share
    of the mean; the per-shard drift adds coherently, contracted by
    γ = 1 - lr·curvature a step:

        E disp ≈ Σ_j c_j² σ̄² (1 - 1/n) + (Σ_j c_j γ^(j-1))² drift²

    Returns the :func:`predict_averaging_benefit` fields plus ``k``,
    ``noise_dispersion``, ``drift_dispersion`` and their sum
    ``predicted_dispersion``."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if not 0.0 <= momentum < 1.0:
        raise ValueError(f"momentum must be in [0, 1), got {momentum}")
    gamma = 1.0 - float(lr) * float(curvature)
    if not 0.0 <= gamma <= 1.0:
        raise ValueError(
            f"lr * curvature = {float(lr) * float(curvature)} must be in "
            "[0, 1] — beyond it the one-step drift contraction "
            "1 - lr*curvature is not a contraction at all")
    base = predict_averaging_benefit(sigma2_workers, alive=alive)
    k = int(steps)
    mu = float(momentum)
    j = np.arange(1, k + 1, dtype=np.float64)
    if mu > 0.0:
        c = float(lr) * (1.0 - mu ** (k - j + 1.0)) / (1.0 - mu)
    else:
        c = np.full(k, float(lr))
    n = base["n_alive"]
    noise = float((c ** 2).sum()) * base["sigma2_bar"] * (1.0 - 1.0 / n)
    drift = float((c * gamma ** (j - 1.0)).sum()) ** 2 * float(drift2)
    base.update({
        "k": k,
        "noise_dispersion": noise,
        "drift_dispersion": drift,
        "predicted_dispersion": noise + drift,
    })
    return base


def empirical_variance_fn(kind: str, X, y):
    """Definition 1 for a dataset: Δ(w) as a 0-dim tensor."""
    from repro_torch.models.convex import gradient_variance

    def fn(w):
        return gradient_variance(kind, w, X, y)
    return fn
