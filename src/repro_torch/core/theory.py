"""Closed-form results of the paper and the simulations that check them.

The reference's ``repro.core.theory``, function for function:

- Lemma 1: the asymptotic variance of the worker average under
  stochastic averaging with rate ζ on f(w) = c w²/2 with gradient noise
  ∇f̃(w) = c w - b̃ w - h̃, Var b̃ = β², Var h̃ = σ²;
- Eq. (4): the coarse-model worker-dispersion bound that *cannot* see
  any benefit from averaging (the paper's Example 2), and its gossip
  generalization;
- the (Q, P) recursion of Appendix A, iterated exactly, and a Monte
  Carlo simulator of the §2.3 process;
- Example 1: SGD on homogeneous quadratics, whose final average does not
  depend on the averaging schedule.

The closed forms are numpy. The two simulations are step loops over
torch tensors on ``device`` (the card by default), drawing through
:mod:`repro_torch.rng` from the reference's keys: the same draws, the
normals within a few float32 ulps of ``jax.random.normal``'s.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import rng
from repro_torch.device import resolve_device

_F32 = np.float32
#: elements drawn per block of :func:`simulate_quadratic`'s noise, so its
#: threefry temporaries stay bounded whatever ``steps x reps x M``
_DRAW_BLOCK = 1 << 24


def lemma1_eta(zeta: float, alpha: float, c: float) -> float:
    if zeta >= 1.0:
        return np.inf
    return zeta / ((1.0 - zeta) * alpha * (2.0 * c - alpha * c * c))


def lemma1_asymptotic_variance(alpha: float, c: float, beta2: float,
                               sigma2: float, M: int, zeta: float) -> float:
    """lim_t Var( (1/M) Σ_i w_{i,t} ). ζ=0 → one-shot regime, ζ=1 →
    minibatch regime (η→∞ handled by its limit)."""
    eta = lemma1_eta(zeta, alpha, c)
    if np.isinf(eta):
        factor = 1.0 / M
    else:
        factor = (1.0 + eta / M) / (1.0 + eta)
    denom = 2.0 * c - alpha * c * c - alpha * beta2 * factor
    if denom <= 0:
        return np.inf  # divergent regime
    return alpha * sigma2 / (M * denom)


def qp_recursion(alpha, c, beta2, sigma2, M, zeta, steps, q0=0.0, p0=0.0):
    """Exact expected-value iteration of Appendix A:
      no-avg:  Q' = (1-αc)² Q + α²β²P/M + α²σ²/M
               P' = ((1-αc)² + α²β²) P + α²σ²
      avg:     Q' = Q ; P' = Q
      mixed with probability ζ via total expectation.
    Returns the trajectory of Q (the variance of the average)."""
    a2 = (1.0 - alpha * c) ** 2
    q, p = q0, p0
    out = np.empty(steps)
    for t in range(steps):
        qn = a2 * q + alpha ** 2 * beta2 * p / M + alpha ** 2 * sigma2 / M
        pn = (a2 + alpha ** 2 * beta2) * p + alpha ** 2 * sigma2
        q = (1 - zeta) * qn + zeta * q
        p = (1 - zeta) * pn + zeta * q  # after averaging P collapses to Q
        # the paper's coupled update uses the pre-update Q for the avg
        # branch; for the fixed point it is equivalent
        out[t] = q
    return out


def simulate_quadratic(alpha, c, beta2, sigma2, M, zeta, steps, *,
                       reps=2000, seed=0, w0_std=0.0, device="cuda"):
    """Monte Carlo of the §2.3 process: ``reps`` independent systems of M
    workers; returns Var over reps of the worker average at the end.

    The reference's draws: ``kb, kh, kz, k0 = split(PRNGKey(seed), 4)``,
    b and h normal over (steps, reps, M), the averaging coin a uniform
    over (steps, reps) below ζ, all in float32; the noise is drawn in
    blocks of steps (the same counters as one draw of the whole shape)."""
    dev = resolve_device(device)
    kb, kh, kz, k0 = rng.split(rng.PRNGKey(seed), 4)
    sb, sh = float(_F32(np.sqrt(beta2))), float(_F32(np.sqrt(sigma2)))
    a, keep = float(_F32(alpha)), float(_F32(1.0 - alpha * c))
    zeta32 = float(_F32(zeta))
    w = rng.normal(k0, (reps, M), device=dev) * float(_F32(w0_std))
    per = max(1, _DRAW_BLOCK // (reps * M))
    for s0 in range(0, steps, per):
        n = min(per, steps - s0)
        b = rng.normal(kb, (n, reps, M), device=dev,
                       start=s0 * reps * M) * sb
        h = rng.normal(kh, (n, reps, M), device=dev,
                       start=s0 * reps * M) * sh
        avg = rng.uniform(kz, (n, reps), device=dev,
                          start=s0 * reps) < zeta32
        for i in range(n):
            w = keep * w + a * (b[i] * w + h[i])
            wbar = torch.mean(w, dim=1, keepdim=True)
            w = torch.where(avg[i][:, None], wbar, w)
    wbar = torch.mean(w, dim=1)
    return float(torch.var(wbar, correction=0))


def coarse_dispersion_bound(alpha, sigma2, L, c, k):
    """Eq. (4): E||w_ik - w̄_k||² ≤ ασ²/(2L-αc²) [1-(1-2αL+α²c²)^k].
    The point (Example 2): it does not depend on when averaging
    happened."""
    denom = 2.0 * L - alpha * c * c
    rate = 1.0 - 2.0 * alpha * L + (alpha * c) ** 2
    return alpha * sigma2 / denom * (1.0 - rate ** k)


# --------------------------------------------------------------------------
# Gossip-topology hooks (repro_torch.topology): what the mixing spectrum
# says about the Eq. 4 dispersion
# --------------------------------------------------------------------------

def mixing_contraction(spectral_gap: float) -> float:
    """Per-event dispersion contraction of one mixing-matrix event: a
    symmetric doubly-stochastic W maps the deviation from the consensus
    through its spectrum on the consensus-orthogonal subspace, so ONE
    event multiplies the Eq. 4 dispersion by at most λ₂² = (1 -
    spectral_gap)² (``Topology.spectral_gap`` = 1 - SLEM): 0 for the
    full mean, 1 for a disconnected graph."""
    lam2 = 1.0 - spectral_gap
    return lam2 * lam2


def mixed_dispersion_fixed_point(alpha, sigma2, L, c, k,
                                 spectral_gap: float) -> float:
    """Eq. (4) generalized to a gossip topology: the steady-state
    PRE-event dispersion when a mixing event with the given spectral gap
    fires every ``k`` steps,

        D* = g(k) / (1 - ρ · rate^k),

    g(k) = :func:`coarse_dispersion_bound` and ρ =
    :func:`mixing_contraction`. gap=1 (full averaging) recovers Eq. 4's
    schedule-independent bound g(k); gap=0 (disconnected) the k→∞
    envelope ασ²/(2L-αc²), as if no event ever fired."""
    rho = mixing_contraction(spectral_gap)
    rate = 1.0 - 2.0 * alpha * L + (alpha * c) ** 2
    g = coarse_dispersion_bound(alpha, sigma2, L, c, k)
    return g / (1.0 - rho * rate ** k)


# --------------------------------------------------------------------------
# Example 1 (homogeneous quadratics): averaging-frequency invariance
# --------------------------------------------------------------------------

def run_homogeneous_quadratic(P, qs, w0, alpha, steps, M, phase_len, seed=0,
                              *, device="cuda"):
    """SGD on f_j(w) = ½wᵀPw + wᵀq_j with common Hessian P. Per Example 1,
    the final worker average is IDENTICAL for any averaging schedule
    given the same sample draws (the reference's ``randint(PRNGKey(seed),
    (steps, M), 0, m)``). Returns the final average, float32 on
    ``device``."""
    dev = resolve_device(device)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)
    P, qs, w0 = f32(P), f32(qs), f32(w0)
    idx = rng.randint(rng.PRNGKey(seed), (steps, M), 0, qs.shape[0],
                      device=dev).long()
    a = float(_F32(alpha))
    w = w0[None].expand(M, -1)
    for t in range(steps):
        g = w @ P.T + qs[idx[t]]
        w = w - a * g
        if phase_len > 0 and (t + 1) % phase_len == 0:
            w = torch.mean(w, dim=0, keepdim=True).expand(M, -1)
    return torch.mean(w, dim=0)
