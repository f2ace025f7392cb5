"""Convex models from the paper's §3.1: least squares and logistic
regression, in component form f(w) = (1/m) sum_j f_j(w), so that
per-sample SGD (paper Eq. 2) and the gradient variance (Definition 1)
are exact, not minibatch approximations.

The counterpart of ``repro.models.convex``, in float32 as the reference
runs with 64-bit mode off. ``X`` (N, D), ``y`` (N,) and ``w`` (D,) are
tensors on one device; the functions run wherever they are.
"""
from __future__ import annotations

import torch


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ---- least squares: f_j(w) = 0.5 (x_j.w - y_j)^2 --------------------------

def ls_objective(w, X, y):
    r = X @ w - y
    return 0.5 * torch.mean(r * r)


def ls_grad_sample(w, x_j, y_j):
    return x_j * (x_j @ w - y_j)


# ---- logistic regression: f_j(w) = log(1 + exp(-y_j x_j.w)), y in {-1,1} --

def lr_objective(w, X, y):
    z = y * (X @ w)
    return torch.mean(_softplus(-z))


def lr_grad_sample(w, x_j, y_j):
    z = y_j * (x_j @ w)
    return -y_j * torch.sigmoid(-z) * x_j


def make_problem(kind: str):
    """(objective(w, X, y), per-sample gradient(w, x_j, y_j))."""
    if kind == "ls":
        return ls_objective, ls_grad_sample
    if kind == "lr":
        return lr_objective, lr_grad_sample
    raise ValueError(kind)


def solve_optimum(kind, X, y, *, iters: int = 400, lr: float = 0.5):
    """w*: the closed form for LS (ridge 1e-6), ``iters`` steps of
    full-gradient descent from zero for logistic regression, with the
    reference's step ``lr / (mean ||x_j||² / D)``."""
    if kind == "ls":
        eye = torch.eye(X.shape[1], dtype=X.dtype, device=X.device)
        return torch.linalg.solve(X.T @ X + 1e-6 * eye, X.T @ y)
    if kind != "lr":
        raise ValueError(kind)
    w = torch.zeros(X.shape[1], dtype=X.dtype, device=X.device)
    meansq = float(torch.mean(torch.sum(X * X, dim=1)))
    step = lr / max(meansq / X.shape[1], 1e-9)
    for _ in range(iters):
        w = w - step * full_gradient(kind, w, X, y)
    return w


def full_gradient(kind, w, X, y):
    """The gradient of the objective at w, through autograd."""
    obj, _ = make_problem(kind)
    w = w.detach().requires_grad_()
    (g,) = torch.autograd.grad(obj(w, X, y), w)
    return g


def per_sample_gradients(kind, w, X, y):
    """(N, D): row j is grad f_j(w), every sample at once."""
    if kind == "ls":
        return X * (X @ w - y)[:, None]
    if kind == "lr":
        z = y * (X @ w)
        return (-y * torch.sigmoid(-z))[:, None] * X
    raise ValueError(kind)


def gradient_variance(kind, w, X, y):
    """Definition 1: (1/m) sum_j ||grad f_j(w) - grad f(w)||^2, as a
    0-dim tensor."""
    per = per_sample_gradients(kind, w, X, y)
    g = torch.mean(per, dim=0)
    return torch.mean(torch.sum((per - g) ** 2, dim=1))
