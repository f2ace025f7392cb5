"""SGD / momentum SGD with the paper's learning-rate schedules, in the
plane protocol the phase engine's fused ``opt_step`` pass speaks.

Learning rates are computed on the host in float32 numpy scalars: a
callable ``lr`` receives the 1-indexed step as ``np.float32``, so
``lambda t: lr0 / (t - 1.0 + d)`` stays in float32 exactly as the
reference's traced int32 step does, and the per-step scalars match the
reference bit for bit. They are handed to the kernel by value — no
device round trip per step.

``apply(params, grads, state, step)`` is the reference's tree-mapped
update (the engine's ``flat`` and ``tree`` carries, ``LocalSGD`` and
``launch.steps``): each leaf computed in float32 and cast back to its
dtype, with the operations of the plane twin
(``repro_torch.kernels.ref.plane_update_ref``) in its order and on the
same float32 scalars, so on float32 leaves the two agree bit for bit and
a bf16/f16 leaf's cast is the plane's rounding code.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.core.flat import tree_flatten, tree_map


class schedules:
    """Learning-rate schedules; each casts ``step`` to float32 first."""

    @staticmethod
    def constant(lr: float) -> Callable:
        return lambda step: np.float32(lr)

    @staticmethod
    def inverse(alpha: float, d: float) -> Callable:
        """The paper's §3.1 schedule: alpha / (t + d)."""
        return lambda step: np.float32(alpha) / (np.float32(step) + d)

    @staticmethod
    def exponential_epoch(lr0: float, decay: float, steps_per_epoch: int):
        """The paper's §3.2 CNN schedule: x``decay`` each epoch."""
        def fn(step):
            epoch = np.floor(np.float32(step) / steps_per_epoch)
            return np.float32(lr0) * np.float32(decay) ** epoch
        return fn


def _scalars(lr, c1=1.0, c2=1.0) -> torch.Tensor:
    """(4,) float32 CPU tensor for ``repro_torch.kernels.opt_step``:
    [lr, bias-correction c1, bias-correction c2, unused]."""
    return torch.tensor(np.array([lr, c1, c2, 0.0], dtype=np.float32))


def _lr_at(lr, step):
    return np.float32(lr(np.float32(step)) if callable(lr) else lr)


def _lr_tensor(lr, step, like):
    """The step's learning rate as the 0-dim float32 tensor the plane
    twin multiplies by (``plane_scalars(step)[0]``), on ``like``'s
    device."""
    return _scalars(_lr_at(lr, step))[0].to(like.device)


def _first_leaf(tree):
    leaves = tree_flatten(tree)[0]
    if not leaves:
        raise ValueError("apply needs a params tree with leaves")
    return leaves[0]


def _zeros_like_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


@dataclass(frozen=True)
class SGD:
    lr: Callable | float = 0.01

    plane_kind = "sgd"
    state_planes = 0

    def init(self, params):
        return ()

    def apply(self, params, grads, state, step):
        """(new params, state): ``p - lr * g`` in float32, cast back."""
        lr = _lr_tensor(self.lr, step, _first_leaf(params))
        new = tree_map(lambda p, g: (p.float() - lr * g.float()).to(p.dtype),
                       params, grads)
        return new, state

    def plane_hypers(self) -> dict:
        """Static hyperparameters for the fused plane update."""
        return {}

    def plane_scalars(self, step) -> torch.Tensor:
        """Per-step dynamic scalars (see ``_scalars``)."""
        return _scalars(_lr_at(self.lr, step))


@dataclass(frozen=True)
class Momentum:
    """Heavy-ball momentum (the paper's CNN recipe: lr .01, mu .9)."""
    lr: Callable | float = 0.01
    mu: float = 0.9
    nesterov: bool = False

    plane_kind = "momentum"
    state_planes = 1  # velocity

    def init(self, params):
        return _zeros_like_f32(params)

    def apply(self, params, grads, state, step):
        """(new params, new velocity): ``v = mu v + g``, then ``p - lr v``
        (Nesterov: ``p - lr (g + mu v)``) in float32, cast back."""
        lr = _lr_tensor(self.lr, step, _first_leaf(params))
        vel = tree_map(lambda g, v: self.mu * v + g.float(), grads, state)
        new = tree_map(
            lambda p, g, v: (p.float() - lr * (
                g.float() + self.mu * v if self.nesterov else v)).to(p.dtype),
            params, grads, vel)
        return new, vel

    def plane_hypers(self) -> dict:
        return {"mu": self.mu, "nesterov": self.nesterov}

    def plane_scalars(self, step) -> torch.Tensor:
        return _scalars(_lr_at(self.lr, step))
