"""SGD / momentum SGD with the paper's learning-rate schedules, in the
plane protocol the phase engine's fused ``opt_step`` pass speaks.

Learning rates are computed on the host in float32 numpy scalars: a
callable ``lr`` receives the 1-indexed step as ``np.float32``, so
``lambda t: lr0 / (t - 1.0 + d)`` stays in float32 exactly as the
reference's traced int32 step does, and the per-step scalars match the
reference bit for bit. They are handed to the kernel by value — no
device round trip per step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.core.flat import tree_map


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

    def plane_hypers(self) -> dict:
        return {"mu": self.mu, "nesterov": self.nesterov}

    def plane_scalars(self, step) -> torch.Tensor:
        return _scalars(_lr_at(self.lr, step))
