"""AdamW in the plane protocol (fp32 moments over bf16/f32 params)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.optim.sgd import _lr_at, _scalars, _zeros_like_f32


@dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0

    plane_kind = "adamw"
    state_planes = 2  # first/second moments, in {"m","v"} flatten order

    def init(self, params):
        return {"m": _zeros_like_f32(params), "v": _zeros_like_f32(params)}

    def plane_hypers(self) -> dict:
        return {"b1": self.b1, "b2": self.b2, "eps": self.eps,
                "weight_decay": self.weight_decay}

    def plane_scalars(self, step) -> torch.Tensor:
        # bias corrections in float32, as the reference computes them
        t = np.float32(step) + np.float32(1.0)
        return _scalars(_lr_at(self.lr, step),
                        np.float32(1.0) - np.float32(self.b1) ** t,
                        np.float32(1.0) - np.float32(self.b2) ** t)
