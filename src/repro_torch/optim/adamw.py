"""AdamW in the plane protocol (fp32 moments over bf16/f32 params)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.core.flat import tree_map
from repro_torch.optim.sgd import (_first_leaf, _lr_at, _scalars,
                                   _zeros_like_f32)


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

    def apply(self, params, grads, state, step):
        """(new params, {"m", "v"}): the moments, then ``p - lr (m̂ /
        (sqrt(v̂) + eps) + wd p)`` in float32, cast back; the bias
        corrections are ``plane_scalars``'."""
        scal = self.plane_scalars(step).to(_first_leaf(params).device)
        lr, c1, c2 = scal[0], scal[1], scal[2]
        m = tree_map(lambda mm, g: self.b1 * mm + (1 - self.b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda vv, g: (self.b2 * vv
                                    + (1 - self.b2) * g.float() * g.float()),
                     state["v"], grads)

        def upd(p, m2, v2):
            d = (m2 / c1) / (torch.sqrt(v2 / c2) + self.eps)
            p32 = p.float()
            return (p32 - lr * (d + self.weight_decay * p32)).to(p.dtype)

        return tree_map(upd, params, m, v), {"m": m, "v": v}

    def plane_hypers(self) -> dict:
        return {"b1": self.b1, "b2": self.b2, "eps": self.eps,
                "weight_decay": self.weight_decay}

    def plane_scalars(self, step) -> torch.Tensor:
        # bias corrections in float32, as the reference computes them
        t = np.float32(step) + np.float32(1.0)
        return _scalars(_lr_at(self.lr, step),
                        np.float32(1.0) - np.float32(self.b1) ** t,
                        np.float32(1.0) - np.float32(self.b2) ** t)
