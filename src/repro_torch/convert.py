"""Carry parameters across from the JAX reference as numpy arrays.

``params_from_jax(tree_of_numpy, device)`` keeps the nested dict / list
structure and every leaf's shape and dtype — an RG-LRU block's (H, bw,
bw) gates ``wa`` / ``wi`` and its float32 ``lam``, and an RWKV block's
float32 ``w0``, ``u`` and ``ln_out``, inside a bfloat16 tree included. ``np.asarray`` of a JAX bfloat16 array
has numpy's extension bfloat16 dtype, which ``torch.from_numpy`` rejects;
such leaves go through float32 (which holds every bfloat16 value
exactly) and then to ``torch.bfloat16``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.flat import tree_map
from repro_torch.device import resolve_device


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    return t.to(device)


def params_from_jax(tree_of_numpy, device="cuda"):
    """The same params as torch tensors on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf(a, dev), tree_of_numpy)
