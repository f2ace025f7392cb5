"""Fused worker average + dispersion over the flat (M, P) plane.

The counterpart of the TPU kernel ``repro.kernels.avg_disp.avg_disp``:
the worker mean (or the means of ``groups`` contiguous worker groups —
the hierarchical schedule's inner event) broadcast back to every row,
plus the Eq. 4 dispersion against the global mean, in one pass. On CUDA
tensors it launches ``csrc/avg_disp.cu``; on CPU tensors it runs the
plain version ``repro_torch.kernels.ref.avg_disp_ref``. A CUDA tensor
the kernel cannot take raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.opt_step import MAX_WORKERS
from repro_torch.kernels.ref import avg_disp_ref


def avg_disp(plane, *, groups: int = 1):
    """plane: (M, P) float32 -> (averaged plane, Eq. 4 dispersion as a
    0-dim tensor). ``groups`` > 1 broadcasts per-group means; the
    dispersion is always against the global mean. The output is a new
    tensor; the input is not modified."""
    m, p = plane.shape
    if groups < 1 or m % groups:
        raise ValueError(f"groups={groups} must divide the {m} worker rows")
    if plane.device.type == "cpu":
        return avg_disp_ref(plane, groups=groups)
    if plane.device.type != "cuda":
        raise ValueError(f"avg_disp runs on cpu or cuda, not {plane.device}")
    if not 1 <= m <= MAX_WORKERS:
        raise ValueError(f"avg_disp's kernel takes 1..{MAX_WORKERS} worker "
                         f"rows, got {m}")
    if plane.dtype != torch.float32 or not plane.is_contiguous():
        raise ValueError(f"avg_disp needs a contiguous float32 plane, got "
                         f"{plane.dtype} (contiguous="
                         f"{plane.is_contiguous()})")
    out = torch.empty_like(plane)
    dpart = torch.empty(-(-p // 256), dtype=torch.float32,
                        device=plane.device)
    disp = torch.empty((), dtype=torch.float32, device=plane.device)
    lib = _build.library("avg_disp")
    with torch.cuda.device(plane.device):
        err = lib.avg_disp_launch(
            plane.data_ptr(), out.data_ptr(), dpart.data_ptr(),
            disp.data_ptr(), m, p, groups,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "avg_disp")
    avg_disp.launches += 1
    return out, disp


#: kernel launches so far (the CPU plain path does not count)
avg_disp.launches = 0
