"""The RG-LRU linear recurrence h_t = a_t h_{t-1} + b_t (h_0 = 0) over
the sequence axis.

The counterpart of the TPU kernel ``repro.kernels.rglru_scan.rglru_scan``.
On CUDA tensors it launches the hand-written kernel ``csrc/rglru_scan.cu``
(bitwise equal to the sequential plain version); on CPU tensors it runs
the plain version ``repro_torch.kernels.ref.rglru_scan_ref``. There is no
other path: a CUDA tensor the kernel cannot take raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rglru_scan_ref


def rglru_scan(a, b):
    """a, b: (B, S, W) float32 -> h: (B, S, W) float32."""
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"rglru_scan: a, b of one (B, S, W) shape "
                         f"expected, got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cpu or cuda, not {a.device}")
    _build.check_plane("rglru_scan", "a", a, a)
    _build.check_plane("rglru_scan", "b", b, a)
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    bsz, s, w = a.shape
    lib = _build.library("rglru_scan")
    with torch.cuda.device(a.device):
        err = lib.rglru_scan_launch(a.data_ptr(), b.data_ptr(),
                                    out.data_ptr(), bsz, s, w,
                                    torch.cuda.current_stream().cuda_stream)
    _build.check(err, "rglru_scan")
    rglru_scan.launches += 1
    return out


#: rglru_scan.cu launches so far (the CPU plain path does not count)
rglru_scan.launches = 0
