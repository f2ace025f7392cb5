"""The RWKV6 (Finch) WKV recurrence over the sequence axis, per (batch,
head):

  y_t = r_t · (S_{t-1} + (u∘k_t) v_tᵀ);   S_t = diag(exp(log_w_t)) S_{t-1} + k_t v_tᵀ

The counterpart of the TPU kernel ``repro.kernels.rwkv6_scan.rwkv6_scan``.
On CUDA tensors it launches the hand-written kernel ``csrc/rwkv6_scan.cu``
(the chunked form, 16 steps a chunk, its products on the tensor cores in
3xTF32; held within rtol / atol 2e-5 of the recurrence evaluated in
float64, as the sequential plain version is); on CPU tensors it runs the
plain version ``repro_torch.kernels.ref.rwkv6_scan_ref``. There is no
other path: a CUDA tensor the kernel cannot take raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rwkv6_scan_ref

#: head dims the kernel is built for, and the input types of r, k, v
#: (their codes)
HEAD_DIMS = (16, 32, 64)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rwkv6_scan(r, k, v, log_w, u):
    """r, k, v, log_w: (B, S, H, n); u: (H*n,) or (H, n). Returns
    (B, S, H, n) float32. On the card: r, k, v float32 or bfloat16 (one
    type), log_w and u float32, all contiguous, r, k, v and log_w 16-byte
    aligned (the kernel stages them with 16-byte copies), n in
    ``HEAD_DIMS``."""
    if r.dim() != 4 or not r.shape == k.shape == v.shape == log_w.shape:
        raise ValueError(f"rwkv6_scan: r, k, v, log_w of one (B, S, H, n) "
                         f"shape expected, got {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(log_w.shape)}")
    bsz, s, h, n = r.shape
    if u.numel() != h * n:
        raise ValueError(f"rwkv6_scan: u of H*n = {h * n} values expected, "
                         f"got {tuple(u.shape)}")
    if r.device.type == "cpu":
        return rwkv6_scan_ref(r, k, v, log_w, u)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan runs on cpu or cuda, not {r.device}")
    if r.dtype not in DTYPES or not r.dtype == k.dtype == v.dtype \
            or n not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan's kernel takes r, k, v of one type "
                         f"in float32 / bfloat16 and n in {HEAD_DIMS}, got "
                         f"{r.dtype}, {k.dtype}, {v.dtype}, n {n}")
    for name, t in (("r", r), ("k", k), ("v", v), ("log_w", log_w),
                    ("u", u)):
        if t.device != r.device or not t.is_contiguous():
            raise ValueError(f"rwkv6_scan: {name} must be contiguous and on "
                             f"{r.device}")
        if name != "u" and t.data_ptr() % 16:
            raise ValueError(f"rwkv6_scan: {name} must be 16-byte aligned")
    for name, t in (("log_w", log_w), ("u", u)):
        if t.dtype != torch.float32:
            raise ValueError(f"rwkv6_scan: {name} must be float32, got "
                             f"{t.dtype}")
    out = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    if out.numel() == 0:
        return out
    lib = _build.library("rwkv6_scan")
    with torch.cuda.device(r.device):
        err = lib.rwkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
            u.data_ptr(), out.data_ptr(), bsz, s, h, n, DTYPES[r.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "rwkv6_scan")
    rwkv6_scan.launches += 1
    return out


#: rwkv6_scan.cu launches so far (the CPU plain path does not count)
rwkv6_scan.launches = 0
