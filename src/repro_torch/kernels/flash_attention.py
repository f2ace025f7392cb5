"""Flash attention: online-softmax attention with a causal and / or
sliding-window mask and GQA / MQA, never materializing the (S, S) scores.

The counterpart of the TPU kernel
``repro.kernels.flash_attention.flash_attention``. On CUDA tensors it
launches a hand-written kernel of ``csrc/flash_attention.cu``: bfloat16
inputs take ``flash_fwd_wgmma`` (Hopper's tensor cores, TMA staging),
float32 inputs ``flash_fwd_f32`` (the CUDA cores, which the suite's
float32 tolerance needs). On CPU tensors it runs the plain version
``repro_torch.kernels.ref.flash_attention_ref``. There is no other path:
a CUDA tensor the kernels cannot take raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

#: head dims the kernels are built for, and the input types (their codes:
#: 0 flash_fwd_f32, 1 flash_fwd_wgmma)
HEAD_DIMS = (32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q (B,S,H,hd), k/v (B,S,Hkv,hd) "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, hd = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, hd) \
            or h % k.shape[2]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)} (same B, S, hd; Hkv "
                         "dividing H)")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"flash_attention: q, k, v dtypes differ: "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None):
    """q: (B,S,H,hd), k/v: (B,S,Hkv,hd) -> (B,S,H,hd) in ``q.dtype``.

    Key j is seen by query i when j <= i (``causal``) and j > i - window
    (``window`` > 0); scores are scaled by ``scale`` (default
    1/sqrt(hd)) after the dot; a row with no key gives 0."""
    _check(q, k, v)
    b, s, h, hd = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    if q.dtype not in DTYPES or hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention's kernel takes float32 / "
                         f"bfloat16 and head_dim in {HEAD_DIMS}, got "
                         f"{q.dtype}, head_dim {hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous, "
                             f"16-byte aligned and on {q.device}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.library("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            h, k.shape[2], hd, DTYPES[q.dtype], int(causal), int(window),
            float(scale), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


#: flash_attention.cu launches so far (the CPU plain path does not count)
flash_attention.launches = 0
