"""Compressed communication: the wire precision of averaging events.

The counterpart of ``repro.core.compress``. Every averaging event ships
each worker's (P,) row; the wire format sets its precision:

  - ``f32``     — identity; the engine lowers it to the uncompressed
                  paths, bit-exactly.
  - ``bf16``    — round-to-nearest-even cast through bfloat16.
  - ``int8``    — per-row scale ``s = max|v| / 127`` and stochastic
                  rounding of ``v / s`` to the int8 grid.
  - ``one_bit`` — per-row scale ``s = mean|v|`` times the sign of each
                  entry.

With error feedback the residual of what quantization dropped is added
back before the next encode (``v = plane + e; q = Q(v); e' = v - q``;
the event acts on ``q``), carried as one more (M, P) f32 plane.

int8's stochastic rounding draws one uniform per entry from the
reference's salted per-row ``fold_in`` chain on ``(dec_key, step,
row)`` (:func:`row_uniforms`, bitwise the reference's through
:mod:`repro_torch.rng`). ``one_bit``'s row statistic ``sum |v|`` is
summed in float64 and divided by P before it rounds to float32 — here
and in the CUDA kernel alike, so the two agree whatever order each sums
in (the reference sums in float32).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import rng

#: wire formats, cheapest-precision last
WIRE_FORMATS = ("f32", "bf16", "int8", "one_bit")

#: payload bits per plane entry on the wire
WIRE_BITS = {"f32": 32, "bf16": 16, "int8": 8, "one_bit": 1}

#: formats whose per-event quantization is biased and therefore
#: requires the error-feedback residual to converge
_NEEDS_ERROR_FEEDBACK = ("int8", "one_bit")

#: formats that ship one f32 scale per row next to the payload
_SCALED = ("int8", "one_bit")

_ENC_SALT = 0x656E63  # "enc": decorrelates the stochastic-rounding
#                     # stream from the schedule's Bernoulli draws and
#                     # the gossip matchings, which fold the same
#                     # (dec_key, step)

#: entries per chunk of :func:`row_uniforms`: its int64 temporaries
#: stay near 1 GB at any (M, P)
_UNIFORM_CHUNK = 1 << 24


def wire_row_bytes(p: int, wire: str) -> int:
    """Bytes ONE worker row (P entries) occupies on the wire: the packed
    payload (rounded up to whole bytes) plus the f32 per-row scale for
    the scaled formats."""
    if wire not in WIRE_FORMATS:
        raise ValueError(f"unknown wire format {wire!r}; "
                         f"pick one of {WIRE_FORMATS}")
    payload = -(-p * WIRE_BITS[wire] // 8)
    return payload + (4 if wire in _SCALED else 0)


@dataclass(frozen=True)
class Compression:
    """The communication-precision axis of every averaging/mixing event:
    ``wire`` picks the format, ``error_feedback`` carries the (M, P)
    residual. The biased formats (``int8``, ``one_bit``) refuse to run
    without it. ``f32`` is the identity."""
    wire: str = "f32"
    error_feedback: bool = True

    def __post_init__(self):
        if self.wire not in WIRE_FORMATS:
            raise ValueError(f"unknown wire format {self.wire!r}; "
                             f"pick one of {WIRE_FORMATS}")
        if self.wire in _NEEDS_ERROR_FEEDBACK and not self.error_feedback:
            raise ValueError(
                f"wire format {self.wire!r} quantizes with per-event "
                "bias and needs the error-feedback residual to "
                "converge — keep error_feedback=True (or use bf16/f32)")

    @property
    def is_identity(self) -> bool:
        return self.wire == "f32"

    @property
    def stochastic(self) -> bool:
        """True when encoding consumes the per-row uniform stream."""
        return self.wire == "int8"

    def row_bytes(self, p: int) -> int:
        return wire_row_bytes(p, self.wire)


def row_uniforms(dec_key, step: int, row_ids, p: int, *,
                 device=None) -> torch.Tensor:
    """The int8 stochastic-rounding uniforms of the given global worker
    rows at this step, an (len(row_ids), p) f32 tensor on ``device``:
    ``u[i] = uniform(fold_in(fold_in(fold_in(dec_key, salt), step),
    row_ids[i]), (p,))`` — the reference's draws, bit for bit. All rows
    are hashed together (a column of row keys against a row of
    counters), ``_UNIFORM_CHUNK`` entries at a time."""
    base = rng.fold_in(rng.fold_in(dec_key, _ENC_SALT), step)
    keys = torch.stack([rng.fold_in(base, int(r)) for r in row_ids])
    k1, k2 = keys.to(device)[:, :1], keys.to(device)[:, 1:]
    out = torch.empty(len(row_ids), p, dtype=torch.float32, device=device)
    cols = max(1, _UNIFORM_CHUNK // max(len(row_ids), 1))
    for c0 in range(0, p, cols):
        lo = torch.arange(c0, min(p, c0 + cols), dtype=torch.int64,
                          device=device)[None]
        b1, b2 = rng.threefry2x32(k1, k2, torch.zeros_like(lo), lo)
        out[:, c0:c0 + cols] = rng.bits_to_uniform(b1 ^ b2)
    return out


def row_scales(v: torch.Tensor, wire: str) -> torch.Tensor:
    """The (M, 1) f32 per-row scales of the scaled formats: int8
    ``max|v| / 127`` (1 for an all-zero row), one_bit ``sum |v| / P``
    summed and divided in float64, then rounded to float32."""
    if wire == "int8":
        amax = torch.amax(torch.abs(v), dim=1, keepdim=True)
        s = amax / torch.full((), 127.0, dtype=v.dtype, device=v.device)
        return torch.where(amax > 0.0, s, torch.ones_like(s))
    if wire == "one_bit":
        # row by row: a float64 copy of a full-width plane is 11.6 GB
        tot = torch.stack([torch.sum(torch.abs(r).double()) for r in v])
        n = torch.full((), float(v.shape[1]), dtype=torch.float64,
                       device=v.device)
        return (tot / n).float()[:, None]
    raise ValueError(f"wire format {wire!r} has no row scale")


def quantize(v: torch.Tensor, wire: str, *, u=None) -> torch.Tensor:
    """Encode+decode one (M, P) float32 plane through ``wire``: the
    decoded image ``q`` the receiving workers reconstruct. ``u`` is the
    :func:`row_uniforms` plane (int8 only). All-zero rows quantize to
    zero in every format."""
    if wire == "f32":
        return v
    if wire == "bf16":
        return v.to(torch.bfloat16).float()
    if wire == "int8":
        if u is None:
            raise ValueError("int8 stochastic rounding needs row_uniforms")
        s = row_scales(v, wire)
        return torch.clamp(torch.floor(v / s + u), -127.0, 127.0) * s
    if wire == "one_bit":
        s = row_scales(v, wire)
        return torch.where(v >= 0.0, s, -s)
    raise ValueError(f"unknown wire format {wire!r}; "
                     f"pick one of {WIRE_FORMATS}")


def encode_decode(plane, resid, *, wire: str, u=None,
                  error_feedback: bool = True):
    """The error-feedback encode of one event: ``v = plane + resid``,
    ``q = quantize(v)``, ``resid' = v - q``. Returns ``(q, resid')``.
    Without ``error_feedback`` the residual passes through unchanged and
    ``v = plane``."""
    v = plane + resid if error_feedback else plane
    q = quantize(v, wire, u=u)
    return q, (v - q if error_feedback else resid)
