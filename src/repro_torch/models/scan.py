"""The log-depth associative scan of ``jax.lax.associative_scan``, for the
plain paths of the recurrent mixers (``recurrent.rglru_scan`` and
``rwkv._chunk_scan``).

The odd / even recursion of JAX's implementation, step for step: combine
neighbouring pairs, scan the pairs, combine each odd prefix with the next
even element, then interleave. Each combine sees the same operands in
the same order as JAX's, so the port rounds where the reference rounds.
"""
from __future__ import annotations

import torch


def associative_scan(combine, elems: list, axis: int) -> list:
    """Inclusive scan of the tensors ``elems`` (one shape along ``axis``)
    under ``combine(x, y) -> list``, an associative operator on lists of
    tensors with ``x`` before ``y``."""
    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.dim()
        idx[axis] = slice(start, stop, step)
        return t[tuple(idx)]

    def scan(elems):
        n = elems[0].shape[axis]
        if n < 2:
            return elems
        reduced = combine([sl(e, 0, -1, 2) for e in elems],
                          [sl(e, 1, None, 2) for e in elems])
        odd = scan(reduced)
        if n % 2 == 0:
            even = combine([sl(e, 0, -1) for e in odd],
                           [sl(e, 2, None, 2) for e in elems])
        else:
            even = combine(odd, [sl(e, 2, None, 2) for e in elems])
        even = [torch.cat([sl(e, 0, 1), r], dim=axis)
                for e, r in zip(elems, even)]
        out = []
        for ev, od in zip(even, odd):  # interleave even and odd positions
            shape = list(ev.shape)
            shape[axis] = n
            full = torch.empty(shape, dtype=ev.dtype, device=ev.device)
            idx = [slice(None)] * ev.dim()
            idx[axis] = slice(0, None, 2)
            full[tuple(idx)] = ev
            idx[axis] = slice(1, None, 2)
            full[tuple(idx)] = od
            out.append(full)
        return out

    return scan(list(elems))
