"""Counter-based random numbers, bit for bit those of ``jax.random``.

The reference draws every per-event random choice from ``jax.random``
``fold_in`` streams on the decision key: the stochastic schedule's
Bernoulli, the gossip matchings, int8 stochastic rounding. Parity with
it needs the same bits, so this module re-implements the pieces of
``jax.random`` those paths use, under jax's default configuration
(threefry2x32 keys, ``jax_threefry_partitionable`` on, 32-bit mode):

  PRNGKey(seed)        -> key [0, seed]
  split(key, n)        -> (n, 2) keys: threefry(key, (0, i)) for i < n
  fold_in(key, d)      -> threefry(key, (0, d))
  random_bits(key, s)  -> b1 ^ b2 of threefry(key, (i >> 32, i mod
                          2**32)), i the flat index (the partitionable
                          counter layout: a uint64 iota as two words)
  uniform(key, s)      -> bits >> 9 | 0x3F800000 as float32, minus 1;
                          on [lo, hi): that * (hi - lo) + lo, then
                          max(lo, .)
  bernoulli(key, p, s) -> uniform(key, s) < float32(p)
  randint(key, s, lo, hi)
                       -> int32 lo + (hb mod n * m + lb mod n) mod n,
                          n = hi - lo, m = (2**16 mod n)**2 mod n, hb
                          and lb the bits of the two halves of
                          split(key), in wrapping uint32 arithmetic
  normal(key, s)       -> sqrt(2) * erfinv(u), u the uniform mapped onto
                          [nextafter(-1, 0), 1) as ``jax.random.uniform``
                          maps it, erfinv XLA's float32 polynomial
  truncated_normal(key, lo, hi, s)
                       -> sqrt(2) * erfinv(u), u uniform on
                          [erf(lo / sqrt 2), erf(hi / sqrt 2)), clipped
                          inside (lo, hi) (the model inits' law)
  permutation(key, n)  -> sort-keyed shuffle of arange(n): rounds of
                          (key, sub = split(key); stable sort by
                          random_bits(sub, (n,)))

On ``device="meta"`` the draws hash nothing: ``random_bits`` and
``truncated_normal`` return an empty ``meta`` tensor of the draw's shape
and dtype (the other draws map those bits on ``meta``), so an init run
on ``meta`` (the dry run's abstract params) builds its tree of shapes
without the threefry work.

A key is a (2,) int64 tensor holding two uint32 words. The key
operations (``split``, ``fold_in``) hash a handful of counters, so they
run the same hash on Python ints, which costs microseconds per call
where tensor ops would cost a launch each; the bulk draws
(``random_bits``) run it in int64 tensors masked to 32 bits (PyTorch has
no uint32 arithmetic on every device), on the device the draws are for.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(k1: int, k2: int, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2)
    under the key (k1, k2): uint32 words as Python ints or as int64
    tensors."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & _MASK
    y0 = (x2 + ks[1]) & _MASK
    for n in range(5):
        for r in _ROT[n % 2]:
            x0 = (x0 + y0) & _MASK
            y0 = _rotl(y0, r) ^ x0
        x0 = (x0 + ks[(n + 1) % 3]) & _MASK
        y0 = (y0 + ks[(n + 2) % 3] + n + 1) & _MASK
    return x0, y0


def _words(key) -> tuple[int, int]:
    """The two uint32 words of a key, as Python ints."""
    k1, k2 = torch.as_tensor(key).reshape(2).tolist()
    return k1, k2


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` in 32-bit mode: the seed as an int32,
    key words [0, seed mod 2**32]."""
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit the int32 that "
                         "32-bit JAX keys are made from")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: a (num, 2) tensor of keys."""
    k1, k2 = _words(key)
    return torch.tensor([threefry2x32(k1, k2, 0, i) for i in range(num)],
                        dtype=torch.int64).reshape(num, 2)


def fold_in(key, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``, ``data`` taken as a uint32."""
    k1, k2 = _words(key)
    return torch.tensor(threefry2x32(k1, k2, 0, data & _MASK),
                        dtype=torch.int64)


def _meta(shape, dtype, device):
    """The draw's empty ``meta`` tensor when ``device`` is ``meta``, else
    None."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    return None


def random_bits(key, shape, *, device=None, start: int = 0) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32 words as int64) on
    ``device``. ``start`` offsets the flat counter: the block
    ``[start, start + prod(shape))`` of the draw over a larger shape, so
    a long row can be drawn in chunks."""
    m = _meta(shape, torch.int64, device)
    if m is not None:
        return m
    k1, k2 = _words(key)
    n = math.prod(shape)
    i = torch.arange(start, start + n, dtype=torch.int64, device=device)
    # the high word is 0 below 2**32 draws (an expert tensor of llama4
    # holds 5.4e9 entries)
    b1, b2 = threefry2x32(k1, k2, i >> 32, i & _MASK)
    return (b1 ^ b2).reshape(shape)


def fold_in_uniforms(key, data) -> np.ndarray:
    """``[uniform(fold_in(key, d), ()) for d in data]`` as a float32 numpy
    array, for host-side draws: both hashes of every ``d`` run at once
    on int64 numpy words (the second hash with an array of keys), not
    one ``d`` at a time."""
    k1, k2 = _words(key)
    d = np.asarray(data, np.int64) & _MASK
    f1, f2 = threefry2x32(k1, k2, np.zeros_like(d), d)
    b1, b2 = threefry2x32(f1, f2, np.zeros_like(d), np.zeros_like(d))
    bits = ((b1 ^ b2) >> 9) | 0x3F800000
    return bits.astype(np.uint32).view(np.float32) - np.float32(1.0)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform``'s float32 map of 32 random bits to [0, 1):
    the top 23 bits as the mantissa of a float in [1, 2), minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def _on_range(u: torch.Tensor, minval, maxval) -> torch.Tensor:
    """``jax.random.uniform``'s map of a [0, 1) float32 draw onto
    [minval, maxval): ``u * (maxval - minval) + minval`` (the bounds
    rounded to float32 first, their difference taken in float32), then
    ``max(minval, .)``. XLA contracts the multiply-add into one fused
    operation: it is taken in float64, where the product is exact, and
    rounded to float32 once."""
    lo, hi = np.float32(minval), np.float32(maxval)
    v = (u.double() * float(hi - lo) + float(lo)).float()
    return torch.clamp_min(v, float(lo))


def uniform(key, shape=(), *, minval=0.0, maxval=1.0, device=None,
            start: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, jnp.float32, minval, maxval)``;
    ``start`` as :func:`random_bits` takes it (a block of a larger
    draw)."""
    u = bits_to_uniform(random_bits(key, shape, device=device, start=start))
    if (minval, maxval) == (0.0, 1.0):
        return u  # u * 1 + 0, then max(0, .), is u itself
    return _on_range(u, minval, maxval)


def bernoulli(key, p: float, shape=()) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (mode "low"): a float32
    uniform below float32(p)."""
    return uniform(key, shape) < torch.tensor(np.float32(p))


# XLA's float32 erfinv (M. Giles, "Approximating the erfinv function"):
# a degree-8 polynomial in w - 2.5 for w = -log1p(-x²) < 5, else in
# sqrt(w) - 3
_ERFINV_LO = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_HI = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)


def _erfinv32(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv as XLA evaluates it: the polynomial's steps are
    fused multiply-adds (each taken in float64, where the product is
    exact, and rounded once); log1p is taken in float64 and rounded,
    where XLA's own float32 log1p lands up to an ulp or two apart."""
    w = (-torch.log1p(-(x * x).double())).float()
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    lo = torch.tensor(_ERFINV_LO, dtype=torch.float32, device=x.device)
    hi = torch.tensor(_ERFINV_HI, dtype=torch.float32, device=x.device)
    p = torch.where(lt, lo[0], hi[0])
    for i in range(1, len(_ERFINV_LO)):
        c = torch.where(lt, lo[i], hi[i])
        p = (c.double() + p.double() * w).float()
    return torch.where(x.abs() == 1, x * torch.finfo(torch.float32).max,
                       p * x)


def normal(key, shape=(), *, device=None, start: int = 0) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float32: the same threefry
    bits, mapped onto [nextafter(-1, 0), 1) as ``jax.random.uniform``
    maps them (bit for bit), then ``sqrt(2) * erfinv``. The erfinv is
    XLA's polynomial; against ``jax.random.normal`` on the CPU about one
    draw in a hundred lands 1-3 ulps apart (the log1p), the rest are
    equal. ``start`` as :func:`random_bits` takes it."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    span = np.float32(1) - lo  # 2.0 in float32, as the reference rounds it
    u = uniform(key, shape, device=device, start=start) * float(span) \
        + float(lo)
    u = torch.clamp_min(u, float(lo))
    return _erfinv32(u) * float(np.float32(np.sqrt(2)))


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a * b`` mod 2**32 for uint32 words (``a`` int64 words, ``b`` a
    Python int), in 16-bit halves of ``b`` so no product leaves int64."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def randint(key, shape, minval: int, maxval: int, *,
            device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32, bounds
    that fit an int32, as jax takes Python ints): the span ``maxval -
    minval`` as a uint32 (1 when ``maxval <= minval``), two streams of
    32 bits from ``split(key)``, and the offset ``(hb % span * m + lb %
    span) % span``, ``m = (2**16 % span)**2 % span``, in uint32
    arithmetic: every product and sum wraps mod 2**32."""
    lo, hi = int(minval), int(maxval)
    if not (-2**31 <= lo < 2**31 and -2**31 <= hi < 2**31):
        raise ValueError(f"randint bounds [{lo}, {hi}) do not fit the "
                         "int32 that 32-bit JAX draws them in")
    span = (hi - lo) & _MASK if hi > lo else 1
    k1, k2 = split(key)
    higher = random_bits(k1, shape, device=device)
    lower = random_bits(k2, shape, device=device)
    mult = (1 << 16) % span
    mult = ((mult * mult) & _MASK) % span
    off = ((_mul32(higher % span, mult) + lower % span) & _MASK) % span
    out = (off + lo + 2**31) & _MASK
    return (out - 2**31).to(torch.int32)


#: float32 erf(-2 / sqrt(2)) and erf(2 / sqrt(2)) as
#: ``jax.random.truncated_normal`` computes them for the bounds the model
#: inits take (-2, 2): XLA's float32 erf of float32(-2) / float32(sqrt 2)
#: under jax 0.9.0 on the CPU, read off as float32 bit patterns
_ERF_AT = {-2.0: float(np.uint32(0xBF745A18).view(np.float32)),
           2.0: float(np.uint32(0x3F745A18).view(np.float32))}
#: draws per chunk of :func:`truncated_normal`: its int64 threefry and
#: float64 erfinv temporaries stay near 3 GB at any shape
_DRAW_CHUNK = 1 << 25


def _erf32(v: float) -> float:
    """XLA's float32 erf(v / sqrt 2) for a bound of :data:`_ERF_AT`."""
    if float(v) not in _ERF_AT:
        raise ValueError(f"truncated_normal takes the bounds "
                         f"{sorted(_ERF_AT)}, whose erf constants are "
                         f"jax's; got {v}")
    return _ERF_AT[float(v)]


def truncated_normal(key, lower, upper, shape, *,
                     device=None) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape)`` in
    float32, step by step as jax 0.9.0 computes it: ``a = erf(lower /
    sqrt 2)`` and ``b = erf(upper / sqrt 2)`` (float32 constants), a
    uniform on [a, b) from the same threefry bits as
    ``jax.random.uniform(minval=a, maxval=b)``, ``sqrt(2) * erfinv(u)``
    with XLA's float32 erfinv (:func:`normal`'s), clipped to
    ``(nextafter(lower, +inf), nextafter(upper, -inf))``. Drawn in
    chunks of the flat counter range (``random_bits(..., start=)``), so
    the temporaries stay bounded whatever the shape. The bounds are
    those of :data:`_ERF_AT` (the inits' -2, 2)."""
    a, b = _erf32(lower), _erf32(upper)
    m = _meta(shape, torch.float32, device)
    if m is not None:
        return m
    lo = float(np.nextafter(np.float32(lower), np.float32(np.inf)))
    hi = float(np.nextafter(np.float32(upper), np.float32(-np.inf)))
    sqrt2 = float(np.float32(np.sqrt(2)))
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float32, device=device)
    for s in range(0, n, _DRAW_CHUNK):
        c = min(_DRAW_CHUNK, n - s)
        u = _on_range(bits_to_uniform(random_bits(key, (c,), device=device,
                                                  start=s)), a, b)
        out[s:s + c] = torch.clamp(_erfinv32(u) * sqrt2, lo, hi)
    return out.reshape(shape)


def permutation(key, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``jax.random``'s ``_shuffle``
    of arange(n), stable sorts keyed by fresh 32-bit draws, with its
    round count ceil(3 ln n / ln(2**32 - 1))."""
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64)
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x
