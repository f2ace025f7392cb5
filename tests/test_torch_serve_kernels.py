"""The serving kernels' wrappers against the JAX reference, on the CPU.

The same numpy inputs go through ``repro.kernels`` (the Pallas kernel in
interpret mode, and its jnp oracle) and through the port's wrappers,
which take their plain versions for CPU tensors. The sweeps and
tolerances are the JAX suite's (``tests/test_kernels.py``): flash
attention over 4 shapes x {causal, causal + window 64, non-causal} at
rtol / atol 2e-5 in float32, and in bfloat16 at 3e-2; the RG-LRU scan
over 3 shapes at rtol / atol 1e-5. One more case emulates the card's
bf16 flash kernel, P rounded to bf16, at the serving tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as jax_flash  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as jax_rglru  # noqa: E402
from repro_torch.kernels import card_check as cc  # noqa: E402
from repro_torch.kernels import ref as port_ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan  # noqa: E402
from repro_torch.models.recurrent import \
    rglru_scan as assoc_scan  # noqa: E402

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
FLASH_SHAPES = [(2, 256, 4, 2, 64), (1, 128, 4, 4, 32),
                (1, 384, 8, 1, 128), (2, 96, 6, 3, 64)]
MASKS = [(True, 0), (True, 64), (False, 0)]
RGLRU_SHAPES = [(2, 64, 512, 64), (1, 300, 1024, 128), (3, 17, 512, 256)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _qkv(b, s, h, hkv, hd, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, s, h, hd)).astype(np.float32),
            r.standard_normal((b, s, hkv, hd)).astype(np.float32),
            r.standard_normal((b, s, hkv, hd)).astype(np.float32))


@pytest.mark.parametrize("shape", FLASH_SHAPES,
                         ids=lambda s: "B{}S{}H{}K{}D{}".format(*s))
@pytest.mark.parametrize("causal,window", MASKS,
                         ids=["causal", "window64", "full"])
def test_flash_attention_matches_reference(shape, causal, window):
    q, k, v = _qkv(*shape)
    n0 = flash_attention.launches
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, window=window)
    assert flash_attention.launches == n0  # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == q.shape
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    kern = jax_flash(jq, jk, jv, causal=causal, window=window)
    oracle = jax_ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                         window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), **F32_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_dtypes(dtype):
    q, k, v = _qkv(1, 128, 2, 2, 64, seed=1)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == tq.dtype
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    kern = jax_flash(jq, jk, jv, causal=True)
    oracle = jax_ref.flash_attention_ref(jq, jk, jv, causal=True, window=0)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    for want in (kern, oracle):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)


def test_flash_attention_window_one_sees_itself():
    """causal with window 1: each query sees only its own key, so the
    output is its key / value head's v row (GQA: head h reads h // g)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 40, 4, 2, 32))
    got = flash_attention(q, k, v, causal=True, window=1)
    np.testing.assert_allclose(
        got.numpy(), torch.repeat_interleave(v, 2, dim=2).numpy(),
        rtol=1e-6, atol=1e-6)


def test_flash_attention_refuses_bad_shapes():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 4, 2, 32))
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention(q, k[:, :8], v[:, :8])
    with pytest.raises(ValueError, match="dtypes differ"):
        flash_attention(q, k.double(), v)
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def _flash_p_in_bf16(q, k, v, *, causal, window):
    """The bf16 tensor-core kernel's rounding, on the CPU: float32 scores
    and softmax, P rounded to bf16 before the PV product, l summed from
    the float32 P, the output rounded once to ``q``'s type."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    kr = torch.repeat_interleave(k.float(), g, dim=2)
    vr = torch.repeat_interleave(v.float(), g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) / np.sqrt(hd)
    pos = torch.arange(s)
    mask = torch.ones((s, s), dtype=torch.bool)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    scores = scores.masked_fill(~mask, -np.inf)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)  # noqa: E741
    out = torch.einsum("bhqk,bkhd->bhqd", p.bfloat16().float(), vr) / l
    return out.transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("shape,causal,window", [
    ((1, 1024, 2, 1, 256), True, 512), ((1, 1024, 3, 1, 64), True, 0),
    ((1, 5120, 2, 1, 128), True, 4096), ((1, 1500, 3, 3, 64), False, 0)],
    ids=["hd256-window512", "hd64-causal", "hd128-window4096",
         "hd64-unmasked1500"])
def test_flash_p_in_bf16_within_serving_tolerance(shape, causal, window):
    """Rounding P to bf16 for the PV product, as the card's bf16 kernel
    does, keeps bf16 attention within ``card_check.FLASH_SERVE_TOL`` of
    the plain version (whose P stays float32)."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(*shape, seed=2))
    got = _flash_p_in_bf16(q, k, v, causal=causal, window=window)
    want = port_ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window).float()
    atol, rtol = cc.FLASH_SERVE_TOL
    d = (got.float() - want).abs()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert bool((d <= atol + rtol * want.abs()).all()), float(d.max())
    # P's rounding shows: the emulation is not the plain version itself
    assert not torch.equal(got.float(), want)


def _ab(b, s, w, seed=0):
    r = np.random.default_rng(seed)
    return (r.uniform(0.2, 0.999, (b, s, w)).astype(np.float32),
            (r.standard_normal((b, s, w)) * 0.3).astype(np.float32))


@pytest.mark.parametrize("b,s,w,bs", RGLRU_SHAPES)
def test_rglru_scan_matches_reference(b, s, w, bs):
    a, bb = _ab(b, s, w)
    n0 = rglru_scan.launches
    got = rglru_scan(torch.from_numpy(a), torch.from_numpy(bb))
    assert rglru_scan.launches == n0  # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == a.shape
    kern = jax_rglru(jnp.asarray(a), jnp.asarray(bb), block_s=bs)
    oracle = jax_ref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(bb))
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), **SCAN_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **SCAN_TOL)


@pytest.mark.parametrize("s", [1, 2, 37, 64, 300])
def test_assoc_scan_matches_sequential(s):
    """The model's plain path (the reference's associative scan) against
    the sequential plain version, odd and even lengths."""
    a, b = (torch.from_numpy(x) for x in _ab(2, s, 64, seed=s))
    np.testing.assert_allclose(assoc_scan(a, b).numpy(),
                               port_ref.rglru_scan_ref(a, b).numpy(),
                               **SCAN_TOL)


def test_rglru_scan_refuses_bad_shapes():
    a, b = (torch.from_numpy(x) for x in _ab(1, 8, 16))
    with pytest.raises(ValueError, match="one \\(B, S, W\\) shape"):
        rglru_scan(a, b[:, :4])
    with pytest.raises(ValueError, match="cpu or cuda"):
        rglru_scan(a.to("meta"), b.to("meta"))
