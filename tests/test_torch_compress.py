"""``repro_torch.core.compress`` against ``repro.core.compress``: the wire
sizes, the eager refusals, and the encode+decode of every wire format on
the same numpy planes (the reference run op by op, as its tests run it).

bf16 and int8 (with the same uniforms) are compared bitwise: the same
IEEE operations in the same order. one_bit within rtol 1e-6: its row
scale mean|v| is summed in float32 by the reference and in float64 by
the port (whose CUDA kernel sums in float64 in another order, and must
round to the same float32)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import compress as jc  # noqa: E402
from repro_torch.core import compress as pc  # noqa: E402

WIRES = ("bf16", "int8", "one_bit")


def _plane(m=6, p=3001, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, p))
         * 10.0 ** rng.integers(-3, 3, (m, 1))).astype(np.float32)
    x[2] = 0.0  # an all-zero row quantizes to zero in every format
    x[3, :5] = [0.0, -0.0, 1e-30, -3e30, 3e30]
    r = (rng.standard_normal((m, p)) * 1e-2).astype(np.float32)
    u = rng.random((m, p), dtype=np.float32)
    return x, r, u


def test_constants_match():
    assert pc.WIRE_FORMATS == jc.WIRE_FORMATS
    assert pc.WIRE_BITS == jc.WIRE_BITS
    assert pc._ENC_SALT == jc._ENC_SALT


@pytest.mark.parametrize("wire", ("f32",) + WIRES)
def test_wire_row_bytes(wire):
    for p in (1, 7, 8, 1000, 361_821_120):
        assert pc.wire_row_bytes(p, wire) == jc.wire_row_bytes(p, wire)
        assert pc.Compression(wire).row_bytes(p) == \
            jc.Compression(wire).row_bytes(p)
    c = pc.Compression(wire)
    assert (c.is_identity, c.stochastic) == (jc.Compression(wire).is_identity,
                                             jc.Compression(wire).stochastic)


@pytest.mark.parametrize("kw", [dict(wire="fp8"),
                                dict(wire="int8", error_feedback=False),
                                dict(wire="one_bit", error_feedback=False)])
def test_compression_refusals_match(kw):
    with pytest.raises(ValueError) as ej:
        jc.Compression(**kw)
    with pytest.raises(ValueError) as ep:
        pc.Compression(**kw)
    assert str(ep.value) == str(ej.value)
    with pytest.raises(ValueError):
        pc.wire_row_bytes(10, "fp8")


@pytest.mark.parametrize("wire", WIRES)
def test_quantize_matches(wire):
    x, _, u = _plane()
    got = pc.quantize(torch.from_numpy(x), wire,
                      u=torch.from_numpy(u)).numpy()
    want = np.asarray(jc.quantize(jnp.asarray(x), wire, u=jnp.asarray(u)))
    assert not got[2].any()
    if wire == "one_bit":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("wire,ef", [("bf16", True), ("bf16", False),
                                     ("int8", True), ("one_bit", True)])
def test_encode_decode_matches(wire, ef):
    x, r, u = _plane(seed=1)
    q_p, r_p = pc.encode_decode(torch.from_numpy(x), torch.from_numpy(r),
                                wire=wire, u=torch.from_numpy(u),
                                error_feedback=ef)
    q_j, r_j = jc.encode_decode(jnp.asarray(x), jnp.asarray(r), wire=wire,
                                u=jnp.asarray(u), error_feedback=ef)
    tol = dict(rtol=1e-6, atol=0) if wire == "one_bit" else \
        dict(rtol=0, atol=0)
    np.testing.assert_allclose(q_p.numpy(), np.asarray(q_j), **tol)
    # the residual v - q: |v - q| <= ~|v|, so one_bit's scale difference
    # shows as an absolute one of the size of the scale's rounding
    np.testing.assert_allclose(
        r_p.numpy(), np.asarray(r_j),
        **(dict(rtol=1e-6, atol=1e-6 * float(np.abs(x).max()))
           if wire == "one_bit" else tol))
    if not ef:
        assert np.array_equal(r_p.numpy(), r)


def test_int8_needs_uniforms():
    with pytest.raises(ValueError, match="row_uniforms"):
        pc.quantize(torch.zeros(2, 3), "int8")


def test_one_bit_scale_is_f64_mean():
    x, _, _ = _plane(seed=2)
    s = pc.row_scales(torch.from_numpy(x), "one_bit").numpy()[:, 0]
    want = (np.abs(x).astype(np.float64).sum(1) / x.shape[1]).astype(
        np.float32)
    np.testing.assert_array_equal(s, want)
