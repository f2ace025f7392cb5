"""The port's plane passes against the JAX reference, on the CPU.

Same numpy inputs through ``repro.kernels`` (the Pallas kernel in
interpret mode, and its jnp twin) and through the port's wrappers, which
take their plain versions for CPU tensors. Plane outputs: rtol 1e-6 /
atol 1e-7; dispersion: rtol 1e-5 (a full-plane f32 sum, reduced in a
different order by each side).

Columns with bf16/f16 rounding codes are held to one unit in the last
place of their dtype instead. Measured reason: the jitted reference
(and the Pallas interpreter) lets XLA contract ``a * b + c`` into an
FMA, so 5-15% of its float32 updates differ from op-by-op rounding by
one f32 ulp (op-by-op JAX matches the port bitwise for sgd and
momentum); where such a value sits on a bf16/f16 rounding boundary the
rounded result moves by one dtype ulp — 1 of 20,000 elements in the
nesterov / M=8 / P=2500 case (4.77e-7 at 9.5e-4, one f16 ulp).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import avg_disp as jax_avg  # noqa: E402
from repro.kernels import opt_step as jax_opt  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.kernels import ref as port_ref  # noqa: E402
from repro_torch.kernels.avg_disp import avg_disp  # noqa: E402
from repro_torch.kernels.opt_step import opt_step  # noqa: E402

PLANE_TOL = dict(rtol=1e-6, atol=1e-7)
DISP_TOL = dict(rtol=1e-5)
# (M, P, groups): both P are ragged against the reference's block_p 1024
SHAPES = [(4, 1000, 2), (8, 2500, 4)]
OPTS = {"sgd": ("sgd", {}), "momentum": ("momentum", {"mu": 0.9}),
        "nesterov": ("momentum", {"mu": 0.9, "nesterov": True}),
        "adamw": ("adamw", {"b1": 0.9, "b2": 0.95, "eps": 1e-8,
                            "weight_decay": 0.01})}
NSTATE = {"sgd": 0, "momentum": 1, "adamw": 2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(m, p, kind, with_codes, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, p)).astype(np.float32)
    g = rng.standard_normal((m, p)).astype(np.float32)
    st = [rng.standard_normal((m, p)).astype(np.float32)
          for _ in range(NSTATE[kind])]
    if kind == "adamw":
        st[1] = np.abs(st[1])
    codes = (rng.integers(0, 3, p).astype(np.float32) if with_codes
             else None)
    scal = np.array([0.05, 0.19, 0.0975, 0.0], np.float32)
    return x, g, tuple(st), scal, codes


def _dtype_ulp(v, codes):
    """One ulp of each element's column dtype (bf16: 8 significant
    bits, f16: 11 with subnormals below 2**-14) at magnitude |v|."""
    e = np.frexp(np.abs(v).astype(np.float64))[1] - 1
    bf = np.ldexp(1.0, e - 7)
    f16 = np.ldexp(1.0, np.maximum(e, -14) - 10)
    return np.where(codes == 1.0, bf, f16)


def assert_plane_close(got, want, codes=None):
    got, want = np.asarray(got), np.asarray(want)
    if codes is None:
        np.testing.assert_allclose(got, want, **PLANE_TOL)
        return
    f32 = np.broadcast_to(codes == 0.0, got.shape)
    np.testing.assert_allclose(got[f32], want[f32], **PLANE_TOL)
    c = np.broadcast_to(codes, got.shape)[~f32]
    g, w = got[~f32], want[~f32]
    ulp = _dtype_ulp(np.maximum(np.abs(g), np.abs(w)), c)
    assert np.all(np.abs(g - w) <= ulp), np.max(np.abs(g - w) / ulp)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def test_round_to_codes_bitwise():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((6, 4000)) *
         10.0 ** rng.integers(-8, 6, (6, 4000))).astype(np.float32)
    x[0, :4] = [np.inf, -np.inf, 70000.0, -0.0]
    codes = rng.integers(0, 3, 4000).astype(np.float32)
    want = np.asarray(jax_ref.round_to_codes(jnp.asarray(x),
                                             jnp.asarray(codes)[None]))
    got = port_ref.round_to_codes(_t(x), _t(codes)[None]).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"M{s[0]}P{s[1]}")
@pytest.mark.parametrize("codes", [False, True], ids=["f32", "codes"])
@pytest.mark.parametrize("mode", ["none", "mean", "group"])
@pytest.mark.parametrize("opt", list(OPTS))
def test_opt_step_plain_matches_jax(opt, mode, codes, shape):
    m, p, groups = shape
    kind, hyp = OPTS[opt]
    x, g, st, scal, cd = _inputs(m, p, kind, codes)
    kw = dict(kind=kind, mode=mode, groups=groups if mode == "group" else 1,
              **hyp)
    got_x, got_s, got_d = opt_step(_t(x), _t(g), tuple(map(_t, st)),
                                   _t(scal), codes=_t(cd), **kw)
    pallas = jax_opt.opt_step(x, g, st, scal, codes=cd, interpret=True,
                              **kw)
    twin = jax_ref.opt_step_ref(jnp.asarray(x), jnp.asarray(g),
                                tuple(map(jnp.asarray, st)),
                                jnp.asarray(scal), codes=cd, **kw)
    for want_x, want_s, want_d in (pallas, twin):
        assert_plane_close(got_x.numpy(), want_x, cd)
        assert len(got_s) == len(want_s) == NSTATE[kind]
        for a, b in zip(got_s, want_s):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       **PLANE_TOL)
        np.testing.assert_allclose(float(got_d), float(want_d), **DISP_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"M{s[0]}P{s[1]}")
@pytest.mark.parametrize("groups", [1, 2])
def test_avg_disp_plain_matches_jax(groups, shape):
    m, p, _ = shape
    x = np.random.default_rng(2).standard_normal((m, p)).astype(np.float32)
    got, got_d = avg_disp(_t(x), groups=groups)
    for want, want_d in (jax_avg.avg_disp(x, groups=groups, interpret=True),
                         jax_ref.avg_disp_ref(jnp.asarray(x),
                                              groups=groups)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **PLANE_TOL)
        np.testing.assert_allclose(float(got_d), float(want_d), **DISP_TOL)


@pytest.mark.parametrize("groups", [1, 2])
def test_plane_average_with_codes_matches_jax(groups):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 1500)).astype(np.float32)
    codes = rng.integers(0, 3, 1500).astype(np.float32)
    got, got_d = port_ref.plane_average_ref(_t(x), groups=groups,
                                            codes=_t(codes))
    want, want_d = jax_ref.plane_average_ref(jnp.asarray(x), groups=groups,
                                             codes=jnp.asarray(codes))
    assert_plane_close(got.numpy(), want, codes)
    np.testing.assert_allclose(float(got_d), float(want_d), **DISP_TOL)


@pytest.mark.parametrize("bad", [
    dict(kind="rmsprop"), dict(mode="mix"), dict(mode="group", groups=3),
    dict(kind="sgd", planes=1)])
def test_opt_step_rejects_what_it_cannot_run(bad):
    x, g, st, scal, _ = _inputs(4, 64, "momentum", False)
    kind = bad.get("kind", "momentum")
    planes = tuple(map(_t, st))[:bad.get("planes", 1)]
    with pytest.raises(ValueError):
        opt_step(_t(x), _t(g), planes, _t(scal), kind=kind,
                 mode=bad.get("mode", "none"), groups=bad.get("groups", 1))


def test_avg_disp_rejects_non_dividing_groups():
    with pytest.raises(ValueError, match="divide"):
        avg_disp(torch.zeros(4, 8), groups=3)
