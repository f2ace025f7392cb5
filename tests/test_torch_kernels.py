"""The port's plane passes against the JAX reference, on the CPU.

Same numpy inputs through ``repro.kernels`` (the Pallas kernel in
interpret mode, and its jnp twin) and through the port's wrappers, which
take their plain versions for CPU tensors. Plane outputs: rtol 1e-6 /
atol 1e-7; dispersion: rtol 1e-5 (a full-plane f32 sum, reduced in a
different order by each side).

Mixed rows (``W @``, the compressed events) are held to rtol 1e-6 /
atol 1e-6: the reference's ``jnp.dot`` sums the M terms in another order
than the port's j-ordered loop. Columns with bf16/f16 rounding codes are
held to one unit in the last place of their dtype instead. Measured reason: the jitted reference
(and the Pallas interpreter) lets XLA contract ``a * b + c`` into an
FMA, so 5-15% of its float32 updates differ from op-by-op rounding by
one f32 ulp (op-by-op JAX matches the port bitwise for sgd and
momentum); where such a value sits on a bf16/f16 rounding boundary the
rounded result moves by one dtype ulp — 1 of 20,000 elements in the
nesterov / M=8 / P=2500 case (4.77e-7 at 9.5e-4, one f16 ulp). In the
fused compressed step the same ulp can move an int8 ``floor`` by one
quantum, a one_bit sign or a bf16 wire rounding; such entries are
counted and the count bounded (``FLIP_BOUND``) instead of loosening the
whole comparison.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import avg_disp as jax_avg  # noqa: E402
from repro.kernels import opt_step as jax_opt  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch import rng as prng  # noqa: E402
from repro_torch import topology as ptopo  # noqa: E402
from repro_torch.kernels import ref as port_ref  # noqa: E402
from repro_torch.kernels.avg_disp import (avg_disp,  # noqa: E402
                                          avg_disp_outer, compressed_mix,
                                          mix_disp)
from repro_torch.kernels.opt_step import opt_step  # noqa: E402

PLANE_TOL = dict(rtol=1e-6, atol=1e-7)
MIX_TOL = dict(rtol=1e-6, atol=1e-6)
#: entries of a fused compressed step allowed outside tolerance (measured
#: 0 on these inputs; see the module note)
FLIP_BOUND = 4
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


def assert_plane_close(got, want, codes=None, tol=PLANE_TOL):
    got, want = np.asarray(got), np.asarray(want)
    if codes is None:
        np.testing.assert_allclose(got, want, **tol)
        return
    f32 = np.broadcast_to(codes == 0.0, got.shape)
    np.testing.assert_allclose(got[f32], want[f32], **tol)
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


# ---- the communication axis: mixing, outer optimizer, compression ------

def _mixing(name, m):
    """(M, M) f32 doubly-stochastic W: a topology's, a gossip matching,
    or a random convex mix of permutation matrices."""
    if name == "ring":
        return ptopo.Topology.ring(m).mixing_matrix().numpy()
    if name == "hypercube":
        return ptopo.Topology.hypercube(m).mixing_matrix().numpy()
    if name == "gossip":
        return ptopo.gossip_matrix(prng.PRNGKey(1), 3, m).numpy()
    rng = np.random.default_rng(m)
    w = rng.dirichlet(np.ones(4))
    W = sum(wk * np.eye(m)[rng.permutation(m)] for wk in w)
    return W.astype(np.float32)


def _n_outside(got, want, codes, tol):
    """Entries outside ``tol``; on coded columns outside ``tol`` plus one
    dtype ulp — the f32 sums differ by up to ``tol`` before they round
    to the dtype, and near zero that difference is several dtype ulps."""
    got, want = np.asarray(got), np.asarray(want)
    lim = tol["atol"] + tol["rtol"] * np.abs(want)
    if codes is not None:
        c = np.broadcast_to(codes, got.shape)
        lim = np.where(c == 0.0, lim, lim + _dtype_ulp(
            np.maximum(np.abs(got), np.abs(want)), c))
    return int(np.sum(np.abs(got - want) > lim))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"M{s[0]}P{s[1]}")
@pytest.mark.parametrize("wname", ["ring", "hypercube", "gossip", "random"])
def test_mix_disp_plain_matches_jax(wname, shape):
    m, p, _ = shape
    x = np.random.default_rng(5).standard_normal((m, p)).astype(np.float32)
    W = _mixing(wname, m)
    got, got_d = mix_disp(_t(x), _t(W))
    for want, want_d in (jax_avg.mix_disp(x, W, interpret=True),
                         jax_ref.mix_disp_ref(jnp.asarray(x),
                                              jnp.asarray(W))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MIX_TOL)
        np.testing.assert_allclose(float(got_d), float(want_d), **DISP_TOL)


def test_mix_disp_with_codes_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((8, 1500)).astype(np.float32)
    codes = rng.integers(0, 3, 1500).astype(np.float32)
    W = _mixing("ring", 8)
    got, got_d = port_ref.mix_disp_ref(_t(x), _t(W), codes=_t(codes))
    want, want_d = jax_ref.mix_disp_ref(jnp.asarray(x), jnp.asarray(W),
                                        codes=jnp.asarray(codes))
    assert _n_outside(got.numpy(), want, codes, MIX_TOL) == 0
    np.testing.assert_allclose(float(got_d), float(want_d), **DISP_TOL)


def test_plain_mix_is_the_j_ordered_loop():
    """``_mix`` is the sum over j in order of separately rounded products
    — the CUDA kernels' arithmetic — not a matmul."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((5, 300)).astype(np.float32)
    W = _mixing("random", 5)
    want = np.zeros_like(x)
    for i in range(5):
        acc = np.zeros(300, np.float32)
        for j in range(5):
            acc = acc + np.float32(W[i, j]) * x[j]
        want[i] = acc
    got = port_ref._mix(_t(W), _t(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"M{s[0]}P{s[1]}")
@pytest.mark.parametrize("codes", [False, True], ids=["f32", "codes"])
@pytest.mark.parametrize("opt", list(OPTS))
def test_opt_step_mix_plain_matches_jax(opt, codes, shape):
    m, p, _ = shape
    kind, hyp = OPTS[opt]
    x, g, st, scal, cd = _inputs(m, p, kind, codes, seed=8)
    W = _mixing("ring" if m == 4 else "hypercube", m)
    kw = dict(kind=kind, mode="mix", **hyp)
    got_x, got_s, got_d = opt_step(_t(x), _t(g), tuple(map(_t, st)),
                                   _t(scal), codes=_t(cd), W=_t(W), **kw)
    pallas = jax_opt.opt_step(x, g, st, scal, codes=cd, W=W,
                              interpret=True, **kw)
    twin = jax_ref.opt_step_ref(jnp.asarray(x), jnp.asarray(g),
                                tuple(map(jnp.asarray, st)),
                                jnp.asarray(scal), codes=cd,
                                W=jnp.asarray(W), **kw)
    for want_x, want_s, want_d in (pallas, twin):
        assert _n_outside(got_x.numpy(), want_x, cd, MIX_TOL) == 0
        for a, b in zip(got_s, want_s):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       **PLANE_TOL)
        np.testing.assert_allclose(float(got_d), float(want_d), **DISP_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"M{s[0]}P{s[1]}")
@pytest.mark.parametrize("nesterov", [True, False])
def test_avg_disp_outer_plain_matches_jax(nesterov, shape):
    m, p, _ = shape
    rng = np.random.default_rng(9)
    x, prev, vel = (rng.standard_normal(s).astype(np.float32)
                    for s in ((m, p), (p,), (p,)))
    kw = dict(lr=0.7, momentum=0.5, nesterov=nesterov)
    got = avg_disp_outer(_t(x), _t(prev), _t(vel), **kw)
    assert got[0].shape == (m, p)
    # the mean is summed in another order than jnp.mean's, and the outer
    # step's differences cancel it into small values: MIX_TOL
    for want in (jax_avg.avg_disp_outer(x, prev, vel, interpret=True, **kw),
                 jax_ref.avg_disp_outer_ref(jnp.asarray(x),
                                            jnp.asarray(prev),
                                            jnp.asarray(vel), **kw)):
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       **MIX_TOL)
        np.testing.assert_allclose(float(got[3]), float(want[3]),
                                   **DISP_TOL)


def test_avg_disp_outer_with_codes_matches_jax():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((4, 1500)).astype(np.float32)
    prev = x.mean(0).astype(np.float32)
    vel = (rng.standard_normal(1500) * 0.1).astype(np.float32)
    codes = rng.integers(0, 3, 1500).astype(np.float32)
    kw = dict(lr=1.0, momentum=0.5, nesterov=True)
    got = port_ref.avg_disp_outer_ref(_t(x), _t(prev), _t(vel),
                                      codes=_t(codes), **kw)
    want = jax_ref.avg_disp_outer_ref(jnp.asarray(x), jnp.asarray(prev),
                                      jnp.asarray(vel),
                                      codes=jnp.asarray(codes), **kw)
    assert_plane_close(got[0].numpy(), want[0], codes)
    assert_plane_close(got[1].numpy(), want[1], codes)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               **PLANE_TOL)


def _wire_inputs(m, p, seed):
    rng = np.random.default_rng(seed)
    r = (rng.standard_normal((m, p)) * 1e-2).astype(np.float32)
    u = rng.random((m, p), dtype=np.float32)
    return r, u


@pytest.mark.parametrize("ef", [True, False], ids=["ef", "no-ef"])
@pytest.mark.parametrize("codes", [False, True], ids=["f32", "codes"])
@pytest.mark.parametrize("mode", ["mean", "group", "mix"])
@pytest.mark.parametrize("wire", ["bf16", "int8", "one_bit"])
def test_compressed_mix_plain_matches_jax(wire, mode, codes, ef):
    """The compressed event alone: the same v = x + e on both sides, so
    the wire roundings agree and no entry may fall outside tolerance."""
    m, p, groups = SHAPES[1]
    x, _, _, _, cd = _inputs(m, p, "sgd", codes, seed=11)
    r, u = _wire_inputs(m, p, 12)
    W = _mixing("ring", m) if mode == "mix" else None
    kw = dict(wire=wire, u=u if wire == "int8" else None, codes=cd,
              error_feedback=ef)
    got = compressed_mix(_t(x), _t(r), mode=mode, W=_t(W),
                         groups=groups if mode == "group" else 1,
                         **{k: _t(v) if k in ("u", "codes") else v
                            for k, v in kw.items()})
    pallas = jax_avg.compressed_mix(
        x, r, mode=mode, W=W, groups=groups if mode == "group" else 1,
        interpret=True, **kw)
    if mode == "mix":
        twin = jax_ref.compressed_mix_ref(jnp.asarray(x), jnp.asarray(r),
                                          jnp.asarray(W), **kw)
    else:
        twin = jax_ref.compressed_avg_ref(
            jnp.asarray(x), jnp.asarray(r),
            groups=groups if mode == "group" else 1, **kw)
    for want in (pallas, twin):
        assert _n_outside(got[0].numpy(), want[0], cd, MIX_TOL) == 0
        assert _n_outside(got[1].numpy(), want[1], None, MIX_TOL) == 0
        np.testing.assert_allclose(float(got[2]), float(want[2]),
                                   **DISP_TOL)
    if not ef:
        np.testing.assert_array_equal(got[1].numpy(), r)


@pytest.mark.parametrize("codes", [False, True], ids=["f32", "codes"])
@pytest.mark.parametrize("mode", ["mean", "group", "mix"])
@pytest.mark.parametrize("wire", ["bf16", "int8", "one_bit"])
def test_opt_step_wire_plain_matches_jax(wire, mode, codes):
    """The fused update + compressed event: entries outside tolerance
    (an XLA FMA moving v across a wire rounding) are counted and the
    count bounded by FLIP_BOUND."""
    m, p, groups = SHAPES[0]
    kind, hyp = OPTS["momentum"]
    x, g, st, scal, cd = _inputs(m, p, kind, codes, seed=13)
    r, u = _wire_inputs(m, p, 14)
    W = _mixing("ring", m) if mode == "mix" else None
    kw = dict(kind=kind, mode=mode, groups=groups if mode == "group" else 1,
              wire=wire, **hyp)
    got = opt_step(_t(x), _t(g), tuple(map(_t, st)), _t(scal),
                   codes=_t(cd), W=_t(W), resid=_t(r),
                   u=_t(u) if wire == "int8" else None, **kw)
    jkw = dict(kw, codes=cd, resid=r, u=u if wire == "int8" else None)
    pallas = jax_opt.opt_step(x, g, st, scal, W=W, interpret=True, **jkw)
    twin = jax_ref.opt_step_ref(
        jnp.asarray(x), jnp.asarray(g), tuple(map(jnp.asarray, st)),
        jnp.asarray(scal), W=None if W is None else jnp.asarray(W), **jkw)
    assert len(got) == 4
    for want in (pallas, twin):
        flips = (_n_outside(got[0].numpy(), want[0], cd, MIX_TOL)
                 + _n_outside(got[2].numpy(), want[2], None, MIX_TOL))
        assert flips <= FLIP_BOUND, flips
        np.testing.assert_allclose(got[1][0].numpy(), np.asarray(want[1][0]),
                                   **PLANE_TOL)
        np.testing.assert_allclose(float(got[3]), float(want[3]),
                                   **DISP_TOL)


@pytest.mark.parametrize("bad", [
    dict(mode="mix"), dict(W="eye"), dict(mode="mix", W="eye3"),
    dict(mode="none", wire="bf16"), dict(mode="mean", wire="int8"),
    dict(mode="mean", wire="bf16", u="u"), dict(mode="mean", wire="fp8"),
    dict(mode="mean", resid="r")],
    ids=["mix-no-W", "W-not-mix", "W-shape", "wire-none", "int8-no-u",
         "u-not-int8", "bad-wire", "resid-no-wire"])
def test_opt_step_refuses_bad_communication_args(bad):
    x, g, st, scal, _ = _inputs(4, 64, "momentum", False)
    r, u = _wire_inputs(4, 64, 0)
    extra = {"eye": torch.eye(4), "eye3": torch.eye(3), "u": _t(u),
             "r": _t(r)}
    kw = {k: extra.get(v, v) for k, v in bad.items()}
    if kw.get("wire") and "resid" not in kw:
        kw["resid"] = _t(r)
    with pytest.raises(ValueError):
        opt_step(_t(x), _t(g), tuple(map(_t, st)), _t(scal),
                 kind="momentum", **kw)


def test_event_wrappers_refuse_bad_args():
    x = torch.zeros(4, 16)
    with pytest.raises(ValueError, match="W"):
        mix_disp(x, torch.eye(3))
    with pytest.raises(ValueError, match="prev_avg"):
        avg_disp_outer(x, torch.zeros(15), torch.zeros(16), lr=1.0,
                       momentum=0.5)
    with pytest.raises(ValueError, match="event mode"):
        compressed_mix(x, x.clone(), wire="bf16", mode="none")
    with pytest.raises(ValueError, match="residual"):
        compressed_mix(x, None, wire="bf16")
    with pytest.raises(ValueError, match="int8"):
        compressed_mix(x, x.clone(), wire="int8")


def test_ptxas_resources_parse_nvcc_log():
    """The build reports each kernel's registers and spills from
    ``nvcc -Xptxas -v``, each under the entry function's name as ptxas
    prints it."""
    from repro_torch.kernels._build import ptxas_resources
    emit = ("_ZN50_GLOBAL__N__5b0b1f41_17_compressed_mix_cu_42f445ae9emit_"
            "colsILi64ELi0EEEvPfS1_PKfS3_S3_S3_S1_iliii")
    log = (
        f"ptxas info    : Compiling entry function '{emit}' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN50_GLOBAL__N__5b0b1f4\n"
        "    24 bytes stack frame, 24 bytes spill stores, 24 bytes spill "
        "loads\n"
        "ptxas info    : Used 254 registers, used 1 barriers, 24 bytes "
        "cumulative stack size, 17408 bytes smem\n"
        "ptxas info    : Compiling entry function '_Z12sum_partialsPKflfPf' "
        "for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 32 registers, used 1 barriers, 8192 bytes smem")
    assert ptxas_resources(log) == [
        {"kernel": emit, "stack": 24, "spill_stores": 24,
         "spill_loads": 24, "registers": 254, "smem": 17408},
        {"kernel": "_Z12sum_partialsPKflfPf", "stack": 0, "spill_stores": 0,
         "spill_loads": 0, "registers": 32, "smem": 8192}]


def test_ptxas_resources_without_static_smem():
    """A kernel with dynamic shared memory only (flash_attention's) gets
    its registers, and 0 bytes of static shared memory."""
    from repro_torch.kernels._build import ptxas_resources
    log = (
        "ptxas info    : Compiling entry function '_Z9flash_fwdv' for "
        "'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers, 404 bytes "
        "cmem[0]")
    assert ptxas_resources(log) == [
        {"kernel": "_Z9flash_fwdv", "stack": 0, "spill_stores": 0,
         "spill_loads": 0, "registers": 128, "smem": 0}]
