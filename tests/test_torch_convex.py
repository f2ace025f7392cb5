"""The paper's §3.1 convex models (``repro_torch.models.convex``) and the
variance envelope (``repro_torch.core.variance_model``) against the
reference's, and ``rng.normal`` against ``jax.random.normal``.

The data are the four ``CONVEX_SUITE`` configurations with their
sparsity and noise, cut to 512-1024 samples and 32-128 dims (the full
sizes run on the card, ``chip_smoke.py``'s convex_suite phase), the same
float32 numpy arrays fed to both packages. Tolerances, float32 on both
sides (measured margins in brackets):

- objectives, per-sample gradients, Δ(w): rtol 1e-5 [2e-7]; the full
  gradient, a mean of N per-sample gradients that nearly cancel at w*,
  within 1e-6 of the largest per-sample gradient entry [1.1e-7 abs];
- w*: LS closed form within 1e-5 of max |w*| [1.5e-6, the sparse
  config's ill-conditioned solve]; logistic descent (400 steps) rtol
  1e-5 [2e-7];
- σ²: rtol 1e-5; β² and ρ: rtol 2e-4 [6.7e-5] — Δ itself agrees to
  ~2e-6 in float32 (the two sides sum in other orders), and β² fits
  Δ(w* + t d) - σ², which cancels most of Δ at small t;
- the prediction helpers are numpy on both sides: equal.

``rng.normal`` takes the reference's threefry bits and its uniform map
bit for bit; XLA's float32 erfinv polynomial is evaluated with the same
fused multiply-adds, but its log1p is not XLA's, so about one draw in a
hundred lands 1-3 ulps apart: held to at most 4 ulps, and to at least 97%
of draws bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import variance_model as jvm  # noqa: E402
from repro.models import convex as jcvx  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.configs.paper import CONVEX_SUITE  # noqa: E402
from repro_torch.core import variance_model as pvm  # noqa: E402
from repro_torch.data import convex_dataset  # noqa: E402
from repro_torch.models import convex as pcvx  # noqa: E402

RTOL = 1e-5
BETA_RTOL = 2e-4
# (samples, dims) per CONVEX_SUITE entry, cut from 4096 x 1024, 8192 x 64,
# 4096 x 512 and 8192 x 32
SIZES = {"synth-ls-sparse-highrho": (512, 128),
         "synth-ls-dense-lowrho": (1024, 64),
         "synth-lr-sparse": (512, 64),
         "synth-lr-dense": (1024, 32)}
NAMES = [c.name for c in CONVEX_SUITE]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def problems():
    """Per config: kind, X, y (numpy float32), and the reference's w*."""
    out = {}
    for c in CONVEX_SUITE:
        n, d = SIZES[c.name]
        X, y, _ = convex_dataset(c.model, n, d, sparsity=c.sparsity,
                                 noise=c.noise, seed=0)
        w_star = np.asarray(jcvx.solve_optimum(c.model, jnp.asarray(X),
                                               jnp.asarray(y)))
        out[c.name] = (c.model, X, y, w_star)
    return out


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _points(d, w_star):
    r = np.random.default_rng(3)
    return [w_star, w_star + 0.1 * r.standard_normal(d).astype(np.float32),
            np.zeros(d, np.float32)]


class TestConvexModels:
    """``models/convex.py`` against ``repro.models.convex``."""

    @pytest.mark.parametrize("name", NAMES)
    def test_objectives_and_gradients_match(self, problems, name):
        kind, X, y, w_star = problems[name]
        jobj, jgs = jcvx.make_problem(kind)
        pobj, pgs = pcvx.make_problem(kind)
        for w in _points(X.shape[1], w_star):
            np.testing.assert_allclose(float(pobj(_t(w), _t(X), _t(y))),
                                       float(jobj(w, X, y)), rtol=RTOL)
            for j in (0, 7, len(X) - 1):
                np.testing.assert_allclose(
                    pgs(_t(w), _t(X[j]), _t(y[j])).numpy(),
                    np.asarray(jgs(w, X[j], y[j])), rtol=RTOL, atol=1e-7)
            scale = float(np.abs(pcvx.per_sample_gradients(
                kind, _t(w), _t(X), _t(y)).numpy()).max())
            np.testing.assert_allclose(
                pcvx.full_gradient(kind, _t(w), _t(X), _t(y)).numpy(),
                np.asarray(jcvx.full_gradient(kind, jnp.asarray(w),
                                              jnp.asarray(X), jnp.asarray(y))),
                rtol=RTOL, atol=1e-6 * scale)
            np.testing.assert_allclose(
                float(pcvx.gradient_variance(kind, _t(w), _t(X), _t(y))),
                float(jcvx.gradient_variance(kind, jnp.asarray(w),
                                             jnp.asarray(X), jnp.asarray(y))),
                rtol=RTOL)

    @pytest.mark.parametrize("name", NAMES)
    def test_per_sample_gradients_are_the_samples(self, problems, name):
        """The vectorized per-sample gradients are the loop's, row by row."""
        kind, X, y, w_star = problems[name]
        _, gs = pcvx.make_problem(kind)
        w = _t(_points(X.shape[1], w_star)[1])
        per = pcvx.per_sample_gradients(kind, w, _t(X), _t(y))
        assert per.shape == X.shape
        for j in (0, 5, len(X) - 1):
            np.testing.assert_allclose(per[j].numpy(),
                                       gs(w, _t(X[j]), _t(y[j])).numpy(),
                                       rtol=RTOL, atol=1e-7)

    @pytest.mark.parametrize("name", NAMES)
    def test_solve_optimum_matches(self, problems, name):
        kind, X, y, w_star = problems[name]
        got = pcvx.solve_optimum(kind, _t(X), _t(y))
        assert got.dtype == torch.float32 and got.shape == (X.shape[1],)
        if kind == "ls":
            np.testing.assert_allclose(got.numpy(), w_star, rtol=0,
                                       atol=1e-5 * np.abs(w_star).max())
        else:
            np.testing.assert_allclose(got.numpy(), w_star, rtol=RTOL,
                                       atol=1e-7)
        # an optimum: the full gradient there is small against the start's
        g0 = pcvx.full_gradient(kind, torch.zeros(X.shape[1]), _t(X), _t(y))
        g = pcvx.full_gradient(kind, got, _t(X), _t(y))
        assert float(torch.linalg.norm(g)) < \
            0.05 * float(torch.linalg.norm(g0))

    def test_make_problem_refuses_unknown_kinds(self):
        for fn in (lambda: pcvx.make_problem("svm"),
                   lambda: pcvx.solve_optimum("svm", torch.zeros(2, 2),
                                              torch.zeros(2)),
                   lambda: pcvx.per_sample_gradients("svm", torch.zeros(2),
                                                     torch.zeros(2, 2),
                                                     torch.zeros(2))):
            with pytest.raises(ValueError):
                fn()


class TestVarianceModel:
    """``core/variance_model.py`` against ``repro.core.variance_model``."""

    @pytest.mark.parametrize("name", NAMES)
    def test_variance_envelope_matches(self, problems, name):
        """σ² at w*, β² over 8 random lines of 8 points (the reference's
        key splits and normal draws), ρ from w0 = 0."""
        kind, X, y, w_star = problems[name]
        jfn = jvm.empirical_variance_fn(kind, jnp.asarray(X), jnp.asarray(y))
        pfn = pvm.empirical_variance_fn(kind, _t(X), _t(y))
        s_j = jvm.measure_sigma2(jfn, jnp.asarray(w_star))
        s_p = pvm.measure_sigma2(pfn, _t(w_star))
        np.testing.assert_allclose(s_p, s_j, rtol=RTOL)
        for seed, lines, radius in ((0, 8, 1.0), (5, 3, 0.25)):
            b_j, s2_j = jvm.measure_beta2(jfn, jnp.asarray(w_star),
                                          key=jax.random.PRNGKey(seed),
                                          num_lines=lines, radius=radius)
            b_p, s2_p = pvm.measure_beta2(pfn, _t(w_star),
                                          key=rng.PRNGKey(seed),
                                          num_lines=lines, radius=radius)
            assert b_p > 0
            np.testing.assert_allclose(b_p, b_j, rtol=BETA_RTOL)
            np.testing.assert_allclose(s2_p, s2_j, rtol=RTOL)
        w0 = np.zeros_like(w_star)
        np.testing.assert_allclose(
            pvm.rho(b_p, s_p, _t(w0), _t(w_star)),
            jvm.rho(b_j, s_j, jnp.asarray(w0), jnp.asarray(w_star)),
            rtol=BETA_RTOL)

    @pytest.mark.parametrize("kw", [
        dict(),
        dict(beta2=3.0, dist2=2.0, alive=[1, 0, 1, 1]),
        dict(lr=0.1, steps=8),
        dict(lr=0.05, steps=16, momentum=0.9, drift2=0.3, curvature=2.0,
             alive=[1, 1, 0, 1]),
    ])
    def test_prediction_helpers_equal(self, kw):
        s2 = [0.5, 1.5, 2.0, 0.25]
        assert pvm.predict_averaging_benefit(s2, **kw) == \
            jvm.predict_averaging_benefit(s2, **kw)

    @pytest.mark.parametrize("kw", [dict(lr=0.1, steps=0),
                                    dict(lr=0.1, steps=4, momentum=1.0),
                                    dict(lr=1.0, steps=4, curvature=3.0)])
    def test_prediction_refusals_match(self, kw):
        for mod in (pvm, jvm):
            with pytest.raises(ValueError):
                mod.predict_post_resize_dispersion([1.0, 2.0], **kw)
        for mod in (pvm, jvm):
            with pytest.raises(ValueError):
                mod.predict_averaging_benefit([1.0, 2.0], alive=[0, 0])


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _check_normal(seed, shape):
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    want = np.asarray(jax.random.normal(key, shape))
    got = rng.normal(torch.tensor(np.asarray(key).astype(np.int64)), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    d = _ulps(got.numpy(), want)
    assert d.max(initial=0) <= 4
    assert (d == 0).mean() >= 0.97


class TestNormal:
    """``rng.normal`` against ``jax.random.normal``: short draws."""

    @pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
    @pytest.mark.parametrize("shape", [(), (1,), (7, 33)])
    def test_normal_matches_jax(self, seed, shape):
        _check_normal(seed, shape)

    def test_normal_draws_split_keys_as_the_reference(self):
        """measure_beta2's line directions: key, sub = split(key) per line,
        then normal(sub) — the same directions on both sides."""
        jkey, pkey = jax.random.PRNGKey(9), rng.PRNGKey(9)
        for _ in range(4):
            jkey, jsub = jax.random.split(jkey)
            pkey, psub = rng.split(pkey)
            np.testing.assert_array_equal(psub.numpy(),
                                          np.asarray(jsub).astype(np.int64))
            d = _ulps(rng.normal(psub, (256,)).numpy(),
                      np.asarray(jax.random.normal(jsub, (256,))))
            assert d.max() <= 4


class TestNormalLongDraws:
    """``rng.normal`` against ``jax.random.normal``: long draws."""

    @pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
    @pytest.mark.parametrize("shape", [(1024,), (65536,)])
    def test_normal_matches_jax_long_draws(self, seed, shape):
        _check_normal(seed, shape)


