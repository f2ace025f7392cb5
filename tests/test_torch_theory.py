"""The port's theory module (``repro_torch.core.theory``) against the
reference's (``repro.core.theory``), function by function, on the CPU.

Mirrors ``tests/test_theory.py``:

- the closed forms (Lemma 1's eta and asymptotic variance, the
  Appendix A (Q, P) recursion, Eq. 4's coarse bound, the mixing
  contraction and its fixed point) at rtol 1e-12: the same float64
  arithmetic;
- ``simulate_quadratic`` on the same keys at rtol 1e-5: the same
  threefry draws, the normals within a few float32 ulps of
  ``jax.random.normal``'s (``rng.normal``), 300 float32 steps of the
  process, and the final variance reduced in another order (measured
  about 2e-7 apart at this size);
- ``run_homogeneous_quadratic`` on the same keys (``rng.randint``, bitwise
  ``jax.random.randint``) at rtol 1e-5 / atol 1e-6: float32 matrix
  products summed in another order;
- Example 1's schedule invariance, Lemma 1 against the port's own
  simulation, and the paper's monotonicity and limits, in the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import theory as jt  # noqa: E402
from repro_torch.configs.paper import QuadraticConfig  # noqa: E402
from repro_torch.core import theory as pt  # noqa: E402

CLOSED = dict(rtol=1e-12, atol=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("zeta", [0.0, 0.02, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("beta2", [0.0, 4.0, 60.0])
def test_lemma1_closed_forms_match_the_reference(zeta, beta2):
    args = (0.05, 1.0, beta2, 1.0, 16, zeta)
    np.testing.assert_allclose(pt.lemma1_asymptotic_variance(*args),
                               jt.lemma1_asymptotic_variance(*args), **CLOSED)
    np.testing.assert_allclose(pt.lemma1_eta(zeta, 0.05, 1.0),
                               jt.lemma1_eta(zeta, 0.05, 1.0), **CLOSED)
    np.testing.assert_allclose(
        pt.qp_recursion(0.05, 1.0, beta2, 1.0, 16, zeta, 400, 0.3, 0.7),
        jt.qp_recursion(0.05, 1.0, beta2, 1.0, 16, zeta, 400, 0.3, 0.7),
        **CLOSED)


@pytest.mark.parametrize("k", [1, 5, 10_000])
@pytest.mark.parametrize("gap", [0.0, 0.25, 1.0])
def test_dispersion_bounds_match_the_reference(k, gap):
    args = (0.01, 1.0, 1.0, 1.0, k)
    np.testing.assert_allclose(pt.coarse_dispersion_bound(*args),
                               jt.coarse_dispersion_bound(*args), **CLOSED)
    np.testing.assert_allclose(pt.mixing_contraction(gap),
                               jt.mixing_contraction(gap), **CLOSED)
    np.testing.assert_allclose(pt.mixed_dispersion_fixed_point(*args, gap),
                               jt.mixed_dispersion_fixed_point(*args, gap),
                               **CLOSED)


@pytest.mark.parametrize("zeta", [0.0, 0.02, 0.5, 1.0])
@pytest.mark.parametrize("w0_std", [0.0, 0.3])
def test_simulate_quadratic_matches_the_reference(zeta, w0_std):
    c = QuadraticConfig()
    args = (c.alpha, c.c, c.beta2, c.sigma2, 8, zeta, 300)
    want = jt.simulate_quadratic(*args, reps=200, seed=1, w0_std=w0_std)
    got = pt.simulate_quadratic(*args, reps=200, seed=1, w0_std=w0_std,
                                device="cpu")
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_simulate_quadratic_draws_in_blocks():
    """A noise block smaller than the run (the draw split over several
    ``start=`` blocks) gives the run of one block."""
    args = (0.05, 1.0, 4.0, 1.0, 6, 0.1, 50)
    one = pt.simulate_quadratic(*args, reps=40, seed=2, device="cpu")
    old = pt._DRAW_BLOCK
    try:
        pt._DRAW_BLOCK = 7 * 40 * 6  # 7 steps a block, the last short
        blocks = pt.simulate_quadratic(*args, reps=40, seed=2, device="cpu")
    finally:
        pt._DRAW_BLOCK = old
    assert blocks == one


def _homogeneous_problem():
    key = jax.random.PRNGKey(0)
    dim, m = 6, 40
    A = jax.random.normal(key, (dim, dim)) * 0.2
    P = A @ A.T + jnp.eye(dim)
    qs = jax.random.normal(jax.random.PRNGKey(1), (m, dim))
    return P, qs, jnp.ones(dim)


@pytest.mark.parametrize("phase_len", [0, 1, 10, 200])
def test_homogeneous_quadratic_matches_the_reference(phase_len):
    P, qs, w0 = _homogeneous_problem()
    want = jt.run_homogeneous_quadratic(P, qs, w0, 0.02, 200, M=8,
                                        phase_len=phase_len, seed=3)
    got = pt.run_homogeneous_quadratic(
        np.asarray(P), np.asarray(qs), np.asarray(w0), 0.02, 200, M=8,
        phase_len=phase_len, seed=3, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_homogeneous_quadratic_schedule_invariance():
    """Example 1 in the port: one-shot == periodic == minibatch averaging
    on the same draws (the reference's own test and tolerance)."""
    P, qs, w0 = (np.asarray(a) for a in _homogeneous_problem())
    outs = [pt.run_homogeneous_quadratic(P, qs, w0, 0.02, 200, M=8,
                                         phase_len=k, seed=3, device="cpu")
            for k in [0, 1, 10, 200]]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("zeta", [0.0, 0.1, 1.0])
def test_lemma1_matches_the_port_simulation(zeta):
    """The reference's Lemma 1 check (rel 0.15), at fewer reps and steps:
    the process reaches its stationary variance within ~100 steps, and
    1000 reps estimate it within ~5% (one standard error)."""
    alpha, c, beta2, sigma2, M = 0.05, 1.0, 4.0, 1.0, 16
    pred = pt.lemma1_asymptotic_variance(alpha, c, beta2, sigma2, M, zeta)
    sim = pt.simulate_quadratic(alpha, c, beta2, sigma2, M, zeta,
                                steps=300, reps=1000, device="cpu")
    assert sim == pytest.approx(pred, rel=0.15)


def test_lemma1_monotone_and_limits():
    vs = [pt.lemma1_asymptotic_variance(0.05, 1.0, 4.0, 1.0, 24, z)
          for z in [0.0, 0.01, 0.1, 0.5, 1.0]]
    assert all(a >= b - 1e-15 for a, b in zip(vs, vs[1:]))
    flat = [pt.lemma1_asymptotic_variance(0.05, 1.0, 0.0, 1.0, 24, z)
            for z in [0.0, 0.1, 1.0]]
    assert max(flat) == pytest.approx(min(flat), rel=1e-12)
    single = 0.05 / (2 - 0.05 - 0.05 * 4.0 / 8)
    assert pt.lemma1_asymptotic_variance(0.05, 1.0, 4.0, 1.0, 8, 1.0) == \
        pytest.approx(single / 8, rel=1e-12)
    b_small = pt.coarse_dispersion_bound(0.01, 1.0, 1.0, 1.0, 5)
    b_large = pt.coarse_dispersion_bound(0.01, 1.0, 1.0, 1.0, 10_000)
    assert b_small < b_large <= 0.01 / (2 - 0.01) + 1e-12


def test_theory_exported_as_the_reference():
    from repro_torch import core
    assert core.lemma1_asymptotic_variance is pt.lemma1_asymptotic_variance
    assert core.simulate_quadratic is pt.simulate_quadratic
