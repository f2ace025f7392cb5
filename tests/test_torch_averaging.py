"""The port's averaging schedules against the JAX reference: decision
codes and the SchedState carry agree bit for bit over a fixed dispersion
stream (the stochastic draws and the adaptive_bytes credit included),
eager validation refuses the same configurations with the same
messages, straggle_aware's discounted decisions match the reference's,
and the outer optimizer's tree step matches the reference."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.averaging import AveragingSchedule as JSched  # noqa: E402
from repro.core.averaging import OuterOptimizer as JOuter  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.core.averaging import (AveragingSchedule,  # noqa: E402
                                        OuterOptimizer)

KINDS = {
    "oneshot": dict(kind="oneshot"),
    "minibatch": dict(kind="minibatch"),
    "periodic": dict(kind="periodic", phase_len=4),
    "hierarchical": dict(kind="hierarchical", inner_phase_len=3,
                         outer_phase_len=8, inner_groups=2),
    "adaptive_threshold": dict(kind="adaptive_threshold",
                               disp_threshold=0.35, disp_ema_beta=0.7),
    "adaptive_budget": dict(kind="adaptive_budget", comm_budget=6,
                            budget_horizon=40, disp_ema_beta=0.5),
    "stochastic": dict(kind="stochastic", zeta=0.3),
    "adaptive_bytes": dict(kind="adaptive_bytes", byte_budget=5000,
                           budget_horizon=40, disp_ema_beta=0.5),
}
#: adaptive_bytes: bytes one event costs (a ring of 4 workers shipping
#: 256-entry f32 rows: 2 messages of 1024 B)
EVENT_COST = 2048.0
STEPS = 40


def _disp_stream(seed=0):
    rng = np.random.default_rng(seed)
    # a rising-and-falling envelope with noise, like a phase's dispersion
    t = np.arange(1, STEPS + 1)
    return (0.2 + 0.3 * np.sin(t / 6.0) ** 2
            + 0.05 * rng.standard_normal(STEPS)).astype(np.float32)


def _bits(x, dt):
    return np.asarray(x, dt).view(np.uint32 if dt == np.float32 else dt)


@pytest.mark.parametrize("name", list(KINDS))
def test_decision_state_matches_jax(name):
    port, ref = AveragingSchedule(**KINDS[name]), JSched(**KINDS[name])
    assert port.expected_phase_len() == pytest.approx(
        ref.expected_phase_len(), nan_ok=True)
    s_p, s_j = port.init_sched_state(), ref.init_sched_state()
    # the engine's decision key for seed 5: split(PRNGKey(5))[1]
    k_p = rng.split(rng.PRNGKey(5))[1]
    k_j = jax.random.split(jax.random.PRNGKey(5))[1]
    codes = []
    for step, d in enumerate(_disp_stream(), start=1):
        c_p, s_p = port.decision_state(step, s_p, d, k_p,
                                       event_cost=EVENT_COST)
        c_j, s_j = ref.decision_state(jnp.asarray(step, jnp.int32), s_j,
                                      jnp.asarray(d), k_j,
                                      event_cost=EVENT_COST)
        assert c_p == int(c_j), (step, c_p, int(c_j))
        codes.append(c_p)
        for f in ("disp_ema", "cum_disp", "credit"):
            np.testing.assert_array_equal(
                _bits(getattr(s_p, f), np.float32),
                _bits(getattr(s_j, f), np.float32), err_msg=f"{f}@{step}")
        for f in ("comm_spent", "since_avg"):
            assert int(getattr(s_p, f)) == int(getattr(s_j, f)), (f, step)
    if name != "oneshot":
        assert any(codes), "the stream must exercise at least one event"


BAD = [
    dict(kind="nope"),
    dict(kind="periodic", phase_len=0),
    dict(kind="stochastic", zeta=0.0),
    dict(kind="stochastic", zeta=1.5),
    dict(kind="hierarchical", inner_groups=0),
    dict(kind="hierarchical", outer_phase_len=0),
    dict(kind="adaptive_threshold", disp_threshold=0.0),
    dict(kind="adaptive_threshold", disp_threshold=1.0, disp_ema_beta=1.0),
    dict(kind="adaptive_budget", comm_budget=0, budget_horizon=5),
    dict(kind="adaptive_budget", comm_budget=6, budget_horizon=5),
    dict(kind="adaptive_bytes", byte_budget=0, budget_horizon=5),
    dict(kind="periodic", straggle_aware=True),
]


@pytest.mark.parametrize("kw", BAD, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_eager_validation_matches_jax(kw):
    with pytest.raises(ValueError) as ej:
        JSched(**kw)
    with pytest.raises(ValueError) as ep:
        AveragingSchedule(**kw)
    assert str(ep.value) == str(ej.value)


@pytest.mark.parametrize("name", ["adaptive_threshold", "adaptive_budget",
                                  "adaptive_bytes"])
def test_straggle_aware_decisions_match_jax(name):
    """straggle_aware: the dispersion times the step's ``disp_scale`` (a
    float32 fraction of the cohort, as ``FaultPlan.disp_scale`` gives it)
    feeds the EMA and the budget; codes and the carry bit for bit the
    reference's; the unaware schedule accrues the unscaled stream."""
    kw = dict(KINDS[name], straggle_aware=True)
    port, ref = AveragingSchedule(**kw), JSched(**kw)
    s_p, s_j = port.init_sched_state(), ref.init_sched_state()
    s_u = AveragingSchedule(**KINDS[name]).init_sched_state()
    scales = np.random.default_rng(1).integers(12, 25, STEPS).astype(
        np.float32) / np.float32(24)
    codes = []
    for step, (d, sc) in enumerate(zip(_disp_stream(2), scales), start=1):
        c_p, s_p = port.decision_state(step, s_p, d, None,
                                       event_cost=EVENT_COST, disp_scale=sc)
        c_j, s_j = ref.decision_state(jnp.asarray(step, jnp.int32), s_j,
                                      jnp.asarray(d), None,
                                      event_cost=EVENT_COST,
                                      disp_scale=jnp.asarray(sc))
        assert c_p == int(c_j), (step, c_p, int(c_j))
        for f in ("disp_ema", "cum_disp", "credit"):
            np.testing.assert_array_equal(
                _bits(getattr(s_p, f), np.float32),
                _bits(getattr(s_j, f), np.float32), err_msg=f"{f}@{step}")
        _, s_u = AveragingSchedule(**KINDS[name]).decision_state(
            step, s_u, d, None, event_cost=EVENT_COST, disp_scale=sc)
        codes.append(c_p)
    assert any(codes) and s_p.cum_disp < s_u.cum_disp


def test_static_kinds_refuse_stateless_adaptive_code():
    with pytest.raises(ValueError, match="SchedState"):
        AveragingSchedule("adaptive_threshold",
                          disp_threshold=1.0).decision_code(3)


@pytest.mark.parametrize("zeta", [0.05, 0.5, 1.0])
def test_stochastic_decisions_bitwise_over_many_keys(zeta):
    """Every decision of 200 steps under 4 seeds: the Bernoulli draw on
    fold_in(dec_key, step), bit for bit the reference's."""
    port = AveragingSchedule("stochastic", zeta=zeta)
    ref = JSched("stochastic", zeta=zeta)
    for seed in range(4):
        k_p = rng.split(rng.PRNGKey(seed))[1]
        k_j = jax.random.split(jax.random.PRNGKey(seed))[1]
        got = [port.decision_code(t, k_p) for t in range(1, 201)]
        want = np.asarray(jax.vmap(lambda t: ref.decision_code(t, k_j))(
            jnp.arange(1, 201, dtype=jnp.int32)))
        assert got == want.tolist(), seed
    assert port.expected_phase_len() == ref.expected_phase_len()


def test_stochastic_needs_the_decision_key():
    with pytest.raises(ValueError, match="key"):
        AveragingSchedule("stochastic", zeta=0.5).decision_code(3)


def test_adaptive_bytes_needs_the_event_cost():
    s = AveragingSchedule("adaptive_bytes", byte_budget=10,
                          budget_horizon=5)
    with pytest.raises(ValueError, match="event_cost"):
        s.decision_state(1, s.init_sched_state(), 0.5)


@pytest.mark.parametrize("nesterov", [True, False])
def test_outer_optimizer_apply_matches_jax(nesterov):
    """Two outer steps on a two-leaf tree (f32 and bf16): velocity and
    f32 average within rtol 1e-6, the bf16 leaf within one bf16 ulp —
    XLA may contract a multiply-add into an FMA, which moves an f32
    value by an ulp and can carry it across a bf16 rounding boundary."""
    rng_np = np.random.default_rng(4)
    leaves = [rng_np.standard_normal(300).astype(np.float32)
              for _ in range(6)]
    po = OuterOptimizer(lr=0.7, momentum=0.5, nesterov=nesterov)
    jo = JOuter(lr=0.7, momentum=0.5, nesterov=nesterov)

    def trees(a, b):
        return ({"w": torch.from_numpy(a),
                 "e": torch.from_numpy(b).to(torch.bfloat16)},
                {"w": jnp.asarray(a), "e": jnp.asarray(b, jnp.bfloat16)})

    prev_p, prev_j = trees(leaves[0], leaves[1])
    vel_p, vel_j = po.init(prev_p), jo.init(prev_j)
    for k in range(2, 6, 2):
        new_p, new_j = trees(leaves[k], leaves[k + 1])
        prev_p, vel_p = po.apply(prev_p, new_p, vel_p)
        prev_j, vel_j = jo.apply(prev_j, new_j, vel_j)
        assert prev_p["e"].dtype == torch.bfloat16
        np.testing.assert_allclose(vel_p["w"].numpy(),
                                   np.asarray(vel_j["w"]), rtol=1e-6)
        np.testing.assert_allclose(prev_p["w"].numpy(),
                                   np.asarray(prev_j["w"]), rtol=1e-6)
        np.testing.assert_allclose(
            prev_p["e"].float().numpy(),
            np.asarray(prev_j["e"], np.float32), rtol=2 ** -7)
