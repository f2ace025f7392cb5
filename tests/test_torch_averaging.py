"""The port's averaging schedules against the JAX reference: decision
codes and the SchedState carry agree bit for bit over a fixed dispersion
stream, eager validation refuses the same configurations with the same
messages, and the two unported kinds raise NotImplementedError."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.averaging import AveragingSchedule as JSched  # noqa: E402
from repro_torch.core.averaging import AveragingSchedule  # noqa: E402

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
}
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
    codes = []
    for step, d in enumerate(_disp_stream(), start=1):
        c_p, s_p = port.decision_state(step, s_p, d)
        c_j, s_j = ref.decision_state(jnp.asarray(step, jnp.int32), s_j,
                                      jnp.asarray(d))
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


@pytest.mark.parametrize("kw", [
    dict(kind="stochastic", zeta=0.1),
    dict(kind="adaptive_bytes", byte_budget=100, budget_horizon=10),
    dict(kind="adaptive_threshold", disp_threshold=1.0,
         straggle_aware=True)], ids=["stochastic", "adaptive_bytes",
                                     "straggle_aware"])
def test_unported_kinds_raise_not_implemented(kw):
    JSched(**kw)  # valid for the reference
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        AveragingSchedule(**kw)


def test_static_kinds_refuse_stateless_adaptive_code():
    with pytest.raises(ValueError, match="SchedState"):
        AveragingSchedule("adaptive_threshold",
                          disp_threshold=1.0).decision_code(3)
