"""The slice as a whole: the port's PhaseEngine against the JAX reference's
on identical staged batches (numpy draws fed to both).

Cases:
  ls        — bench_engine's ``ls`` recipe: Momentum lr 0.01 / mu 0.9,
              M=4, dim 64, periodic K=4, 16 steps;
  paper-mb  — the paper's ``synth-ls-sparse-highrho`` least squares
              (1024 dims, 24 workers, one sample per worker and step;
              512 samples instead of 4096) with SGD on the paper's
              lr0 / (t - 1 + d) schedule, minibatch averaging;
  paper-hier— the same under hierarchical averaging (inner_groups 2):
              the ``avg_disp`` event path;
  smollm    — reduced smollm-360m in float32: M=4, Momentum, periodic
              K=3, 6 steps.

Decision codes, event steps and ``averages`` must be equal; loss and
dispersion traces and the final plane allclose — for the convex cases at
the reference suite's own tolerances (tests/test_flat.py: params and
loss rtol 1e-6 / atol 1e-7, dispersion rtol 1e-5), for smollm at loss
rtol 2e-5 and final plane atol 2e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import reduced_f32  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.core.averaging import AveragingSchedule as JSched  # noqa: E402
from repro.core.engine import PhaseEngine as JEngine  # noqa: E402
from repro.core.engine import tree_stack  # noqa: E402
from repro.core.flat import FlatSpec as JaxFlatSpec  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.models import lm_loss as jax_lm_loss  # noqa: E402
from repro_torch import optim as popt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.paper import CONVEX_SUITE  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import AveragingSchedule, PhaseEngine  # noqa: E402
from repro_torch.data import convex_dataset, token_stream  # noqa: E402
from repro_torch.models import lm_loss  # noqa: E402

CONVEX_TOL = dict(params=dict(rtol=1e-6, atol=1e-7),
                  loss=dict(rtol=1e-6, atol=1e-7), disp=dict(rtol=1e-5))
SMOLLM_TOL = dict(params=dict(rtol=0, atol=2e-5),
                  loss=dict(rtol=2e-5), disp=dict(rtol=1e-5))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---- the cases: (jax loss, port loss, params, batches, schedule kw,
#      (jax optimizer, port optimizer), workers, tolerances) -------------

def _ls_case():
    m, dim, samples, steps = 4, 64, 1024, 16
    X, y, _ = convex_dataset("ls", samples, dim, sparsity=0.2, noise=0.1,
                             seed=0)
    idx = np.random.default_rng(0).integers(0, samples, (steps, m, 8))
    batches = [{"x": X[idx[t]], "y": y[idx[t]]} for t in range(steps)]

    def jloss(p, b, r):
        res = b["x"] @ p["w"] - b["y"]
        return 0.5 * jnp.mean(res * res), {}

    def ploss(p, b, r):
        res = b["x"] @ p["w"] - b["y"]
        return 0.5 * torch.mean(res * res), {}

    return dict(jloss=jloss, ploss=ploss,
                params={"w": np.zeros(dim, np.float32)}, batches=batches,
                sched=dict(kind="periodic", phase_len=4),
                opts=(jopt.Momentum(lr=0.01, mu=0.9),
                      popt.Momentum(lr=0.01, mu=0.9)),
                workers=m, tol=CONVEX_TOL)


def _paper_case(sched):
    c = CONVEX_SUITE[0]
    assert c.name == "synth-ls-sparse-highrho"
    n, steps = 512, 32
    X, y, _ = convex_dataset(c.model, n, c.num_dims, sparsity=c.sparsity,
                             noise=c.noise, seed=0)
    idx = np.random.default_rng(0).integers(0, n, (steps, c.num_workers))
    batches = [{"x": X[idx[t]], "y": y[idx[t]]} for t in range(steps)]
    lr_d = 200.0
    lr0 = 0.8 * lr_d / float(np.mean(np.sum(X * X, axis=1)))

    def lr(t):
        return lr0 / (t - 1.0 + lr_d)

    def jloss(p, b, r):
        return 0.5 * jnp.square(b["x"] @ p["w"] - b["y"]), {}

    def ploss(p, b, r):
        return 0.5 * torch.square(b["x"] @ p["w"] - b["y"]), {}

    return dict(jloss=jloss, ploss=ploss,
                params={"w": np.zeros(c.num_dims, np.float32)},
                batches=batches, sched=sched,
                opts=(jopt.SGD(lr=lr), popt.SGD(lr=lr)),
                workers=c.num_workers, tol=CONVEX_TOL)


def _smollm_case():
    m, b, s, steps = 4, 2, 16, 6
    jcfg = reduced_f32("smollm-360m")
    pcfg = dataclasses.replace(get_config("smollm-360m", reduced=True),
                               dtype="float32")
    params = jax.tree.map(np.asarray, jax_init(jcfg, jax.random.PRNGKey(0)))
    streams = [token_stream(jcfg.vocab_size, b, s, seed=i) for i in range(m)]
    batches = [{"tokens": np.stack([next(st) for st in streams])}
               for _ in range(steps)]
    return dict(jloss=lambda p, bt, r: jax_lm_loss(jcfg, p, bt),
                ploss=lambda p, bt, r: lm_loss(pcfg, p, bt),
                params=params, batches=batches,
                sched=dict(kind="periodic", phase_len=3),
                opts=(jopt.Momentum(lr=0.01, mu=0.9),
                      popt.Momentum(lr=0.01, mu=0.9)),
                workers=m, tol=SMOLLM_TOL)


CASES = {
    "ls": _ls_case,
    "paper-mb": lambda: _paper_case(dict(kind="minibatch")),
    "paper-hier": lambda: _paper_case(dict(
        kind="hierarchical", inner_groups=2, inner_phase_len=4,
        outer_phase_len=16)),
    "smollm": _smollm_case,
}


def _run_both(case):
    m, seed = case["workers"], 3
    jopt_, popt_ = case["opts"]
    # reference: one compiled phase over the whole staged block
    jeng = JEngine(case["jloss"], jopt_, JSched(**case["sched"]))
    jstate = jeng.init(jax.tree.map(jnp.asarray, case["params"]), m, seed)
    staged = tree_stack([jax.tree.map(jnp.asarray, bt)
                         for bt in case["batches"]])
    jstate, jtrace = jeng.run_phase(jstate, staged)
    wp = jstate.worker_params
    jplane = np.asarray(JaxFlatSpec.of(wp).pack(wp))
    jtrace = jax.tree.map(np.asarray, jtrace)
    # port: the same block through run_phase, and through run
    peng = PhaseEngine(case["ploss"], popt_,
                       AveragingSchedule(**case["sched"]), device="cpu")
    params = params_from_jax(case["params"], device="cpu")
    pstate = peng.init(params, m, seed)
    pstate, ptrace = peng.run_phase(pstate, case["batches"])
    final, hist = peng.run(params, iter(case["batches"]), num_workers=m,
                           seed=seed, record_every=1)
    return dict(jtrace=jtrace, jplane=jplane, ptrace=ptrace,
                pplane=pstate.plane.numpy(), hist=hist, final=final,
                tol=case["tol"],
                # the CUDA kernels update the planes in place
                contiguous=pstate.plane.is_contiguous() and all(
                    s.is_contiguous() for s in pstate.opt_planes))


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _run_both(CASES[name]())
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(CASES))
def test_decisions_and_events_equal(runs, name):
    r = runs(name)
    codes = [int(c) for c in r["jtrace"]["avg_code"]]
    assert r["ptrace"]["avg_code"] == codes
    events = [t for t, c in enumerate(codes, start=1) if c]
    assert events, "the case must average at least once"
    assert r["hist"]["averages"] == len(events)
    assert [t for t, _ in r["hist"]["dispersion"]] == events
    if name == "paper-hier":
        assert codes.count(1) == 6 and codes.count(2) == 2


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_dispersion_traces_close(runs, name):
    r = runs(name)
    tol = r["tol"]
    np.testing.assert_allclose(r["ptrace"]["loss"], r["jtrace"]["loss"],
                               **tol["loss"])
    np.testing.assert_allclose(r["ptrace"]["dispersion"],
                               r["jtrace"]["dispersion"], **tol["disp"])
    # run()'s history records the same per-step traces
    np.testing.assert_allclose([v for _, v in r["hist"]["loss"]],
                               r["jtrace"]["loss"], **tol["loss"])
    np.testing.assert_allclose([v for _, v in r["hist"]["disp_trace"]],
                               r["jtrace"]["dispersion"], **tol["disp"])


@pytest.mark.parametrize("name", list(CASES))
def test_final_plane_close(runs, name):
    r = runs(name)
    assert r["contiguous"]
    np.testing.assert_allclose(r["pplane"], r["jplane"], **r["tol"]["params"])
    # the consensus run() returns is the worker mean of that plane
    cons = np.concatenate([x.reshape(-1).numpy()
                           for x in jax.tree.leaves(r["final"])])
    np.testing.assert_allclose(cons, r["jplane"].mean(axis=0),
                               **r["tol"]["params"])
