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
              K=3, 6 steps;
  ls-<topology>-{periodic,minibatch} — the ls recipe over each of the
              seven topologies, the rare events (``mix_disp`` /
              ``avg_disp``) and the fused ones (``opt_step`` mode mix /
              mean / group);
  ls-stochastic, ls-bytes — the stochastic (ζ=0.3) and adaptive_bytes
              schedules: Bernoulli draws and byte pricing;
  ls-<wire>-{mean,ring} — periodic K=4 with the bf16 / int8 / one_bit
              wire and error feedback (``compressed_mix``), int8 with the
              reference's stochastic-rounding uniforms; ls-gossip-int8
              and ls-int8-mb (minibatch: the ``opt_step`` wire path);
  ls-outer-{periodic,minibatch} — the outer optimizer (momentum 0.5);
  smollm-ring-1bit — reduced smollm-360m (float32), ring + one_bit,
              periodic K=2: the compressed mix on a model's plane;
  ls16-*     — the ls recipe with a bfloat16 weight, so every column
              carries a rounding code: ring + one_bit (``compressed_mix``
              with codes), minibatch gossip (``opt_step`` mode mix with
              codes), gossip alone (``mix_disp`` with codes) and the
              outer optimizer (its plain ``avg_disp_outer_ref``, as the
              reference on coded planes). The mix-only cases use gossip
              matchings, whose W (entries 0, ½) makes every mixed value
              one rounded sum of two exact products in any order; a ring
              W's 1/3 entries summed in ``jnp.dot``'s order can move a
              bf16 rounding, after which the trajectories drift apart.

Decision codes, event steps and ``averages`` must be equal; loss and
dispersion traces and the final plane allclose — for the convex cases at
the reference suite's own tolerances (tests/test_flat.py: params and
loss rtol 1e-6 / atol 1e-7, dispersion rtol 1e-5), for smollm at loss
rtol 2e-5 and final plane atol 2e-5. The bf16 ls cases hold the plane
to one bf16 ulp (rtol 2**-8) and the losses and dispersions to 1e-4: an
f32 value that XLA contracts into an FMA (the update) or sums in another
order (the one_bit scale) can land one ulp away and move a bf16
rounding. (A bf16 *model* is not compared: PyTorch and
XLA round a bf16 transformer's intermediates at other places, which
moves its losses by ~1e-4 before any averaging.)

Lowerings pinned bitwise within the port: topology ``full`` and the
``f32`` wire equal running without them, and topology ``groups`` equals
the hierarchical inner event of the same groups at the same steps.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import reduced_f32  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro import topology as jtopo  # noqa: E402
from repro.core.averaging import AveragingSchedule as JSched  # noqa: E402
from repro.core.averaging import OuterOptimizer as JOuter  # noqa: E402
from repro.core.compress import Compression as JComp  # noqa: E402
from repro.core.engine import PhaseEngine as JEngine  # noqa: E402
from repro.core.engine import tree_stack  # noqa: E402
from repro.core.flat import FlatSpec as JaxFlatSpec  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.models import lm_loss as jax_lm_loss  # noqa: E402
from repro_torch import optim as popt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.paper import CONVEX_SUITE  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch import topology as ptopo  # noqa: E402
from repro_torch.core import AveragingSchedule, PhaseEngine  # noqa: E402
from repro_torch.core.averaging import OuterOptimizer  # noqa: E402
from repro_torch.core.compress import Compression  # noqa: E402
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

def _ls_case(sched=None, dtype=np.float32, tol=CONVEX_TOL, **comm):
    m, dim, samples, steps = 4, 64, 1024, 16
    X, y, _ = convex_dataset("ls", samples, dim, sparsity=0.2, noise=0.1,
                             seed=0)
    idx = np.random.default_rng(0).integers(0, samples, (steps, m, 8))
    batches = [{"x": X[idx[t]], "y": y[idx[t]]} for t in range(steps)]

    def jloss(p, b, r):
        res = b["x"] @ p["w"].astype(jnp.float32) - b["y"]
        return 0.5 * jnp.mean(res * res), {}

    def ploss(p, b, r):
        res = b["x"] @ p["w"].float() - b["y"]
        return 0.5 * torch.mean(res * res), {}

    return dict(jloss=jloss, ploss=ploss,
                params={"w": np.zeros(dim, dtype)}, batches=batches,
                sched=sched or dict(kind="periodic", phase_len=4),
                opts=(jopt.Momentum(lr=0.01, mu=0.9),
                      popt.Momentum(lr=0.01, mu=0.9)),
                workers=m, tol=tol, **comm)


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


def _smollm_case(dtype="float32", sched=None, tol=SMOLLM_TOL, **comm):
    m, b, s, steps = 4, 2, 16, 6
    jcfg = dataclasses.replace(reduced_f32("smollm-360m"), dtype=dtype)
    pcfg = dataclasses.replace(get_config("smollm-360m", reduced=True),
                               dtype=dtype)
    params = jax.tree.map(np.asarray, jax_init(jcfg, jax.random.PRNGKey(0)))
    streams = [token_stream(jcfg.vocab_size, b, s, seed=i) for i in range(m)]
    batches = [{"tokens": np.stack([next(st) for st in streams])}
               for _ in range(steps)]
    return dict(jloss=lambda p, bt, r: jax_lm_loss(jcfg, p, bt),
                ploss=lambda p, bt, r: lm_loss(pcfg, p, bt),
                params=params, batches=batches,
                sched=sched or dict(kind="periodic", phase_len=3),
                opts=(jopt.Momentum(lr=0.01, mu=0.9),
                      popt.Momentum(lr=0.01, mu=0.9)),
                workers=m, tol=tol, **comm)


PERIODIC = dict(kind="periodic", phase_len=4)
MINIBATCH = dict(kind="minibatch")
TOPOLOGIES = ("full", "ring", "torus", "hypercube", "groups",
              "gossip_pairs", "disconnected")
#: the bf16 cases: a bf16 rounding may move by one ulp (module note)
BF16_TOL = dict(params=dict(rtol=2 ** -8, atol=1e-7),
                loss=dict(rtol=1e-4), disp=dict(rtol=1e-4))
BF16 = jnp.bfloat16

CASES = {
    "ls": _ls_case,
    "paper-mb": lambda: _paper_case(dict(kind="minibatch")),
    "paper-hier": lambda: _paper_case(dict(
        kind="hierarchical", inner_groups=2, inner_phase_len=4,
        outer_phase_len=16)),
    "smollm": _smollm_case,
    **{f"ls-{t}-{k}": (lambda t=t, sc=sc: _ls_case(sc, topology=t))
       for t in TOPOLOGIES
       for k, sc in (("periodic", PERIODIC), ("minibatch", MINIBATCH))},
    "ls-stochastic": lambda: _ls_case(dict(kind="stochastic", zeta=0.3)),
    "ls-bytes": lambda: _ls_case(dict(kind="adaptive_bytes",
                                      byte_budget=1024, budget_horizon=16),
                                 topology="ring", wire="bf16"),
    **{f"ls-{w}-{t or 'mean'}": (lambda w=w, t=t: _ls_case(
        PERIODIC, topology=t, wire=w))
       for w in ("bf16", "int8", "one_bit") for t in (None, "ring")},
    "ls-gossip-int8": lambda: _ls_case(PERIODIC, topology="gossip_pairs",
                                       wire="int8"),
    "ls-int8-mb": lambda: _ls_case(MINIBATCH, topology="torus",
                                   wire="int8"),
    "ls-outer-periodic": lambda: _ls_case(PERIODIC, outer=0.5),
    "ls-outer-minibatch": lambda: _ls_case(MINIBATCH, outer=0.5),
    "smollm-ring-1bit": lambda: _smollm_case(
        sched=dict(kind="periodic", phase_len=2), topology="ring",
        wire="one_bit"),
    "ls16-ring-1bit": lambda: _ls_case(PERIODIC, BF16, BF16_TOL,
                                       topology="ring", wire="one_bit"),
    "ls16-gossip-mb": lambda: _ls_case(MINIBATCH, BF16, BF16_TOL,
                                       topology="gossip_pairs"),
    "ls16-gossip": lambda: _ls_case(PERIODIC, BF16, BF16_TOL,
                                    topology="gossip_pairs"),
    "ls16-outer": lambda: _ls_case(PERIODIC, BF16, BF16_TOL, outer=0.5),
}
WIRE_CASES = ["ls-bytes", "ls-gossip-int8", "ls-int8-mb",
              "smollm-ring-1bit", "ls16-ring-1bit",
              *(f"ls-{w}-{t}" for w in ("bf16", "int8", "one_bit")
                for t in ("mean", "ring"))]


def _comm(case, jax_side: bool, m: int) -> dict:
    """The engine's topology / compression / outer keywords of a case."""
    topo = (jtopo if jax_side else ptopo).Topology
    kw = {}
    if case.get("topology"):
        kw["topology"] = topo.build(case["topology"], m)
    if case.get("wire"):
        kw["compression"] = (JComp if jax_side else Compression)(
            case["wire"])
    if case.get("outer"):
        kw["outer"] = (JOuter if jax_side else OuterOptimizer)(
            lr=1.0, momentum=case["outer"])
    return kw


def _run_both(case):
    m, seed = case["workers"], 3
    jopt_, popt_ = case["opts"]
    # reference: one compiled phase over the whole staged block
    jeng = JEngine(case["jloss"], jopt_, JSched(**case["sched"]),
                   **_comm(case, True, m))
    jstate = jeng.init(jax.tree.map(jnp.asarray, case["params"]), m, seed)
    staged = tree_stack([jax.tree.map(jnp.asarray, bt)
                         for bt in case["batches"]])
    jstate, jtrace = jeng.run_phase(jstate, staged)
    wp = jstate.worker_params
    jplane = np.asarray(JaxFlatSpec.of(wp).pack(wp))
    jtrace = jax.tree.map(np.asarray, jtrace)
    # port: the same block through run_phase, and through run
    peng = PhaseEngine(case["ploss"], popt_,
                       AveragingSchedule(**case["sched"]), device="cpu",
                       **_comm(case, False, m))
    params = params_from_jax(case["params"], device="cpu")
    pstate = peng.init(params, m, seed)
    pstate, ptrace = peng.run_phase(pstate, case["batches"])
    final, hist = peng.run(params, iter(case["batches"]), num_workers=m,
                           seed=seed, record_every=1)
    jresid = (np.asarray(jstate.resid) if case.get("wire") else None)
    return dict(jtrace=jtrace, jplane=jplane, ptrace=ptrace,
                pplane=pstate.plane.numpy(), hist=hist, final=final,
                tol=case["tol"], jresid=jresid,
                presid=(None if pstate.resid is None
                        else pstate.resid.numpy()),
                keys=(np.asarray(jstate.key), pstate.key.numpy()),
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
    # the data key advanced once per step, as the reference's
    jkey, pkey = r["keys"]
    np.testing.assert_array_equal(pkey.astype(np.uint32), jkey)


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
    cons = np.concatenate([x.reshape(-1).float().numpy()
                           for x in jax.tree.leaves(r["final"])])
    np.testing.assert_allclose(cons, r["jplane"].mean(axis=0),
                               **r["tol"]["params"])


@pytest.mark.parametrize("name", WIRE_CASES)
def test_residual_close(runs, name):
    """The error-feedback residual plane at the end of the run."""
    r = runs(name)
    assert r["presid"] is not None and r["presid"].shape == r["jresid"].shape
    tol = r["tol"]["params"]
    np.testing.assert_allclose(r["presid"], r["jresid"], rtol=tol["rtol"],
                               atol=max(tol["atol"], 1e-6))


def _port_run(sched, batches_case, **kw):
    case = batches_case
    eng = PhaseEngine(case["ploss"], case["opts"][1],
                      AveragingSchedule(**sched), device="cpu", **kw)
    params = params_from_jax(case["params"], device="cpu")
    state = eng.init(params, case["workers"], 3)
    state, trace = eng.run_phase(state, case["batches"])
    return state, trace


@pytest.mark.parametrize("sched", [PERIODIC, MINIBATCH],
                         ids=["periodic", "minibatch"])
def test_full_topology_and_f32_wire_are_the_plain_engine(sched):
    case = _ls_case()
    base, _ = _port_run(sched, case)
    for kw in (dict(topology=ptopo.Topology.full(4)),
               dict(compression=Compression("f32"))):
        st, _ = _port_run(sched, case, **kw)
        assert torch.equal(st.plane, base.plane), kw
        assert st.resid is None


def test_groups_topology_is_the_group_mean_event():
    """topology groups(2) under periodic K=4 against the hierarchical
    inner event of the same 2 groups every 4 steps (no outer event in
    the run): the same planes, bit for bit."""
    case = _ls_case()
    st_g, tr_g = _port_run(PERIODIC, case,
                           topology=ptopo.Topology.blocks(4, 2))
    st_h, tr_h = _port_run(dict(kind="hierarchical", inner_groups=2,
                                inner_phase_len=4, outer_phase_len=10**6),
                           case)
    assert [c // 2 for c in tr_g["avg_code"]] == tr_h["avg_code"]
    assert torch.equal(st_g.plane, st_h.plane)


@pytest.mark.parametrize("bad", ["workers", "outer-ring", "outer-wire"])
def test_engine_refuses_bad_communication(bad):
    kw = {"workers": dict(topology=ptopo.Topology.ring(5)),
          "outer-ring": dict(topology=ptopo.Topology.ring(4),
                             outer=OuterOptimizer(momentum=0.5)),
          "outer-wire": dict(compression=Compression("bf16"),
                             outer=OuterOptimizer(momentum=0.5))}[bad]
    eng = PhaseEngine(lambda p, b, r: (p["w"].sum(), {}), popt.SGD(0.1),
                      AveragingSchedule(**PERIODIC), device="cpu", **kw)
    with pytest.raises(ValueError):
        eng.init({"w": torch.zeros(8)}, 4)
