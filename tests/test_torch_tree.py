"""The port's tree machinery and unfused carries against the JAX
reference's, on the CPU, the same numpy draws fed to both:

- the optimizers' tree ``apply`` (SGD, Momentum ± Nesterov, AdamW) against
  the reference's within rtol 1e-6 / atol 1e-7, and bit for bit the rows
  the port's plane twin ``plane_update_ref`` gives (float32 leaves; a
  bf16 leaf against the plane's rounding codes);
- the tree averages (``average_all``, ``average_inner``,
  ``worker_dispersion``), ``mix_tree`` and the seven ``*_tree`` fault
  helpers against the reference's (means and mixes rtol 1e-6 / atol 1e-7,
  row selections exactly, dispersions rtol 1e-5), the means and mixes
  bit for bit the port's plane twins;
- ``PhaseEngine(fused_opt=False)`` (the ``flat`` carry) and
  ``PhaseEngine(flat=False)`` (the ``tree`` carry) over the seven
  schedules, a ring, the outer optimizer, one_bit and int8 wires, a bf16
  leaf and the crash + rejoin plan of ``tests/test_faults.py`` with
  stragglers: each against the reference's same carry (decisions,
  ``averages`` and event steps equal; params rtol 1e-6 / atol 1e-7 —
  one bf16 ulp on the bf16 case — losses allclose, dispersions rtol
  1e-5: R1) and against the port's own flat-native run (params and
  losses bit for bit, as the reference's
  ``test_crash_rejoin_bitwise_across_paths`` holds its carries;
  dispersions within rtol 1e-6, the tree carry summing them per leaf);
- the carries over ``DeviceDataset`` index blocks and ``run_host``
  bitwise their staged ``run``; ``return_state`` in the flat-native
  layout, a checkpoint and an elastic resize of a tree-carry run; a
  float64 tree (no plane) in the tree carry; the refusals;
- ``LocalSGD`` against the reference's;
- the CLI's ``--tree-engine``, ``--no-fused-opt`` and ``--scan-unroll``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import TOL, assert_histories_match  # noqa: E402
from repro import faults as jf  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro import topology as jtopo  # noqa: E402
from repro.core import averaging as javg  # noqa: E402
from repro.core.averaging import AveragingSchedule as JSched  # noqa: E402
from repro.core.averaging import OuterOptimizer as JOuter  # noqa: E402
from repro.core.compress import Compression as JComp  # noqa: E402
from repro.core.engine import PhaseEngine as JEngine  # noqa: E402
from repro.core.local_sgd import LocalSGD as JLocalSGD  # noqa: E402
from repro_torch import faults as pf  # noqa: E402
from repro_torch import optim as popt  # noqa: E402
from repro_torch import topology as ptopo  # noqa: E402
from repro_torch.checkpoint import (load_engine_state,  # noqa: E402
                                    save_engine_state)
from repro_torch.core import (AveragingSchedule, LocalSGD,  # noqa: E402
                              PhaseEngine, average_all, average_inner,
                              consensus, replicate, worker_dispersion)
from repro_torch.core.averaging import OuterOptimizer  # noqa: E402
from repro_torch.core.compress import Compression  # noqa: E402
from repro_torch.core.flat import FlatSpec, tree_flatten  # noqa: E402
from repro_torch.data import DeviceDataset, convex_dataset  # noqa: E402
from repro_torch.elastic import ElasticPlan, run_elastic  # noqa: E402
from repro_torch.kernels import ref as pref  # noqa: E402
from repro_torch.launch import train  # noqa: E402

WORKERS, DIM, STEPS = 4, 16, 24
_PLAN = "crash:m=1@t=6,rejoin:m=1@t=14"
BF16_TOL = dict(params=dict(rtol=2 ** -8, atol=1e-7), loss=dict(rtol=1e-4),
                disp=dict(rtol=1e-4))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


def _draw(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def _close(got, want, tol=TOL["params"]):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **tol)


def _eq(a, b):
    return torch.equal(a, b) and a.dtype == b.dtype


# ---- the optimizers' tree apply -------------------------------------------

OPTS = {
    "sgd": (lambda: popt.SGD(0.05), lambda: jopt.SGD(0.05)),
    "sgd-schedule": (
        lambda: popt.SGD(popt.schedules.inverse(2.0, 10.0)),
        lambda: jopt.SGD(jopt.schedules.inverse(2.0, 10.0))),
    "momentum": (lambda: popt.Momentum(0.05, 0.9),
                 lambda: jopt.Momentum(0.05, 0.9)),
    "nesterov": (lambda: popt.Momentum(0.05, 0.9, nesterov=True),
                 lambda: jopt.Momentum(0.05, 0.9, nesterov=True)),
    "adamw": (lambda: popt.AdamW(1e-2, weight_decay=0.1),
              lambda: jopt.AdamW(1e-2, weight_decay=0.1)),
}


def _opt_inputs(name, seed, dtype=np.float32):
    """A two-leaf worker tree (M=3), its grads and a nonzero state."""
    shapes = {"b": (3, 5), "w": (3, 4, 6)}
    params = {k: _draw(s, seed + i) for i, (k, s) in enumerate(
        sorted(shapes.items()))}
    grads = {k: _draw(s, seed + 10 + i) for i, (k, s) in enumerate(
        sorted(shapes.items()))}
    if dtype != np.float32:  # round the weights onto the dtype's grid
        params["w"] = np.asarray(torch.from_numpy(params["w"]).to(
            torch.bfloat16).float())
    n = {"sgd": 0, "sgd-schedule": 0, "momentum": 1, "nesterov": 1,
         "adamw": 2}[name]
    states = [{k: np.abs(_draw(s, seed + 20 + 3 * j + i, 0.1))
               for i, (k, s) in enumerate(sorted(shapes.items()))}
              for j in range(n)]
    return params, grads, states


def _port_state(name, states):
    st = [{k: _t(v) for k, v in s.items()} for s in states]
    if name == "adamw":
        return {"m": st[0], "v": st[1]}
    return st[0] if st else ()


class TestTreeApply:
    @pytest.mark.parametrize("step", [1, 7])
    @pytest.mark.parametrize("name", list(OPTS))
    def test_apply_matches_reference_and_plane_twin(self, name, step):
        p_opt, j_opt = OPTS[name][0](), OPTS[name][1]()
        params, grads, states = _opt_inputs(name, 3 * step)
        pp = {k: _t(v) for k, v in params.items()}
        pg = {k: _t(v) for k, v in grads.items()}
        new, st = p_opt.apply(pp, pg, _port_state(name, states), step)
        jst = ({"m": jax.tree.map(_j, states[0]),
                "v": jax.tree.map(_j, states[1])} if name == "adamw"
               else jax.tree.map(_j, states[0]) if states else ())
        jnew, jst2 = j_opt.apply(jax.tree.map(_j, params),
                                 jax.tree.map(_j, grads), jst,
                                 jnp.asarray(step, jnp.int32))
        for k in params:
            _close(new[k], jnew[k])
        for a, b in zip(tree_flatten(st)[0], jax.tree.leaves(jst2)):
            _close(a, b)
        # the plane twin on the packed rows: bit for bit
        spec = FlatSpec.of(pp)
        planes = tuple(spec.pack(s) for s in st_list(name, states))
        upd, new_planes = pref.plane_update_ref(
            spec.pack(pp), spec.pack(pg), planes,
            p_opt.plane_scalars(step), kind=p_opt.plane_kind,
            **p_opt.plane_hypers())
        assert _eq(spec.pack(new), upd)
        for a, b in zip(planes_of(name, st, spec), new_planes):
            assert _eq(a, b)

    @pytest.mark.parametrize("name", ["sgd", "momentum", "adamw"])
    def test_bf16_leaf_rounds_as_the_plane_codes(self, name):
        p_opt = OPTS[name][0]()
        params, grads, states = _opt_inputs(name, 5, dtype="bf16")
        pp = {"b": _t(params["b"]),
              "w": _t(params["w"]).to(torch.bfloat16)}
        pg = {"b": _t(grads["b"]), "w": _t(grads["w"]).to(torch.bfloat16)}
        new, st = p_opt.apply(pp, pg, _port_state(name, states), 2)
        assert new["w"].dtype == torch.bfloat16
        spec = FlatSpec.of(pp)
        upd, _ = pref.plane_update_ref(
            spec.pack(pp), spec.pack(pg),
            tuple(spec.pack(s) for s in st_list(name, states)),
            p_opt.plane_scalars(2), kind=p_opt.plane_kind,
            codes=spec.rounding_codes(), **p_opt.plane_hypers())
        assert _eq(spec.pack(new), upd)


def st_list(name, states):
    return [{k: _t(v) for k, v in s.items()} for s in states]


def planes_of(name, st, spec):
    if name == "adamw":
        return (spec.pack(st["m"]), spec.pack(st["v"]))
    return (spec.pack(st),) if st != () else ()


# ---- the tree averages, mix_tree and the fault helpers ----------------------

def _tree(m=WORKERS, seed=0):
    return {"b": _draw((m, 3), seed), "w": _draw((m, 2, 5), seed + 1)}


def _pt(tree):
    return {k: _t(v) for k, v in tree.items()}


def _jt(tree):
    return {k: _j(v) for k, v in tree.items()}


MASKS = {"all": np.ones(WORKERS, np.float32),
         "dead": np.array([1, 0, 1, 1], np.float32),
         "two": np.array([0, 1, 1, 0], np.float32)}


class TestTreeOperators:
    def test_average_all_and_inner_match_reference_and_plane(self):
        x = _tree()
        spec = FlatSpec.of(_pt(x))
        plane = spec.pack(_pt(x))
        got = average_all(_pt(x))
        for k in x:
            _close(got[k], javg.average_all(_jt(x))[k])
        assert _eq(spec.pack(got), pref.plane_average_ref(plane)[0])
        got = average_inner(_pt(x), 2)
        for k in x:
            _close(got[k], javg.average_inner(_jt(x), 2)[k])
        assert _eq(spec.pack(got), pref.plane_average_ref(plane,
                                                          groups=2)[0])

    def test_worker_dispersion_and_consensus(self):
        x = _tree(seed=4)
        _close(worker_dispersion(_pt(x)),
               javg.worker_dispersion(_jt(x)), TOL["disp"])
        spec = FlatSpec.of(_pt(x))
        _close(worker_dispersion(_pt(x)),
               pref._plane_dispersion(spec.pack(_pt(x))), dict(rtol=1e-6))
        got = consensus(_pt(x))
        for k in x:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(jnp.mean(_j(x[k]), 0)))
        one = replicate({"w": torch.arange(3.0)}, 2)["w"]
        assert one.shape == (2, 3) and one.is_contiguous()

    @pytest.mark.parametrize("kind", ["ring", "gossip_pairs"])
    def test_mix_tree(self, kind):
        x = _tree(seed=7)
        pt = ptopo.Topology.build(kind, WORKERS)
        jt_ = jtopo.Topology.build(kind, WORKERS)
        from repro_torch import rng
        W = pt.mixing_matrix(3, rng.PRNGKey(1), device="cpu")
        jW = jt_.mixing_matrix(3, jax.random.PRNGKey(1))
        got = ptopo.mix_tree(_pt(x), W)
        for k in x:
            _close(got[k], jtopo.mix_tree(_jt(x), jW)[k])
        spec = FlatSpec.of(_pt(x))
        assert _eq(spec.pack(got), pref.mix_disp_ref(spec.pack(_pt(x)),
                                                     W)[0])

    @pytest.mark.parametrize("mask", list(MASKS))
    def test_fault_tree_helpers(self, mask):
        a = MASKS[mask]
        x, y = _tree(seed=11), _tree(seed=12)
        spec = FlatSpec.of(_pt(x))
        plane = spec.pack(_pt(x))
        for fn in ("select_rows_tree",):
            got = getattr(pf, fn)(_pt(x), _pt(y), a)
            want = getattr(jf, fn)(_jt(x), _jt(y), _j(a))
            for k in x:
                np.testing.assert_array_equal(got[k].numpy(), want[k])
        got = pf.zero_rows_tree(_pt(x), a)
        want = jf.zero_rows_tree(_jt(x), _j(a))
        for k in x:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
        got = pf.masked_mean_tree(_pt(x), a)
        for k in x:
            _close(got[k], jf.masked_mean_tree(_jt(x), _j(a))[k])
        assert _eq(spec.pack1(got), pf.masked_mean(plane, a))
        _close(pf.masked_dispersion_tree(_pt(x), a),
               jf.masked_dispersion_tree(_jt(x), _j(a)), TOL["disp"])
        _close(pf.masked_dispersion_tree(_pt(x), a),
               pf.masked_dispersion(plane, a), dict(rtol=1e-6))
        rejoined = np.array([0, 1, 0, 0], np.float32)
        got = pf.warm_start_tree(_pt(x), a, rejoined)
        want = jf.warm_start_tree(_jt(x), _j(a), _j(rejoined))
        for k in x:
            _close(got[k], want[k])
        for g in (1, 2):
            got = pf.masked_average_all_tree(_pt(x), a, groups=g)
            want = jf.masked_average_all_tree(_jt(x), _j(a), groups=g)
            for k in x:
                _close(got[k], want[k])
            assert _eq(spec.pack(got),
                       pref.plane_average_ref(plane, groups=g, alive=a)[0])
        W = ptopo.Topology.ring(WORKERS).mixing_matrix(device="cpu")
        jW = jtopo.Topology.ring(WORKERS).mixing_matrix()
        got = pf.masked_mix_tree(_pt(x), W, a)
        want = jf.masked_mix_tree(_jt(x), jW, _j(a))
        for k in x:
            _close(got[k], want[k])
        assert _eq(spec.pack(got), pref.mix_disp_ref(plane, W, alive=a)[0])

    def test_bf16_leaf_events_round_as_the_codes(self):
        x = _pt(_tree(seed=2))
        x["w"] = x["w"].to(torch.bfloat16)
        spec = FlatSpec.of(x)
        plane, codes = spec.pack(x), spec.rounding_codes()
        assert _eq(spec.pack(average_all(x)),
                   pref.plane_average_ref(plane, codes=codes)[0])
        W = ptopo.Topology.ring(WORKERS).mixing_matrix(device="cpu")
        assert _eq(spec.pack(ptopo.mix_tree(x, W)),
                   pref.mix_disp_ref(plane, W, codes=codes)[0])
        a = MASKS["dead"]
        assert _eq(spec.pack(pf.masked_average_all_tree(x, a, groups=2)),
                   pref.plane_average_ref(plane, groups=2, codes=codes,
                                          alive=a)[0])


# ---- the engine's flat and tree carries ------------------------------------

def _batches(steps=STEPS, m=WORKERS):
    X, y, _ = convex_dataset("ls", 1024, DIM, sparsity=0.2, noise=0.1,
                             seed=0)
    idx = np.random.default_rng(0).integers(0, 1024, (steps, m, 8))
    return [{"x": X[idx[t]], "y": y[idx[t]]} for t in range(steps)]


def _jloss(p, b, r):
    res = b["x"] @ p["w"].astype(jnp.float32) + p["b"][0] - b["y"]
    return 0.5 * jnp.mean(res * res), {}


def _ploss(p, b, r):
    res = b["x"] @ p["w"].float() + p["b"][0] - b["y"]
    return 0.5 * torch.mean(res * res), {}


SCHEDS = {
    "oneshot": dict(kind="oneshot"),
    "minibatch": dict(kind="minibatch"),
    "periodic": dict(kind="periodic", phase_len=8),
    "stochastic": dict(kind="stochastic", zeta=0.2),
    "hierarchical": dict(kind="hierarchical", inner_phase_len=4,
                         outer_phase_len=8, inner_groups=2),
    "adaptive_threshold": dict(kind="adaptive_threshold",
                               disp_threshold=0.05),
    "adaptive_budget": dict(kind="adaptive_budget", comm_budget=4,
                            budget_horizon=STEPS),
}
#: name: (schedule, optimizer, topology, wire, outer momentum, fault
#: plan, weight dtype)
CASES = {
    **{k: (k, "momentum", None, None, 0.0, False, np.float32)
       for k in SCHEDS},
    "periodic-ring": ("periodic", "momentum", "ring", None, 0.0, False,
                      np.float32),
    "periodic-outer": ("periodic", "momentum", None, None, 0.5, False,
                       np.float32),
    "periodic-one_bit-ring": ("periodic", "sgd", "ring", "one_bit", 0.0,
                              False, np.float32),
    "minibatch-int8": ("minibatch", "sgd", None, "int8", 0.0, False,
                       np.float32),
    "periodic-bf16": ("periodic", "momentum", None, None, 0.0, False,
                      "bf16"),
    "plan-periodic": ("periodic", "momentum", None, None, 0.0, True,
                      np.float32),
    "plan-stochastic": ("stochastic", "momentum", None, None, 0.0, True,
                        np.float32),
    "plan-adaptive_threshold": ("adaptive_threshold", "momentum", None,
                                None, 0.0, True, np.float32),
    "plan-periodic-int8": ("periodic", "sgd", None, "int8", 0.0, True,
                           np.float32),
    "plan-hierarchical-ring": ("hierarchical", "momentum", None, None, 0.0,
                               True, np.float32),
}
CARRIES = {"flat": dict(fused_opt=False), "tree": dict(flat=False)}


def _params(case):
    w = np.zeros(DIM, np.float32)
    b = np.full(2, 0.25, np.float32)
    return {"b": b, "w": w}, CASES[case][6]


def _engines(case, carry):
    sname, oname, topo, wire, om, plan, _ = CASES[case]
    jkw, pkw = {}, {}
    if topo:
        jkw["topology"] = jtopo.Topology.build(topo, WORKERS)
        pkw["topology"] = ptopo.Topology.build(topo, WORKERS)
    if wire:
        jkw["compression"] = JComp(wire)
        pkw["compression"] = Compression(wire)
    if om:
        jkw["outer"] = JOuter(lr=1.0, momentum=om)
        pkw["outer"] = OuterOptimizer(lr=1.0, momentum=om)
    if plan:
        jkw["faults"] = jf.FaultPlan.parse(_PLAN, WORKERS,
                                           straggle_prob=0.1)
        pkw["faults"] = pf.FaultPlan.parse(_PLAN, WORKERS,
                                           straggle_prob=0.1)
    jo, po = ((jopt.SGD(0.05), popt.SGD(0.05)) if oname == "sgd" else
              (jopt.Momentum(0.05, 0.9), popt.Momentum(0.05, 0.9)))
    ckw = {} if carry == "flat_native" else CARRIES[carry]
    jeng = JEngine(_jloss, jo, JSched(**SCHEDS[sname]), **jkw, **ckw)
    peng = PhaseEngine(_ploss, po, AveragingSchedule(**SCHEDS[sname]),
                       device="cpu", **pkw, **ckw)
    return jeng, peng


def _port_params(case):
    params, dt = _params(case)
    out = _pt(params)
    if dt == "bf16":
        out["w"] = out["w"].to(torch.bfloat16)
    return out


def _port_run(case, carry, **kw):
    _, peng = _engines(case, carry)
    return peng.run(_port_params(case), iter(_batches()),
                    num_workers=WORKERS, seed=3, record_every=1,
                    return_state=True, **kw)


def _ref_run(case, carry):
    jeng, _ = _engines(case, carry)
    params, dt = _params(case)
    jp = jax.tree.map(jnp.asarray, params)
    if dt == "bf16":
        jp["w"] = jp["w"].astype(jnp.bfloat16)
    return jeng.run(jp, [jax.tree.map(jnp.asarray, b) for b in _batches()],
                    num_workers=WORKERS, seed=3, record_every=1,
                    return_state=True)


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(case, carry, ref=False):
        key = (case, carry, ref)
        if key not in cache:
            cache[key] = (_ref_run if ref else _port_run)(case, carry)
        return cache[key]
    return get


def _tol(case):
    return BF16_TOL if CASES[case][6] == "bf16" else TOL


CARRY_CASES = [(c, k) for c in CASES for k in CARRIES]


class TestCarries:
    @pytest.mark.parametrize("case,carry", CARRY_CASES)
    def test_against_the_reference_carry(self, runs, case, carry):
        """Decisions, averages and event steps equal; params, losses and
        dispersions within R1's tolerances."""
        pf_, ph, ps = runs(case, carry)
        jfinal, jh, js = runs(case, carry, ref=True)
        assert_histories_match(ph, jh, _tol(case))
        if CASES[case][0] != "oneshot":
            assert ph["averages"] > 0
        for k in ("b", "w"):
            _close(pf_[k].float(), np.asarray(jfinal[k], np.float32),
                   _tol(case)["params"])
        _close(ps.plane, np.concatenate(
            [np.asarray(js.worker_params[k], np.float32).reshape(WORKERS, -1)
             for k in ("b", "w")], axis=1), _tol(case)["params"])
        if CASES[case][5]:
            np.testing.assert_array_equal(ps.fault.alive,
                                          np.asarray(js.fault.alive))

    @pytest.mark.parametrize("case,carry", CARRY_CASES)
    def test_bitwise_the_flat_native_run(self, runs, case, carry):
        """The port's carry against its own flat-native run: the final
        state's planes, the consensus and the losses bit for bit; the
        dispersions within rtol 1e-6 (the tree carry sums per leaf)."""
        pf_, ph, ps = runs(case, carry)
        nf, nh, ns = runs(case, "flat_native")
        assert ps.opt_state is None and ps.params is None
        assert _eq(ps.plane, ns.plane)
        for a, b in zip(ps.opt_planes, ns.opt_planes):
            assert _eq(a, b)
        if ns.resid is not None:
            assert _eq(ps.resid, ns.resid)
        for a, b in zip(ps.outer_state, ns.outer_state):
            assert _eq(a, b)
        for k in ("b", "w"):
            assert _eq(pf_[k], nf[k])
        assert ph["loss"] == nh["loss"]
        assert ph["averages"] == nh["averages"]
        assert [t for t, _ in ph["dispersion"]] == \
            [t for t, _ in nh["dispersion"]]
        _close([v for _, v in ph["disp_trace"]],
               [v for _, v in nh["disp_trace"]], dict(rtol=1e-6))


class TestCarryDrivers:
    @pytest.mark.parametrize("carry", list(CARRIES))
    def test_indexed_and_host_runs_bitwise_staged(self, carry):
        case = "plan-periodic"
        X, y, _ = convex_dataset("ls", 1024, DIM, sparsity=0.2, noise=0.1,
                                 seed=0)
        idx = np.random.default_rng(0).integers(0, 1024,
                                                (STEPS, WORKERS, 8))
        staged = [{"x": X[idx[t]], "y": y[idx[t]]} for t in range(STEPS)]
        _, eng = _engines(case, carry)
        f0, h0 = eng.run(_port_params(case), staged, num_workers=WORKERS,
                         seed=3, record_every=1, phase_len=5)
        ds = DeviceDataset({"x": _t(X), "y": _t(y)}, WORKERS, indices=idx,
                           device="cpu")
        f1, h1 = eng.run(_port_params(case), ds, num_workers=WORKERS,
                         seed=3, record_every=1, phase_len=7)
        f2, h2 = eng.run_host(_port_params(case), staged,
                              num_workers=WORKERS, seed=3, record_every=1)
        for f, h in ((f1, h1), (f2, h2)):
            for k in f0:
                assert _eq(f[k], f0[k])
            assert h["loss"] == h0["loss"]
            assert h["dispersion"] == h0["dispersion"]

    def test_checkpoint_and_elastic_take_the_tree_carry(self, tmp_path):
        """A tree-carry state is in the plane layout between phases: it
        checkpoints and resumes bitwise one run, and resizes."""
        case = "periodic"
        _, eng = _engines(case, "tree")
        data = _batches()
        f_all, _, s_all = eng.run(_port_params(case), iter(data),
                                  num_workers=WORKERS, seed=3,
                                  return_state=True)
        _, _, s10 = eng.run(_port_params(case), iter(data[:10]),
                            num_workers=WORKERS, seed=3, return_state=True)
        path = str(tmp_path / "tree")
        save_engine_state(path, s10)
        like = eng.init(_port_params(case), WORKERS, 3)
        s_back, at = load_engine_state(path, like)
        assert at == 10
        f_res, _ = eng.run(None, iter(data[10:]), num_workers=WORKERS,
                           state=s_back)
        for k in f_all:
            assert _eq(f_res[k], f_all[k])
        plan = ElasticPlan.parse(WORKERS, shrink_at=["9:2"],
                                 grow_at=["17:4"])
        fe, he = run_elastic(eng, _port_params(case),
                             lambda m, t0, k: iter(
                                 [{kk: v[:m] for kk, v in b.items()}
                                  for b in data[t0:t0 + k]]),
                             plan, steps=STEPS, seed=3)
        fn, hn = run_elastic(_engines(case, "flat_native")[1],
                             _port_params(case),
                             lambda m, t0, k: iter(
                                 [{kk: v[:m] for kk, v in b.items()}
                                  for b in data[t0:t0 + k]]),
                             plan, steps=STEPS, seed=3)
        assert he["resizes"] == hn["resizes"] and he["resizes"]
        for k in fe:
            assert _eq(fe[k], fn[k])

    def test_a_float64_tree_takes_the_tree_carry(self):
        """A tree FlatSpec cannot embed runs the tree carry (state
        ``params`` / ``opt_state`` trees, no plane), against the same
        float32 run within float32 rounding; its checkpoint and resize
        are refused."""
        def loss(p, b, r):
            res = b["x"].double() @ p["w"] + p["b"][0] - b["y"].double()
            return 0.5 * torch.mean(res * res), {}
        eng = PhaseEngine(loss, popt.Momentum(0.05, 0.9),
                          AveragingSchedule("periodic", phase_len=8),
                          device="cpu")
        p64 = {k: v.double() for k, v in _port_params("periodic").items()}
        f, h, st = eng.run(p64, iter(_batches()), num_workers=WORKERS,
                           seed=3, record_every=1, return_state=True)
        assert st.plane is None and st.spec is None
        assert eng.carry(st) == "tree"
        assert tree_flatten(st.params)[0][0].dtype == torch.float64
        assert h["averages"] == 3 and f["w"].dtype == torch.float64
        f32, _, _ = _port_run("periodic", "flat_native")
        _close(f["w"], f32["w"], dict(rtol=1e-4, atol=1e-6))
        with pytest.raises(ValueError, match="plane layout"):
            save_engine_state("/nonexistent/x", st)
        from repro_torch.elastic import resize_state
        with pytest.raises(ValueError, match="repack the"):
            resize_state(st, 2)
        with pytest.raises(ValueError, match="FlatSpec cannot embed"):
            PhaseEngine(loss, popt.SGD(0.05),
                        AveragingSchedule("periodic", phase_len=8),
                        device="cpu", compression=Compression("int8")
                        ).init(p64, WORKERS)

    def test_refusals(self):
        mesh = object()  # refused before the mesh is looked at
        for kw in (dict(fused_opt=False), dict(flat=False)):
            with pytest.raises(ValueError, match="flat-native"):
                PhaseEngine(_ploss, popt.SGD(0.05),
                            AveragingSchedule("periodic"), device="cpu",
                            mesh=mesh, **kw)
        with pytest.raises(TypeError, match="neither the plane"):
            PhaseEngine(_ploss, object(), AveragingSchedule("periodic"),
                        device="cpu")

    def test_an_optimizer_without_the_plane_protocol_takes_the_flat_carry(
            self):
        """An init / apply optimizer (Momentum's tree half) runs the flat
        carry, bitwise the flat-native Momentum run."""
        class TreeMomentum:
            def __init__(self):
                self._m = popt.Momentum(0.05, 0.9)

            def init(self, params):
                return self._m.init(params)

            def apply(self, params, grads, state, step):
                return self._m.apply(params, grads, state, step)

        eng = PhaseEngine(_ploss, TreeMomentum(),
                          AveragingSchedule(**SCHEDS["periodic"]),
                          device="cpu")
        f, h, st = eng.run(_port_params("periodic"), iter(_batches()),
                           num_workers=WORKERS, seed=3, record_every=1,
                           return_state=True)
        assert eng.carry(st) == "flat" and len(st.opt_planes) == 1
        nf, nh, ns = _port_run("periodic", "flat_native")
        assert _eq(st.plane, ns.plane) and h["loss"] == nh["loss"]


# ---- LocalSGD -------------------------------------------------------------

class TestLocalSGD:
    def test_against_the_reference(self):
        sched = dict(kind="hierarchical", inner_phase_len=2,
                     outer_phase_len=4, inner_groups=2)
        p = LocalSGD(_ploss, popt.Momentum(0.05, 0.9),
                     AveragingSchedule(**sched),
                     outer=OuterOptimizer(lr=1.0, momentum=0.5),
                     device="cpu")
        j = JLocalSGD(_jloss, jopt.Momentum(0.05, 0.9), JSched(**sched),
                      outer=JOuter(lr=1.0, momentum=0.5))
        params, _ = _params("periodic")
        wp, os_, outer = p.init(_pt(params), WORKERS)
        jwp, jos, jouter = j.init(jax.tree.map(jnp.asarray, params),
                                  WORKERS)
        keys = jax.random.split(jax.random.PRNGKey(0), WORKERS)
        for t, b in enumerate(_batches(8), start=1):
            wp, os_, m = p.local_step(wp, os_, b, t)
            jwp, jos, jm = j.local_step(jwp, jos, jax.tree.map(
                jnp.asarray, b), jnp.asarray(t, jnp.int32), keys)
            _close(m["loss"], jm["loss"], TOL["loss"])
            if t % 2 == 0:
                scope = "all" if t % 4 == 0 else "inner"
                wp, outer, d = p.average(wp, outer, scope)
                jwp, jouter, jd = j.average(jwp, jouter, scope)
                _close(d, jd, TOL["disp"])
        for k in params:
            _close(wp[k], jwp[k])
            _close(outer[0][k], jouter[0][k])
        f, h = p.run(_pt(params), iter(_batches()), num_workers=WORKERS,
                     record_every=4)
        jfin, jh = j.run(jax.tree.map(jnp.asarray, params),
                         [jax.tree.map(jnp.asarray, b) for b in _batches()],
                         num_workers=WORKERS, record_every=4)
        assert_histories_match(h, jh)
        for k in params:
            _close(f[k], jfin[k])


# ---- the CLI ----------------------------------------------------------------

CLI = ["--device", "cpu", "--reduced", "--steps", "4", "--workers", "2",
       "--avg", "periodic", "--phase-len", "2", "--batch", "1", "--seq",
       "8"]


def _cli(extra):
    return train.main(CLI + extra)


class TestCli:
    def test_carries_and_scan_unroll_train_bitwise(self, capsys):
        """``--tree-engine`` and ``--no-fused-opt`` train bitwise the
        default flat-native run on the CPU (an f32 model); ``--scan-unroll``
        0, 1 and 4 change nothing and are recorded."""
        base, bh, bs = _cli([])
        capsys.readouterr()
        for extra, carry in (([], "flat_native"),
                             (["--scan-unroll", "0"], "flat_native"),
                             (["--scan-unroll", "1"], "flat_native"),
                             (["--scan-unroll", "4"], "flat_native"),
                             (["--tree-engine"], "tree"),
                             (["--no-fused-opt"], "flat"),
                             (["--tree-engine", "--scan-unroll", "0"],
                              "tree")):
            final, hist, state = _cli(extra)
            out = capsys.readouterr().out
            unroll = extra[-1] if "--scan-unroll" in extra else "1"
            assert (f"[train] engine: carry={carry}, scan_unroll={unroll}"
                    in out)
            assert "2 averaging ops" in out
            assert torch.equal(state.plane, bs.plane)
            for a, b in zip(tree_flatten(final)[0], tree_flatten(base)[0]):
                assert torch.equal(a, b)
            assert hist["loss"] == bh["loss"]

    @pytest.mark.parametrize("argv", [["--scan-unroll", "-1"],
                                      ["--shard", "--tree-engine"],
                                      ["--shard", "--no-fused-opt"]])
    def test_refuses_bad_flags(self, argv):
        with pytest.raises(SystemExit) as e:
            train.main(CLI + argv)
        assert e.value.code == 2

    def test_carries_under_faults_and_a_wire(self):
        """The carries under a crash + rejoin and the int8 wire: the
        reference CLI's averaging count, bitwise the flat-native CLI."""
        extra = ["--faults", "crash:m=1@t=2,rejoin:m=1@t=3",
                 "--comm-dtype", "int8"]
        base = _cli(extra)
        for flag in ("--tree-engine", "--no-fused-opt"):
            got = _cli(extra + [flag])
            assert torch.equal(got[2].plane, base[2].plane)
            assert torch.equal(got[2].resid, base[2].resid)
            assert got[1]["loss"] == base[1]["loss"]


def test_dataclass_replace_keeps_the_carry():
    """``dataclasses.replace`` (the elastic segments, the CLI's resume)
    keeps ``flat`` / ``fused_opt``."""
    eng = PhaseEngine(_ploss, popt.SGD(0.05), AveragingSchedule("periodic"),
                      device="cpu", flat=False, fused_opt=False)
    eng2 = dataclasses.replace(eng, faults=None)
    assert (eng2.flat, eng2.fused_opt) == (False, False)
