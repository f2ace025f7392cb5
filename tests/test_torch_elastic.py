"""The port's elastic membership (``repro_torch.elastic``) against the JAX
reference's (``repro.elastic``), the same numpy draws fed to both.

Mirrors ``tests/test_elastic.py``:

- ``ElasticPlan`` validation and parsing (the reference's plans,
  messages, segments, solo windows and composed segment fault plans);
- the row repack on the planes: a shrink keeps the kept rows bitwise in
  fresh planes, a grow warm-starts the new rows from the cohort mean
  (rounded to the plane's codes) with zero state rows, a shrink-grow
  round trip restores the layout; the reference's refusals;
- the engine: a trivial plan is the plain (fault) engine bit for bit
  over the seven schedules; ``run_elastic`` against
  ``repro.elastic.run_elastic`` — shrink, grow and a curriculum, with a
  base fault plan, straggles and the int8 wire, hierarchical and ring —
  with ``resizes``, ``averages`` and decisions equal, params and losses
  within rtol 1e-6 / atol 1e-7 (losses by ``allclose``: R1), the fault
  rows equal; a resume through a v5 checkpoint at and between resize
  boundaries bitwise the uninterrupted run, also from a
  reference-written checkpoint; the grow curriculum keeps a grown row
  out of the consensus; the reference's refusals (outer optimizer, a
  fault plan of another M, a hierarchical M' that does not divide, a
  completed state, a ring of two);
- checkpoints of resized runs: v5 metadata, fixed-membership saves stay
  v4, another M refused with both counts, the ladder into the resized
  like-state.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import elastic as je  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.checkpoint import io as jio  # noqa: E402
from repro.core.averaging import AveragingSchedule as JSched  # noqa: E402
from repro.core.compress import Compression as JComp  # noqa: E402
from repro.core.engine import PhaseEngine as JEngine  # noqa: E402
from repro.faults import FaultPlan as JFaultPlan  # noqa: E402
from repro.topology import Topology as JTopology  # noqa: E402
from repro_torch import elastic as pe  # noqa: E402
from repro_torch import optim as popt  # noqa: E402
from repro_torch.checkpoint import io as pio  # noqa: E402
from repro_torch.core import AveragingSchedule, PhaseEngine  # noqa: E402
from repro_torch.core.averaging import OuterOptimizer  # noqa: E402
from repro_torch.core.compress import Compression  # noqa: E402
from repro_torch.faults import FaultPlan, FaultState  # noqa: E402
from repro_torch.kernels.ref import round_to_codes  # noqa: E402
from repro_torch.topology import Topology  # noqa: E402
from torch_parity import assert_runs_match  # noqa: E402

DIM, WORKERS, STEPS = 8, 4, 24
_PLAN = "crash:m=1@t=6,rejoin:m=1@t=14"

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


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _block(steps=STEPS, m=WORKERS, seed=0):
    """One (steps, m, 16, DIM) data block; every engine and segment
    slices the same arrays (the reference suite's draws)."""
    rng = np.random.default_rng(seed)
    w_true = rng.standard_normal(DIM)
    x = rng.standard_normal((steps, m, 16, DIM)).astype(np.float32)
    y = (x @ w_true + 0.1 * rng.standard_normal(
        (steps, m, 16))).astype(np.float32)
    return x, y


def _factory(block, as_jax=False):
    x, y = block
    cast = jnp.asarray if as_jax else (lambda a: a)

    def data(m, t0, k):
        return [(cast(x[t, :m]), cast(y[t, :m]))
                for t in range(t0 - 1, t0 - 1 + k)]
    return data


def _batches(block, m=WORKERS):
    return _factory(block)(m, 1, block[0].shape[0])


def _jloss(params, batch, rng):
    x, y = batch
    r = x @ params["w"] - y
    return jnp.mean(r * r), {}


def _ploss(params, batch, rng):
    x, y = batch
    r = x @ params["w"].float() - y
    return torch.mean(r * r), {}


def _pparams(dtype=torch.float32):
    return {"w": torch.zeros(DIM, dtype=dtype)}


def _jparams():
    return {"w": jnp.zeros((DIM,), jnp.float32)}


def _engine(sched=None, opt="momentum", **kw):
    o = {"sgd": popt.SGD(0.05), "momentum": popt.Momentum(0.05, 0.9)}[opt]
    return PhaseEngine(_ploss, o, AveragingSchedule(
        **(sched or SCHEDS["periodic"])), device="cpu", **kw)


def _jengine(sched=None, opt="momentum", **kw):
    o = {"sgd": jopt.SGD(0.05), "momentum": jopt.Momentum(0.05, 0.9)}[opt]
    return JEngine(_jloss, o, JSched(**(sched or SCHEDS["periodic"])), **kw)


def _equal_states(a, b):
    assert torch.equal(a.plane, b.plane)
    assert all(torch.equal(x, y) for x, y in zip(a.opt_planes,
                                                 b.opt_planes))
    assert (a.resid is None) == (b.resid is None)
    if a.resid is not None:
        assert torch.equal(a.resid, b.resid)
    if isinstance(a.fault, FaultState):
        assert np.array_equal(a.fault.alive, b.fault.alive)
        assert np.array_equal(a.fault.staleness, b.fault.staleness)


# ---- ElasticPlan ------------------------------------------------------------

class TestElasticPlan:
    def test_parse_roundtrip(self):
        kw = dict(shrink_at=["8:3"], grow_at=["16:4"], curriculum=2)
        plan, ref = pe.ElasticPlan.parse(4, **kw), je.ElasticPlan.parse(
            4, **kw)
        assert plan.resizes == (pe.ResizeEvent(8, 3), pe.ResizeEvent(16, 4))
        assert plan.resizes == ref.resizes and plan.curriculum == 2
        assert not plan.is_trivial
        assert plan.sizes() == ref.sizes() == (4, 3, 4)

    def test_noop_plan_is_trivial(self):
        plan = pe.ElasticPlan(4, ((10, 4),))
        assert plan.is_trivial and plan.sizes() == (4,)

    @pytest.mark.parametrize("kw,match", [
        (dict(shrink_at=["8:6"]), "would grow"),
        (dict(grow_at=["8:2"]), "would shrink"),
        (dict(shrink_at=["bogus"]), "cannot parse"),
        (dict(shrink_at=["8:3"], grow_at=["8:4"]), "strictly increasing"),
        (dict(shrink_at=["1:3"]), "strictly increasing|>= 2"),
        (dict(shrink_at=["8:0"]), "must be >= 1"),
        (dict(shrink_at=["8:3"], curriculum=-1), "curriculum"),
    ])
    def test_invalid_plans_refused_as_the_reference(self, kw, match):
        with pytest.raises(ValueError, match=match) as ep:
            pe.ElasticPlan.parse(4, **kw)
        with pytest.raises(ValueError) as ej:
            je.ElasticPlan.parse(4, **kw)
        assert str(ep.value) == str(ej.value)

    def test_segments_and_solo_windows(self):
        plan = pe.ElasticPlan(4, ((8, 3), (16, 4)), curriculum=3)
        ref = je.ElasticPlan(4, ((8, 3), (16, 4)), curriculum=3)
        for total in (24, 7, 16):
            assert [tuple(s) for s in plan.segments(total)] == \
                [tuple(s) for s in ref.segments(total)]
        assert [tuple(s) for s in plan.segments(24)] == \
            [(1, 8, 4), (8, 16, 3), (16, 25, 4)]
        assert plan.solo_windows() == ref.solo_windows() == ((3, 16, 19),)
        assert pe.ElasticPlan(4, ((8, 3), (16, 4))).solo_windows() == ()

    @pytest.mark.parametrize("m,start,stop", [(3, 8, 16), (4, 16, 25),
                                              (4, 1, 8)])
    def test_segment_faults_compose_with_base_as_the_reference(
            self, m, start, stop):
        base = FaultPlan.parse(_PLAN, 4, straggle_prob=0.1)
        jbase = JFaultPlan.parse(_PLAN, 4, straggle_prob=0.1)
        plan = pe.ElasticPlan(4, ((8, 3), (16, 4)), curriculum=2)
        ref = je.ElasticPlan(4, ((8, 3), (16, 4)), curriculum=2)
        fp = plan.segment_faults(base, m, start, stop)
        jfp = ref.segment_faults(jbase, m, start, stop)
        assert fp.num_workers == jfp.num_workers == m
        assert [tuple(e) for e in fp.events] == [tuple(e) for e in
                                                 jfp.events]
        assert fp.solo == tuple(tuple(w) for w in jfp.solo)
        assert fp.straggle_prob == jfp.straggle_prob == 0.1

    def test_segment_faults_trivial_lowering(self):
        assert pe.ElasticPlan(4, ((8, 3),)).segment_faults(None, 3, 8,
                                                           25) is None

    def test_base_plan_m_mismatch_refused(self):
        with pytest.raises(ValueError, match="elastic plan starts at"):
            pe.ElasticPlan(4, ((8, 3),)).segment_faults(FaultPlan(8), 3)


# ---- the row repack ---------------------------------------------------------

def _rand_state(m, seed=0, dtype=torch.float32):
    """An int8 + fault-plan engine state with random rows."""
    eng = _engine(compression=Compression("int8"),
                  faults=FaultPlan.parse(_PLAN, m))
    st = eng.init(_pparams(dtype), m, 0)
    g = torch.Generator().manual_seed(seed)
    plane = torch.randn(st.plane.shape, generator=g)
    if st.codes is not None:
        plane = round_to_codes(plane, st.codes)
    rows = np.random.default_rng(seed)
    return st._replace(
        plane=plane, opt_planes=tuple(torch.randn(t.shape, generator=g)
                                      for t in st.opt_planes),
        resid=torch.randn(st.resid.shape, generator=g),
        fault=FaultState(np.ones(m, np.float32),
                         rows.integers(0, 5, m).astype(np.int32)))


class TestRepack:
    @pytest.mark.parametrize("old_m,new_m", [(4, 1), (4, 2), (4, 3), (4, 4),
                                             (6, 2), (5, 4)])
    def test_shrink_then_grow(self, old_m, new_m):
        st = _rand_state(old_m, seed=old_m + new_m)
        small = pe.shrink_state(st, new_m)
        for a, b in ((small.plane, st.plane), (small.resid, st.resid)) + \
                tuple(zip(small.opt_planes, st.opt_planes)):
            assert a.shape[0] == new_m and a.is_contiguous()
            assert torch.equal(a, b[:new_m])
            # a fresh plane: the dropped rows' memory goes with the old
            assert a.untyped_storage().data_ptr() != \
                b.untyped_storage().data_ptr()
        assert small.fault.staleness.tolist() == \
            st.fault.staleness[:new_m].tolist()
        big = pe.grow_state(small, old_m)
        assert torch.equal(big.plane[:new_m], small.plane)
        glob = small.plane.sum(0) / new_m if new_m == 1 else None
        for r in range(new_m, old_m):
            assert torch.equal(big.plane[r], big.plane[new_m])
            if glob is not None:
                assert torch.equal(big.plane[r], glob)
        for t in big.opt_planes + (big.resid,):
            assert t.shape[0] == old_m and not t[new_m:].any()
        assert big.fault.alive[new_m:].tolist() == [1.0] * (old_m - new_m)
        assert big.fault.staleness[new_m:].tolist() == [0] * (old_m - new_m)
        # the round trip restores the layout, kept rows bitwise
        assert big.plane.shape == st.plane.shape
        assert [t.shape for t in big.opt_planes] == [t.shape for t in
                                                     st.opt_planes]
        assert big.fault.alive.dtype == st.fault.alive.dtype
        assert big.fault.staleness.dtype == st.fault.staleness.dtype

    def test_grow_matches_the_reference(self):
        """The reference's grow of the same rows: the cohort mean of the
        alive rows, leaf dtypes; state rows zero."""
        st = _rand_state(3, seed=5)
        st = st._replace(fault=FaultState(np.float32([1, 0, 1]),
                                          st.fault.staleness))
        jeng = _jengine(compression=JComp("int8"),
                        faults=JFaultPlan.parse("crash:m=1@t=2", 3))
        jst = jeng.init(_jparams(), 3, 0)
        from repro.faults import FaultState as JFaultState
        jst = jst._replace(
            worker_params={"w": jnp.asarray(st.plane.numpy())},
            opt_state={"w": jnp.asarray(st.opt_planes[0].numpy())},
            resid=jnp.asarray(st.resid.numpy()),
            fault=JFaultState(jnp.asarray(st.fault.alive),
                              jnp.asarray(st.fault.staleness)))
        big = pe.grow_state(st, 5)
        jbig = je.grow_state(jst, 5, optimizer=jopt.Momentum(0.05, 0.9))
        np.testing.assert_allclose(big.plane.numpy(),
                                   np.asarray(jbig.worker_params["w"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(big.opt_planes[0].numpy(),
                                      np.asarray(jbig.opt_state["w"]))
        np.testing.assert_array_equal(big.resid.numpy(),
                                      np.asarray(jbig.resid))
        np.testing.assert_array_equal(big.fault.alive,
                                      np.asarray(jbig.fault.alive))

    def test_grow_rounds_to_the_codes(self):
        st = _rand_state(4, seed=2, dtype=torch.bfloat16)
        assert st.codes is not None
        big = pe.grow_state(st, 6)
        want = round_to_codes(st.plane.sum(0) / torch.tensor(4.0), st.codes)
        assert torch.equal(big.plane[4], want)
        assert torch.equal(big.plane[5], want)

    def test_shrink_refuses_all_dead(self):
        st = _rand_state(4)
        dead = st._replace(fault=FaultState(np.float32([0, 0, 1, 1]),
                                            st.fault.staleness))
        with pytest.raises(ValueError, match="no alive worker"):
            pe.shrink_state(dead, 2)

    def test_shrink_grow_bounds(self):
        st = _engine().init(_pparams(), 4, 0)
        with pytest.raises(ValueError, match="cannot shrink"):
            pe.shrink_state(st, 5)
        with pytest.raises(ValueError, match="cannot grow"):
            pe.grow_state(st, 3)
        assert pe.resize_state(st, 4) is st


# ---- the engine -------------------------------------------------------------

class TestElasticEngine:
    @pytest.mark.parametrize("sname", list(SCHEDS))
    def test_noop_resize_bitwise_equals_fault_engine(self, sname):
        block = _block()
        eng = _engine(SCHEDS[sname], opt="sgd",
                      faults=FaultPlan.parse(_PLAN, WORKERS,
                                             straggle_prob=0.1))
        f0, h0 = eng.run(_pparams(), _batches(block), num_workers=WORKERS,
                         seed=0, record_every=1)
        f1, h1 = pe.run_elastic(eng, _pparams(), _factory(block),
                                pe.ElasticPlan(WORKERS, ((10, WORKERS),)),
                                steps=STEPS, seed=0, record_every=1)
        assert torch.equal(f0["w"], f1["w"])
        assert h1["resizes"] == []
        for key in ("loss", "dispersion", "averages"):
            assert h0[key] == h1[key]

    #: name: (schedule, optimizer, plan, curriculum, base faults, engine
    #: extras)
    RUNS = {
        "shrink-grow-faults": ("periodic", "momentum", ((8, 3), (16, 4)),
                               2, True, {}),
        "hierarchical": ("hierarchical", "sgd", ((8, 2), (16, 4)), 2,
                         False, {}),
        "int8-faults": ("periodic", "momentum", ((8, 3), (16, 4)), 2, True,
                        {"compression": "int8"}),
        "stochastic-grow": ("stochastic", "sgd", ((6, 2), (12, 5)), 3,
                            False, {}),
        "ring": ("periodic", "momentum", ((8, 5), (16, 3)), 0, False,
                 {"topology": "ring"}),
        "adaptive-budget": ("adaptive_budget", "momentum",
                            ((8, 3), (16, 4)), 2, True, {}),
    }

    def _pair(self, name):
        sname, opt, resizes, cur, faults, extra = self.RUNS[name]
        pkw, jkw = {}, {}
        if faults:
            pkw["faults"] = FaultPlan.parse(_PLAN, WORKERS,
                                            straggle_prob=0.1)
            jkw["faults"] = JFaultPlan.parse(_PLAN, WORKERS,
                                             straggle_prob=0.1)
        if "compression" in extra:
            pkw["compression"] = Compression(extra["compression"])
            jkw["compression"] = JComp(extra["compression"])
        if "topology" in extra:
            pkw["topology"] = Topology.build(extra["topology"], WORKERS)
            jkw["topology"] = JTopology.build(extra["topology"], WORKERS)
        return (_engine(SCHEDS[sname], opt, **pkw),
                _jengine(SCHEDS[sname], opt, **jkw),
                pe.ElasticPlan(WORKERS, resizes, curriculum=cur),
                je.ElasticPlan(WORKERS, resizes, curriculum=cur))

    @pytest.mark.parametrize("name", list(RUNS))
    def test_run_elastic_matches_the_reference(self, name):
        eng, jeng, plan, jplan = self._pair(name)
        block = _block(m=max(plan.sizes()))
        got = pe.run_elastic(eng, _pparams(), _factory(block), plan,
                             steps=STEPS, seed=0, record_every=1,
                             return_state=True)
        want = je.run_elastic(jeng, _jparams(), _factory(block, True),
                              jplan, steps=STEPS, seed=0, record_every=1,
                              return_state=True)
        assert got[1]["resizes"] == want[1]["resizes"] != []
        assert_runs_match(got[:2], want[:2])
        st, jst = got[2], want[2]
        assert st.plane.shape[0] == np.shape(jst.worker_params["w"])[0]
        np.testing.assert_allclose(st.plane.numpy(),
                                   np.asarray(jst.worker_params["w"]),
                                   rtol=1e-6, atol=1e-7)
        if isinstance(st.fault, FaultState):
            np.testing.assert_array_equal(st.fault.alive,
                                          np.asarray(jst.fault.alive))
            np.testing.assert_array_equal(st.fault.staleness,
                                          np.asarray(jst.fault.staleness))

    def test_resume_across_resize_bitwise(self, tmp_path):
        """Checkpoint at a boundary, mid-segment and at the grow-back,
        resume through a v5 save: bitwise the uninterrupted run."""
        eng, _, plan, _ = self._pair("int8-faults")
        fac = _factory(_block())
        f_full, h_full, st_full = pe.run_elastic(
            eng, _pparams(), fac, plan, steps=STEPS, seed=0,
            record_every=1, return_state=True)
        for cut in (8, 12, 16):
            _, h1, st_mid = pe.run_elastic(eng, _pparams(), fac, plan,
                                           steps=cut, seed=0,
                                           record_every=1,
                                           return_state=True)
            path = str(tmp_path / f"ck{cut}")
            pio.save_engine_state(path, st_mid, elastic=True)
            seg_eng, m = pe.segment_engine(eng, plan, cut, STEPS)
            loaded, at = pio.load_engine_state(
                path, seg_eng.init(_pparams(), m, 0))
            assert at == cut
            f_res, h2, st_res = pe.run_elastic(
                eng, _pparams(), fac, plan, steps=STEPS, seed=0,
                record_every=1, state=loaded, return_state=True)
            assert torch.equal(f_full["w"], f_res["w"])
            _equal_states(st_full, st_res)
            assert h1["loss"] + h2["loss"] == h_full["loss"]
            assert h1["resizes"] + h2["resizes"] == h_full["resizes"]

    @pytest.mark.parametrize("cut", [8, 12])
    def test_reference_checkpoint_resumes_across_resize(self, tmp_path,
                                                        cut):
        """A reference-written v5 state of a resized run resumes in the
        port: equal to the reference's uninterrupted run."""
        eng, jeng, plan, jplan = self._pair("shrink-grow-faults")
        block = _block()
        want = je.run_elastic(jeng, _jparams(), _factory(block, True),
                              jplan, steps=STEPS, seed=0, record_every=1)
        _, h1, jst = je.run_elastic(jeng, _jparams(), _factory(block, True),
                                    jplan, steps=cut, seed=0,
                                    record_every=1, return_state=True)
        path = str(tmp_path / "ck")
        jio.save_engine_state(path, jst, elastic=True)
        seg_eng, m = pe.segment_engine(eng, plan, cut, STEPS)
        loaded, at = pio.load_engine_state(path,
                                           seg_eng.init(_pparams(), m, 0))
        assert at == cut and loaded.plane.shape[0] == m == 3
        f, h2 = pe.run_elastic(eng, _pparams(), _factory(block), plan,
                               steps=STEPS, seed=0, record_every=1,
                               state=loaded)
        hist = {k: h1[k] + h2[k] for k in ("loss", "dispersion",
                                           "disp_trace", "averages",
                                           "resizes")}
        assert_runs_match((f, hist), want)

    def test_grow_curriculum_masks_consensus(self):
        """Inside its curriculum window a grown row trains, but stays out
        of the consensus."""
        block = _block()
        plan = pe.ElasticPlan(WORKERS, ((8, 3), (16, 4)), curriculum=6)
        eng = _engine(dict(kind="periodic", phase_len=4), opt="sgd")
        f, _, st = pe.run_elastic(eng, _pparams(), _factory(block), plan,
                                  steps=18, seed=0, return_state=True)
        _, _, st15 = pe.run_elastic(eng, _pparams(), _factory(block), plan,
                                    steps=15, seed=0, return_state=True)
        grown = pe.grow_state(st15, WORKERS).plane[3]
        assert not torch.equal(st.plane[3], grown)  # it trained
        s = st.plane[0] + st.plane[1] + st.plane[2]
        assert torch.equal(f["w"], s / torch.tensor(3.0))  # excluded

    def test_elastic_with_outer_refused(self):
        eng = _engine(outer=OuterOptimizer(lr=1.0, momentum=0.5))
        with pytest.raises(ValueError, match="outer"):
            pe.run_elastic(eng, _pparams(), _factory(_block()),
                           pe.ElasticPlan(WORKERS, ((8, 3),)), steps=STEPS)

    def test_fault_plan_m_mismatch_refused(self):
        eng = _engine(faults=FaultPlan(8))
        with pytest.raises(ValueError, match="elastic plan starts at"):
            pe.run_elastic(eng, _pparams(), _factory(_block()),
                           pe.ElasticPlan(WORKERS, ((8, 3),)), steps=STEPS)

    def test_hierarchical_resize_must_divide(self):
        eng = _engine(SCHEDS["hierarchical"], opt="sgd")
        with pytest.raises(ValueError, match="inner_groups"):
            pe.run_elastic(eng, _pparams(), _factory(_block()),
                           pe.ElasticPlan(WORKERS, ((8, 3),)), steps=STEPS)

    def test_completed_state_refused(self):
        block = _block()
        eng = _engine(opt="sgd")
        plan = pe.ElasticPlan(WORKERS, ((8, 3),))
        _, _, st = pe.run_elastic(eng, _pparams(), _factory(block), plan,
                                  steps=STEPS, seed=0, return_state=True)
        with pytest.raises(ValueError, match="already completed"):
            pe.run_elastic(eng, _pparams(), _factory(block), plan,
                           steps=STEPS, state=st)

    def test_resize_engine_rebuilds_topology(self):
        eng = _engine(topology=Topology.full(WORKERS))
        small = pe.resize_engine(eng, 3)
        assert small.topology.num_workers == 3
        assert small.topology.kind == "full"
        with pytest.raises(ValueError, match="ring"):
            pe.resize_engine(_engine(topology=Topology.ring(WORKERS)), 2)


# ---- checkpoints of resized runs ------------------------------------------

class TestElasticCheckpoint:
    def _resized(self):
        eng = _engine(opt="sgd", compression=Compression("int8"),
                      faults=FaultPlan.parse(_PLAN, WORKERS,
                                             straggle_prob=0.1))
        plan = pe.ElasticPlan(WORKERS, ((8, 3),), curriculum=2)
        _, _, st = pe.run_elastic(eng, _pparams(), _factory(_block()),
                                  plan, steps=12, seed=0,
                                  return_state=True)
        seg_eng, m = pe.segment_engine(eng, plan, 12, STEPS)
        assert m == 3
        return st, seg_eng, m

    def test_elastic_save_is_v5(self, tmp_path):
        st, seg_eng, m = self._resized()
        path = str(tmp_path / "ck")
        pio.save_engine_state(path, st, elastic=True)
        meta = json.load(open(path + ".json"))["extra"]
        assert meta["engine_state_version"] == pio.ENGINE_STATE_VERSION == 5
        assert meta["num_workers"] == 3
        assert meta["has_fault"] and meta["has_resid"] and meta["has_sched"]
        loaded, at = pio.load_engine_state(path,
                                           seg_eng.init(_pparams(), m, 0))
        assert at == 12
        _equal_states(loaded, st)

    def test_fixed_membership_saves_keep_v4(self, tmp_path):
        eng = _engine(opt="sgd", faults=FaultPlan.parse(_PLAN, WORKERS))
        _, _, st = eng.run(_pparams(), _batches(_block()),
                           num_workers=WORKERS, seed=0, return_state=True)
        path = str(tmp_path / "ck")
        pio.save_engine_state(path, st)
        assert json.load(open(path + ".json"))["extra"][
            "engine_state_version"] == 4

    @pytest.mark.parametrize("drop_m", [False, True],
                             ids=["v5", "pre-v5"])
    def test_m_mismatch_refused_with_both_ms(self, tmp_path, drop_m):
        st, _, _ = self._resized()
        path = str(tmp_path / "ck")
        pio.save_engine_state(path, st, elastic=not drop_m)
        if drop_m:
            meta = json.load(open(path + ".json"))
            meta["extra"].pop("num_workers")
            json.dump(meta, open(path + ".json", "w"))
        full = _engine(opt="sgd", compression=Compression("int8"),
                       faults=FaultPlan.parse(_PLAN, WORKERS))
        with pytest.raises(ValueError) as e:
            pio.load_engine_state(path, full.init(_pparams(), WORKERS, 0))
        msg = str(e.value)
        assert "3-row" in msg and "4 rows" in msg
        assert "repro_torch.elastic" in msg

    def test_version_ladder_round_trip_resized(self, tmp_path):
        """v0-v5 for the resized (M=3) state: every stripped layout
        loads into the resized like-state, the missing fields fresh."""
        st, seg_eng, m = self._resized()
        cases = {0: st._replace(sched=(), resid=None, fault=()),
                 2: st._replace(resid=None, fault=()),
                 3: st._replace(fault=()), 4: st}
        for want, stripped in cases.items():
            like = seg_eng.init(_pparams(), m, 0)
            path = str(tmp_path / f"v{want}")
            pio.save_engine_state(path, stripped)
            meta = json.load(open(path + ".json"))["extra"]
            assert meta["engine_state_version"] == want
            loaded, at = pio.load_engine_state(path, like)
            assert at == 12 and torch.equal(loaded.plane, st.plane)
        like = seg_eng.init(_pparams(), m, 0)
        path = str(tmp_path / "v5")
        pio.save_engine_state(path, st, elastic=True)
        loaded, _ = pio.load_engine_state(path, like)
        _equal_states(loaded, st)


class TestShardedElastic:
    """The CLI's elastic run under a 2-rank mesh (``torchrun``, gloo):
    shrinking to 3 rows leaves a mesh of one rank (the other sits the
    segment out), growing back to 4 splits the rows again."""

    ARGV = ["--device", "cpu", "--reduced", "--workers", "4", "--avg",
            "periodic", "--phase-len", "2", "--batch", "1", "--seq", "8",
            "--steps", "8", "--shrink-at", "3:3", "--grow-at", "5:4",
            "--rejoin-curriculum", "1"]

    @pytest.mark.parametrize("coll", ["gather", "psum"])
    def test_cli_elastic_under_a_mesh_equals_the_unsharded_run(
            self, tmp_path, capsys, coll):
        import torch_sharded_worker as tw
        from repro_torch.launch import train
        one = str(tmp_path / "one")
        final, hist, _ = train.main(self.ARGV + ["--checkpoint", one])
        want = capsys.readouterr().out
        two = str(tmp_path / "two")
        rc, out, err = tw.torchrun(2, self.ARGV + [
            "--shard", "--collective", coll, "--checkpoint", two])
        assert rc == 0, out + err
        for line in ("[train] shrink 4 -> 3 workers before step 3",
                     "[train] grow 3 -> 4 workers before step 5"):
            assert line in out and line in want
        assert "(2 rows/shard" in out
        ops = [ln.split("), ")[-1] for ln in (out + want).splitlines()
               if "averaging ops" in ln]
        assert len(ops) == 2 and ops[0] == ops[1]
        # gather: the whole engine state bitwise; psum: the consensus
        # model within the reference's psum tolerances
        kind = ".state.npz" if coll == "gather" else ".npz"
        a, b = np.load(one + kind), np.load(two + kind)
        assert a.files == b.files
        for k in a.files:
            if coll == "gather":
                np.testing.assert_array_equal(b[k], a[k])
            else:
                np.testing.assert_allclose(b[k], a[k], rtol=1e-5,
                                           atol=1e-7)
