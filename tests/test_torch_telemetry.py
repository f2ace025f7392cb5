"""The port's telemetry plane (``repro_torch.telemetry``, the engine's
``telemetry`` flag and ``sink``, ``run_elastic``'s resize events, the
training CLI's ``--telemetry`` / ``--profile-dir``) on the CPU.

Mirrors ``tests/test_telemetry.py`` (all but its sharded case: the port
has no sharded plane yet):

- telemetry on vs off is bitwise in the final state, the consensus and
  the history, over the seven schedules, with the int8 wire over a
  ring, under a fault plan, through ``run_host`` and across a resume;
- turning it on adds no host read of a device tensor: the calls of
  ``torch.Tensor.item`` / ``tolist`` / ``__float__`` are counted, on and
  off;
- the metrics agree with the history, the compressed wire is priced in
  ``comm_bytes``; the schema round-trips and refuses future versions and
  unknown types; ``RunLog.history()`` rebuilds the engine's history key
  for key (``phase_wall`` too); ``run_elastic`` emits its resizes; a
  sink is refused without telemetry; ``timed`` / ``time_run`` /
  ``profile_trace``; the report renders.

Against the reference, for the same run (float32, the same numpy
batches, the same start params; the engine's over 24 steps, as the
parity suites run, see ``REF_STEPS``): the port's records equal the
reference's ``MemorySink`` records in types, order and ``(t0, t1)``;
``steps``, the event counts, ``comm_bytes``, ``alive_min`` /
``alive_mean`` / ``straggle_rate`` and the fault, resize and checkpoint
events exactly; ``loss_*`` within rtol 1e-6 / atol 1e-7 and ``disp_*``
within rtol 1e-5 (the north star's tolerances); wall-clock fields
excluded. The same for ``run_elastic`` under a fault plan, and for the
two CLIs (``repro.launch.train --telemetry`` against
``repro_torch.launch.train --device cpu --telemetry``, with a
``checkpoint_event``, and an elastic run), whose port-written log the
reference's ``repro.telemetry.report.render`` renders unchanged, with the
reference log's table rows but the ``run:`` line and ``steps/s``.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import elastic as je  # noqa: E402
from repro.core import AveragingSchedule as JSched  # noqa: E402
from repro.core import Compression as JComp  # noqa: E402
from repro.core import PhaseEngine as JEngine  # noqa: E402
from repro.faults import FaultPlan as JFaultPlan  # noqa: E402
from repro.optim import Momentum as JMomentum  # noqa: E402
from repro.telemetry import MemorySink as JMemorySink  # noqa: E402
from repro.telemetry import RunLog as JRunLog  # noqa: E402
from repro.telemetry import run_meta_record as jrun_meta  # noqa: E402
from repro.topology import Topology as JTopology  # noqa: E402
from repro_torch import elastic as pe  # noqa: E402
from repro_torch.checkpoint import (load_engine_state,  # noqa: E402
                                    save_engine_state)
from repro_torch.core import AveragingSchedule, PhaseEngine  # noqa: E402
from repro_torch.core.compress import Compression  # noqa: E402
from repro_torch.faults import FaultPlan  # noqa: E402
from repro_torch.optim import Momentum  # noqa: E402
from repro_torch.telemetry import (FLUSH_FUNCTIONS, NUM_SLOTS,  # noqa: E402
                                   SLOT_NAMES, TELEMETRY_VERSION, JsonlSink,
                                   MemorySink, NullSink, RunLog,
                                   accumulate, flush_metrics, init_history,
                                   init_metrics, make_record, parse_record,
                                   profile_trace, run_meta_record, time_run,
                                   timed)
from repro_torch.telemetry.report import main as report_main  # noqa: E402
from repro_torch.telemetry.report import render  # noqa: E402
from repro_torch.topology import Topology, comm_bytes  # noqa: E402

WORKERS, STEPS, DIM, SAMPLES = 4, 40, 12, 256
LOSS_TOL = dict(rtol=1e-6, atol=1e-7)
DISP_TOL = dict(rtol=1e-5)
_PLAN = "crash:m=2@t=10,rejoin:m=2@t=25"

SCHEDULES = {
    "oneshot": dict(kind="oneshot"),
    "minibatch": dict(kind="minibatch"),
    "periodic": dict(kind="periodic", phase_len=8),
    "stochastic": dict(kind="stochastic", zeta=0.2),
    "hierarchical": dict(kind="hierarchical", inner_phase_len=5,
                         outer_phase_len=20, inner_groups=2),
    "adaptive_threshold": dict(kind="adaptive_threshold",
                               disp_threshold=0.05, disp_ema_beta=0.5),
    "adaptive_budget": dict(kind="adaptive_budget", comm_budget=6,
                            budget_horizon=STEPS),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _problem(seed=0, m=WORKERS):
    """The reference suite's least squares as float32 numpy arrays:
    (X, y, per-step (m, 8) sample indices)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((SAMPLES, DIM))
    y = X @ rng.standard_normal(DIM)
    idx = rng.integers(0, SAMPLES, (STEPS, m, 8))
    return X.astype(np.float32), y.astype(np.float32), idx


X, Y, IDX = _problem()


def _batches(t0=0, k=STEPS, m=WORKERS, idx=IDX):
    return [{"x": X[idx[t, :m]], "y": Y[idx[t, :m]]}
            for t in range(t0, t0 + k)]


def _jbatches(t0=0, k=STEPS, m=WORKERS, idx=IDX):
    return [{"x": jnp.asarray(X[idx[t, :m]]), "y": jnp.asarray(Y[idx[t, :m]])}
            for t in range(t0, t0 + k)]


def _loss(params, batch, rng):
    r = batch["x"] @ params["w"] - batch["y"]
    return 0.5 * torch.mean(r * r), {}


def _jloss(params, batch, rng):
    r = batch["x"] @ params["w"] - batch["y"]
    return 0.5 * jnp.mean(r * r), {}


def _params():
    return {"w": torch.zeros(DIM)}


def _jparams():
    return {"w": jnp.zeros(DIM, jnp.float32)}


def _engine(sched="periodic", telemetry=True, **kw):
    return PhaseEngine(_loss, Momentum(lr=0.05, mu=0.9),
                       AveragingSchedule(**SCHEDULES[sched]), device="cpu",
                       telemetry=telemetry, **kw)


def _jengine(sched="periodic", **kw):
    return JEngine(_jloss, JMomentum(lr=0.05, mu=0.9),
                   JSched(**SCHEDULES[sched]), telemetry=True, **kw)


def _pair(sched="periodic", **kw):
    return _engine(sched, False, **kw), _engine(sched, True, **kw)


def _no_wall(hist):
    return {k: v for k, v in hist.items() if k != "phase_wall"}


def _assert_states_equal(a, b):
    assert torch.equal(a.plane, b.plane)
    assert all(torch.equal(x, y) for x, y in zip(a.opt_planes,
                                                 b.opt_planes))
    assert (a.resid is None) == (b.resid is None)
    if a.resid is not None:
        assert torch.equal(a.resid, b.resid)
    assert a.step == b.step and a.sched == b.sched
    if a.fault != ():
        assert np.array_equal(a.fault.alive, b.fault.alive)
        assert np.array_equal(a.fault.staleness, b.fault.staleness)


def _run_both(off, on, sink=None, batches=_batches, **kw):
    kw.setdefault("num_workers", WORKERS)
    kw.setdefault("seed", 3)
    kw.setdefault("record_every", 1)
    f0, h0, s0 = off.run(_params(), batches(), return_state=True, **kw)
    f1, h1, s1 = on.run(_params(), batches(), return_state=True, sink=sink,
                        **kw)
    _assert_states_equal(s0, s1)
    assert torch.equal(f0["w"], f1["w"])
    assert _no_wall(h0) == _no_wall(h1)
    return h1


# ---- telemetry on vs off ----------------------------------------------------

@pytest.mark.parametrize("name", list(SCHEDULES))
def test_invariant_across_schedules(name):
    off, on = _pair(name)
    sink = MemorySink()
    hist = _run_both(off, on, sink=sink)
    pm = [r for r in sink.records if r["type"] == "phase_metrics"]
    assert sum(r["steps"] for r in pm) == STEPS
    assert sum(r["events"] for r in pm) == hist["averages"]


def test_invariant_through_run_host():
    off, on = _pair("periodic")
    f0, h0 = off.run_host(_params(), _batches(), num_workers=WORKERS,
                          seed=3, record_every=1)
    f1, h1 = on.run_host(_params(), _batches(), num_workers=WORKERS, seed=3,
                         record_every=1)
    assert torch.equal(f0["w"], f1["w"])
    assert _no_wall(h0) == _no_wall(h1)


def test_invariant_with_compression_and_topology():
    off, on = _pair("periodic", compression=Compression("int8"),
                    topology=Topology.build("ring", WORKERS))
    _run_both(off, on, sink=MemorySink())


def test_invariant_with_faults():
    plan = FaultPlan.parse(_PLAN, WORKERS, straggle_prob=0.25)
    off, on = _pair("periodic", faults=plan)
    sink = MemorySink()
    _run_both(off, on, sink=sink)
    fe = [(r["kind"], r["worker"], r["step"]) for r in sink.records
          if r["type"] == "fault_event"]
    assert fe == [("crash", 2, 10), ("rejoin", 2, 25)]
    pm = [r for r in sink.records if r["type"] == "phase_metrics"]
    # the crash window (steps 10..24) has 3 alive workers
    assert min(r["alive_min"] for r in pm) == 3.0
    assert any(r["straggle_rate"] > 0 for r in pm)
    # the occupancy is the plan's streams': the alive count of every
    # step, and of it the rows whose straggle draw fired
    dec_key = on.init(_params(), WORKERS, 3).dec_key
    alive = [plan.alive_at(t) for t in range(1, STEPS + 1)]
    strag = [float(np.sum(a * plan.straggle_mask(dec_key, t,
                                                 np.arange(WORKERS))))
             for t, a in zip(range(1, STEPS + 1), alive)]
    for r in pm:
        steps = range(r["t0"] - 1, r["t1"])
        a_sum = sum(float(alive[i].sum()) for i in steps)
        assert r["alive_mean"] == a_sum / r["steps"]
        assert r["alive_min"] == min(float(alive[i].sum()) for i in steps)
        assert r["straggle_rate"] == sum(strag[i] for i in steps) / a_sum


def test_invariant_across_resume(tmp_path):
    """A resumed telemetry run equals the uninterrupted telemetry-off run
    bitwise, and its phases flush fresh accumulators whose windows are
    contiguous across the cut."""
    off, on = _pair("stochastic")
    f_full, h_full, s_full = off.run(_params(), _batches(),
                                     num_workers=WORKERS, seed=7,
                                     record_every=8, return_state=True)
    cut = 24
    sink = MemorySink()
    _, h1, st = on.run(_params(), _batches(k=cut), num_workers=WORKERS,
                       seed=7, record_every=8, return_state=True, sink=sink)
    path = str(tmp_path / "ck")
    save_engine_state(path, st)
    loaded, at = load_engine_state(path, on.init(_params(), WORKERS, 7))
    assert at == cut
    f_res, h2, s_res = on.run(None, _batches(cut, STEPS - cut),
                              num_workers=WORKERS, record_every=8,
                              state=loaded, return_state=True, sink=sink)
    _assert_states_equal(s_full, s_res)
    assert torch.equal(f_full["w"], f_res["w"])
    assert h_full["loss"] == h1["loss"] + h2["loss"]
    pm = [r for r in sink.records if r["type"] == "phase_metrics"]
    assert sum(r["steps"] for r in pm) == STEPS
    spans = [(r["t0"], r["t1"]) for r in pm]
    assert spans[0][0] == 1 and spans[-1][1] == STEPS
    assert all(a2 == b1 + 1 for (_, b1), (a2, _) in zip(spans, spans[1:]))


@pytest.mark.parametrize("faults", [False, True], ids=["plain", "faults"])
def test_no_extra_host_reads(monkeypatch, faults):
    """The host reads of tensors (``item``, ``tolist``, ``__float__``)
    per run are the same with telemetry on and off: the accumulator is
    folded from the values the phase reads anyway."""
    counts = []

    def counting(name):
        real = getattr(torch.Tensor, name)

        def wrapper(self, *a, **k):
            counts.append(name)
            return real(self, *a, **k)
        return wrapper

    kw = {}
    if faults:
        kw["faults"] = FaultPlan.parse(_PLAN, WORKERS, straggle_prob=0.25)
    off, on = _pair("periodic", **kw)
    for name in ("item", "tolist", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, counting(name))
    off.run(_params(), _batches(), num_workers=WORKERS, seed=3,
            phase_len=10, record_every=5)
    n_off = sorted(counts)
    counts.clear()
    on.run(_params(), _batches(), num_workers=WORKERS, seed=3, phase_len=10,
           record_every=5, sink=MemorySink())
    assert sorted(counts) == n_off and n_off


# ---- metrics against the history ------------------------------------------

def test_metrics_match_history():
    off, on = _pair("periodic")
    sink = MemorySink()
    hist = _run_both(off, on, sink=sink, phase_len=10)
    pm = [r for r in sink.records if r["type"] == "phase_metrics"]
    assert [r["steps"] for r in pm] == [10] * 4
    assert sum(r["events"] for r in pm) == hist["averages"]
    losses = [v for _, v in hist["loss"]]
    disps = [v for _, v in hist["disp_trace"]]
    for i, r in enumerate(pm):
        seg_l, seg_d = losses[i * 10:(i + 1) * 10], disps[i * 10:(i + 1) * 10]
        np.testing.assert_allclose(r["loss_mean"], np.mean(seg_l),
                                   rtol=1e-5)
        assert r["loss_max"] == max(seg_l)
        assert r["disp_max"] == max(seg_d)
        assert r["loss_trace"] == hist["loss"][i * 10:(i + 1) * 10]
        assert (r["t0"], r["t1"], r["wall_s"]) == hist["phase_wall"][i]
    per_event = comm_bytes(Topology.full(WORKERS), 1, DIM, "f32")
    assert sum(r["comm_bytes"] for r in pm) == hist["averages"] * per_event


@pytest.mark.parametrize("wire", ["bf16", "int8", "one_bit"])
def test_metrics_price_compressed_wire(wire):
    off, on = _pair("periodic", compression=Compression(wire))
    sink = MemorySink()
    hist = _run_both(off, on, sink=sink)
    per_event = comm_bytes(Topology.full(WORKERS), 1, DIM, wire)
    total = sum(r["comm_bytes"] for r in sink.records
                if r["type"] == "phase_metrics")
    assert total == hist["averages"] * per_event


def test_accumulator_folds_in_float32():
    """The slots fold in float32, in the reference's order: a byte count
    past 2**24 rounds as a float32 sum does, not as an int."""
    acc = init_metrics()
    assert acc.dtype == np.float32 and acc.shape == (NUM_SLOTS,)
    eb = 1_447_284_480.0  # smollm-360m's f32 row, one worker, full mean
    want = np.float32(0.0)
    for code in (2, 0, 2, 1, 2):
        acc = accumulate(acc, loss=1.5, disp=0.25, code=code,
                         event_bytes_all=eb, event_bytes_inner=eb / 3,
                         n_alive=4.0, n_straggle=1.0)
        want = want + (np.float32(code == 1) * np.float32(eb / 3)
                       + np.float32(code == 2) * np.float32(eb))
    out = flush_metrics(acc)
    assert out["comm_bytes"] == float(want)
    assert (out["steps"], out["events_all"], out["events_inner"],
            out["events"]) == (5, 3, 1, 4)
    assert out["alive_min"] == 4.0 and out["straggle_rate"] == 0.25
    assert FLUSH_FUNCTIONS == ("flush_metrics",)
    assert SLOT_NAMES[0] == "steps" and SLOT_NAMES[-1] == "straggle_sum"
    with pytest.raises(ValueError, match="slots"):
        flush_metrics(np.zeros(3))
    with pytest.raises(ValueError, match=">= 1 steps"):
        flush_metrics(init_metrics())


# ---- schema and RunLog ------------------------------------------------------

def test_record_schema_round_trip(tmp_path):
    records = [
        run_meta_record(config={"workers": 4}, device="cpu"),
        make_record("phase_metrics", t0=1, t1=10, steps=10, events=1),
        make_record("averaging_event", step=8, dispersion=0.1, scope="all"),
        make_record("fault_event", step=3, kind="crash", worker=1),
        make_record("resize_event", step=5, old_m=4, new_m=6),
        make_record("checkpoint_event", step=10, path="ck.state",
                    layout_version=5),
    ]
    path = tmp_path / "run.jsonl"
    with JsonlSink(path) as sink:
        for r in records:
            sink.emit(r)
    log = RunLog.load(path)
    assert [r["type"] for r in log.records] == [r["type"] for r in records]
    for orig, back in zip(records, log.records):
        assert orig == back
    assert all(r["v"] == TELEMETRY_VERSION for r in log.records)
    # either package reads the other's records
    assert [r["type"] for r in JRunLog.load(path).records] == \
        [r["type"] for r in records]


def test_run_meta_keys_are_the_reference_keys():
    got, want = run_meta_record(config={"a": 1}, device="cpu"), jrun_meta(
        config={"a": 1})
    assert set(got) - {"torch_version"} == set(want) - {"jax_version"}
    assert got["backend"] == "cpu" and got["device_kind"] == "cpu"
    assert got["device_count"] == 1 and got["config"] == {"a": 1}
    assert got["torch_version"] == torch.__version__


def test_reader_refuses_future_version_and_unknown_type():
    with pytest.raises(ValueError, match="newer than this reader"):
        parse_record({"v": TELEMETRY_VERSION + 1, "type": "run_meta"})
    with pytest.raises(ValueError, match="unknown telemetry record type"):
        parse_record({"v": TELEMETRY_VERSION, "type": "mystery"})
    with pytest.raises(ValueError, match="no integer 'v'"):
        parse_record({"type": "run_meta"})
    with pytest.raises(ValueError, match="must be a dict"):
        parse_record("[1, 2]")
    with pytest.raises(ValueError, match="unknown telemetry record type"):
        make_record("mystery")
    with pytest.raises(ValueError):
        MemorySink().emit({"type": "run_meta"})
    with pytest.raises(ValueError, match="unknown record type"):
        RunLog([]).of_type("mystery")
    NullSink().emit({"anything": "goes-nowhere"})


def test_runlog_history_matches_engine_hist(tmp_path):
    off, on = _pair("stochastic")
    path = tmp_path / "run.jsonl"
    with JsonlSink(path) as sink:
        hist = _run_both(off, on, sink=sink)
    assert RunLog.load(path).history() == hist


def test_init_history_is_the_shared_constructor():
    hist = init_history()
    assert hist == {"loss": [], "dispersion": [], "disp_trace": [],
                    "averages": 0, "eval": [], "worker_eval": [],
                    "phase_wall": []}
    assert init_history(resizes=True)["resizes"] == []
    a, b = init_history(), init_history()
    a["loss"].append((1, 0.0))
    assert b["loss"] == []


def test_sink_requires_telemetry_engine():
    off, _ = _pair("periodic")
    with pytest.raises(ValueError, match="telemetry=True"):
        off.run(_params(), _batches(), num_workers=WORKERS,
                sink=MemorySink())


# ---- elastic ------------------------------------------------------------------

_EIDX = _problem(m=6)[2]


def _factory(m, t0, k):
    return _batches(t0 - 1, k, m, _EIDX)


def _jfactory(m, t0, k):
    return _jbatches(t0 - 1, k, m, _EIDX)


def test_elastic_emits_resize_events():
    plan = pe.ElasticPlan.parse(WORKERS, grow_at=("21:6",))
    off, on = _pair("periodic")
    f0, h0 = pe.run_elastic(off, _params(), _factory, plan, steps=STEPS,
                            seed=3, record_every=1)
    sink = MemorySink()
    f1, h1 = pe.run_elastic(on, _params(), _factory, plan, steps=STEPS,
                            seed=3, record_every=1, sink=sink)
    assert torch.equal(f0["w"], f1["w"])
    assert _no_wall(h0) == _no_wall(h1)
    rz = [r for r in sink.records if r["type"] == "resize_event"]
    assert [(r["step"], r["old_m"], r["new_m"]) for r in rz] == [(21, 4, 6)]
    assert RunLog(sink.records).history() == h1
    assert sum(r["steps"] for r in sink.records
               if r["type"] == "phase_metrics") == STEPS


# ---- against the reference --------------------------------------------------

def _assert_records_match(got: list, want: list):
    """The port's records against the reference's: types and order, the
    integer fields and the point events exactly, losses and dispersions
    at the north star's tolerances, wall-clock fields left out."""
    assert [r["type"] for r in got] == [r["type"] for r in want]
    for g, w in zip(got, want):
        assert g["v"] == w["v"]
        t = g["type"]
        if t == "run_meta":
            assert g["config"] == w["config"]
            continue
        if t == "phase_metrics":
            exact = ("t0", "t1", "steps", "events", "events_inner",
                     "events_all", "comm_bytes", "alive_min", "alive_mean",
                     "straggle_rate")
            assert {k: g[k] for k in exact} == {k: w[k] for k in exact}
            for k in ("loss_mean", "loss_max"):
                np.testing.assert_allclose(g[k], w[k], **LOSS_TOL)
            for k in ("disp_mean", "disp_max"):
                np.testing.assert_allclose(g[k], w[k], **DISP_TOL)
            for key, tol in (("loss_trace", LOSS_TOL),
                             ("disp_trace", DISP_TOL)):
                assert [s for s, _ in g[key]] == [s for s, _ in w[key]]
                if g[key]:
                    np.testing.assert_allclose(
                        [v for _, v in g[key]], [v for _, v in w[key]],
                        **tol)
            assert set(g) == set(w)
        elif t == "averaging_event":
            assert (g["step"], g["scope"]) == (w["step"], w["scope"])
            np.testing.assert_allclose(g["dispersion"], w["dispersion"],
                                       **DISP_TOL)
        elif t == "checkpoint_event":
            assert (g["step"], g["layout_version"]) == \
                (w["step"], w["layout_version"])
            assert os.path.basename(g["path"]) == \
                os.path.basename(w["path"])
        else:
            assert g == w


REF_RUNS = {
    "periodic": ("periodic", {}),
    "hierarchical": ("hierarchical", {}),
    "stochastic-ring-int8": ("stochastic", dict(topology="ring",
                                                compression="int8")),
    "minibatch-groups": ("minibatch", dict(topology="groups")),
    "faults": ("periodic", dict(faults=True)),
    "adaptive": ("adaptive_threshold", {}),
}


def _ref_pair(name):
    sched, extra = REF_RUNS[name]
    pkw, jkw = {}, {}
    if "topology" in extra:
        pkw["topology"] = Topology.build(extra["topology"], WORKERS)
        jkw["topology"] = JTopology.build(extra["topology"], WORKERS)
    if "compression" in extra:
        pkw["compression"] = Compression(extra["compression"])
        jkw["compression"] = JComp(extra["compression"])
    if extra.get("faults"):
        pkw["faults"] = FaultPlan.parse(_PLAN, WORKERS, straggle_prob=0.25)
        jkw["faults"] = JFaultPlan.parse(_PLAN, WORKERS, straggle_prob=0.25)
    return _engine(sched, **pkw), _jengine(sched, **jkw)


#: steps of the engine runs held to the reference's records: the parity
#: suites' length. The loss reductions sum in another order than XLA's
#: (one ulp apart from the first step), and over 40 steps of these runs
#: that roundoff walks the losses up to 2.4e-6 apart (int8 over a ring),
#: past the loss tolerance. adaptive_threshold runs without the fault
#: plan: under it, its 18 masked events in 40 steps (the reference takes
#: each masked mean as a matrix product, a few ulps from the port's exact
#: sum) walk the losses 1.2e-6 apart by step 21.
REF_STEPS = 24


@pytest.mark.parametrize("name", list(REF_RUNS))
def test_engine_records_match_the_reference(name):
    eng, jeng = _ref_pair(name)
    sink, jsink = MemorySink(), JMemorySink()
    eng.run(_params(), _batches(k=REF_STEPS), num_workers=WORKERS, seed=3,
            record_every=2, phase_len=7, sink=sink)
    jeng.run(_jparams(), _jbatches(k=REF_STEPS), num_workers=WORKERS,
             seed=3, record_every=2, phase_len=7, sink=jsink)
    assert sink.records and any(r["type"] == "averaging_event"
                                for r in sink.records)
    _assert_records_match(sink.records, jsink.records)


def test_elastic_records_match_the_reference_under_faults():
    base = "crash:m=1@t=6,rejoin:m=1@t=14"
    eng = _engine("periodic",
                  faults=FaultPlan.parse(base, WORKERS, straggle_prob=0.1))
    jeng = _jengine("periodic",
                    faults=JFaultPlan.parse(base, WORKERS, straggle_prob=0.1))
    kw = dict(shrink_at=("11:3",), grow_at=("25:6",), curriculum=2)
    sink, jsink = MemorySink(), JMemorySink()
    f, h = pe.run_elastic(eng, _params(), _factory,
                          pe.ElasticPlan.parse(WORKERS, **kw), steps=STEPS,
                          seed=3, record_every=1, sink=sink)
    je.run_elastic(jeng, _jparams(), _jfactory,
                   je.ElasticPlan.parse(WORKERS, **kw), steps=STEPS, seed=3,
                   record_every=1, sink=jsink)
    types = [r["type"] for r in sink.records]
    assert types.count("resize_event") == 2 and "fault_event" in types
    _assert_records_match(sink.records, jsink.records)
    assert RunLog(sink.records).history() == h


CLI_ARGV = ["--reduced", "--workers", "4", "--avg", "periodic",
            "--phase-len", "2", "--batch", "1", "--seq", "8", "--faults",
            "crash:m=1@t=3,rejoin:m=1@t=5", "--straggle-prob", "0.2"]
CLI_ELASTIC = ["--reduced", "--workers", "4", "--avg", "periodic",
               "--phase-len", "2", "--batch", "1", "--seq", "8",
               "--shrink-at", "3:2", "--grow-at", "5:4",
               "--rejoin-curriculum", "1"]


def _table_rows(text: str) -> list:
    """The report's lines but the ``run:`` header, each table row with
    its ``steps/s`` column (the third) and the total's rate left out."""
    out = []
    for line in text.splitlines():
        if line.startswith("run:"):
            continue
        cols = line.split()
        if cols and cols[0].isdigit() and len(cols) == 13:
            cols = cols[:2] + cols[3:]
            line = " ".join(cols)
        out.append(line.split(", ")[0] if line.startswith("total:")
                   else line)
    return out


@pytest.mark.parametrize("argv", [CLI_ARGV, CLI_ELASTIC],
                         ids=["faults", "elastic"])
def test_cli_records_match_the_reference(tmp_path, argv, capsys):
    """Both CLIs with ``--telemetry`` and ``--checkpoint``: the port's
    log against the reference's, and the reference's report renders the
    port's log with the reference log's table rows."""
    from repro.launch import train as jtrain
    from repro.telemetry.report import render as jrender
    from repro_torch.launch import train
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    jlog, plog = tmp_path / "j" / "run.jsonl", tmp_path / "p" / "run.jsonl"
    jtrain.main(argv + ["--steps", "6", "--telemetry", str(jlog),
                        "--checkpoint", str(tmp_path / "j" / "ck")])
    _, hist, _ = train.main(["--device", "cpu"] + argv + [
        "--steps", "6", "--telemetry", str(plog),
        "--checkpoint", str(tmp_path / "p" / "ck")])
    assert f"[train] telemetry -> {plog}" in capsys.readouterr().out
    got, want = RunLog.load(plog), JRunLog.load(jlog)
    assert got.meta["backend"] == "cpu" and "torch_version" in got.meta
    _assert_records_match(got.records, want.records)
    assert got.of_type("checkpoint_event")[0]["path"] == \
        str(tmp_path / "p" / "ck") + ".state"
    assert got.history() == hist
    assert _table_rows(jrender(JRunLog.load(plog))) == \
        _table_rows(jrender(want))
    # the port's own report: the same rows, its header naming torch
    text = render(got)
    assert text.startswith(f"run: torch {torch.__version__} (cpu, 1x cpu)")
    assert _table_rows(text) == _table_rows(jrender(want))


def test_cli_profile_dir_writes_a_trace(tmp_path, capsys):
    from repro_torch.launch import train
    prof = tmp_path / "prof"
    argv = ["--device", "cpu", "--reduced", "--workers", "2", "--avg",
            "periodic", "--phase-len", "2", "--batch", "1", "--seq", "8",
            "--steps", "2"]
    f0, h0, s0 = train.main(argv)
    f1, h1, s1 = train.main(argv + ["--profile-dir", str(prof)])
    assert f"[train] profiler trace -> {prof}" in capsys.readouterr().out
    traces = [p for p in os.listdir(prof) if p.endswith(".pt.trace.json")]
    assert len(traces) == 1
    events = json.load(open(prof / traces[0]))["traceEvents"]
    assert any("opt_step" in str(e.get("name", "")) or
               e.get("cat") == "cpu_op" for e in events)
    assert torch.equal(s0.plane, s1.plane)
    assert h0["loss"] == h1["loss"]


# ---- timing -------------------------------------------------------------------

def test_timed_and_time_run():
    calls = []

    def fn():
        calls.append(1)

    assert timed(fn) >= 0.0
    calls.clear()
    ms = time_run(fn, steps=10, reps=3, warmup=2)
    assert ms >= 0.0
    assert len(calls) == 5  # 2 warmup + 3 timed
    with pytest.raises(ValueError):
        time_run(fn, steps=0)
    with pytest.raises(ValueError):
        time_run(fn, steps=1, reps=0)


def test_time_run_blocks_on_returned_tensors():
    x = torch.arange(8.0)
    assert time_run(lambda: {"y": x * 2, "n": 3}, steps=1, block=True) >= 0
    assert timed(lambda: None, block=True) >= 0.0


def test_profile_trace_noop_without_dir(tmp_path):
    with profile_trace(None):
        pass
    with profile_trace(""):
        pass
    with profile_trace(str(tmp_path / "p")):
        torch.ones(4).sum()
    assert any(p.endswith(".pt.trace.json")
               for p in os.listdir(tmp_path / "p"))


# ---- report -------------------------------------------------------------------

def test_report_renders_phase_table(tmp_path):
    on = _engine("periodic")
    path = tmp_path / "run.jsonl"
    with JsonlSink(path) as sink:
        sink.emit(run_meta_record(config={
            "workers": WORKERS, "lr": 0.05, "momentum": 0.9,
            "avg": "periodic", "phase_len": 8}, device="cpu"))
        on.run(_params(), _batches(), num_workers=WORKERS, seed=3,
               record_every=1, phase_len=10, sink=sink)
    text = render(RunLog.load(path))
    assert "disp_mean" in text and "B/event" in text
    assert f"total: {STEPS} steps" in text
    assert "disp_pred" in text
    lines = [ln for ln in text.splitlines() if ln.strip().startswith("0 ")]
    assert lines, text


def test_report_cli(tmp_path, capsys):
    path = tmp_path / "run.jsonl"
    with JsonlSink(path) as sink:
        sink.emit(make_record("phase_metrics", t0=1, t1=10, steps=10,
                              events=2, comm_bytes=96.0, loss_mean=1.0,
                              disp_mean=0.1, disp_max=0.2,
                              alive_mean=4.0, straggle_rate=0.0,
                              wall_s=0.5))
    assert report_main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "total: 10 steps, 2 events" in out
