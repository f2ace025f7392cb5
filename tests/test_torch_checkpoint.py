"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
reference's (``repro.checkpoint``), the same numpy draws fed to both.

- A reference-written engine state of every version of the ladder the
  reference writes (v0, the versionless v1, v2, v3 with the int8
  residual, v4 with fault rows, with and without the residual, v5 from
  an elastic save) resumes in the port, and the resumed run equals the
  reference's uninterrupted run: ``averages`` and event steps equal,
  params and losses within rtol 1e-6 / atol 1e-7 (losses by
  ``allclose``: R1), dispersions within rtol 1e-5 — over SGD, Momentum,
  AdamW and the outer optimizer.
- The other direction: a port-written float32 state resumes in the
  reference: a state the port loaded from the reference and wrote again
  resumes into the reference's uninterrupted run bitwise, and a state
  the port trained loads leaf for leaf bitwise and resumes with the
  reference's decisions (``TestPortStateResumesInReference``). This
  direction holds float32 states only: the reference cannot load
  bfloat16 leaves (its ``astype`` from the void dtype ``np.savez`` gives
  them; R3 in ROADMAP.md).
- A port-written state with bfloat16 leaves round-trips bitwise in the
  port, in a process that imports no ``ml_dtypes``, and resumes bitwise
  as the uninterrupted port run.
- The port writes the reference's ladder (v0, v2, v3, v4 with and
  without the residual, v5) and refuses what the reference refuses —
  torn ``.npz`` / ``.json``, a missing ``.npz``, another worker count
  (both counts named, the elastic module pointed at), a newer or an
  invalid version, a residual or fault rows the target lacks.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro.checkpoint import io as jio  # noqa: E402
from repro.core.averaging import AveragingSchedule as JSched  # noqa: E402
from repro.core.averaging import OuterOptimizer as JOuter  # noqa: E402
from repro.core.compress import Compression as JComp  # noqa: E402
from repro.core.engine import PhaseEngine as JEngine  # noqa: E402
from repro.faults import FaultPlan as JFaultPlan  # noqa: E402
from repro_torch import optim as popt  # noqa: E402
from repro_torch.checkpoint import io as pio  # noqa: E402
from repro_torch.core import AveragingSchedule, PhaseEngine  # noqa: E402
from repro_torch.core.averaging import OuterOptimizer  # noqa: E402
from repro_torch.core.compress import Compression  # noqa: E402
from repro_torch.faults import FaultPlan  # noqa: E402
from torch_parity import assert_runs_match  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DIM, SAMPLES, WORKERS, STEPS, CUT = 12, 256, 4, 32, 16
_PLAN = "crash:m=1@t=6,rejoin:m=1@t=20"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _batches():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((SAMPLES, DIM)).astype(np.float32)
    y = (X @ rng.standard_normal(DIM)).astype(np.float32)
    idx = rng.integers(0, SAMPLES, (STEPS, WORKERS, 8))
    return [{"x": X[idx[t]], "y": y[idx[t]]} for t in range(STEPS)]


def _jloss(p, b, r):
    res = b["x"] @ p["w"].astype(jnp.float32) - b["y"]
    return 0.5 * jnp.mean(res * res), {}


def _ploss(p, b, r):
    res = b["x"] @ p["w"].float() - b["y"]
    return 0.5 * torch.mean(res * res), {}


#: name: (optimizer, outer, wire, fault plan, how the reference saves)
CASES = {
    "sgd-v2": ("sgd", False, None, False, "v2"),
    "momentum-v2": ("momentum", False, None, False, "v2"),
    "adamw-v2": ("adamw", False, None, False, "v2"),
    "outer-v2": ("momentum", True, None, False, "v2"),
    "momentum-v0": ("momentum", False, None, False, "v0"),
    "adamw-v1": ("adamw", False, None, False, "v1"),
    "int8-v3": ("momentum", False, "int8", False, "v2"),
    "faults-v4": ("sgd", False, None, True, "v2"),
    "faults-int8-v4": ("adamw", False, "int8", True, "v2"),
    "faults-v5": ("momentum", False, None, True, "v5"),
}
WANT_VERSION = {"sgd-v2": 2, "momentum-v2": 2, "adamw-v2": 2, "outer-v2": 2,
                "momentum-v0": 0, "adamw-v1": None, "int8-v3": 3,
                "faults-v4": 4, "faults-int8-v4": 4, "faults-v5": 5}


def _engines(case):
    """(reference engine maker, port engine maker) of a case: stochastic
    averaging (zeta 0.3; decisions drawn from the decision key), the
    case's optimizer, outer optimizer, wire and fault plan."""
    opt, outer, wire, faults, _ = CASES[case]
    jo, po = {"sgd": (jopt.SGD(0.05), popt.SGD(0.05)),
              "momentum": (jopt.Momentum(0.05, 0.9),
                           popt.Momentum(0.05, 0.9)),
              "adamw": (jopt.AdamW(0.01), popt.AdamW(0.01))}[opt]
    jkw, pkw = {}, {}
    if outer:
        jkw["outer"] = JOuter(lr=0.9, momentum=0.5)
        pkw["outer"] = OuterOptimizer(lr=0.9, momentum=0.5)
    if wire:
        jkw["compression"], pkw["compression"] = JComp(wire), \
            Compression(wire)
    if faults:
        jkw["faults"] = JFaultPlan.parse(_PLAN, WORKERS, straggle_prob=0.1)
        pkw["faults"] = FaultPlan.parse(_PLAN, WORKERS, straggle_prob=0.1)
    sched = dict(kind="stochastic", zeta=0.3)

    def jax_engine():
        return JEngine(_jloss, jo, JSched(**sched), **jkw)

    def port_engine():
        return PhaseEngine(_ploss, po, AveragingSchedule(**sched),
                           device="cpu", **pkw)
    return jax_engine, port_engine


def _jrun(engine, batches, state=None, params=None):
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    return engine.run(params, jb, num_workers=WORKERS, seed=7,
                      record_every=1, state=state, return_state=True)


def _prun(engine, batches, state=None, params=None):
    return engine.run(params, batches, num_workers=WORKERS, seed=7,
                      record_every=1, state=state, return_state=True)


def _jparams():
    return {"w": jnp.zeros(DIM, jnp.float32)}


def _pparams(dtype=torch.float32):
    return {"w": torch.zeros(DIM, dtype=dtype)}


def _concat(h1, h2) -> dict:
    return {k: (h1[k] + h2[k]) for k in ("loss", "dispersion", "disp_trace",
                                          "averages")}


def _jax_save(path, st, how):
    if how == "v0":
        jio.save_engine_state(path, st._replace(sched=()))
    elif how == "v1":
        jio.save_checkpoint(path, jax.device_get(st), step=int(st.step))
    else:
        jio.save_engine_state(path, st, elastic=how == "v5")


class TestReferenceStateResumesInPort:
    @pytest.mark.parametrize("case", list(CASES))
    def test_resume_equals_reference_uninterrupted(self, tmp_path, case):
        jax_engine, port_engine = _engines(case)
        batches = _batches()
        f_full, h_full, _ = _jrun(jax_engine(), batches,
                                  params=_jparams())
        _, h1, st = _jrun(jax_engine(), batches[:CUT], params=_jparams())
        path = str(tmp_path / "ck")
        _jax_save(path, st, CASES[case][4])
        meta = json.load(open(path + ".json"))
        assert meta["extra"].get("engine_state_version") == \
            WANT_VERSION[case]
        like = port_engine().init(_pparams(), WORKERS, 7)
        loaded, at = pio.load_engine_state(path, like)
        assert at == CUT and loaded.step == CUT
        f_res, h2, st_res = _prun(port_engine(), batches[CUT:],
                                  state=loaded)
        assert_runs_match((f_res, _concat(h1, h2)), (f_full, h_full))
        if CASES[case][3]:
            _, _, st_j = _jrun(jax_engine(), batches, params=_jparams())
            assert np.array_equal(st_res.fault.alive,
                                  np.asarray(st_j.fault.alive))
            assert np.array_equal(st_res.fault.staleness,
                                  np.asarray(st_j.fault.staleness))


class TestPortStateResumesInReference:
    """float32 states only: the reference cannot load bfloat16 leaves
    (R3 in ROADMAP.md).

    The trajectory is held bitwise on a state the port wrote with the
    reference's own values (a reference state loaded and saved by the
    port): the reference's resumed run is its uninterrupted run. A state
    the port trained is held on its leaves (the reference loads each
    bitwise) and on the decisions of the resumed run; its params are not
    compared after the resume, since a port-trained and a
    reference-trained iterate differ by the engines' roundings (XLA's FMA
    contraction), which an element near 0 can carry past atol 1e-7."""

    @pytest.mark.parametrize("case", [c for c in CASES
                                      if CASES[c][4] in ("v2", "v5")])
    def test_resume_equals_reference_uninterrupted(self, tmp_path, case):
        jax_engine, port_engine = _engines(case)
        batches = _batches()
        f_full, h_full, s_full = _jrun(jax_engine(), batches,
                                       params=_jparams())
        _, h1, st = _jrun(jax_engine(), batches[:CUT], params=_jparams())
        jio.save_engine_state(str(tmp_path / "jax"), st)
        held, _ = pio.load_engine_state(
            str(tmp_path / "jax"), port_engine().init(_pparams(), WORKERS,
                                                      7))
        path = str(tmp_path / "ck")
        pio.save_engine_state(path, held, elastic=CASES[case][4] == "v5")
        loaded, at = jio.load_engine_state(
            path, jax_engine().init(_jparams(), WORKERS, 7))
        assert at == CUT
        for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(st)):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        f_res, h2, s_res = _jrun(jax_engine(), batches[CUT:], state=loaded)
        np.testing.assert_array_equal(np.asarray(f_res["w"]),
                                      np.asarray(f_full["w"]))
        for a, b in zip(jax.tree.leaves(s_res), jax.tree.leaves(s_full)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert_runs_match((f_res, _concat(h1, h2)), (f_full, h_full))

    @pytest.mark.parametrize("case", [c for c in CASES
                                      if CASES[c][4] in ("v2", "v5")])
    def test_port_trained_state_resumes(self, tmp_path, case):
        jax_engine, port_engine = _engines(case)
        batches = _batches()
        _, h_full, _ = _jrun(jax_engine(), batches, params=_jparams())
        _, h1, st = _prun(port_engine(), batches[:CUT], params=_pparams())
        path = str(tmp_path / "ck")
        pio.save_engine_state(path, st, elastic=CASES[case][4] == "v5")
        loaded, at = jio.load_engine_state(
            path, jax_engine().init(_jparams(), WORKERS, 7))
        assert at == CUT and int(loaded.step) == CUT
        np.testing.assert_array_equal(np.asarray(loaded.worker_params["w"]),
                                      st.plane.numpy())
        np.testing.assert_array_equal(np.asarray(loaded.key),
                                      st.key.numpy().astype(np.uint32))
        for a, b in zip(jax.tree.leaves(loaded.opt_state), st.opt_planes):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        if st.outer_state != ():
            for a, b in zip(loaded.outer_state, st.outer_state):
                np.testing.assert_array_equal(np.asarray(a["w"]),
                                              b.numpy())
        if CASES[case][3]:
            np.testing.assert_array_equal(np.asarray(loaded.fault.alive),
                                          st.fault.alive)
            np.testing.assert_array_equal(
                np.asarray(loaded.fault.staleness), st.fault.staleness)
        f_res, h2, _ = _jrun(jax_engine(), batches[CUT:], state=loaded)
        assert bool(np.isfinite(np.asarray(f_res["w"])).all())
        hist = _concat(h1, h2)
        assert hist["averages"] == h_full["averages"]
        assert [t for t, _ in hist["dispersion"]] == \
            [t for t, _ in h_full["dispersion"]]

    def test_consensus_checkpoint_loads_in_reference(self, tmp_path):
        tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                "b": (torch.tensor(2.5),)}
        path = str(tmp_path / "m")
        pio.save_checkpoint(path, tree, step=5)
        back, step = jio.load_checkpoint(
            path, {"a": np.zeros((2, 3), np.float32),
                   "b": (np.float32(0),)})
        assert step == 5
        np.testing.assert_array_equal(back["a"], tree["a"].numpy())
        assert float(back["b"][0]) == 2.5


class TestBf16:
    def _state(self):
        engine = PhaseEngine(_ploss, popt.Momentum(0.05, 0.9),
                             AveragingSchedule("stochastic", zeta=0.3),
                             device="cpu",
                             outer=OuterOptimizer(lr=0.9, momentum=0.5))
        return engine

    def test_bf16_state_round_trips_bitwise_and_resumes(self, tmp_path):
        engine = self._state()
        batches = _batches()
        f_full, h_full, s_full = _prun(engine, batches,
                                       params=_pparams(torch.bfloat16))
        _, h1, st = _prun(engine, batches[:CUT],
                          params=_pparams(torch.bfloat16))
        path = str(tmp_path / "ck")
        pio.save_engine_state(path, st)
        meta = json.load(open(path + ".json"))
        # the worker params and the outer average in bf16, as the
        # reference writes them; opt state and outer velocity in f32
        assert meta["dtypes"][:4] == ["bfloat16", "float32", "bfloat16",
                                      "float32"]
        data = np.load(path + ".npz")
        assert data["leaf_0"].dtype == np.dtype("V2")
        like = engine.init(_pparams(torch.bfloat16), WORKERS, 7)
        loaded, _ = pio.load_engine_state(path, like)
        assert torch.equal(loaded.plane, st.plane)
        assert all(torch.equal(a, b) for a, b in
                   zip(loaded.opt_planes + loaded.outer_state,
                       st.opt_planes + st.outer_state))
        assert torch.equal(loaded.key, st.key) and loaded.sched == st.sched
        f_res, h2, s_res = _prun(engine, batches[CUT:], state=loaded)
        assert torch.equal(s_res.plane, s_full.plane)
        assert torch.equal(f_res["w"], f_full["w"])
        assert h1["loss"] + h2["loss"] == h_full["loss"]

    def test_bf16_leaves_need_no_ml_dtypes(self, tmp_path):
        code = (
            "import sys, torch\n"
            "from repro_torch.checkpoint import save_checkpoint, "
            "load_checkpoint\n"
            "t = {'a': torch.randn(5, 3).to(torch.bfloat16), "
            "'b': torch.randn(4)}\n"
            f"save_checkpoint({str(tmp_path / 'm')!r}, t, step=3)\n"
            f"back, step = load_checkpoint({str(tmp_path / 'm')!r}, t)\n"
            "assert step == 3 and back['a'].dtype == torch.bfloat16\n"
            "assert torch.equal(back['a'], t['a'])\n"
            "assert torch.equal(back['b'], t['b'])\n"
            "print('ML_DTYPES', 'ml_dtypes' in sys.modules)\n")
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        assert out.returncode == 0, out.stderr
        assert "ML_DTYPES False" in out.stdout


def _port_state(wire=None, faults=False, steps=CUT):
    kw = {}
    if wire:
        kw["compression"] = Compression(wire)
    if faults:
        kw["faults"] = FaultPlan.parse(_PLAN, WORKERS, straggle_prob=0.1)
    engine = PhaseEngine(_ploss, popt.Momentum(0.05, 0.9),
                         AveragingSchedule("periodic", phase_len=4),
                         device="cpu", **kw)
    st = _prun(engine, _batches()[:steps], params=_pparams())[2]
    return engine, st


class TestLadder:
    @pytest.mark.parametrize("wire,faults,elastic,strip,want", [
        (None, False, False, True, 0),
        (None, False, False, False, 2),
        ("int8", False, False, False, 3),
        (None, True, False, False, 4),
        ("int8", True, False, False, 4),
        ("int8", True, True, False, 5),
    ], ids=["v0", "v2", "v3", "v4", "v4-resid", "v5"])
    def test_port_writes_the_lowest_version(self, tmp_path, wire, faults,
                                            elastic, strip, want):
        engine, st = _port_state(wire, faults)
        saved = st._replace(sched=()) if strip else st
        path = str(tmp_path / "ck")
        pio.save_engine_state(path, saved, elastic=elastic,
                              extra={"note": "kept"})
        extra = json.load(open(path + ".json"))["extra"]
        assert extra["engine_state_version"] == want
        assert extra["num_workers"] == WORKERS and extra["note"] == "kept"
        if want == 4:
            assert extra["has_resid"] == (wire is not None)
        if want == 5:
            assert extra["has_sched"] and extra["has_resid"] \
                and extra["has_fault"]
        like = engine.init(_pparams(), WORKERS, 7)
        loaded, at = pio.load_engine_state(path, like)
        assert at == CUT and torch.equal(loaded.plane, st.plane)
        if strip:
            assert loaded.sched == engine.schedule.init_sched_state()
        else:
            assert loaded.sched == st.sched
        if wire:
            assert torch.equal(loaded.resid, st.resid)
        if faults:
            assert np.array_equal(loaded.fault.alive, st.fault.alive)
            assert np.array_equal(loaded.fault.staleness,
                                  st.fault.staleness)

    def test_pre_resid_and_pre_fault_states_load_fresh(self, tmp_path):
        """A v2 state into an engine with a wire and a plan: a zero
        residual and all-alive, fresh fault rows, as the reference."""
        _, st = _port_state()
        engine, _ = _port_state("int8", True)
        path = str(tmp_path / "ck")
        pio.save_engine_state(path, st)
        loaded, _ = pio.load_engine_state(
            path, engine.init(_pparams(), WORKERS, 7))
        assert torch.equal(loaded.plane, st.plane)
        assert not loaded.resid.any()
        assert loaded.fault.alive.tolist() == [1.0] * WORKERS


def _refused(fn, *needles):
    with pytest.raises(ValueError) as e:
        fn()
    msg = str(e.value)
    for n in needles:
        assert n in msg, msg
    return msg


class TestRefusals:
    """The reference's refusals, each met by both loaders (the port's
    messages name ``repro_torch.elastic`` where the reference's name
    ``repro.elastic``)."""

    def _both(self, tmp_path, wire=None, faults=False):
        engine, st = _port_state(wire, faults)
        path = str(tmp_path / "ck")
        pio.save_engine_state(path, st)
        jeng = JEngine(_jloss, jopt.Momentum(0.05, 0.9),
                       JSched("periodic", 4))
        return path, engine, jeng

    @pytest.mark.parametrize("what", ["npz", "json", "missing"])
    def test_torn_files_refused(self, tmp_path, what):
        path, engine, jeng = self._both(tmp_path)
        if what == "npz":
            raw = open(path + ".npz", "rb").read()
            open(path + ".npz", "wb").write(raw[:len(raw) // 2])
            needle = "torn/partial array file"
        elif what == "json":
            raw = open(path + ".json").read()
            open(path + ".json", "w").write(raw[:len(raw) // 2])
            needle = "torn/partial metadata"
        else:
            os.remove(path + ".npz")
            needle = "no array file"
        _refused(lambda: pio.load_engine_state(
            path, engine.init(_pparams(), WORKERS, 7)), needle)
        _refused(lambda: jio.load_engine_state(
            path, jeng.init(_jparams(), WORKERS, 7)), needle)

    def test_other_worker_count_refused(self, tmp_path):
        path, engine, jeng = self._both(tmp_path)
        _refused(lambda: pio.load_engine_state(
            path, engine.init(_pparams(), 3, 7)),
            "4-row worker plane", "3 rows", "repro_torch.elastic")
        _refused(lambda: jio.load_engine_state(
            path, jeng.init(_jparams(), 3, 7)),
            "4-row worker plane", "3 rows", "repro.elastic")

    @pytest.mark.parametrize("version,needle", [
        (6, "newer than this build's 5"), ("2", "invalid engine-state"),
        (True, "invalid engine-state"), (-1, "invalid engine-state")])
    def test_bad_versions_refused(self, tmp_path, version, needle):
        path, engine, jeng = self._both(tmp_path)
        meta = json.load(open(path + ".json"))
        meta["extra"]["engine_state_version"] = version
        json.dump(meta, open(path + ".json", "w"))
        _refused(lambda: pio.load_engine_state(
            path, engine.init(_pparams(), WORKERS, 7)), needle)
        _refused(lambda: jio.load_engine_state(
            path, jeng.init(_jparams(), WORKERS, 7)), needle)

    @pytest.mark.parametrize("wire,faults,needle", [
        ("int8", False, "error-feedback residual"),
        (None, True, "per-worker fault rows"),
        ("int8", True, "error-feedback residual")])
    def test_fields_the_target_lacks_refused(self, tmp_path, wire, faults,
                                             needle):
        engine, st = _port_state(wire, faults)
        path = str(tmp_path / "ck")
        pio.save_engine_state(path, st)
        plain = PhaseEngine(_ploss, popt.Momentum(0.05, 0.9),
                            AveragingSchedule("periodic", phase_len=4),
                            device="cpu")
        _refused(lambda: pio.load_engine_state(
            path, plain.init(_pparams(), WORKERS, 7)), needle)
        jeng = JEngine(_jloss, jopt.Momentum(0.05, 0.9),
                       JSched("periodic", 4))
        _refused(lambda: jio.load_engine_state(
            path, jeng.init(_jparams(), WORKERS, 7)), needle)

    def test_other_model_refused(self, tmp_path):
        path, _, _ = self._both(tmp_path)
        other = PhaseEngine(_ploss, popt.Momentum(0.05, 0.9),
                            AveragingSchedule("periodic", phase_len=4),
                            device="cpu")
        _refused(lambda: pio.load_engine_state(
            path, other.init({"w": torch.zeros(DIM + 1)}, WORKERS, 7)),
            "checkpoint/model mismatch")

