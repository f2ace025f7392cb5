"""The main path's step 5: the port's ``PhaseEngine.run`` over a
``DeviceDataset`` — batches gathered on the device from index blocks —
against the reference's indexed ``run``, on ``tests/test_flat.py``'s
least-squares problem (M=4, dim 12, 256 samples, batches of 8, 65
steps, SGD lr 0.05) under its seven schedules. The dataset, the index
draws and the start params are the same numpy arrays on both sides.

Against the reference (its own suite's tolerances): decisions, event
steps and ``averages`` equal; final params rtol 1e-6 / atol 1e-7;
dispersion rtol 1e-5; the ``eval`` (the consensus params, and the
objective taken in float64 at rtol 1e-5) and ``worker_eval`` (every
worker's params) records at the params tolerances; losses ``allclose``
at rtol 1e-6 / atol 1e-7 only —
the reference's own loss traces differ in the last ulp between its data
paths (ROADMAP queue 3, R1), so no trace is held bitwise across
packages.

Within the port, bitwise: the indexed run, the staged run (prefetched
and in line) and ``run_host`` give the same params and history; so do
``kernel_impl`` ``"auto"`` and ``"ref"`` on the CPU, and a run split in
two over one dataset (the cursor) against one run. ``kernel_impl="cuda"``
is refused on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import AveragingSchedule as JSched  # noqa: E402
from repro.core import PhaseEngine as JEngine  # noqa: E402
from repro.data.pipeline import DeviceDataset as JDataset  # noqa: E402
from repro.optim import SGD as JSGD  # noqa: E402
from repro_torch.configs.paper import CONVEX_SUITE  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import AveragingSchedule, PhaseEngine  # noqa: E402
from repro_torch.core.flat import FlatSpec  # noqa: E402
from repro_torch.data import DeviceDataset, convex_dataset  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.optim import SGD  # noqa: E402

WORKERS, STEPS, DIM, SAMPLES, BATCH = 4, 65, 12, 256, 8
PARAMS_TOL = dict(rtol=1e-6, atol=1e-7)
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
RECORD = 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _problem(seed=0):
    """test_flat's problem, made float32 once: both packages get these
    arrays."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((SAMPLES, DIM))
    y = X @ rng.standard_normal(DIM) + 0.1 * rng.standard_normal(SAMPLES)
    idx = np.random.default_rng(1).integers(0, SAMPLES,
                                            (STEPS, WORKERS, BATCH))
    return X.astype(np.float32), y.astype(np.float32), idx


X, Y, IDX = _problem()
W0 = {"w": {"inner": np.zeros(DIM, np.float32)}}


def _jloss(p, b, r):
    res = b["x"] @ p["w"]["inner"] - b["y"]
    return 0.5 * jnp.mean(res * res), {}


def _ploss(p, b, r):
    res = b["x"] @ p["w"]["inner"] - b["y"]
    return 0.5 * torch.mean(res * res), {}


def _jeval(p):
    """The consensus params and the objective, taken in float64 so that
    it differs only as far as the params do."""
    w = np.asarray(p["w"]["inner"])
    r = X.astype(np.float64) @ w.astype(np.float64) - Y
    return w.copy(), float(0.5 * np.mean(r * r))


def _peval(p):
    return _jeval({"w": {"inner": p["w"]["inner"].numpy()}})


def _jworker_eval(wp):
    return np.array(wp["w"]["inner"])


def _pworker_eval(wp):
    return wp["w"]["inner"].numpy().copy()


def _port(name, **kw):
    return PhaseEngine(_ploss, SGD(lr=0.05),
                       AveragingSchedule(**SCHEDULES[name]), device="cpu",
                       **kw)


def _port_params():
    return params_from_jax(W0, "cpu")


def _staged():
    return ({"x": X[IDX[t]], "y": Y[IDX[t]]} for t in range(STEPS))


_EVALS = dict(record_every=RECORD, eval_fn=_peval,
              worker_eval_fn=_pworker_eval)


@pytest.fixture(scope="module")
def runs():
    """Per schedule: the reference's indexed run and the port's indexed,
    staged (prefetched), staged in line and host runs."""
    out = {}
    for name in SCHEDULES:
        jeng = JEngine(_jloss, JSGD(lr=0.05), JSched(**SCHEDULES[name]))
        jf, jh = jeng.run(W0, JDataset({"x": X, "y": Y}, WORKERS,
                                       indices=IDX),
                          num_workers=WORKERS, seed=3, record_every=RECORD,
                          eval_fn=_jeval, worker_eval_fn=_jworker_eval)
        eng = _port(name)
        ds = DeviceDataset({"x": X, "y": Y}, WORKERS, indices=IDX,
                           device="cpu")
        kw = dict(num_workers=WORKERS, seed=3, **_EVALS)
        out[name] = dict(
            jax=(np.asarray(jf["w"]["inner"]), jh),
            indexed=eng.run(_port_params(), ds, **kw),
            staged=eng.run(_port_params(), _staged(), **kw),
            inline=eng.run(_port_params(), list(_staged()), **kw),
            host=eng.run_host(_port_params(), _staged(), **kw))
    return out


def _hist_equal(a, b):
    """Two port histories equal, value for value (the host clock
    aside)."""
    for k in ("loss", "dispersion", "disp_trace", "averages"):
        assert a[k] == b[k], k
    for k in ("eval", "worker_eval"):
        assert [t for t, _ in a[k]] == [t for t, _ in b[k]], k
        for (_, x), (_, y) in zip(a[k], b[k]):
            if isinstance(x, tuple):
                np.testing.assert_array_equal(x[0], y[0])
                assert x[1] == y[1]
            else:
                np.testing.assert_array_equal(x, y)


def _paper_problem(steps=48):
    """synth-ls-sparse-highrho's shapes cut to 512 samples x 256 dims,
    24 workers, one sample per worker and step: the (K, M) index layout
    of the paper's §3.1 curves."""
    c = CONVEX_SUITE[0]
    Xp, yp, _ = convex_dataset(c.model, 512, 256, sparsity=c.sparsity,
                               noise=c.noise, seed=0)
    idx = np.random.default_rng(1).integers(0, 512, (steps, c.num_workers))
    lr0 = 0.8 * 200.0 / float(np.mean(np.sum(Xp * Xp, axis=1)))
    return c.num_workers, Xp, yp, idx, lr0


class TestAgainstReference:
    """The port's indexed ``run`` against the reference's."""

    @pytest.mark.parametrize("name", list(SCHEDULES))
    def test_indexed_run_matches_reference(self, runs, name):
        jw, jh = runs[name]["jax"]
        final, h = runs[name]["indexed"]
        assert h["averages"] == jh["averages"]
        assert [t for t, _ in h["dispersion"]] == \
            [t for t, _ in jh["dispersion"]]
        np.testing.assert_allclose(final["w"]["inner"].numpy(), jw,
                                   **PARAMS_TOL)
        np.testing.assert_allclose([v for _, v in h["dispersion"]],
                                   [v for _, v in jh["dispersion"]], rtol=1e-5,
                                   atol=1e-8)
        np.testing.assert_allclose([v for _, v in h["disp_trace"]],
                                   [v for _, v in jh["disp_trace"]], rtol=1e-5,
                                   atol=1e-8)
        assert [t for t, _ in h["loss"]] == [t for t, _ in jh["loss"]]
        np.testing.assert_allclose([v for _, v in h["loss"]],
                                   [v for _, v in jh["loss"]], rtol=1e-6,
                                   atol=1e-7)

    @pytest.mark.parametrize("name", list(SCHEDULES))
    def test_eval_hooks_match_reference(self, runs, name):
        _, jh = runs[name]["jax"]
        _, h = runs[name]["indexed"]
        steps = list(range(RECORD, STEPS + 1, RECORD))
        assert [t for t, _ in h["eval"]] == [t for t, _ in jh["eval"]] == steps
        assert [t for t, _ in h["worker_eval"]] == steps
        assert [t for t, _ in jh["worker_eval"]] == steps
        for (_, (w, f)), (_, (jw_, jf)) in zip(h["eval"], jh["eval"]):
            np.testing.assert_allclose(w, jw_, **PARAMS_TOL)
            # the objective moves with the params: rtol 1e-6 / atol 1e-7 on
            # them moves it by a few 1e-6 at most here
            np.testing.assert_allclose(f, jf, rtol=1e-5)
        for (_, wp), (_, jwp) in zip(h["worker_eval"], jh["worker_eval"]):
            assert wp.shape == (WORKERS, DIM)
            np.testing.assert_allclose(wp, jwp, **PARAMS_TOL)


class TestAgainstReferenceParts:
    """Against the reference: decision codes, the start, the one-sample
    index layout, a sampling dataset."""

    def test_decision_codes_match_reference(self):
        """One phase over the whole index block on both sides: the per-step
        decision codes (0 / 1 inner / 2 all) equal, the traces close."""
        name = "hierarchical"
        jeng = JEngine(_jloss, JSGD(lr=0.05), JSched(**SCHEDULES[name]))
        jstate = jeng.init(W0, WORKERS, 3)
        _, jtr = jeng.run_phase_indexed(
            jstate, {"x": jnp.asarray(X), "y": jnp.asarray(Y)},
            jnp.asarray(IDX.astype(np.int32)))
        eng = _port(name)
        state = eng.init(_port_params(), WORKERS, 3)
        _, tr = eng.run_phase_indexed(
            state, {"x": torch.from_numpy(X), "y": torch.from_numpy(Y)}, IDX)
        assert tr["avg_code"] == [int(c) for c in np.asarray(jtr["avg_code"])]
        assert set(tr["avg_code"]) == {0, 1, 2}
        np.testing.assert_allclose(tr["dispersion"],
                                   np.asarray(jtr["dispersion"]),
                                   rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(tr["loss"], np.asarray(jtr["loss"]),
                                   rtol=1e-6, atol=1e-7)

    def test_both_start_from_the_same_params_and_data(self):
        """The start is the same: the reference's w0 carried across by
        ``params_from_jax`` packs to a bitwise-equal plane, and the two
        datasets hold bitwise-equal arrays."""
        jeng = JEngine(_jloss, JSGD(lr=0.05), JSched("periodic", 8))
        jwp = jeng.init(W0, WORKERS, 3).worker_params
        state = _port("periodic").init(_port_params(), WORKERS, 3)
        np.testing.assert_array_equal(state.plane.numpy(),
                                      np.asarray(jwp["w"]["inner"]))
        assert state.plane.dtype == torch.float32
        jds = JDataset({"x": X, "y": Y}, WORKERS, indices=IDX)
        ds = DeviceDataset({"x": X, "y": Y}, WORKERS, indices=IDX,
                           device="cpu")
        for k in ("x", "y"):
            np.testing.assert_array_equal(ds.arrays[k].numpy(),
                                          np.asarray(jds.arrays[k]))

    def test_single_sample_index_layout_matches_reference(self):
        m, Xp, yp, idx, lr0 = _paper_problem()

        def jl(p, b, r):
            return 0.5 * jnp.square(b["x"] @ p["w"] - b["y"]), {}

        def pl(p, b, r):
            return 0.5 * torch.square(b["x"] @ p["w"] - b["y"]), {}

        def jobj(p):
            r = Xp @ np.asarray(p["w"]) - yp
            return float(0.5 * np.mean(r * r))

        lr = (lambda t: lr0 / (t - 1.0 + 200.0))
        w0 = {"w": np.zeros(Xp.shape[1], np.float32)}
        jf, jh = JEngine(jl, JSGD(lr=lr), JSched("periodic", 16)).run(
            w0, JDataset({"x": Xp, "y": yp}, m, indices=idx), num_workers=m,
            seed=0, record_every=8, eval_fn=jobj)
        eng = PhaseEngine(pl, SGD(lr=lr), AveragingSchedule("periodic",
                                                            phase_len=16),
                          device="cpu")
        f, h = eng.run(params_from_jax(w0, "cpu"),
                       DeviceDataset({"x": Xp, "y": yp}, m, indices=idx,
                                     device="cpu"),
                       num_workers=m, seed=0, record_every=8,
                       eval_fn=lambda p: jobj({"w": p["w"].numpy()}))
        assert h["averages"] == jh["averages"] == 3
        assert [t for t, _ in h["dispersion"]] == [16, 32, 48]
        np.testing.assert_allclose(f["w"].numpy(), np.asarray(jf["w"]),
                                   **PARAMS_TOL)
        np.testing.assert_allclose([v for _, v in h["eval"]],
                                   [v for _, v in jh["eval"]], rtol=1e-6)

    def test_dataset_sampler_matches_reference_and_needs_steps(self):
        """A sampling dataset (replacement, batch 8) runs ``steps`` steps,
        as the reference's does; without ``steps`` it is refused, and so is
        a dataset drawn for another worker count."""
        jf, jh = JEngine(_jloss, JSGD(lr=0.05), JSched("periodic", 8)).run(
            W0, JDataset({"x": X, "y": Y}, WORKERS, batch_size=BATCH, seed=2),
            num_workers=WORKERS, seed=3, steps=24, record_every=1)
        eng = _port("periodic")
        f, h = eng.run(_port_params(), DeviceDataset(
            {"x": X, "y": Y}, WORKERS, batch_size=BATCH, seed=2, device="cpu"),
            num_workers=WORKERS, seed=3, steps=24, record_every=1)
        assert h["averages"] == jh["averages"] == 3
        np.testing.assert_allclose(f["w"]["inner"].numpy(),
                                   np.asarray(jf["w"]["inner"]), **PARAMS_TOL)
        with pytest.raises(ValueError, match="steps="):
            eng.run(_port_params(), DeviceDataset(
                {"x": X, "y": Y}, WORKERS, batch_size=BATCH, device="cpu"),
                num_workers=WORKERS)
        with pytest.raises(ValueError, match="workers"):
            eng.run(_port_params(), DeviceDataset(
                {"x": X, "y": Y}, 2, batch_size=BATCH, device="cpu"),
                num_workers=WORKERS, steps=4)


class TestWithinPort:
    """Within the port: the paths bitwise, and ``kernel_impl``."""

    @pytest.mark.parametrize("name", list(SCHEDULES))
    def test_staged_indexed_and_host_bitwise(self, runs, name):
        final, h = runs[name]["indexed"]
        for path in ("staged", "inline", "host"):
            f2, h2 = runs[name][path]
            np.testing.assert_array_equal(f2["w"]["inner"].numpy(),
                                          final["w"]["inner"].numpy())
            _hist_equal(h2, h)

    @pytest.mark.parametrize("name", ["periodic", "hierarchical", "minibatch"])
    def test_kernel_impl_ref_equals_auto_on_cpu(self, name):
        kw = dict(num_workers=WORKERS, seed=3, record_every=1)
        ds = lambda: DeviceDataset({"x": X, "y": Y}, WORKERS, indices=IDX,
                                   device="cpu")
        fa, ha = _port(name).run(_port_params(), ds(), **kw)
        fr, hr = _port(name, kernel_impl="ref").run(_port_params(), ds(), **kw)
        np.testing.assert_array_equal(fr["w"]["inner"].numpy(),
                                      fa["w"]["inner"].numpy())
        _hist_equal(hr, ha)

    def test_kernel_impl_refusals(self):
        with pytest.raises(ValueError, match="kernel_impl='cuda'"):
            _port("periodic", kernel_impl="cuda")
        with pytest.raises(ValueError, match="kernel_impl must be"):
            _port("periodic", kernel_impl="pallas")


class TestEngineParts:
    """The block size, the gather's device check, the worker params, the
    dataset's cursor, the phase blocks, the prefetch."""

    @pytest.mark.parametrize("zeta", [1.0, 0.2, 0.05, 0.001])
    def test_default_phase_len_matches_reference(self, zeta):
        for kw in (dict(kind="stochastic", zeta=zeta), SCHEDULES["periodic"],
                   SCHEDULES["hierarchical"], SCHEDULES["adaptive_budget"],
                   SCHEDULES["oneshot"]):
            j = JEngine(_jloss, JSGD(lr=0.05), JSched(**kw))
            p = PhaseEngine(_ploss, SGD(lr=0.05), AveragingSchedule(**kw),
                            device="cpu")
            assert p.default_phase_len() == j.default_phase_len()

    def test_gather_refuses_a_dataset_on_another_device(self):
        eng = _port("periodic")
        state = eng.init(_port_params(), WORKERS, 3)
        with pytest.raises(ValueError, match="gather"):
            eng.run_phase_indexed(state, {"x": torch.zeros(4, 2,
                                                           device="meta")},
                                  IDX[:1])

    def test_worker_params_are_copies(self):
        eng = _port("periodic")
        state = eng.init(_port_params(), WORKERS, 3)
        wp = eng.worker_params(state)
        assert wp["w"]["inner"].shape == (WORKERS, DIM)
        FlatSpec.of(wp)  # a worker tree
        wp["w"]["inner"][0, 0] = 7.0
        assert float(state.plane[0, 0]) == 0.0

    def test_dataset_cursor_continues_across_calls(self):
        """Two calls over one dataset (30 steps, then the rest) give the one
        run's params and events; a list shorter than ``steps`` ends the run."""
        eng = _port("periodic")
        ds = DeviceDataset({"x": X, "y": Y}, WORKERS, indices=IDX,
                           device="cpu")
        _, h1, state = eng.run(_port_params(), ds, num_workers=WORKERS, seed=3,
                               steps=30, return_state=True)
        assert ds.num_steps == STEPS - 30 and state.step == 30
        f2, h2, state = eng.run(None, ds, num_workers=WORKERS, steps=1000,
                                state=state, return_state=True)
        assert state.step == STEPS and ds.num_steps == 0
        full, hf = eng.run(_port_params(), DeviceDataset(
            {"x": X, "y": Y}, WORKERS, indices=IDX, device="cpu"),
            num_workers=WORKERS, seed=3)
        np.testing.assert_array_equal(f2["w"]["inner"].numpy(),
                                      full["w"]["inner"].numpy())
        assert h1["dispersion"] + h2["dispersion"] == hf["dispersion"]

    def test_record_boundaries_end_phases(self):
        """With an eval hook, blocks of the period (8) are cut where a
        record step (every 12) falls inside them, as the reference's
        ``take_at`` cuts them; without one they are not."""
        eng = _port("periodic")
        ends = []
        for hook in (_peval, None):
            _, h = eng.run(_port_params(), DeviceDataset(
                {"x": X, "y": Y}, WORKERS, indices=IDX, device="cpu"),
                num_workers=WORKERS, seed=3, record_every=12, eval_fn=hook)
            ends.append([t1 for _, t1, _ in h["phase_wall"]])
        assert ends[0] == [8, 12, 20, 24, 32, 36, 44, 48, 56, 60, 65]
        assert ends[1] == [8, 16, 24, 32, 40, 48, 56, 64, 65]

    def test_prefetch_only_for_streams(self, monkeypatch):
        """A generator is staged by the background Prefetcher (bitwise the
        in-line staging); a list is staged in line."""
        made = []

        class Counting(pipeline.Prefetcher):
            def __init__(self, it, **kw):
                made.append(1)
                super().__init__(it, **kw)

        monkeypatch.setattr(pipeline, "Prefetcher", Counting)
        eng = _port("periodic")
        kw = dict(num_workers=WORKERS, seed=3, record_every=1)
        fa, ha = eng.run(_port_params(), _staged(), **kw)
        assert len(made) == 1
        fb, hb = eng.run(_port_params(), _staged(), prefetch=False, **kw)
        fc, hc = eng.run(_port_params(), list(_staged()), **kw)
        assert len(made) == 1
        for f, h in ((fb, hb), (fc, hc)):
            np.testing.assert_array_equal(f["w"]["inner"].numpy(),
                                          fa["w"]["inner"].numpy())
            _hist_equal(h, ha)

    def test_prefetched_stream_error_reaches_the_caller(self):
        def broken():
            yield from list(_staged())[:10]
            raise OSError("stream broke")

        with pytest.raises(OSError, match="stream broke"):
            _port("periodic").run(_port_params(), broken(),
                                  num_workers=WORKERS)
