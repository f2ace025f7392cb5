"""The port's experiments (``repro_torch.experiments``) on the CPU against
the reference's scripts, ``benchmarks/bench_*.py``, loaded unedited from
their files with the repository's root on ``sys.path`` (as
``examples/convex_averaging.py`` imports them), at small sizes. Where a
script's ``run`` would take minutes, both ``run``s get the same wrapped
globals (a smaller config, a smaller simulation), and their payloads are
captured from ``save``.

Tolerances:

- decisions, ``averages``, event steps, phase lengths, averaging counts:
  equal;
- Figure 2's engine runs (``PhaseEngine`` wrapped to keep each history):
  the objectives, the losses and the final params at the engine's rtol
  1e-6 / atol 1e-7 (``tests/test_flat.py``); the normalized curves
  ``(f - f*) / (f(0) - f*)`` at atol ``SUBOPT_ATOL`` = 5e-6: three float32
  objectives near 0.5, each within 1e-6 of its twin, over a span of
  0.1-0.6 (measured at most 1.2e-6 apart);
- Figure 3's CNN runs: ``test_torch_cnn.py``'s rtol 1e-3 / atol 5e-4 (a
  ReLU or max-pool flip by an ulp is amplified by training);
- the quartic on the reference's own ``u``: the objectives at rtol
  ``QUARTIC_RTOL`` = 1e-5 (400 float32 steps; the reference's XLA fuses
  ``w - α g`` into one FMA and sums the 24-worker mean in another order;
  measured 6e-7 apart); the port's own ``u`` within 4 float32 ulps of
  ``jax.random.normal``'s (``rng.normal``), and its objectives at the
  same rtol;
- Figure 1 (float64 on both sides): the PC errors at rtol 1e-12
  (measured 7e-16 apart);
- Table 1: σ², β² and ρ at rtol ``TABLE1_RTOL`` = 1e-4: σ² is the
  gradient variance at w*, where the sparse least squares' residuals are
  its 1e-3 noise, so the float32 solve's last bits show at 1.5e-5;
- Lemma 1: the closed form at rtol 1e-12, the simulated variance at rtol
  1e-5 (``test_torch_theory.py``), its relative error against the closed
  form at atol 2e-5 (that rtol times simulated / closed form, about 1).
"""
import dataclasses
import importlib.util
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import paper as jpaper  # noqa: E402
from repro.data import convex_dataset  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.configs import paper as ppaper  # noqa: E402
from repro_torch.core.flat import tree_flatten  # noqa: E402
from repro_torch.experiments import (common, fig1_pca, fig2_convex,  # noqa: E402
                                     fig3_cnn, lemma1, quartic, table1)
from repro_torch.experiments import __main__ as run_all  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ENGINE_TOL = dict(rtol=1e-6, atol=1e-7)
CNN_TOL = dict(rtol=1e-3, atol=5e-4)
SUBOPT_ATOL = 5e-6
QUARTIC_RTOL = 1e-5
TABLE1_RTOL = 1e-4
FRACS = [0.0, 0.001, 0.01, 0.1]
QUARTIC_STEPS = 400
PCA = dict(dim=20, num_workers=8, num_samples=300)
PCA_LENS = [0, 100, 25, 5, 1]
#: Figure 2 at n x d, workers, steps, phase lengths and two rates
F2 = dict(n=64, d=8, workers=4, steps=40, phase_lens=(0, 1, 8),
          lr_mults=(0.8, 3.0))
CNN = dict(conv_channels=(4, 8), fc_hidden=32)
CNN_STEPS, CNN_EVERY, CNN_EVAL = 20, 5, 64
LEMMA1_REPS, LEMMA1_STEPS = 8, 100


def _bench(name: str):
    """A fresh copy of ``benchmarks/<name>.py``, unedited (its globals may
    be wrapped without touching another test's copy)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location(
        f"{name}_ref_{id(object())}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(mod):
    """A fresh copy of the port's experiment module ``mod``."""
    spec = importlib.util.spec_from_file_location(
        f"{mod.__name__}_t_{id(object())}", mod.__file__)
    out = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(out)
    return out


def _no_warmup(mod):
    """The module's ``timeit`` without its warm-up call: each ``run``
    computes its rows once."""
    timeit = getattr(mod, "timeit", None)
    if timeit is not None:
        mod.timeit = lambda fn, *a, reps=3, warmup=1: timeit(
            fn, *a, reps=reps, warmup=0)


def _capture(mod) -> dict:
    """Replace the module's ``save`` and ``emit``: keep the payload and
    the derived string."""
    got = {}
    mod.save = lambda name, payload: got.update(name=name, payload=payload)
    mod.emit = lambda name, us, derived: got.update(line=name,
                                                     derived=derived)
    return got


def _keep_runs(mod) -> list:
    """Wrap the module's PhaseEngine so that each ``run``'s (final,
    history) is kept."""
    runs = []

    class Kept(mod.PhaseEngine):
        def run(self, *a, **k):
            out = super().run(*a, **k)
            runs.append(out)
            return out
    mod.PhaseEngine = Kept
    return runs


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _values(pairs):
    return np.array([v for _, v in pairs], np.float64)


def _steps(pairs):
    return [t for t, _ in pairs]


def _hold_runs(ref_runs, port_runs):
    """Each engine run of the port against the reference's: averages and
    event steps equal; losses, dispersions, evals and params at
    ENGINE_TOL."""
    assert len(ref_runs) == len(port_runs) > 0
    for (fr, hr), (fp, hp) in zip(ref_runs, port_runs):
        assert hp["averages"] == hr["averages"]
        for key in ("dispersion", "loss", "eval"):
            assert _steps(hp[key]) == _steps(hr[key])
            np.testing.assert_allclose(_values(hp[key]), _values(hr[key]),
                                       rtol=1e-6 if key != "dispersion"
                                       else 1e-5, atol=1e-7)
        np.testing.assert_allclose(fp["w"].numpy(), np.asarray(fr["w"]),
                                   **ENGINE_TOL)


# ---- the quartic (§2.4) ----------------------------------------------------

@pytest.fixture(scope="module")
def quartic_ref():
    ref = _bench("bench_quartic")
    cfg = jpaper.QuarticConfig(num_steps=QUARTIC_STEPS)
    u = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                     (cfg.num_steps, cfg.num_workers)))
    return u, ref.run_quartic(cfg, FRACS)


def test_quartic_noise_within_4_ulps_of_jax(quartic_ref):
    u, _ = quartic_ref
    got = rng.normal(rng.PRNGKey(0), u.shape, device="cpu").numpy()
    assert np.all(np.abs(got - u) <= 4 * np.spacing(np.abs(u)))


@pytest.mark.parametrize("own_u", [False, True])
def test_quartic_matches_reference(quartic_ref, own_u):
    u, want = quartic_ref
    cfg = ppaper.QuarticConfig(num_steps=QUARTIC_STEPS)
    got = quartic.run_quartic(cfg, FRACS, device="cpu",
                              u=None if own_u else u)
    assert [r["avg_frac"] for r in got] == [r["avg_frac"] for r in want]
    np.testing.assert_allclose([r["objective"] for r in got],
                               [r["objective"] for r in want],
                               rtol=QUARTIC_RTOL)


def test_quartic_refuses_a_misshapen_u():
    with pytest.raises(ValueError, match="u must be"):
        quartic.run_quartic(ppaper.QuarticConfig(num_steps=4), FRACS,
                            device="cpu", u=np.zeros((3, 24)))


# ---- Figure 1 (Oja's rule) ---------------------------------------------------

@pytest.mark.parametrize("block", [64, fig1_pca.DRAW_BLOCK])
def test_fig1_pca_matches_reference(block, monkeypatch):
    ref = _bench("bench_fig1_pca")
    want = ref.pca_error_vs_avg_steps(jpaper.PCAConfig(**PCA), PCA_LENS)
    monkeypatch.setattr(fig1_pca, "DRAW_BLOCK", block)
    got = fig1_pca.pca_error_vs_avg_steps(ppaper.PCAConfig(**PCA), PCA_LENS,
                                          device="cpu")
    for key in ("phase_len", "num_avg_steps"):
        assert [r[key] for r in got] == [r[key] for r in want]
    np.testing.assert_allclose([r["pc_error"] for r in got],
                               [r["pc_error"] for r in want], rtol=1e-12)


# ---- the scripts' run(), on the same smaller globals ------------------------

def _small_quartic(mod, real):
    mod.QuarticConfig = lambda: real(num_steps=QUARTIC_STEPS)


def _small_pca(mod, real):
    mod.PCAConfig = lambda **k: real(**dict(k, **PCA))


def _small_lemma1(mod):
    sim = mod.simulate_quadratic
    mod.simulate_quadratic = lambda *a, **k: sim(
        *a[:6], LEMMA1_STEPS, **dict(k, reps=LEMMA1_REPS))


def _small_suite(mod, n=128, d=16):
    mod.CONVEX_SUITE = tuple(dataclasses.replace(c, num_samples=n,
                                                 num_dims=d)
                             for c in mod.CONVEX_SUITE)


def _runs(name, port_mod, shrink):
    ref, port = _bench(f"bench_{name}"), _port(port_mod)
    shrink(ref, port)
    _no_warmup(ref)
    _no_warmup(port)
    got_r, got_p = _capture(ref), _capture(port)
    ref.run()
    port.run(device="cpu")
    assert got_p["name"] == got_r["name"] == f"bench_{name}"
    assert got_p["line"] == got_r["line"]
    return got_r, got_p


def test_quartic_run_matches_reference():
    want, got = _runs("quartic", quartic, lambda r, p: (
        _small_quartic(r, jpaper.QuarticConfig),
        _small_quartic(p, ppaper.QuarticConfig)))
    assert got["derived"] == want["derived"]
    assert got["payload"]["paper"] == want["payload"]["paper"]
    np.testing.assert_allclose(
        [r["objective"] for r in got["payload"]["rows"]],
        [r["objective"] for r in want["payload"]["rows"]], rtol=QUARTIC_RTOL)


def test_fig1_run_matches_reference():
    want, got = _runs("fig1_pca", fig1_pca, lambda r, p: (
        _small_pca(r, jpaper.PCAConfig), _small_pca(p, ppaper.PCAConfig)))
    assert got["derived"] == want["derived"]
    assert got["payload"]["config"] == want["payload"]["config"]
    np.testing.assert_allclose(
        [r["pc_error"] for r in got["payload"]["rows"]],
        [r["pc_error"] for r in want["payload"]["rows"]], rtol=1e-12)


def test_lemma1_run_matches_reference():
    want, got = _runs("lemma1", lemma1, lambda r, p: (_small_lemma1(r),
                                                      _small_lemma1(p)))
    assert got["payload"]["config"] == want["payload"]["config"]
    rows_r, rows_p = want["payload"]["rows"], got["payload"]["rows"]
    assert [r["zeta"] for r in rows_p] == [r["zeta"] for r in rows_r]
    for key, rtol in (("lemma1", 1e-12), ("simulated", 1e-5)):
        np.testing.assert_allclose([r[key] for r in rows_p],
                                   [r[key] for r in rows_r], rtol=rtol)
    # |sim - pred| / pred moves by sim's rtol times sim / pred (about 1)
    np.testing.assert_allclose([r["rel_err"] for r in rows_p],
                               [r["rel_err"] for r in rows_r], rtol=0,
                               atol=2e-5)


def test_table1_run_matches_reference():
    want, got = _runs("table1", table1, lambda r, p: (_small_suite(r),
                                                      _small_suite(p)))
    assert got["derived"] == want["derived"]
    rows_r, rows_p = want["payload"]["rows"], got["payload"]["rows"]
    for key in ("dataset", "model", "n", "d"):
        assert [r[key] for r in rows_p] == [r[key] for r in rows_r]
    for key in ("sigma2", "beta2", "rho"):
        np.testing.assert_allclose([r[key] for r in rows_p],
                                   [float(r[key]) for r in rows_r],
                                   rtol=TABLE1_RTOL)


# ---- Figure 2 (the §3.1 convex curves) --------------------------------------

def _convex(kind):
    sparsity, noise = {"ls": (0.3, 0.1), "lr": (1.0, 0.0)}[kind]
    return convex_dataset(kind, F2["n"], F2["d"], sparsity=sparsity,
                          noise=noise, seed=0)[:2]


def _hold_curves(got, want):
    assert list(got) == list(want)
    for name in want:
        assert _steps(got[name]) == _steps(want[name])
        np.testing.assert_allclose(_values(got[name]), _values(want[name]),
                                   rtol=0, atol=SUBOPT_ATOL)


def test_fig2_schedules_match_reference():
    ref = _bench("bench_fig2_convex")
    for k in (0, 1, 8):
        a, b = fig2_convex._schedule(k), ref._schedule(k)
        assert (a.kind, a.phase_len) == (b.kind, b.phase_len)
    curve = [(10, 0.5), (20, 0.1), (30, 0.05)]
    assert fig2_convex._steps_to(curve, 0.1) == ref._steps_to(curve, 0.1)
    assert fig2_convex._steps_to(curve, 0.01) == float("inf")


def test_fig2_grid_curves_match_reference():
    """The grid's minimum curves. Each rate's lr0 divides by the mean
    squared row norm, a float32 sum whose order differs from XLA's (one
    ulp apart here), so the engine runs are held at the engine's
    tolerance on a common lr0 in the next test (the logistic loss) and in
    ``test_torch_engine.py``; here the curves and each run's events."""
    ref, port = _bench("bench_fig2_convex"), _port(fig2_convex)
    runs_r, runs_p = _keep_runs(ref), _keep_runs(port)
    X, y = _convex("ls")
    kw = {k: F2[k] for k in ("workers", "steps", "phase_lens", "lr_mults")}
    want = ref.grid_curves("ls", jnp.asarray(X), jnp.asarray(y), **kw)
    got = port.grid_curves("ls", X, y, device="cpu", **kw)
    assert list(want) == ["oneshot", "minibatch", "periodic_8", "single"]
    _hold_curves(got, want)
    # four curves a rate; the minibatch curve averages every step
    assert len(runs_p) == len(runs_r) == 4 * len(F2["lr_mults"])
    assert [h["averages"] for _, h in runs_p[:4]] == [0, F2["steps"],
                                                      F2["steps"] // 8, 0]
    for (_, hr), (_, hp) in zip(runs_r, runs_p):
        assert hp["averages"] == hr["averages"]
        assert _steps(hp["dispersion"]) == _steps(hr["dispersion"])


def test_fig2_sgd_curves_match_reference():
    """The logistic regression's curves on a common lr0 (the least
    squares' run in the grid above and in ``test_torch_examples.py``)."""
    ref, port = _bench("bench_fig2_convex"), _port(fig2_convex)
    runs_r, runs_p = _keep_runs(ref), _keep_runs(port)
    kind = "lr"
    X, y = _convex(kind)
    kw = dict(workers=F2["workers"], steps=F2["steps"],
              phase_lens=list(F2["phase_lens"]), lr0=0.5, lr_d=20.0,
              record_every=8)
    want = ref.sgd_curves(kind, jnp.asarray(X), jnp.asarray(y), **kw)
    got = port.sgd_curves(kind, X, y, device="cpu", **kw)
    _hold_curves(got, want)
    _hold_runs(runs_r, runs_p)


def test_fig2_run_matches_reference():
    """The scripts' bookkeeping (the suite cut to n <= 2048, d <= 256,
    the speedup at 0.1, the final ratio, the line) on the same curves:
    both ``grid_curves`` replaced by the port's at a small size."""
    ref, port = _bench("bench_fig2_convex"), _port(fig2_convex)
    small = port.grid_curves

    def grid(kind, X, y, **k):
        return small(kind, np.array(X), np.array(y), workers=2, steps=40,
                     phase_lens=(0, 1, 128, 1024), lr_mults=(0.8,),
                     device="cpu")
    for mod in (ref, port):
        _small_suite(mod, n=4096, d=8)
        _no_warmup(mod)
        mod.grid_curves = grid
    got_r, got_p = _capture(ref), _capture(port)
    ref.run()
    port.run(device="cpu")
    assert got_p["line"] == got_r["line"] == "fig2_convex_curves"
    assert got_p["derived"] == got_r["derived"]
    assert got_p["payload"] == got_r["payload"]


# ---- Figure 3 (the §3.2 CNN) -------------------------------------------------

def test_fig3_run_cnn_matches_reference():
    ref, port = _bench("bench_fig3_cnn"), _port(fig3_cnn)
    runs_r, runs_p = _keep_runs(ref), _keep_runs(port)
    kw = dict(record_every=CNN_EVERY, eval_n=CNN_EVAL)
    want = ref.run_cnn(dataclasses.replace(jpaper.CNNConfig(), **CNN),
                       CNN_STEPS, **kw)
    got = port.run_cnn(dataclasses.replace(ppaper.CNNConfig(), **CNN),
                       CNN_STEPS, device="cpu", **kw)
    assert list(got) == list(want) == ["periodic", "oneshot"]
    for sched in want:
        for key in ("avg", "best", "worst"):
            a, b = np.array(got[sched][key]), np.array(want[sched][key])
            assert a.shape == b.shape
            assert list(a[:, 0]) == list(range(CNN_EVERY, CNN_STEPS + 1,
                                               CNN_EVERY))
            np.testing.assert_allclose(a, b, **CNN_TOL)
    assert [h["averages"] for _, h in runs_p] == [CNN_STEPS // 10, 0]
    for (fr, hr), (fp, hp) in zip(runs_r, runs_p):
        assert hp["averages"] == hr["averages"]
        assert _steps(hp["dispersion"]) == _steps(hr["dispersion"])
        ports = tree_flatten(fp)[0]
        refs = jax.tree.leaves(fr)
        assert len(ports) == len(refs)
        for a, b in zip(ports, refs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **CNN_TOL)


def test_fig3_run_matches_reference():
    """The scripts' bookkeeping on the same curves: both ``run_cnn``
    replaced by the port's at a small width and step count."""
    ref, port = _bench("bench_fig3_cnn"), _port(fig3_cnn)
    small = port.run_cnn

    def run_cnn(cfg, steps, **k):
        return small(dataclasses.replace(ppaper.CNNConfig(), **CNN), 10,
                     record_every=5, eval_n=32, device="cpu")
    ref.run_cnn = port.run_cnn = run_cnn
    _no_warmup(ref)
    _no_warmup(port)
    got_r, got_p = _capture(ref), _capture(port)
    ref.run()
    port.run(device="cpu")
    assert got_p["line"] == got_r["line"] == "fig3_cnn_mnist"
    assert got_p["derived"] == got_r["derived"]
    assert got_p["payload"] == dict(got_r["payload"], scan_unroll=True)


# ---- the command lines -----------------------------------------------------

def test_main_runs_the_six_in_the_reference_order(monkeypatch, capsys):
    calls = []
    for label, mod in run_all.EXPERIMENTS:
        monkeypatch.setattr(mod, "run", lambda device, m=mod: calls.append(
            (m.__name__.rsplit(".", 1)[1], device)))
    run_all.main(["--device", "cpu"])
    assert calls == [(n, "cpu") for n in ("lemma1", "table1", "fig2_convex",
                                          "fig1_pca", "quartic",
                                          "fig3_cnn")]
    assert capsys.readouterr().out.splitlines()[0] == \
        "name,us_per_call,derived"


def test_main_exits_1_naming_the_failed(monkeypatch, capsys):
    for _, mod in run_all.EXPERIMENTS:
        monkeypatch.setattr(mod, "run", lambda device: None)

    def fail(device):
        raise RuntimeError("boom")
    monkeypatch.setattr(quartic, "run", fail)
    with pytest.raises(SystemExit) as e:
        run_all.main(["--device", "cpu"])
    assert e.value.code == 1
    assert "FAILED: ['quartic (paper §2.4)']" in capsys.readouterr().err


@pytest.mark.parametrize("name", ["", ".fig1_pca", ".fig2_convex",
                                  ".fig3_cnn", ".lemma1", ".quartic",
                                  ".table1"])
def test_entry_points_refuse_missing_cuda(name, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(sys, "argv", [f"repro_torch.experiments{name}"])
    # run afresh as __main__, as ``python -m`` runs it
    monkeypatch.delitem(sys.modules, f"repro_torch.experiments"
                        f"{name or '.__main__'}", raising=False)
    with pytest.raises(SystemExit) as e:
        runpy.run_module(f"repro_torch.experiments{name}",
                         run_name="__main__")
    assert e.value.code == 2


def test_save_writes_beside_the_reference(tmp_path, monkeypatch):
    assert common.RESULTS_DIR == ROOT / "results"
    monkeypatch.setattr(common, "RESULTS_DIR", tmp_path / "results")
    common.save("bench_quartic", {"rows": [{"objective": np.float32(0.5)}]})
    assert [p.name for p in (tmp_path / "results").iterdir()] == [
        "bench_quartic_torch.json"]
