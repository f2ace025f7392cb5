"""The port's examples (``examples/*_torch.py``) on the CPU against the
reference's examples, loaded from their files (the reference files are
not edited: a test sets ``STEPS`` on the loaded module and wraps its
``PhaseEngine`` to keep each run's history).

- ``quickstart_torch.py`` against ``quickstart.py``, both at 20 steps:
  the same ``averages`` for the three schedules, the recorded losses and
  the final eval losses within ``SMOLLM_TOL`` (``test_torch_engine.py``),
  the same printed lines;
- ``train_cnn_e2e_torch.py --steps 20`` against ``train_cnn_e2e.py``: the
  same ``averages``, the consensus params and their test loss within the
  CNN parity tolerance of ``test_torch_cnn.py`` (rtol 1e-3 / atol 5e-4),
  the checkpoint round trip bitwise;
- ``serve_lm_torch.py``: each arch's ``[serve]`` lines and tokens;
- ``nonconvex_pca_torch.py`` against ``nonconvex_pca.py``, both with the
  quartic at 400 steps and Oja's rule at 8 workers x 500 samples (their
  config classes wrapped): the quartic's objectives at rtol 1e-5 and the
  PC errors at rtol 1e-12 (``test_torch_experiments.py``), the same
  averaging counts and printed lines;
- ``convex_averaging_torch.py`` against ``convex_averaging.py``, both on
  64 x 8 datasets (``convex_dataset`` wrapped; ``rho``'s zero start cut
  to the 8 dims) and the grid at 40 steps, 4 workers and its first
  rate (0.8): σ², β² and ρ at rtol 1e-4 and the curves at atol 5e-6
  (``test_torch_experiments.py``), the same printed names;
- each refuses to start without CUDA unless ``--device cpu``.
"""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.flat import tree_flatten  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
STEPS = 20
#: the experiments' tolerances (``test_torch_experiments.py``)
QUARTIC_RTOL, TABLE1_RTOL, SUBOPT_ATOL = 1e-5, 1e-4, 5e-6
#: test_torch_engine.py's SMOLLM_TOL (losses) and test_torch_cnn.py's TOL
LOSS_RTOL = 2e-5
CNN_TOL = dict(rtol=1e-3, atol=5e-4)


def _load(name: str, alias: str):
    # the reference's paper examples import ``benchmarks``
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location(
        alias, ROOT / "examples" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _keep_runs(mod) -> list:
    """Wrap the loaded module's PhaseEngine so that each ``run``'s
    (final, history) is kept."""
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


@pytest.fixture(scope="module")
def quickstart(_one_thread):
    import contextlib
    import io
    port = _load("quickstart_torch.py", "quickstart_torch_t")
    port.STEPS = STEPS
    out_p = io.StringIO()
    with contextlib.redirect_stdout(out_p):
        got = port.main(["--device", "cpu"])
    ref = _load("quickstart.py", "quickstart_ref_t")
    ref.STEPS = STEPS
    runs = _keep_runs(ref)
    out_r = io.StringIO()
    with contextlib.redirect_stdout(out_r):
        ref.main()
    return got, [h for _, h in runs], out_p.getvalue(), out_r.getvalue()


@pytest.mark.parametrize("i,name", list(enumerate(
    ["oneshot", "periodic_10", "minibatch"])))
def test_quickstart_matches_reference(quickstart, i, name):
    got, hists, _, out_r = quickstart
    want = hists[i]
    assert got[name]["averages"] == want["averages"]
    assert [s for s, _ in got[name]["loss"]] == [s for s, _ in want["loss"]]
    np.testing.assert_allclose([v for _, v in got[name]["loss"]],
                               [v for _, v in want["loss"]], rtol=LOSS_RTOL)
    line = next(ln for ln in out_r.splitlines()
                if ln.strip().startswith(name))
    np.testing.assert_allclose(got[name]["eval_loss"],
                               float(line.rsplit(" ", 1)[1]),
                               rtol=LOSS_RTOL, atol=1e-4)


def test_quickstart_prints_the_reference_lines(quickstart):
    _, _, out_p, out_r = quickstart
    assert out_p.splitlines() == out_r.splitlines()


@pytest.fixture(scope="module")
def cnn(_one_thread, tmp_path_factory):
    import contextlib
    import io
    d = tmp_path_factory.mktemp("cnn")
    port = _load("train_cnn_e2e_torch.py", "train_cnn_e2e_torch_t")
    out_p = io.StringIO()
    with contextlib.redirect_stdout(out_p):
        got = port.main(["--device", "cpu", "--steps", str(STEPS), "--ckpt",
                         str(d / "port")])
    ref = _load("train_cnn_e2e.py", "train_cnn_e2e_ref_t")
    runs = _keep_runs(ref)
    argv, sys.argv = sys.argv, ["train_cnn_e2e.py", "--steps", str(STEPS),
                                "--ckpt", str(d / "ref")]
    out_r = io.StringIO()
    try:
        with contextlib.redirect_stdout(out_r):
            ref.main()
    finally:
        sys.argv = argv
    return got, runs[0], out_p.getvalue(), out_r.getvalue()


def test_cnn_averages_match_reference(cnn):
    got, (_, want), _, _ = cnn
    assert got["hist"]["averages"] == want["averages"] == STEPS // 10


def test_cnn_consensus_matches_reference(cnn):
    got, (final, _), _, _ = cnn
    ports = tree_flatten(got["final"])[0]
    import jax
    refs = jax.tree.leaves(final)
    assert len(ports) == len(refs)
    for a, b in zip(ports, refs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **CNN_TOL)


def test_cnn_test_loss_matches_reference(cnn):
    import jax.numpy as jnp
    from repro.configs.paper import CNNConfig as JCNNConfig
    from repro.models import cnn as jcnn
    from repro_torch.configs.paper import CNNConfig
    from repro_torch.data import mnist_like
    from repro_torch.models import cnn as pcnn
    got, (final, _), _, _ = cnn
    images, labels = mnist_like(1024, seed=1)
    pl = float(pcnn.cnn_loss(CNNConfig(), got["final"], {
        "images": torch.from_numpy(images),
        "labels": torch.from_numpy(labels)}))
    jl = float(jcnn.cnn_loss(JCNNConfig(), final, {
        "images": jnp.asarray(images), "labels": jnp.asarray(labels)}))
    np.testing.assert_allclose(pl, jl, **CNN_TOL)


def test_cnn_checkpoint_round_trip_is_bitwise(cnn):
    got, _, out_p, _ = cnn
    assert got["step"] == STEPS
    for a, b in zip(tree_flatten(got["final"])[0],
                    tree_flatten(got["restored"])[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert "checkpoint round-trip OK ->" in out_p


def test_cnn_prints_the_reference_lines(cnn):
    _, _, out_p, out_r = cnn
    p, r = out_p.splitlines(), out_r.splitlines()
    assert p[0] == r[0] == f"trained {STEPS} steps, 2 averages"
    # the checkpoint paths differ; the final test error is printed the same
    assert p[-1].rsplit("(", 1)[1] == r[-1].rsplit("(", 1)[1]


@pytest.fixture(scope="module")
def served(_one_thread):
    import contextlib
    import io
    port = _load("serve_lm_torch.py", "serve_lm_torch_t")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        toks = port.main(["--device", "cpu"])
    return port.ARCHS, toks, out.getvalue()


@pytest.mark.parametrize("arch", ["smollm-360m", "recurrentgemma-2b",
                                  "rwkv6-7b"])
def test_serve_example_serves_each_arch(served, arch):
    archs, toks, out = served
    assert archs == ["smollm-360m", "recurrentgemma-2b", "rwkv6-7b"]
    assert f"[serve] {arch}-reduced: batch=2 prompt=4 gen=8 in" in out
    t = toks[arch]
    assert t.shape == (2, 8) and int(t.max()) < 512 and int(t.min()) >= 0
    ids = f"[serve] sample output ids: {t[0][:12].tolist()}"
    assert ids in out


def _keep_returns(mod, *names) -> dict:
    """Wrap the loaded module's functions ``names`` so that each one's
    last return is kept."""
    kept = {}
    for name in names:
        def keep(*a, _fn=getattr(mod, name), _name=name, **k):
            kept[_name] = out = _fn(*a, **k)
            return out
        setattr(mod, name, keep)
    return kept


def _run_pair(port_name, ref_name, shrink, *names):
    """Both examples with ``shrink(module)`` applied and ``names`` kept:
    ((kept, printed) of the port, of the reference)."""
    import contextlib
    import io
    out = []
    for name, argv in ((port_name, ["--device", "cpu"]), (ref_name, None)):
        mod = _load(name, name.removesuffix(".py") + "_t")
        shrink(mod)
        kept = _keep_returns(mod, *names)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main(*([argv] if argv else []))
        out.append((kept, buf.getvalue().splitlines()))
    return out


@pytest.fixture(scope="module")
def nonconvex(_one_thread):
    def shrink(mod):
        quartic, pca = mod.QuarticConfig, mod.PCAConfig
        mod.QuarticConfig = lambda: quartic(num_steps=400)
        mod.PCAConfig = lambda **k: pca(**dict(k, num_workers=8,
                                               num_samples=500))
    return _run_pair("nonconvex_pca_torch.py", "nonconvex_pca.py", shrink,
                     "run_quartic", "pca_error_vs_avg_steps")


def test_nonconvex_example_matches_reference(nonconvex):
    (got, out_p), (want, out_r) = nonconvex
    q_p, q_r = got["run_quartic"], want["run_quartic"]
    assert [r["avg_frac"] for r in q_p] == [r["avg_frac"] for r in q_r]
    np.testing.assert_allclose([r["objective"] for r in q_p],
                               [r["objective"] for r in q_r],
                               rtol=QUARTIC_RTOL)
    p_p, p_r = got["pca_error_vs_avg_steps"], want["pca_error_vs_avg_steps"]
    for key in ("phase_len", "num_avg_steps"):
        assert [r[key] for r in p_p] == [r[key] for r in p_r]
    np.testing.assert_allclose([r["pc_error"] for r in p_p],
                               [r["pc_error"] for r in p_r], rtol=1e-12)
    assert out_p == out_r


@pytest.fixture(scope="module")
def convex(_one_thread):
    n, d = 64, 8

    def shrink(mod):
        dataset, rho, grid = mod.convex_dataset, mod.rho, mod.grid_curves
        mod.convex_dataset = lambda kind, num, dim, **k: dataset(kind, n, d,
                                                                 **k)
        # the examples' zero start has the full 128 dims
        mod.rho = lambda b2, s2, w0, ws: rho(b2, s2, w0[:d], ws)
        # the example's first rate (the grid's minimum over rates is held
        # in test_torch_experiments.py)
        mod.grid_curves = lambda kind, X, y, **k: grid(
            kind, X, y, **dict(k, steps=40, workers=4,
                               lr_mults=k["lr_mults"][:1]))
    return _run_pair("convex_averaging_torch.py", "convex_averaging.py",
                     shrink, "measure_beta2", "rho", "grid_curves")


def test_convex_example_matches_reference(convex):
    (got, out_p), (want, out_r) = convex
    np.testing.assert_allclose(got["measure_beta2"],
                               [float(v) for v in want["measure_beta2"]],
                               rtol=TABLE1_RTOL)
    np.testing.assert_allclose(got["rho"], float(want["rho"]),
                               rtol=TABLE1_RTOL)
    c_p, c_r = got["grid_curves"], want["grid_curves"]
    assert list(c_p) == list(c_r) == ["oneshot", "periodic_128", "single"]
    for name in c_r:
        assert [t for t, _ in c_p[name]] == [t for t, _ in c_r[name]]
        np.testing.assert_allclose([v for _, v in c_p[name]],
                                   [v for _, v in c_r[name]], rtol=0,
                                   atol=SUBOPT_ATOL)
    # the names and the closing line; the numbers are held above
    assert [ln.split()[0] for ln in out_p] == [ln.split()[0] for ln in out_r]
    assert out_p[-1] == out_r[-1]


@pytest.mark.parametrize("name", ["quickstart_torch.py", "serve_lm_torch.py",
                                  "train_cnn_e2e_torch.py",
                                  "convex_averaging_torch.py",
                                  "nonconvex_pca_torch.py"])
def test_example_refuses_missing_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = _load(name, name.removesuffix(".py") + "_refuse")
    with pytest.raises(SystemExit) as e:
        mod.main([])
    assert e.value.code == 2
