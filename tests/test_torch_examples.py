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
#: test_torch_engine.py's SMOLLM_TOL (losses) and test_torch_cnn.py's TOL
LOSS_RTOL = 2e-5
CNN_TOL = dict(rtol=1e-3, atol=5e-4)


def _load(name: str, alias: str):
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


@pytest.mark.parametrize("name", ["quickstart_torch.py", "serve_lm_torch.py",
                                  "train_cnn_e2e_torch.py"])
def test_example_refuses_missing_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = _load(name, name.removesuffix(".py") + "_refuse")
    with pytest.raises(SystemExit) as e:
        mod.main([])
    assert e.value.code == 2
