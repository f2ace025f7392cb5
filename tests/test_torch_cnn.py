"""The paper's §3.2 CNN experiment in the port (``repro_torch.models.cnn``,
``repro_torch.data.mnist_like``, ``CNNConfig``) against the reference's,
on the CPU at a narrow config (conv channels (4, 8), fc 32, image 28).

- ``mnist_like`` (and the prototypes' ``_conv2_same``) bitwise: numpy;
- ``init_cnn`` within 4 float32 ulps (``rng.normal`` against
  ``jax.random.normal``; ROADMAP queue 3) in the reference's tree, which
  ``FlatSpec`` lays out element for element as the reference's does;
- forward, loss and error against the reference on ``params_from_jax``
  params: logits within atol/rtol 1e-5 (the convolutions, im2col
  products here, summed in another order than XLA's; measured about
  2e-6 apart), losses within rtol 1e-6, errors equal;
- the engine's periodic-10 and oneshot runs (Momentum 0.9, lr 0.01 x0.95
  per epoch, 4 workers, batch 8) over a ``DeviceDataset`` in ``permute``
  mode, with the eval hooks, against the reference's indexed runs:
  decisions, event steps and ``averages`` equal; losses, dispersions,
  eval values and params within rtol 1e-3 / atol 5e-4, the same for
  both schedules and the resume. The convolutions' sums differ from
  XLA's in the last ulp, and a ReLU or max-pool decision that an ulp
  flips routes a gradient elsewhere, which training then carries:
  measured over 50 steps, the permute draws stay within 5e-7 relative
  on the losses and 2e-7 on the params, the resume's with-replacement
  draws (seed 4) reach 9e-5 relative on the dispersions and 1.7e-4 on
  the params;
- a reference-written CNN engine state resumes in the port, and the
  resumed run matches the reference's uninterrupted run at those
  tolerances.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import io as jio  # noqa: E402
from repro.configs.paper import CNNConfig as JCNNConfig  # noqa: E402
from repro.core import AveragingSchedule as JSched  # noqa: E402
from repro.core import PhaseEngine as JEngine  # noqa: E402
from repro.core.flat import FlatSpec as JFlatSpec  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.data.pipeline import DeviceDataset as JDataset  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.optim import Momentum as JMomentum  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.checkpoint import io as pio  # noqa: E402
from repro_torch.configs.paper import CNNConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import AveragingSchedule, PhaseEngine  # noqa: E402
from repro_torch.core.flat import FlatSpec  # noqa: E402
from repro_torch.data import DeviceDataset, mnist_like  # noqa: E402
from repro_torch.data import synthetic as psyn  # noqa: E402
from repro_torch.models import cnn as pcnn  # noqa: E402
from repro_torch.optim import Momentum, schedules  # noqa: E402
from torch_parity import assert_histories_match, leaves_np  # noqa: E402

NARROW = dict(conv_channels=(4, 8), fc_hidden=32)
CFG, JCFG = CNNConfig(**NARROW), JCNNConfig(**NARROW)
SAMPLES, EVAL, STEPS, RECORD = 512, 64, 50, 25
TOL = dict(rtol=1e-3, atol=5e-4)
SCHEDULES = {"periodic": dict(kind="periodic", phase_len=10),
             "oneshot": dict(kind="oneshot")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data():
    images, labels = mnist_like(SAMPLES, seed=0, noise=0.6)
    test_images, test_labels = mnist_like(EVAL, seed=1, noise=0.6)
    return images, labels, test_images, test_labels


def _jparams():
    return jcnn.init_cnn(JCFG, jax.random.PRNGKey(0))


def _pparams():
    return params_from_jax(jax.tree.map(np.asarray, _jparams()),
                           device="cpu")


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("kw", [dict(num=64), dict(num=33, seed=5),
                                dict(num=16, noise=0.6, proto_seed=3),
                                dict(num=8, image_size=12, num_classes=4)],
                         ids=["default", "seed", "noise-proto", "small"])
def test_mnist_like_bitwise(kw):
    num = kw.pop("num")
    a, b = mnist_like(num, **kw)
    ja, jb = jsyn.mnist_like(num, **kw)
    assert a.dtype == ja.dtype and b.dtype == jb.dtype
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(b, jb)
    img = np.random.default_rng(0).standard_normal((9, 11))
    k = np.ones((3, 3)) / 9.0
    np.testing.assert_array_equal(psyn._conv2_same(img, k),
                                  jsyn._conv2_same(img, k))


@pytest.mark.parametrize("cfg_kw", [NARROW, {}], ids=["narrow", "paper"])
def test_init_cnn_within_4_ulps(cfg_kw):
    cfg, jcfg = CNNConfig(**cfg_kw), JCNNConfig(**cfg_kw)
    got = pcnn.init_cnn(cfg, rng.PRNGKey(0), device="cpu")
    want = jcnn.init_cnn(jcfg, jax.random.PRNGKey(0))
    assert sorted(got) == sorted(want) == ["conv1", "conv2", "fc1", "fc2"]
    for layer in want:
        for name in ("w", "b"):
            g, w = got[layer][name], np.asarray(want[layer][name])
            assert tuple(g.shape) == w.shape and g.dtype == torch.float32
            assert _ulps(g.numpy(), w) <= 4, (layer, name)
    # the paper's widths give the plane of 1,663,370 parameters, laid out
    # element for element as the reference's
    spec = FlatSpec.of(got, worker_axis=False)
    jspec = JFlatSpec.of(want, worker_axis=False)
    assert spec.width == jspec.width
    if not cfg_kw:
        assert spec.width == 1_663_370
    np.testing.assert_array_equal(
        spec.pack1(params_from_jax(jax.tree.map(np.asarray, want),
                                   device="cpu")).numpy(),
        np.asarray(jspec.pack1(want)))


def test_forward_loss_error_match_the_reference():
    images, labels, _, _ = _data()
    batch = {"images": images[:32], "labels": labels[:32]}
    jb = jax.tree.map(jnp.asarray, batch)
    pb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jp, pp = _jparams(), _pparams()
    logits = pcnn.cnn_forward(CFG, pp, pb["images"])
    assert tuple(logits.shape) == (32, CFG.num_classes)
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(jcnn.cnn_forward(JCFG, jp, jb["images"])),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(pcnn.cnn_loss(CFG, pp, pb)),
                               float(jcnn.cnn_loss(JCFG, jp, jb)), rtol=1e-6)
    assert float(pcnn.cnn_error(CFG, pp, pb)) == \
        float(jcnn.cnn_error(JCFG, jp, jb))


def _runs(name, steps=STEPS, indices=None):
    """(port run, reference run) of one schedule: the paper's recipe at
    the narrow width, the same data, sampler and start params, with the
    eval hooks (consensus train loss and test error, the workers'
    train losses) every RECORD steps."""
    images, labels, test_images, test_labels = _data()
    spe = SAMPLES // (4 * 8)
    plr = schedules.exponential_epoch(CFG.lr, CFG.lr_decay_per_epoch, spe)
    jlr = jsched.exponential_epoch(JCFG.lr, JCFG.lr_decay_per_epoch, spe)
    arrays = {"images": images, "labels": labels}
    ev = {"images": test_images, "labels": test_labels}
    tr = {"images": images[:EVAL], "labels": labels[:EVAL]}
    pev, ptr = ({k: torch.from_numpy(v) for k, v in d.items()}
                for d in (ev, tr))
    jev, jtr = (jax.tree.map(jnp.asarray, d) for d in (ev, tr))
    peng = PhaseEngine(lambda p, b, r: (pcnn.cnn_loss(CFG, p, b), {}),
                       Momentum(lr=lambda t: plr(t - 1), mu=CFG.momentum),
                       AveragingSchedule(**SCHEDULES[name]), device="cpu")
    jeng = JEngine(lambda p, b, r: (jcnn.cnn_loss(JCFG, p, b), {}),
                   JMomentum(lr=lambda t: jlr(t - 1), mu=JCFG.momentum),
                   JSched(**SCHEDULES[name]))
    kw = dict(batch_size=8, seed=0, mode="permute") if indices is None \
        else dict(indices=indices)
    pdata = DeviceDataset(arrays, 4, device="cpu", **kw)
    jdata = JDataset(arrays, 4, **kw)
    got = peng.run(
        _pparams(), pdata, num_workers=4, seed=0, record_every=RECORD,
        eval_fn=lambda p: (float(pcnn.cnn_loss(CFG, p, ptr)),
                           float(pcnn.cnn_error(CFG, p, pev))),
        worker_eval_fn=lambda wp: [float(pcnn.cnn_loss(
            CFG, {k: {n: v[i] for n, v in d.items()} for k, d in wp.items()},
            ptr)) for i in range(4)],
        phase_len=RECORD, steps=steps, return_state=True)
    want = jeng.run(
        _jparams(), jdata, num_workers=4, seed=0, record_every=RECORD,
        eval_fn=lambda p: (float(jcnn.cnn_loss(JCFG, p, jtr)),
                           float(jcnn.cnn_error(JCFG, p, jev))),
        worker_eval_fn=lambda wp: [float(jcnn.cnn_loss(
            JCFG, jax.tree.map(lambda x: x[i], wp), jtr)) for i in range(4)],
        phase_len=RECORD, steps=steps, return_state=True)
    return got, want, (peng, jeng, pdata, jdata)


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_engine_runs_match_the_reference(name):
    (pf, ph, ps), (jf, jh, js), _ = _runs(name)
    assert ph["averages"] == jh["averages"] == (STEPS // 10 if name ==
                                                "periodic" else 0)
    assert_histories_match(ph, jh, dict(loss=TOL, disp=TOL))
    assert [t for t, _ in ph["eval"]] == [t for t, _ in jh["eval"]] == \
        [RECORD, 2 * RECORD]
    np.testing.assert_allclose(np.array([v for _, v in ph["eval"]]),
                               np.array([v for _, v in jh["eval"]]), **TOL)
    np.testing.assert_allclose(np.array([v for _, v in ph["worker_eval"]]),
                               np.array([v for _, v in jh["worker_eval"]]),
                               **TOL)
    for a, b in zip(leaves_np(pf), leaves_np(jf)):
        np.testing.assert_allclose(a, b, **TOL)
    jplane = JFlatSpec.of(js.worker_params).pack(js.worker_params)
    np.testing.assert_allclose(ps.plane.numpy(), np.asarray(jplane), **TOL)


def test_reference_cnn_checkpoint_resumes_in_port(tmp_path):
    """A reference-written engine state of the CNN run at step 25 loads
    into the port's like-state, and the port's resumed 25 steps match the
    reference's uninterrupted 50."""
    idx = np.random.default_rng(4).integers(0, SAMPLES, (STEPS, 4, 8))
    (_, _, _), (jf_full, jh_full, _), _ = _runs("periodic", indices=idx)
    (_, _, _), (_, jh1, jst), (peng, _, _, _) = _runs(
        "periodic", steps=RECORD, indices=idx)
    path = str(tmp_path / "ck")
    jio.save_engine_state(path, jst)
    like = peng.init(_pparams(), 4, 0)
    loaded, at = pio.load_engine_state(path, like)
    assert at == RECORD
    data = DeviceDataset({"images": _data()[0], "labels": _data()[1]}, 4,
                         indices=idx[RECORD:], device="cpu")
    f2, h2 = peng.run(None, data, num_workers=4, record_every=1,
                      phase_len=RECORD, state=loaded)
    assert jh1["averages"] + h2["averages"] == jh_full["averages"]
    assert [t for t, _ in jh1["dispersion"] + h2["dispersion"]] == \
        [t for t, _ in jh_full["dispersion"]]
    np.testing.assert_allclose([v for _, v in h2["dispersion"]],
                               [v for _, v in jh_full["dispersion"][2:]],
                               **TOL)
    for a, b in zip(leaves_np(f2), leaves_np(jf_full)):
        np.testing.assert_allclose(a, b, **TOL)
