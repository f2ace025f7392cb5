"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``; every test skips without a CUDA device (decided
in a fixture, so every worker collects the same tests). Needs no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda.py

``--noconftest`` because tests/conftest.py imports JAX, which a GPU host
that runs only the port need not have.

The shapes, inputs and criteria are ``repro_torch.kernels.card_check``'s,
the same that ``chip_smoke.py`` runs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import card_check as cc  # noqa: E402
from repro_torch.kernels.avg_disp import avg_disp  # noqa: E402
from repro_torch.kernels.opt_step import opt_step  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", cc.SHAPES, ids=lambda s: f"M{s[0]}P{s[1]}")
@pytest.mark.parametrize("codes", [None, "mixed"], ids=["f32", "codes"])
@pytest.mark.parametrize("mode", ["none", "mean", "group"])
@pytest.mark.parametrize("opt", list(cc.OPTS))
def test_opt_step_kernel_matches_plain(dev, opt, mode, codes, shape):
    m, p, groups = shape
    kind, hyp = cc.OPTS[opt]
    x, g, st, scal, cd = cc.make_inputs(dev, m, p, kind, codes)
    n0 = opt_step.launches
    cc.check_opt_step(opt, x, g, st, scal, cd, kind=kind, mode=mode,
                      groups=groups if mode == "group" else 1, **hyp)
    assert opt_step.launches == n0 + 2


@pytest.mark.parametrize("shape", cc.SHAPES, ids=lambda s: f"M{s[0]}P{s[1]}")
@pytest.mark.parametrize("groups", cc.AVG_GROUPS)
def test_avg_disp_kernel_matches_plain(dev, groups, shape):
    m, p, _ = shape
    x = cc.make_inputs(dev, m, p, "sgd", seed=groups)[0]
    n0 = avg_disp.launches
    cc.check_avg_disp(f"g{groups}", x, groups)
    assert avg_disp.launches == n0 + 2


def test_kernels_refuse_what_they_cannot_take(dev):
    x, g, st, scal, _ = cc.make_inputs(dev, 4, 64, "momentum")
    with pytest.raises(ValueError, match="contiguous"):
        opt_step(x.t().contiguous().t(), g, st, scal, kind="momentum")
    with pytest.raises(ValueError):
        opt_step(x, g.double(), st, scal, kind="momentum")
    with pytest.raises(ValueError, match="1..64"):
        avg_disp(torch.zeros(65, 8, device=dev))


def test_engine_on_card_matches_cpu(dev):
    from repro_torch.configs import get_config
    from repro_torch.core import AveragingSchedule, PhaseEngine
    from repro_torch.data import token_stream
    from repro_torch.models import init_params, lm_loss
    from repro_torch.optim import Momentum

    cfg = dataclasses.replace(get_config("smollm-360m", reduced=True),
                              dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    streams = [token_stream(cfg.vocab_size, 2, 16, seed=i) for i in range(4)]
    batches = [{"tokens": np.stack([next(s) for s in streams])}
               for _ in range(4)]

    def run(device):
        eng = PhaseEngine(lambda p, b, r: lm_loss(cfg, p, b),
                          Momentum(lr=0.01, mu=0.9),
                          AveragingSchedule("periodic", phase_len=2),
                          device=device)
        return eng.run(params, iter(batches), num_workers=4, seed=0,
                       record_every=1)

    n0 = opt_step.launches
    (fg, hg), (fc, hc) = run("cuda"), run("cpu")
    assert opt_step.launches == n0 + 4
    assert hg["averages"] == hc["averages"] == 2
    np.testing.assert_allclose([v for _, v in hg["loss"]],
                               [v for _, v in hc["loss"]], rtol=1e-4)
    for a, b in zip(torch.utils._pytree.tree_leaves(fg),
                    torch.utils._pytree.tree_leaves(fc)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4)
