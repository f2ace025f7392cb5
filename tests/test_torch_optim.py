"""The port's optimizers against the JAX reference: the per-step plane
scalars [lr, c1, c2, 0] are bitwise equal, including the paper's
callable lr and AdamW's float32 bias corrections."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.optim import SGD as JSGD  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import Momentum as JMomentum  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch.optim import SGD, AdamW, Momentum, schedules  # noqa: E402

STEPS = [1, 2, 3, 7, 64, 129, 1000, 4096]
# the paper's §3.1 schedule as bench_fig2_convex passes it (steps are
# 1-indexed, hence the -1)
LR0, LR_D = 0.37, 200.0


def paper_lr(t):
    return LR0 / (t - 1.0 + LR_D)


PAIRS = {
    "sgd-const": (SGD(lr=0.05), JSGD(lr=0.05)),
    "sgd-paper": (SGD(lr=paper_lr), JSGD(lr=paper_lr)),
    "sgd-inverse": (SGD(lr=schedules.inverse(3.0, 7.0)),
                    JSGD(lr=jsched.inverse(3.0, 7.0))),
    "sgd-exp-epoch": (SGD(lr=schedules.exponential_epoch(0.01, 0.95, 10)),
                      JSGD(lr=jsched.exponential_epoch(0.01, 0.95, 10))),
    "momentum": (Momentum(lr=0.01, mu=0.9), JMomentum(lr=0.01, mu=0.9)),
    "nesterov": (Momentum(lr=0.1, mu=0.5, nesterov=True),
                 JMomentum(lr=0.1, mu=0.5, nesterov=True)),
    "adamw": (AdamW(lr=3e-4), JAdamW(lr=3e-4)),
    "adamw-decay": (AdamW(lr=paper_lr, b1=0.8, b2=0.99, weight_decay=0.1),
                    JAdamW(lr=paper_lr, b1=0.8, b2=0.99, weight_decay=0.1)),
}


@pytest.mark.parametrize("name", list(PAIRS))
def test_plane_scalars_bitwise(name):
    port, ref = PAIRS[name]
    assert port.plane_kind == ref.plane_kind
    assert port.plane_hypers() == ref.plane_hypers()
    for step in STEPS:
        got = port.plane_scalars(step)
        assert got.dtype == torch.float32 and got.shape == (4,)
        # the reference engine hands its schedules an int32 array step
        want = np.asarray(ref.plane_scalars(jnp.asarray(step, jnp.int32)),
                          np.float32)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.view(np.uint32), err_msg=str(step))


@pytest.mark.parametrize("opt", [SGD(), Momentum(), AdamW()],
                         ids=["sgd", "momentum", "adamw"])
def test_state_planes_match_init(opt):
    params = {"a": torch.zeros(3, 2), "b": [torch.zeros(5)]}
    leaves = [x for x in torch.utils._pytree.tree_leaves(opt.init(params))]
    assert len(leaves) == opt.state_planes * 2
    assert all(x.dtype == torch.float32 for x in leaves)
