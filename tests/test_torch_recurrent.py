"""The port's RG-LRU block against the JAX reference on the reduced
recurrentgemma-2b config in float32, on the CPU: the same params
(carried over as numpy) and inputs through ``repro.models.recurrent``
and ``repro_torch.models.recurrent``.

``apply_rglru`` in both compute paths — the reference's ``impl="xla"``
(associative scan) against the port's ``"plain"`` (the same recursion),
its ``"pallas"`` (the Pallas scan in interpret mode) against the port's
``"kernel"`` (on the CPU the sequential plain version) — with and
without the decode state, and one ``decode_rglru`` step: rtol / atol
1e-5 (float32 matmuls summed in another order by each side).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import reduced_f32  # noqa: E402
from repro.models import recurrent as jax_rec  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan  # noqa: E402
from repro_torch.models import recurrent as rec  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
IMPLS = [("xla", "plain"), ("pallas", "kernel")]
B, S = 2, 37


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    jcfg = reduced_f32("recurrentgemma-2b")
    pcfg = port_configs.get_config("recurrentgemma-2b", reduced=True)
    pcfg = dataclasses.replace(pcfg, dtype="float32")
    p = jax.tree.map(np.asarray, jax_rec.init_rglru(jcfg,
                                                    jax.random.PRNGKey(3)))
    x = np.random.default_rng(0).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    return jcfg, pcfg, p, x


@pytest.mark.parametrize("jimpl,pimpl", IMPLS, ids=["plain", "kernel"])
@pytest.mark.parametrize("state", [False, True], ids=["out", "state"])
def test_apply_rglru_matches_jax(setup, jimpl, pimpl, state):
    jcfg, pcfg, p, x = setup
    want = jax_rec.apply_rglru(jcfg, p, jnp.asarray(x), impl=jimpl,
                               return_state=state)
    n0 = rglru_scan.launches
    got = rec.apply_rglru(pcfg, params_from_jax(p, device="cpu"),
                          torch.from_numpy(x), impl=pimpl,
                          return_state=state)
    assert rglru_scan.launches == n0  # CPU: the plain version
    if not state:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        return
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    assert set(got[1]) == set(want[1]) == {"h", "conv"}
    assert got[1]["h"].dtype == torch.float32
    for name in ("h", "conv"):
        assert tuple(got[1][name].shape) == want[1][name].shape
        np.testing.assert_allclose(got[1][name].numpy(),
                                   np.asarray(want[1][name]), **TOL)


def test_decode_rglru_matches_jax(setup):
    jcfg, pcfg, p, x = setup
    r = np.random.default_rng(1)
    w = jcfg.rnn_width
    cache = {"h": r.standard_normal((B, w)).astype(np.float32),
             "conv": r.standard_normal((B, jcfg.conv_width - 1, w)
                                       ).astype(np.float32)}
    want, wc = jax_rec.decode_rglru(jcfg, p, jnp.asarray(x[:, :1]),
                                    jax.tree.map(jnp.asarray, cache))
    got, gc = rec.decode_rglru(pcfg, params_from_jax(p, device="cpu"),
                               torch.from_numpy(x[:, :1]),
                               params_from_jax(cache, device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("h", "conv"):
        np.testing.assert_allclose(gc[name].numpy(), np.asarray(wc[name]),
                                   **TOL)


def test_prefill_state_continues_into_decode(setup):
    """The state captured over S tokens, stepped over token S, equals the
    full-sequence block over S + 1 tokens at the last position."""
    _, pcfg, p, x = setup
    tp = params_from_jax(p, device="cpu")
    xt = torch.from_numpy(x)
    full = rec.apply_rglru(pcfg, tp, xt)
    _, st = rec.apply_rglru(pcfg, tp, xt[:, :-1], return_state=True)
    out, _ = rec.decode_rglru(pcfg, tp, xt[:, -1:], st)
    np.testing.assert_allclose(out.numpy(), full[:, -1:].numpy(), **TOL)


def test_init_rglru_law_and_layout(setup):
    jcfg, pcfg, p, _ = setup
    bf = port_configs.get_config("recurrentgemma-2b", reduced=True)
    mine = rec.init_rglru(bf, rng.PRNGKey(0))
    assert set(mine) == set(p)
    for k, v in mine.items():
        assert tuple(v.shape) == p[k].shape, k
        assert v.dtype == (torch.float32 if k == "lam" else torch.bfloat16)
    # a = exp(-8 softplus(lam)) at r = 1 lies in (0.9, 0.999)
    a = torch.exp(-8.0 * torch.nn.functional.softplus(mine["lam"]))
    assert bool(((a > 0.9 - 1e-6) & (a < 0.999 + 1e-6)).all())
