"""The port's dense transformer against the JAX reference on the reduced
smollm config in float32: the same params (carried over as numpy) and
tokens give the same loss (rtol 1e-5), and the port's per-row gradient
plane matches the reference's ``make_plane_step`` (atol 1e-5)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import reduced_f32  # noqa: E402
from repro.core.engine import make_plane_step as jax_plane_step  # noqa: E402
from repro.core.flat import FlatSpec as JaxFlatSpec  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.models import lm_loss as jax_lm_loss  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.engine import make_plane_step  # noqa: E402
from repro_torch.core.flat import FlatSpec  # noqa: E402
from repro_torch.data import token_stream  # noqa: E402
from repro_torch.models import init_params, lm_loss  # noqa: E402

M, B, S = 3, 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    jcfg = reduced_f32("smollm-360m")
    pcfg = port_configs.get_config("smollm-360m", reduced=True)
    pcfg = dataclasses.replace(pcfg, dtype="float32")
    params = jax.tree.map(np.asarray, jax_init(jcfg, jax.random.PRNGKey(0)))
    toks = np.stack([next(token_stream(jcfg.vocab_size, B, S, seed=i))
                     for i in range(M)])
    return jcfg, pcfg, params, toks


def test_configs_match_reference():
    from repro.configs import get_config
    for reduced in (False, True):
        j = get_config("smollm-360m", reduced=reduced)
        p = port_configs.get_config("smollm-360m", reduced=reduced)
        for f in ("name", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "head_dim", "d_ff", "vocab_size", "dtype",
                  "rope_theta", "norm", "act", "gated_mlp",
                  "tie_embeddings", "max_seq_len"):
            assert getattr(p, f) == getattr(j, f), f
        assert p.padded_vocab == j.padded_vocab
        assert p.num_params() == j.num_params()
        assert [vars(s) for s in p.layers] == [vars(s) for s in j.layers]


def test_lm_loss_matches_jax(setup):
    jcfg, pcfg, params, toks = setup
    want, _ = jax_lm_loss(jcfg, params, {"tokens": jnp.asarray(toks[0])})
    got, _ = lm_loss(pcfg, params_from_jax(params, device="cpu"),
                     {"tokens": torch.from_numpy(toks[0]).long()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_plane_grads_match_jax(setup):
    jcfg, pcfg, params, toks = setup
    # M workers at distinct points: the shared params plus per-row noise
    jspec = JaxFlatSpec.of(params, worker_axis=False)
    rng = np.random.default_rng(5)
    row = np.asarray(jspec.pack1(params))
    plane = (row[None] + 0.01 * rng.standard_normal((M, row.size))
             ).astype(np.float32)
    jgrads = jax_plane_step(
        lambda p, b, r: jax_lm_loss(jcfg, p, b), jspec)
    jl, _, jg = jax.jit(jgrads)(jnp.asarray(plane),
                                {"tokens": jnp.asarray(toks)})
    spec = FlatSpec.of(params_from_jax(params, device="cpu"),
                       worker_axis=False)
    pgrads = make_plane_step(lambda p, b, r: lm_loss(pcfg, p, b), spec)
    pl, _, pg = pgrads(torch.from_numpy(plane),
                       {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), atol=1e-5)


def test_init_params_law_and_layout(setup):
    jcfg, pcfg, params, _ = setup
    mine = init_params(pcfg, 0, device="cpu")
    jl, _ = jax.tree.flatten(params)
    pl = [x for x in torch.utils._pytree.tree_leaves(mine)]
    assert len(jl) == len(pl)
    spec = FlatSpec.of(mine, worker_axis=False)
    assert spec.shapes == JaxFlatSpec.of(params, worker_axis=False).shapes
    w = mine["layers"][0]["ffn"]["w_in"]
    # truncated normal on [-2, 2] scaled by 1/sqrt(fan_in)
    assert w.abs().max() <= 2.0 / np.sqrt(w.shape[0]) + 1e-6
    assert abs(float(w.std()) * np.sqrt(w.shape[0]) - 0.88) < 0.05
    again = init_params(pcfg, 0, device="cpu")
    assert torch.equal(again["embed"]["tok"], mine["embed"]["tok"])


def test_init_params_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(port_configs.get_config("smollm-360m", reduced=True), 0)
