"""The port's RWKV6 ("Finch") path against the JAX reference, on the CPU:
reduced rwkv6-7b (2 layers, d_model 256, 8 WKV heads of 32) in float32,
with the reference's params carried over as numpy, and the same numpy
draws through both packages.

- ``kernels.rwkv6_scan`` (on the CPU, its sequential plain twin) against
  the reference's ``rwkv6_scan_ref`` and its Pallas kernel in interpret
  mode: the JAX suite's three shapes (tests/test_kernels.py), a ragged
  sequence, bf16 r / k / v, u as (H*n,) and (H, n); rtol / atol 2e-5;
- the chunked ``rwkv_attention`` (and its final state) against the
  reference's and against the twin, rtol / atol 2e-4 as the JAX suite
  holds the chunked path;
- ``forward`` in both compute paths against the reference's "xla" /
  "pallas", rtol / atol 1e-4;
- ``make_prefill_step`` equal to the cacheless ``forward``'s last
  position, and within 1e-4 of the cache-capturing prefill (kernel
  against the chunked path);
- the config, ``num_params`` (leaf for leaf, at full width from shapes)
  and the bf16 tree's conversion.

Prefill with cache capture, decode, ``generate`` and the CLI are in
tests/test_torch_serve.py, with the other archs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import reduced_f32  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.ref import rwkv6_scan_ref as jax_scan_ref  # noqa: E402
from repro.kernels.rwkv6_scan import rwkv6_scan as jax_scan  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.models import rwkv as jax_rwkv  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.flat import tree_flatten  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import forward, init_params  # noqa: E402
from repro_torch.models import rwkv  # noqa: E402

ARCH = "rwkv6-7b"
SCAN_TOL = dict(rtol=2e-5, atol=2e-5)
CHUNK_TOL = dict(rtol=2e-4, atol=2e-4)
TOL = dict(rtol=1e-4, atol=1e-4)
# (B, S, H, n), the Pallas kernel's block_s, the dtype of r / k / v, u's
# shape: the JAX suite's three cases, a ragged sequence against the
# block, bf16 inputs, u per head
SCAN_CASES = [((2, 64, 4, 32), 32, "float32", "flat"),
              ((1, 100, 2, 64), 64, "float32", "flat"),
              ((1, 48, 1, 16), 16, "float32", "flat"),
              ((2, 37, 4, 32), 16, "float32", "flat"),
              ((2, 40, 2, 32), 16, "bfloat16", "flat"),
              ((1, 33, 4, 16), 16, "float32", "heads")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _draws(shape, seed=0):
    """r, k, v (normal x 0.5), log_w (the suite's clip(-exp(N(0, 1)), -5,
    -1e-5)) and u (H*n,) (normal x 0.1), float32 numpy."""
    b, s, h, n = shape
    g = np.random.default_rng(seed)
    r, k, v = (g.standard_normal(shape).astype(np.float32) * 0.5
               for _ in range(3))
    lw = np.clip(-np.exp(g.standard_normal(shape)), -5.0, -1e-5
                 ).astype(np.float32)
    u = (g.standard_normal(h * n) * 0.1).astype(np.float32)
    return r, k, v, lw, u


def _port_cfg():
    return dataclasses.replace(port_configs.get_config(ARCH, reduced=True),
                               dtype="float32")


@pytest.fixture(scope="module")
def model():
    """(reference cfg, port cfg, numpy params, port params, tokens)."""
    jcfg = reduced_f32(ARCH)
    params = jax.tree.map(np.asarray, jax_init(jcfg, jax.random.PRNGKey(0)))
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (2, 45)).astype(np.int32)
    return jcfg, _port_cfg(), params, params_from_jax(params, "cpu"), toks


@pytest.mark.parametrize(
    "shape,block_s,dtype,u_shape", SCAN_CASES,
    ids=lambda v: "B{}S{}H{}N{}".format(*v) if isinstance(v, tuple)
    else str(v))
def test_rwkv6_scan_matches_jax(shape, block_s, dtype, u_shape):
    """The port's wrapper (on the CPU, the twin) against the reference's
    oracle and its Pallas kernel in interpret mode."""
    r, k, v, lw, u = _draws(shape, seed=shape[1])
    h, n = shape[2], shape[3]
    ju = jnp.asarray(u) if u_shape == "flat" else jnp.asarray(u).reshape(h, n)
    tu = torch.from_numpy(u)
    tu = tu if u_shape == "flat" else tu.reshape(h, n)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jr, jk, jv = (jnp.asarray(t).astype(jdt) for t in (r, k, v))
    tr, tk, tv = (torch.from_numpy(t).to(tdt) for t in (r, k, v))
    n0 = rwkv6_scan.launches
    got = rwkv6_scan(tr, tk, tv, torch.from_numpy(lw), tu)
    assert rwkv6_scan.launches == n0  # the CPU twin counts nothing
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    want = jax_scan_ref(jr, jk, jv, jnp.asarray(lw), ju)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)
    kern = jax_scan(jr, jk, jv, jnp.asarray(lw), ju, block_s=block_s,
                    interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), **SCAN_TOL)


def test_rwkv6_scan_refuses_what_it_cannot_take():
    r, k, v, lw, u = (torch.from_numpy(t) for t in _draws((1, 8, 2, 16)))
    with pytest.raises(ValueError, match="shape"):
        rwkv6_scan(r, k[:, :4], v, lw, u)
    with pytest.raises(ValueError, match="u of"):
        rwkv6_scan(r, k, v, lw, u[:16])
    with pytest.raises(ValueError, match="cpu or cuda"):
        rwkv6_scan(r.to("meta"), k.to("meta"), v.to("meta"),
                   lw.to("meta"), u.to("meta"))


@pytest.mark.parametrize("s", [64, 37, 16, 5])
def test_chunked_attention_matches_jax(s):
    """The chunked path and its final state against the reference's
    chunked path, and its output against the sequential twin."""
    jcfg, pcfg = reduced_f32(ARCH), _port_cfg()
    r, k, v, lw, u = _draws((2, s, 2, 32), seed=s)
    want, wstate = jax_rwkv.rwkv_attention(
        jcfg, *(jnp.asarray(t) for t in (r, k, v, lw, u)), return_state=True)
    t = [torch.from_numpy(a) for a in (r, k, v, lw, u)]
    got, state = rwkv.rwkv_attention(pcfg, *t, return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CHUNK_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(wstate), **CHUNK_TOL)
    np.testing.assert_allclose(got.numpy(), ref.rwkv6_scan_ref(*t).numpy(),
                               **CHUNK_TOL)
    np.testing.assert_array_equal(
        rwkv.rwkv_attention(pcfg, *t).numpy(), got.numpy())


def test_chunk_scan_matches_jax():
    """The associative scan across chunks alone (the shared odd / even
    recursion along axis 2), over 13 chunks."""
    g = np.random.default_rng(3)
    A = g.uniform(0.1, 1.0, (2, 3, 13, 8)).astype(np.float32)
    S = g.standard_normal((2, 3, 13, 8, 8)).astype(np.float32)
    want = jax_rwkv._chunk_scan(jnp.asarray(A), jnp.asarray(S))
    got = rwkv._chunk_scan(torch.from_numpy(A), torch.from_numpy(S))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("jimpl,pimpl", [("xla", "plain"),
                                         ("pallas", "kernel")],
                         ids=["plain", "kernel"])
def test_forward_matches_jax(model, jimpl, pimpl):
    jcfg, pcfg, params, tparams, toks = model
    want, _ = jax_forward(jcfg, params, {"tokens": jnp.asarray(toks)},
                          impl=jimpl)
    got = forward(pcfg, tparams, {"tokens": torch.from_numpy(toks).long()},
                  impl=pimpl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("state", [False, True], ids=["out", "state"])
def test_apply_rwkv_matches_jax(model, state):
    """One time-mix block, through the kernel dispatch: without the state
    the scan (on the CPU the twin), with it the chunked path and its
    ``{"wkv", "shift_t"}``."""
    jcfg, pcfg, params, tparams, _ = model
    x = np.random.default_rng(4).standard_normal(
        (2, 21, jcfg.d_model)).astype(np.float32)
    p = params["layers"][0]["mixer"]
    want = jax_rwkv.apply_rwkv(jcfg, p, jnp.asarray(x), impl="pallas",
                               return_state=state)
    got = rwkv.apply_rwkv(pcfg, tparams["layers"][0]["mixer"],
                          torch.from_numpy(x), impl="kernel",
                          return_state=state)
    if not state:
        want, got = (want, {}), (got, {})
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    assert sorted(got[1]) == sorted(want[1])
    for name in got[1]:
        np.testing.assert_allclose(got[1][name].numpy(),
                                   np.asarray(want[1][name]), **TOL)


def test_prefill_step_runs_the_scan(model):
    """The cacheless prefill step equals ``forward(impl="kernel")``'s last
    position, and the cache-capturing prefill (the chunked path) within
    1e-4."""
    _, pcfg, _, tparams, toks = model
    t = torch.from_numpy(toks).long()
    last = steps.make_prefill_step(pcfg)(tparams, {"tokens": t})
    full = forward(pcfg, tparams, {"tokens": t}, impl="kernel")
    np.testing.assert_array_equal(last.numpy(), full[:, -1].numpy())
    logits, _ = serve.prefill(pcfg, tparams, t, max_len=4)
    np.testing.assert_allclose(last.numpy(), logits[:, -1].numpy(), **TOL)


def test_config_matches_reference():
    for reduced in (False, True):
        j = jax_get_config(ARCH, reduced=reduced)
        p = port_configs.get_config(ARCH, reduced=reduced)
        assert dataclasses.asdict(p) == dataclasses.asdict(j)
    red = port_configs.get_config(ARCH, reduced=True)
    assert (red.num_layers, red.d_model, red.rwkv_head_dim) == (2, 256, 32)


def _final_norm_size(tree_shapes):
    return sum(int(np.prod(s.shape)) for s in
               jax.tree.leaves(tree_shapes["final_norm"]))


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_num_params_counts_every_leaf(reduced):
    """Every leaf but the final norm (scale and bias): the port's own
    init at the reduced width; at full width the reference's tree by
    shape alone (``jax.eval_shape``, nothing allocated), which the port's
    init mirrors leaf for leaf."""
    cfg = port_configs.get_config(ARCH, reduced=reduced)
    jcfg = jax_get_config(ARCH, reduced=reduced)
    shapes = jax.eval_shape(lambda: jax_init(jcfg, jax.random.PRNGKey(0)))
    total = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert cfg.num_params() == total - _final_norm_size(shapes)
    if reduced:
        params = init_params(cfg, 0, device="cpu")
        leaves = tree_flatten(params)[0]
        norm = sum(t.numel() for t in params["final_norm"].values())
        assert cfg.num_params() + norm == sum(t.numel() for t in leaves)
        assert [tuple(t.shape) for t in leaves] == \
            [s.shape for s in jax.tree.leaves(shapes)]
    else:
        assert cfg.num_params() == 6_997_803_008


def test_params_carry_over_with_their_dtypes():
    """The bf16 reference tree converts leaf for leaf: ``w0``, ``u`` and
    ``ln_out`` stay float32, the rest bfloat16, the layernorm biases and
    the untied unembedding included."""
    jcfg = jax_get_config(ARCH, reduced=True)
    params = jax.tree.map(np.asarray, jax_init(jcfg, jax.random.PRNGKey(1)))
    got = params_from_jax(params, device="cpu")
    mixer = got["layers"][0]["mixer"]
    for name in ("w0", "u", "ln_out"):
        assert mixer[name].dtype == torch.float32
    for name in ("wr", "wA", "wB", "mu_w"):
        assert mixer[name].dtype == torch.bfloat16
    assert got["layers"][0]["ffn"]["wk"].dtype == torch.bfloat16
    assert got["layers"][0]["norm1"]["bias"].dtype == torch.bfloat16
    assert tuple(got["embed"]["unembed"].shape) == (jcfg.d_model,
                                                    jcfg.padded_vocab)
    for a, t in zip(jax.tree.leaves(params), tree_flatten(got)[0]):
        assert tuple(t.shape) == a.shape
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      t.float().numpy())


def test_layernorm_and_untied_unembed_match_jax(model):
    from repro.models import layers as jax_layers
    from repro_torch.models import layers
    jcfg, pcfg, params, tparams, _ = model
    g = np.random.default_rng(6)
    x = g.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    p = {"scale": g.standard_normal(jcfg.d_model).astype(np.float32) * 0.1,
         "bias": g.standard_normal(jcfg.d_model).astype(np.float32) * 0.1}
    want = jax_layers.apply_norm(jcfg, jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x))
    got = layers.apply_norm(pcfg, {k: torch.from_numpy(v)
                                   for k, v in p.items()},
                            torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    want = jax_layers.unembed(jcfg, params["embed"], jnp.asarray(x))
    got = layers.unembed(pcfg, tparams["embed"], torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
