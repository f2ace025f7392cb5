"""The dense archs starcoder2-3b (layernorm, plain gelu MLP, window 4096,
GQA 24 / 2, rope theta 1e5), minitron-8b (layernorm, plain relu2 MLP,
untied unembedding, GQA 32 / 8) and gemma3-27b (5:1 local / global
attention, window 1024, GeGLU, rope theta 1e6) in the port against the
JAX reference, on the CPU, at ``reduced=True`` (two layers, d_model 256,
four query heads over one key / value head, window 64) in float32, with
the reference's params carried over as numpy:

- every config field, ``padded_vocab`` and the layer specs equal the
  reference's, at full size and reduced; ``num_params`` counts every
  leaf but the final norm;
- (``init_params`` against the reference's draws: every port arch in
  ``tests/test_torch_init.py``;)
- ``lm_loss`` within rtol 1e-5 and the (M, P) gradient plane within
  atol 1e-5 (``tests/test_torch_models.py``'s tolerances);
- prefill over a prompt of 70 (past the reduced window of 64):
  ``forward(impl="kernel", return_cache=True)`` against the reference's
  ``forward(impl="pallas", return_cache=True)``, logits and every cache
  leaf within rtol / atol 1e-4 (``tests/test_torch_serve.py``'s); 4
  decode steps' logits within the same; 4 greedy tokens equal;
- the serve and train CLIs with ``--device cpu --reduced``;
- the banded branch (``attn_banded``) against the reference's banded
  forward and the port's masked path (rtol / atol 1e-4).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import reduced_f32  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.engine import make_plane_step as jax_plane_step  # noqa: E402
from repro.core.flat import FlatSpec as JaxFlatSpec  # noqa: E402
from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.models import lm_loss as jax_lm_loss  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.engine import make_plane_step  # noqa: E402
from repro_torch.core.flat import FlatSpec, tree_flatten  # noqa: E402
from repro_torch.data import token_stream  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import (decode_step, forward,  # noqa: E402
                                init_params, lm_loss)

ARCHS = ["starcoder2-3b", "minitron-8b", "gemma3-27b"]
TOL = dict(rtol=1e-4, atol=1e-4)
# batch, prompt (past the reduced window of 64), tokens decoded
B, P, GEN = 2, 70, 4
# the gradient plane's rows, batch and sequence (test_torch_models.py's)
M, GB, GS = 3, 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_cfg(arch):
    return dataclasses.replace(port_configs.get_config(arch, reduced=True),
                               dtype="float32")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, reference cfg, port cfg, numpy params, port params,
    prompt + continuation tokens (B, P + GEN))."""
    arch = request.param
    jcfg = reduced_f32(arch)
    params = jax.tree.map(np.asarray, jax_init(jcfg, jax.random.PRNGKey(0)))
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (B, P + GEN)).astype(np.int32)
    return (arch, jcfg, _port_cfg(arch), params,
            params_from_jax(params, device="cpu"), toks)


@pytest.fixture(scope="module")
def prefills(model):
    """Both sides' prefill over the prompt, the cache sized P + GEN."""
    _, jcfg, pcfg, params, tparams, toks = model
    jl, _, jc = jax_forward(jcfg, params, {"tokens": jnp.asarray(toks[:, :P])},
                            impl="pallas", return_cache=True,
                            cache_len=P + GEN)
    n0 = flash_attention.launches
    pl, pc = forward(pcfg, tparams, {"tokens": torch.from_numpy(
        toks[:, :P]).long()}, impl="kernel", return_cache=True,
        cache_len=P + GEN)
    # on the CPU the wrapper takes its plain version and counts nothing
    assert flash_attention.launches == n0
    return (np.asarray(jl), jc), (pl, pc)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for reduced in (False, True):
        j = jax_config(arch, reduced=reduced)
        p = port_configs.get_config(arch, reduced=reduced)
        assert dataclasses.asdict(p) == dataclasses.asdict(j)
        assert p.padded_vocab == j.padded_vocab
        assert p.num_active_params() == p.num_params()
        if p.norm == "rmsnorm":  # layernorm: the port counts its bias
            assert p.num_params() == j.num_params()


def test_full_size_layouts():
    """The published layouts: starcoder2-3b's 30 local layers, gemma3's
    5:1 interleave (52 local, 10 global), minitron's untied 256k vocab;
    and their sizes by the port's count."""
    sc = port_configs.get_config("starcoder2-3b")
    assert [s.mixer for s in sc.layers] == ["attn_local"] * 30
    assert (sc.sliding_window, sc.num_heads // sc.num_kv_heads) == (4096, 12)
    gm = port_configs.get_config("gemma3-27b")
    kinds = [s.mixer for s in gm.layers]
    assert kinds.count("attn_local") == 52 and kinds.count("attn") == 10
    assert kinds[:6] == ["attn_local"] * 5 + ["attn"]
    assert gm.logit_softcap == 0.0 and not gm.attn_banded
    mt = port_configs.get_config("minitron-8b")
    assert not mt.tie_embeddings and mt.padded_vocab == 256_000
    for arch, lo, hi in (("starcoder2-3b", 3.0e9, 3.1e9),
                         ("minitron-8b", 7.7e9, 7.8e9),
                         ("gemma3-27b", 26.9e9, 27.1e9)):
        assert lo < port_configs.get_config(arch).num_params() < hi, arch


@pytest.mark.parametrize("arch", ARCHS)
def test_num_params_counts_every_leaf(arch):
    cfg = port_configs.get_config(arch, reduced=True)
    params = init_params(cfg, 0, device="cpu")
    norm = sum(t.numel() for t in params["final_norm"].values())
    assert cfg.num_params() + norm == sum(
        t.numel() for t in tree_flatten(params)[0])


def _grad_tokens(jcfg):
    return np.stack([next(token_stream(jcfg.vocab_size, GB, GS, seed=i))
                     for i in range(M)])


def test_lm_loss_matches_jax(model):
    _, jcfg, pcfg, params, tparams, _ = model
    toks = _grad_tokens(jcfg)[0]
    want, wm = jax_lm_loss(jcfg, params, {"tokens": jnp.asarray(toks)})
    got, gm = lm_loss(pcfg, tparams, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    # the reference's metrics dict: no experts, no auxiliary terms
    assert gm.keys() == wm.keys()
    assert float(gm["ce"]) == float(got)
    assert gm["load_balance"] == wm["load_balance"] == 0.0


def test_plane_grads_match_jax(model):
    _, jcfg, pcfg, params, tparams, _ = model
    toks = _grad_tokens(jcfg)
    jspec = JaxFlatSpec.of(params, worker_axis=False)
    row = np.asarray(jspec.pack1(params))
    plane = (row[None] + 0.01 * np.random.default_rng(5).standard_normal(
        (M, row.size))).astype(np.float32)
    jl, _, jg = jax.jit(jax_plane_step(
        lambda p, b, r: jax_lm_loss(jcfg, p, b), jspec))(
        jnp.asarray(plane), {"tokens": jnp.asarray(toks)})
    spec = FlatSpec.of(tparams, worker_axis=False)
    pl, _, pg = make_plane_step(lambda p, b, r: lm_loss(pcfg, p, b), spec)(
        torch.from_numpy(plane), {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), atol=1e-5)


def test_prefill_matches_jax(model, prefills):
    (jl, jc), (pl, pc) = prefills
    np.testing.assert_allclose(pl.numpy(), jl, **TOL)
    assert pc["pos"] == int(jc["pos"]) == P
    jleaves = jax.tree.leaves(jc["layers"])
    pleaves = tree_flatten(pc["layers"])[0]
    assert len(jleaves) == len(pleaves)
    for a, t in zip(jleaves, pleaves):
        assert tuple(t.shape) == a.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(a), **TOL)


def test_decode_steps_match_jax(model, prefills):
    """Four decode steps past the window: local layers attend through
    the window's cache slice, global layers over the whole cache."""
    _, jcfg, pcfg, params, tparams, toks = model
    (_, jc), (_, pc) = prefills
    step = jax.jit(lambda p, t, c: jax_decode_step(jcfg, p, t, c))
    pc = {"pos": pc["pos"], "layers": [
        {k: {n: t.clone() for n, t in v.items()} for k, v in c.items()}
        for c in pc["layers"]]}
    for t in range(P, P + GEN):
        jlog, jc = step(params, jnp.asarray(toks[:, t:t + 1]), jc)
        plog, pc = decode_step(pcfg, tparams,
                               torch.from_numpy(toks[:, t:t + 1]).long(), pc)
        np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), **TOL,
                                   err_msg=f"decode step at position {t}")


def test_greedy_tokens_match_jax(model):
    _, jcfg, pcfg, params, tparams, toks = model
    want = jax_generate(jcfg, params, jnp.asarray(toks[:, :P]),
                        max_len=GEN, greedy=True)
    got = serve.generate(pcfg, tparams, torch.from_numpy(toks[:, :P]).long(),
                         max_len=GEN, greedy=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_on_cpu(arch, capsys):
    toks = serve.main(["--arch", arch, "--device", "cpu", "--reduced",
                       "--batch", "2", "--prompt-len", str(P), "--gen", "4"])
    out = capsys.readouterr().out
    assert f"[serve] {arch}-reduced: batch=2 prompt={P} gen=4 in" in out
    assert toks.shape == (2, 4) and int(toks.max()) < 512


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_on_cpu(arch, capsys):
    final, hist, state = train.main(
        ["--arch", arch, "--device", "cpu", "--reduced", "--steps", "2",
         "--workers", "2", "--batch", "2", "--seq", "16", "--avg",
         "periodic", "--phase-len", "2"])
    out = capsys.readouterr().out
    assert f"[train] {arch}-reduced:" in out
    assert "1 averaging ops" in out and hist["averages"] == 1
    assert state.step == 2 and state.plane.shape[0] == 2
    assert all(bool(torch.isfinite(t).all())
               for t in tree_flatten(final)[0])


@pytest.mark.parametrize("arch", ["gemma3-27b", "starcoder2-3b",
                                  "recurrentgemma-2b"])
def test_banded_attention_is_refused(arch):
    """The banded branch (``attn_banded``), which this test once held
    refused and which now runs (the name is kept so the case is followed
    across the port's history): a local layer's sliding window (16 over S = 64) computed band-wise,
    against the reference's banded forward at the tolerance of its own
    ``test_banded_equals_naive`` (rtol / atol 1e-4) and against the
    port's masked path; the loss and its gradients through it; the
    kernel path takes flash_attention first, as the reference's dispatch
    does."""
    jcfg = reduced_f32(arch, sliding_window=16, attn_banded=True)
    assert "attn_local" in [s.mixer for s in jcfg.layers]
    params = jax.tree.map(np.asarray, jax_init(jcfg, jax.random.PRNGKey(0)))
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    jl, _ = jax_forward(jcfg, params, {"tokens": jnp.asarray(toks)})
    cfg = dataclasses.replace(_port_cfg(arch), sliding_window=16,
                              attn_banded=True)
    tparams = params_from_jax(params, device="cpu")
    batch = {"tokens": torch.from_numpy(toks).long()}
    got = forward(cfg, tparams, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), **TOL)
    masked = forward(dataclasses.replace(cfg, attn_banded=False), tparams,
                     batch)
    np.testing.assert_allclose(got.numpy(), masked.numpy(), **TOL)
    jloss, _ = jax_lm_loss(jcfg, params, {"tokens": jnp.asarray(toks)})
    loss, _ = lm_loss(cfg, tparams, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert forward(cfg, tparams, batch, impl="kernel").shape[1] == 64


