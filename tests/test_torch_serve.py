"""The port's serving path against the JAX reference, on the CPU: reduced
recurrentgemma-2b (an RG-LRU block and a local-attention block, window
64, MQA), reduced smollm-360m (GQA attention) and reduced rwkv6-7b (two
RWKV6 time-mix + channel-mix blocks, layernorm, untied embeddings) in
float32, with the reference's params carried over as numpy.

- prefill: ``forward(impl="kernel", return_cache=True)`` (on the CPU the
  kernels' plain versions) against the reference's
  ``forward(impl="pallas", return_cache=True)`` (Pallas in interpret
  mode): logits and every cache leaf within rtol / atol 1e-4;
- decode: ``decode_step`` logits step by step within the same, over a
  prompt longer than the window, so the window's cache slice is taken;
- ``generate(impl="plain")`` tokens equal to the reference's
  ``generate``, greedy and sampled with the same seed;
- prefill then decode equals the full-sequence forward (the port alone);
- the CLI on the CPU, its refusal without CUDA, and no JAX in the
  port's process.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import reduced_f32  # noqa: E402
from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.flat import tree_flatten  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import (decode_step, forward,  # noqa: E402
                                init_cache, init_params)

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["recurrentgemma-2b", "smollm-360m", "rwkv6-7b"]
# the archs with an attention block
ATTN_ARCHS = ["recurrentgemma-2b", "smollm-360m"]
# batch, prompt (longer than recurrentgemma's reduced window of 64),
# tokens generated
B, P, GEN = 2, 80, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_cfg(arch):
    return dataclasses.replace(port_configs.get_config(arch, reduced=True),
                               dtype="float32")


def _copy(cache):
    """A copy of a port cache (decode writes K/V in place)."""
    return {"pos": cache["pos"], "layers": [
        {k: {n: t.clone() for n, t in v.items()} for k, v in c.items()}
        for c in cache["layers"]]}


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
    """Both sides' prefill over the prompt, cache sized P + GEN."""
    _, jcfg, pcfg, params, tparams, toks = model
    jl, _, jc = jax_forward(jcfg, params, {"tokens": jnp.asarray(toks[:, :P])},
                            impl="pallas", return_cache=True,
                            cache_len=P + GEN)
    n0 = (flash_attention.launches, rglru_scan.launches,
          rwkv6_scan.launches)
    pl, pc = forward(pcfg, tparams, {"tokens": torch.from_numpy(
        toks[:, :P]).long()}, impl="kernel", return_cache=True,
        cache_len=P + GEN)
    # on the CPU the wrappers take their plain versions and count nothing
    assert (flash_attention.launches, rglru_scan.launches,
            rwkv6_scan.launches) == n0
    return (np.asarray(jl), jc), (pl, pc)


def test_configs_match_reference():
    from repro.configs import get_config
    for reduced in (False, True):
        j = get_config("recurrentgemma-2b", reduced=reduced)
        p = port_configs.get_config("recurrentgemma-2b", reduced=reduced)
        assert dataclasses.asdict(p) == dataclasses.asdict(j)
    full = port_configs.get_config("recurrentgemma-2b")
    assert [s.mixer for s in full.layers].count("rglru") == 18
    assert [s.mixer for s in full.layers].count("attn_local") == 8
    assert 2.67e9 < full.num_params() < 2.69e9


@pytest.mark.parametrize("arch", ARCHS)
def test_num_params_counts_every_leaf(arch):
    cfg = port_configs.get_config(arch, reduced=True)
    params = init_params(cfg, 0, device="cpu")
    leaves = tree_flatten(params)[0]
    # every leaf but the final norm (a scale, and a bias for layernorm),
    # which the count leaves out as the reference's does
    norm = sum(t.numel() for t in params["final_norm"].values())
    assert cfg.num_params() + norm == sum(t.numel() for t in leaves)


def test_params_carry_over_with_their_dtypes():
    """A bf16 reference tree converts leaf for leaf: the block-diagonal
    gates keep their (H, bw, bw) shape and ``lam`` stays float32."""
    from repro.configs import get_config
    jcfg = get_config("recurrentgemma-2b", reduced=True)
    params = jax.tree.map(np.asarray, jax_init(jcfg, jax.random.PRNGKey(1)))
    got = params_from_jax(params, device="cpu")
    mixer = got["layers"][0]["mixer"]
    h, bw = jcfg.num_heads, jcfg.rnn_width // jcfg.num_heads
    assert tuple(mixer["wa"].shape) == tuple(mixer["wi"].shape) == (h, bw, bw)
    assert mixer["lam"].dtype == torch.float32
    assert mixer["conv"].dtype == mixer["conv_b"].dtype == torch.bfloat16
    for a, t in zip(jax.tree.leaves(params), tree_flatten(got)[0]):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      t.float().numpy())


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
    _, jcfg, pcfg, params, tparams, toks = model
    (_, jc), (_, pc) = prefills
    step = jax.jit(lambda p, t, c: jax_decode_step(jcfg, p, t, c))
    pc = _copy(pc)
    for t in range(P, P + GEN):
        jlog, jc = step(params, jnp.asarray(toks[:, t:t + 1]), jc)
        plog, pc = decode_step(pcfg, tparams,
                               torch.from_numpy(toks[:, t:t + 1]).long(), pc)
        np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), **TOL,
                                   err_msg=f"decode step at position {t}")
    assert pc["pos"] == P + GEN


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sample"])
def test_generate_matches_jax(model, greedy):
    _, jcfg, pcfg, params, tparams, toks = model
    want = jax_generate(jcfg, params, jnp.asarray(toks[:, :P]),
                        max_len=GEN, greedy=greedy, seed=3)
    got = serve.generate(pcfg, tparams, torch.from_numpy(toks[:, :P]).long(),
                         max_len=GEN, greedy=greedy, seed=3, impl="plain")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_categorical_matches_jax():
    """The sampler alone, over logits whose Gumbel draws decide."""
    from repro_torch import rng
    logits = np.random.default_rng(0).standard_normal((3, 700)
                                                      ).astype(np.float32)
    for seed in range(4):
        want = jax.random.categorical(jax.random.PRNGKey(seed),
                                      jnp.asarray(logits))
        got = serve.categorical(rng.PRNGKey(seed), torch.from_numpy(logits))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_then_decode_equals_full_forward(model):
    """True prefill (forward with the cache) followed by decode equals the
    full-sequence forward, the port alone (the reference's
    tests/test_models_smoke.py continuity test, same tolerance)."""
    _, _, pcfg, _, tparams, toks = model
    t = torch.from_numpy(toks).long()
    ref = forward(pcfg, tparams, {"tokens": t})
    logits, cache = forward(pcfg, tparams, {"tokens": t[:, :P]},
                            impl="kernel", return_cache=True,
                            cache_len=P + GEN)
    outs = [logits[:, -1]]
    for i in range(P, P + GEN - 1):
        lg, cache = decode_step(pcfg, tparams, t[:, i:i + 1], cache)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(),
                               ref[:, P - 1:P + GEN - 1].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_steps_match_forward_and_decode(model, prefills):
    """The prefill step equals the cache-capturing prefill's last position,
    bitwise where both take the same path; for rwkv6-7b the step runs the
    scan and the capturing prefill the chunked WKV, so the step is held
    within 1e-4 to that prefill and to the reference's cacheless
    ``forward(impl="pallas")``. The decode step equals ``decode_step``."""
    _, jcfg, pcfg, params, tparams, toks = model
    (_, _), (pl, pc) = prefills
    prefill = steps.make_prefill_step(pcfg)
    last = prefill(tparams, {"tokens": torch.from_numpy(toks[:, :P]).long()})
    if any(s.mixer == "rwkv" for s in pcfg.layers):
        np.testing.assert_allclose(last.numpy(), pl[:, -1].numpy(), **TOL)
        want, _ = jax_forward(jcfg, params,
                              {"tokens": jnp.asarray(toks[:, :P])},
                              impl="pallas")
        np.testing.assert_allclose(last.numpy(), np.asarray(want)[:, -1],
                                   **TOL)
    else:
        np.testing.assert_array_equal(last.numpy(), pl[:, -1].numpy())
    tok = torch.from_numpy(toks[:, P:P + 1]).long()
    a, _ = steps.make_decode_step(pcfg)(tparams, tok, _copy(pc))
    b, _ = decode_step(pcfg, tparams, tok, _copy(pc))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_decode_from_empty_cache_equals_forward(model):
    """``init_cache`` then one decode step per token gives the
    full-sequence forward's logits at every position (the reference's
    decode test, tests/test_models_smoke.py, same tolerance)."""
    _, _, pcfg, _, tparams, toks = model
    t = torch.from_numpy(toks[:, :P]).long()
    ref = forward(pcfg, tparams, {"tokens": t})
    cache = init_cache(pcfg, B, P, device="cpu")
    outs = []
    for i in range(P):
        lg, cache = decode_step(pcfg, tparams, t[:, i:i + 1], cache)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), ref.numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("jimpl,pimpl", [("xla", "plain"),
                                         ("pallas", "kernel")],
                         ids=["plain", "kernel"])
@pytest.mark.parametrize("pos_offset", [0, 5])
@pytest.mark.parametrize("model", ATTN_ARCHS, indirect=True)
def test_attention_matches_jax(model, jimpl, pimpl, pos_offset):
    """The attention block alone, with the captured k / v, at a query
    offset too (the reference's kernel branch ignores the offset in its
    mask, and so does the port's)."""
    from repro.models import attention as jax_attn
    from repro_torch.models import attention as attn
    _, jcfg, pcfg, params, tparams, _ = model
    i = next(n for n, s in enumerate(jcfg.layers)
             if s.mixer in ("attn", "attn_local"))
    x = np.random.default_rng(2).standard_normal(
        (B, 70, jcfg.d_model)).astype(np.float32)
    want, (wk, wv) = jax_attn.attention(
        jcfg, params["layers"][i]["mixer"], jnp.asarray(x),
        layer=jcfg.layers[i], impl=jimpl, pos_offset=pos_offset,
        return_kv=True)
    got, (gk, gv) = attn.attention(
        pcfg, tparams["layers"][i]["mixer"], torch.from_numpy(x),
        layer=pcfg.layers[i], impl=pimpl, pos_offset=pos_offset,
        return_kv=True)
    for a, b in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_forward_refuses_unknown_impl(model):
    _, _, pcfg, _, tparams, toks = model
    with pytest.raises(ValueError, match="impl"):
        forward(pcfg, tparams, {"tokens": torch.from_numpy(toks).long()},
                impl="pallas")


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_on_cpu(arch, capsys):
    toks = serve.main(["--arch", arch, "--device", "cpu", "--reduced",
                       "--batch", "2", "--prompt-len", "70", "--gen", "4"])
    out = capsys.readouterr().out
    assert f"[serve] {arch}-reduced: batch=2 prompt=70 gen=4 in" in out
    assert "[serve] sample output ids: [" in out
    assert toks.shape == (2, 4) and int(toks.max()) < 512


def test_cli_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        serve.main(["--reduced", "--gen", "2"])
    assert e.value.code == 2


def test_serve_imports_no_jax():
    code = (
        "import sys\n"
        "from repro_torch.launch import serve\n"
        "import repro_torch.models.rwkv, repro_torch.kernels.rwkv6_scan\n"
        "serve.main(['--arch', 'recurrentgemma-2b', '--device', 'cpu', "
        "'--reduced', '--batch', '1', '--prompt-len', '8', '--gen', '2', "
        "'--sample'])\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith(('jax.', 'jaxlib', 'repro.')) or n == 'repro')\n"
        "print('BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], env=ENV, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[serve] recurrentgemma-2b-reduced" in out.stdout
    assert "BAD []" in out.stdout, out.stdout


def test_serve_profile_needs_the_card():
    from repro_torch.launch import profile, profile_serve
    assert profile._group("void flash_fwd<__nv_bfloat16, 256>") \
        == "flash_attention"
    for name in ("void (anonymous namespace)::flash_fwd_wgmma<256>("
                 "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
                 "__nv_bfloat16*, int, int, int, float, int, int)",
                 "void (anonymous namespace)::flash_fwd_f32<64>("
                 "float const*, float const*, float const*, float*, int, "
                 "int, int, float, int, int)"):
        assert profile._group(name) == "flash_attention"
    assert profile._group("rglru_scan_cols") == "rglru_scan"
    assert profile._group("void (anonymous namespace)::rwkv6_scan_heads"
                          "<64, __nv_bfloat16>") == "rwkv6_scan"
    with pytest.raises(SystemExit) as e:
        profile_serve.main(["--device", "cpu", "--reduced", "--gen", "1"])
    assert e.value.code == 2
