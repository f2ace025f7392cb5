"""Encoders and cross-attention in the port against the JAX reference, on
the CPU: whisper-small (an encoder of unmasked self-attention blocks over
stubbed frames, decoder blocks with a cross-attention sublayer,
layernorm, learned positions) at ``reduced=True`` (2 + 2 layers, 32
frames) and llama-3.2-vision-90b (4 self-attention : 1 cross-only block
over stubbed media embeddings) at ``reduced=True`` — whose second layer
is mixer-less and cross-less, as the reference's ``reduce_config`` makes
it — and at 5 layers (the pattern's period, one cross-only block), all
in float32, with the reference's params carried over as numpy and the
same numpy frames on both sides:

- every config field equal to the reference's, at full size, reduced and
  at 5 layers; ``num_params`` counts every leaf but the final norm;
- ``init_params`` leaf for leaf against the reference's draws at 5
  layers (the reduced archs: ``tests/test_torch_init.py``);
- ``encode`` against the reference's within rtol / atol 1e-4;
- prefill (``impl="kernel"`` against the reference's ``impl="pallas"``
  in interpret mode): logits and every cache leaf, ``cross`` included,
  within rtol / atol 1e-4 (``tests/test_torch_serve.py``'s); 4 decode
  steps' logits within the same; 4 greedy tokens equal through
  ``serve.generate(batch_extra=)``; ``lm_loss`` with frames within rtol
  1e-5; the kernel taken by every self-attention (the encoder's
  unmasked) and by no cross-attention;
- learned positions at a nonzero offset, and a position past
  ``max_seq_len`` refused;
- the serve CLI and ``launch/profile_serve``'s units with frames on the
  CPU, and the train CLI's refusal of both archs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import reduce_config as jax_reduce  # noqa: E402
from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import lm_loss as jax_lm_loss  # noqa: E402
from repro.models.transformer import encode as jax_encode  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.flat import tree_flatten  # noqa: E402
from repro_torch.launch import profile_serve, serve, train  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.models import (decode_step, encode, forward,  # noqa: E402
                                init_cache, init_params, lm_loss)
from test_torch_init import _hold_params  # noqa: E402

WHISPER, VLM = "whisper-small", "llama-3.2-vision-90b"
#: (arch, layers): None is ``reduced=True``
CASES = [(WHISPER, None), (VLM, None), (VLM, 5)]
IDS = ["whisper", "vlm", "vlm-5"]
TOL = dict(rtol=1e-4, atol=1e-4)
# batch, prompt, tokens decoded
B, P, GEN = 2, 24, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch, layers, dtype="float32"):
    """(reference cfg, port cfg): reduced, or the reduced recipe at
    ``layers`` layers; in ``dtype`` (None: the config's)."""
    if layers is None:
        pair = (jax_config(arch, reduced=True),
                port_configs.get_config(arch, reduced=True))
    else:
        pair = (jax_reduce(jax_config(arch), num_layers=layers),
                port_configs.reduce_config(port_configs.get_config(arch),
                                           num_layers=layers))
    if dtype is None:
        return pair
    return tuple(dataclasses.replace(c, dtype=dtype) for c in pair)


def _frames(cfg, seed=3):
    """{"audio" | "media": (B, T, d) float32 numpy}, standard normal x
    0.3 as the reference's CLI draws them."""
    name, n = (("audio", cfg.encoder_seq) if cfg.family == "audio"
               else ("media", cfg.num_media_tokens))
    x = np.random.default_rng(seed).standard_normal((B, n, cfg.d_model))
    return {name: (x * 0.3).astype(np.float32)}


def _jb(toks, frames):
    return {"tokens": jnp.asarray(toks),
            **{k: jnp.asarray(v) for k, v in frames.items()}}


def _pb(toks, frames):
    return {"tokens": torch.from_numpy(toks).long(),
            **{k: torch.from_numpy(v) for k, v in frames.items()}}


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def model(request):
    """(reference cfg, port cfg, numpy params, port params, prompt +
    continuation tokens (B, P + GEN), numpy frames)."""
    jcfg, pcfg = _cfgs(*request.param)
    params = jax.tree.map(np.asarray, jax_init(jcfg, jax.random.PRNGKey(0)))
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (B, P + GEN)).astype(np.int32)
    return (jcfg, pcfg, params, params_from_jax(params, device="cpu"), toks,
            _frames(jcfg))


@pytest.fixture(scope="module")
def prefills(model):
    """Both sides' prefill over the prompt, the cache sized P + GEN."""
    jcfg, pcfg, params, tparams, toks, fr = model
    jl, _, jc = jax_forward(jcfg, params, _jb(toks[:, :P], fr),
                            impl="pallas", return_cache=True,
                            cache_len=P + GEN)
    pl, pc = forward(pcfg, tparams, _pb(toks[:, :P], fr), impl="kernel",
                     return_cache=True, cache_len=P + GEN)
    return (np.asarray(jl), jc), (pl, pc)


# ---- configs and init ------------------------------------------------------

@pytest.mark.parametrize("arch,layers", CASES, ids=IDS)
def test_configs_match_reference(arch, layers):
    j, p = _cfgs(arch, layers, dtype=None)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    if layers is None:
        assert dataclasses.asdict(port_configs.get_config(arch)) \
            == dataclasses.asdict(jax_config(arch))
    assert p.padded_vocab == j.padded_vocab
    assert p.num_active_params() == p.num_params()


def test_reduced_vlm_has_no_cross_layer():
    """The reduced VLM's second layer is the pattern's cross-only block
    turned into a mixer-less, cross-less block (``reduce_config`` puts
    the "none" mixer kind in and keeps the first spec's flags); five
    layers hold the pattern's period."""
    red = port_configs.get_config(VLM, reduced=True).layers
    assert [(s.mixer, s.cross_attn) for s in red] == [("attn", False),
                                                      ("none", False)]
    five = _cfgs(VLM, 5)[1].layers
    assert [(s.mixer, s.cross_attn) for s in five] \
        == [("attn", False)] * 4 + [("none", True)]


@pytest.mark.parametrize("arch,layers", CASES, ids=IDS)
def test_num_params_counts_every_leaf(arch, layers):
    cfg = _cfgs(arch, layers, dtype=None)[1]
    params = init_params(cfg, 0, device="cpu")
    norm = sum(t.numel() for t in params["final_norm"].values())
    assert cfg.num_params() + norm == sum(
        t.numel() for t in tree_flatten(params)[0])


def test_full_size_counts_against_the_reference():
    """At full size the port's count is the reference's plus what the
    reference leaves out: whisper's learned-position table, its
    encoder's final norm and the layernorm biases, and a cross-attention
    block's third norm (the reference counts two a block) — for the VLM
    its cross-only blocks' ``norm1``. 8.77e10 for the VLM, whose weights
    alone take 175 GB of bf16."""
    w = port_configs.get_config(WHISPER)
    d = w.d_model
    # the reference counts 2d of norms a block; the port a scale and a
    # bias (2d) for each norm: three a decoder block, two an encoder one
    norms = (6 - 2) * w.num_layers + (4 - 2) * w.encoder_layers
    assert w.num_params() == jax_config(WHISPER).num_params() \
        + w.max_seq_len * d + 2 * d + norms * d
    v = port_configs.get_config(VLM)
    none_blocks = sum(s.mixer == "none" for s in v.layers)
    assert none_blocks == 20
    assert v.num_params() == jax_config(VLM).num_params() \
        + none_blocks * v.d_model
    assert 8.7e10 < v.num_params() < 8.8e10


def test_init_params_matches_jax_at_five_layers():
    """The 5-layer VLM in float32: the cross-only block's keys (ks[1] of
    its layer key) and its mixer-less ``norm1``, within 4 ulps."""
    jcfg, pcfg = _cfgs(VLM, 5)
    share = _hold_params(init_params(pcfg, 3, device="cpu"),
                         jax_init(jcfg, jax.random.PRNGKey(3)))
    assert share <= 0.03


# ---- the forward, prefill and decode ---------------------------------------

@pytest.mark.parametrize("model", [CASES[0]], ids=IDS[:1], indirect=True)
def test_encode_matches_jax(model):
    jcfg, pcfg, params, tparams, _, fr = model
    want = jax_encode(jcfg, params, jnp.asarray(fr["audio"]), impl="pallas")
    got = encode(pcfg, tparams, torch.from_numpy(fr["audio"]),
                 impl="kernel")
    assert tuple(got.shape) == (B, jcfg.encoder_seq, jcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_matches_jax(model, prefills):
    (jl, jc), (pl, pc) = prefills
    np.testing.assert_allclose(pl.numpy(), jl, **TOL)
    assert pc["pos"] == int(jc["pos"]) == P
    jcfg = model[0]
    for spec, jlay, play in zip(jcfg.layers, jc["layers"], pc["layers"]):
        assert play.keys() == jlay.keys()
        assert ("cross" in play) == spec.cross_attn
    jleaves = jax.tree.leaves(jc["layers"])
    pleaves = tree_flatten(pc["layers"])[0]
    assert len(jleaves) == len(pleaves)
    for a, t in zip(jleaves, pleaves):
        assert tuple(t.shape) == a.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(a), **TOL)


def test_decode_steps_match_jax(model, prefills):
    jcfg, pcfg, params, tparams, toks, _ = model
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
    jcfg, pcfg, params, tparams, toks, fr = model
    want = jax_generate(jcfg, params, jnp.asarray(toks[:, :P]), max_len=GEN,
                        greedy=True,
                        batch_extra={k: jnp.asarray(v) for k, v in fr.items()})
    got = serve.generate(pcfg, tparams, torch.from_numpy(toks[:, :P]).long(),
                         max_len=GEN, greedy=True,
                         batch_extra={k: torch.from_numpy(v)
                                      for k, v in fr.items()})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lm_loss_matches_jax(model):
    jcfg, pcfg, params, tparams, toks, fr = model
    want, wm = jax_lm_loss(jcfg, params, _jb(toks, fr))
    got, gm = lm_loss(pcfg, tparams, _pb(toks, fr))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert gm.keys() == wm.keys()


def test_kernel_dispatch(model, monkeypatch):
    """``impl="kernel"``: every self-attention takes flash_attention (the
    encoder's unmasked, the decoder's causal), no cross-attention does —
    the counts chip_smoke.py holds on the card (24 a whisper-small
    prefill) at the reduced depth; ``impl="plain"`` takes it nowhere."""
    jcfg, pcfg, _, tparams, toks, fr = model
    seen = []
    real = attn_mod.flash_attention

    def counted(q, k, v, **kw):
        seen.append(kw["causal"])
        return real(q, k, v, **kw)

    monkeypatch.setattr(attn_mod, "flash_attention", counted)
    forward(pcfg, tparams, _pb(toks[:, :P], fr), impl="kernel")
    self_attn = sum(s.mixer == "attn" for s in jcfg.layers)
    assert seen == [False] * jcfg.encoder_layers + [True] * self_attn
    seen.clear()
    forward(pcfg, tparams, _pb(toks[:, :P], fr), impl="plain")
    assert seen == []


def test_init_cache_projects_the_memory(model, prefills):
    """``init_cache(memory=, params=)``: the cross K/V of the prefill's
    cache, from the same memory; attention K/V zero-filled."""
    jcfg, pcfg, _, tparams, toks, fr = model
    (_, _), (_, pc) = prefills
    if jcfg.family == "audio":
        memory = encode(pcfg, tparams, torch.from_numpy(fr["audio"]),
                        impl="kernel")
    else:
        memory = torch.from_numpy(fr["media"])
    cache = init_cache(pcfg, B, P + GEN, memory=memory, params=tparams,
                       device="cpu")
    assert cache["pos"] == 0
    for spec, c, want in zip(jcfg.layers, cache["layers"], pc["layers"]):
        assert c.keys() == want.keys()
        if spec.cross_attn:
            for n in ("k", "v"):
                assert torch.equal(c["cross"][n], want["cross"][n])
        if "attn" in c:
            assert not c["attn"]["k"].any()
    if any(s.cross_attn for s in jcfg.layers):
        with pytest.raises(ValueError, match="memory= and params="):
            init_cache(pcfg, B, P, device="cpu")


# ---- learned positions -----------------------------------------------------

@pytest.mark.parametrize("model", [CASES[0]], ids=IDS[:1], indirect=True)
def test_learned_positions_at_an_offset(model):
    jcfg, pcfg, params, tparams, toks, _ = model
    assert jcfg.pos_emb == "learned"
    t = toks[:, :5]
    for off in (0, 7):
        want = jax_layers.embed(jcfg, params["embed"], jnp.asarray(t),
                                pos_offset=off)
        got = port_layers.embed(pcfg, tparams["embed"],
                                torch.from_numpy(t).long(), pos_offset=off)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    at0, at7 = (port_layers.embed(pcfg, tparams["embed"],
                                  torch.from_numpy(t).long(), pos_offset=o)
                for o in (0, 7))
    assert not torch.equal(at0, at7)
    # the table's row 7 + i is added to token i
    np.testing.assert_allclose(
        (at7 - at0).numpy(), (tparams["embed"]["pos"][7:12]
                              - tparams["embed"]["pos"][:5]).numpy()[None]
        .repeat(B, 0), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("where", ["embed", "decode_step"])
def test_a_position_past_max_seq_len_is_refused(where):
    cfg = dataclasses.replace(_cfgs(WHISPER, None)[1], max_seq_len=16)
    params = init_params(cfg, 0, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    if where == "embed":
        port_layers.embed(cfg, params["embed"], toks, pos_offset=12)
        with pytest.raises(ValueError, match="past the learned-position "
                           "table of 16"):
            port_layers.embed(cfg, params["embed"], toks, pos_offset=13)
        return
    fr = {k: torch.from_numpy(v[:1]) for k, v in _frames(cfg).items()}
    logits, cache = serve.prefill(cfg, params, toks, max_len=12,
                                  batch_extra=fr)
    toks_out = serve.decode(cfg, params, logits, cache, max_len=12)
    assert tuple(toks_out.shape) == (1, 12)  # positions 4 .. 15
    logits, cache = serve.prefill(cfg, params, toks, max_len=13,
                                  batch_extra=fr)
    with pytest.raises(ValueError, match="16"):
        serve.decode(cfg, params, logits, cache, max_len=13)


# ---- the CLIs --------------------------------------------------------------

@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_cli_serves_on_cpu(arch, capsys):
    toks = serve.main(["--arch", arch, "--device", "cpu", "--reduced",
                       "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    out = capsys.readouterr().out
    assert f"[serve] {arch}-reduced: batch=2 prompt=8 gen=4 in" in out
    assert toks.shape == (2, 4) and int(toks.max()) < 512


def test_cli_refuses_a_prompt_past_max_seq_len(capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", WHISPER, "--device", "cpu", "--reduced",
                    "--prompt-len", "4090", "--gen", "7"])
    assert e.value.code == 2
    assert "past whisper-small-reduced's max_seq_len of 4096" \
        in capsys.readouterr().err


def test_cli_frames_are_the_setup_s(capsys):
    """The CLI's frames: drawn from ``--seed`` on the device, standard
    normal x 0.3 in the config's dtype, of the family's shape."""
    ap = serve.make_parser()
    args = ap.parse_args(["--arch", VLM, "--device", "cpu", "--reduced",
                          "--batch", "3", "--seed", "5"])
    cfg, _, _, extra = serve.setup(args, ap)
    x = extra["media"]
    assert tuple(x.shape) == (3, cfg.num_media_tokens, cfg.d_model)
    assert x.dtype == torch.float32 and x.device.type == "cpu"
    assert torch.equal(x, serve.frames(cfg, 3, 5, "cpu")["media"])
    assert 0.25 < float(x.std()) < 0.35
    assert serve.frames(port_configs.get_config("smollm-360m"), 3, 5,
                        "cpu") == {}


def test_profile_serve_units_take_the_frames():
    """``launch/profile_serve``'s three units on the CPU, whisper reduced:
    the prefill is the serve prefill over the CLI's frames, the cacheless
    step's last logits the prefill's, the decode ``--gen`` tokens."""
    ap = serve.make_parser()
    args = ap.parse_args(["--arch", WHISPER, "--device", "cpu", "--reduced",
                          "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    cfg, params, prompt, extra = serve.setup(args, ap)
    units = profile_serve.phases(cfg, params, prompt, extra, args.gen)
    assert {k: (n, takes) for k, (n, _, takes) in units.items()} == {
        "prefill": (1, False), "decode": (3, True),
        "prefill_step": (1, False)}
    logits, cache = units["prefill"][1]()
    want, _ = serve.prefill(cfg, params, prompt, max_len=3,
                            batch_extra=extra)
    assert torch.equal(logits, want)
    without, _ = serve.prefill(cfg, params, prompt, max_len=3,
                               batch_extra={"audio": extra["audio"] * 0})
    assert not torch.equal(logits, without)
    last = units["prefill_step"][1]()
    np.testing.assert_allclose(last.numpy(), logits[:, -1].numpy(), **TOL)
    toks = units["decode"][1](logits, cache)
    assert tuple(toks.shape) == (2, 3)


@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_train_cli_refuses(arch, capsys):
    with pytest.raises(SystemExit) as e:
        train.main(["--arch", arch, "--device", "cpu", "--reduced",
                    "--steps", "2", "--workers", "2"])
    assert e.value.code == 2
    assert "carries no frames" in capsys.readouterr().err
