"""The port's mixture-of-experts FFN (``repro_torch.models.moe``) and the
MoE archs phi3.5-moe-42b-a6.6b (16 experts top-2, layernorm, untied) and
llama4-maverick-400b-a17b (128 experts top-1 with a shared expert, dense
and MoE layers interleaved) against the JAX reference, on the CPU, in
float32, with the reference's params carried over as numpy:

- ``apply_moe`` in four cases — top-2 over 4 experts (reduced phi3.5),
  top-1 with the shared expert (reduced llama4), a capacity factor low
  enough that tokens are dropped, and ``moe_group_size`` > 0 over a token
  count that is no multiple of the group — its output within rtol / atol
  1e-5, ``load_balance`` and ``router_z`` within rtol 1e-6, and the
  dispatch (which token goes to which expert slot, which tokens drop)
  equal: no router choice flips between the packages at these draws;
- ties among the router probabilities broken to the lower index, as
  ``jax.lax.top_k`` breaks them, down to the experts a zero router picks;
- ``lm_loss`` with its metrics dict ("ce" holding the loss with the
  auxiliary terms, as the reference's) within rtol 1e-5 and the gradient
  plane within atol 1e-5 (``tests/test_torch_models.py``'s tolerances);
- a reduced phi3.5 ``PhaseEngine`` run (periodic 2, M=2, Momentum, 4
  steps) against the reference's engine at the LM parity tolerances of
  ``tests/test_torch_engine.py`` (loss rtol 2e-5, plane atol 2e-5);
- prefill (logits and every cache leaf, rtol / atol 1e-4), 4 decode steps
  and 4 greedy tokens (equal) past llama4's reduced window of 64;
- ``num_params`` against the leaf count, ``num_active_params`` against
  its definition (``init_params`` against the reference's draws:
  ``tests/test_torch_init.py``); bf16 MoE trees converted leaf for leaf;
  an engine state
  through the checkpoint format and back, resumed bitwise, and read by
  the reference.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import reduced_f32  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.checkpoint import io as jio  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.averaging import AveragingSchedule as JSched  # noqa: E402
from repro.core.engine import PhaseEngine as JEngine  # noqa: E402
from repro.core.engine import make_plane_step as jax_plane_step  # noqa: E402
from repro.core.flat import FlatSpec as JaxFlatSpec  # noqa: E402
from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.models import lm_loss as jax_lm_loss  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch import optim as popt  # noqa: E402
from repro_torch.checkpoint import io as pio  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import AveragingSchedule, PhaseEngine  # noqa: E402
from repro_torch.core.engine import make_plane_step  # noqa: E402
from repro_torch.core.flat import FlatSpec, tree_flatten  # noqa: E402
from repro_torch.data import token_stream  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import (decode_step, forward,  # noqa: E402
                                init_params, lm_loss)
from repro_torch.models import moe  # noqa: E402

PHI, LLAMA4 = "phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b"
ARCHS = [PHI, LLAMA4]
TOL = dict(rtol=1e-4, atol=1e-4)
Y_TOL = dict(rtol=1e-5, atol=1e-5)
# the engine run's tolerances: tests/test_torch_engine.py's SMOLLM_TOL
LM_TOL = dict(params=dict(rtol=0, atol=2e-5), loss=dict(rtol=2e-5),
              disp=dict(rtol=1e-5))
B, P, GEN = 2, 70, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(arch, **kw):
    """(reference cfg, port cfg) of the reduced arch in float32."""
    jcfg = reduced_f32(arch, **kw)
    pcfg = dataclasses.replace(port_configs.get_config(arch, reduced=True),
                               dtype="float32", **kw)
    return jcfg, pcfg


# ---- apply_moe -------------------------------------------------------------

#: name: (arch, config overrides, batch, sequence)
MOE_CASES = {"top2": (PHI, {}, 2, 24),
             "top1-shared": (LLAMA4, {}, 2, 24),
             "drops": (PHI, dict(capacity_factor=0.25), 2, 24),
             "groups": (PHI, dict(moe_group_size=8), 2, 13)}


def _moe_inputs(jcfg, b, s, seed=0):
    p = jax.tree.map(np.asarray, jmoe.init_moe(jcfg, jax.random.PRNGKey(seed)))
    x = np.random.default_rng(seed).standard_normal(
        (b, s, jcfg.d_model)).astype(np.float32)
    return p, x


def _dispatch_both(jcfg, pcfg, jp, tp, x, group):
    """Each side's combine weights from its own router probabilities,
    over groups of ``group`` tokens (the whole batch at 0)."""
    xt = x.reshape(-1, x.shape[-1])
    jprobs = jax.nn.softmax(jnp.asarray(xt) @ jp["router"], axis=-1)
    pprobs = torch.softmax(torch.from_numpy(xt) @ tp["router"], dim=-1)
    t = xt.shape[0]
    g = group if group and group < t else t
    pad = -(-t // g) * g - t
    jprobs = jnp.pad(jprobs, ((0, pad), (0, 0))).reshape(
        -1, g, jcfg.num_experts)
    pprobs = torch.nn.functional.pad(pprobs, (0, 0, 0, pad)).reshape(
        -1, g, pcfg.num_experts)
    cap = moe._capacity(pcfg, g)
    assert cap == jmoe._capacity(jcfg, g)
    jc = np.stack([np.asarray(jmoe._dispatch_combine(jcfg, jprobs[i], cap))
                   for i in range(jprobs.shape[0])])
    return jc, moe._dispatch_combine(pcfg, pprobs, cap).numpy()


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_apply_moe_matches_jax(case):
    arch, kw, b, s = MOE_CASES[case]
    jcfg, pcfg = _pair(arch, **kw)
    jp, x = _moe_inputs(jcfg, b, s)
    tp = params_from_jax(jp, device="cpu")
    want, waux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x))
    got, gaux = moe.apply_moe(pcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **Y_TOL)
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(gaux[k]), float(waux[k]), rtol=1e-6)
    # the same routing on both sides: slots, drops, combine weights
    jc, pc = _dispatch_both(jcfg, pcfg, jp, tp, x, pcfg.moe_group_size)
    np.testing.assert_array_equal(pc > 0, jc > 0)
    np.testing.assert_allclose(pc, jc, rtol=1e-6, atol=1e-7)
    # slots each token took, the padded tail left out
    routed = (pc > 0).sum(axis=(-1, -2)).reshape(-1)[:b * s]
    if case == "drops":
        assert (routed < pcfg.top_k).sum() > 0
    else:
        assert (routed == pcfg.top_k).all()


def test_dropped_tokens_go_in_token_order():
    """Past an expert's capacity the later tokens drop: with every token
    routed to the same two experts, the first ``cap`` of each keep."""
    _, pcfg = _pair(PHI, capacity_factor=0.25)
    t = 40
    cap = moe._capacity(pcfg, t)
    probs = torch.tensor([[0.4, 0.3, 0.2, 0.1]]).repeat(t, 1)
    comb = moe._dispatch_combine(pcfg, probs, cap)
    kept = (comb > 0).any(-1)                  # (T, E)
    assert kept[:cap, :2].all() and not kept[cap:].any()
    assert not kept[:, 2:].any()


def test_top_k_breaks_ties_as_jax():
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.3, 0.3, 0.3],
                      [0.0, 0.5, 0.0, 0.5],
                      [0.2, 0.2, 0.4, 0.2],
                      [0.3, 0.1, 0.3, 0.3]], np.float32)
    for k in (1, 2, 3):
        wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
        gv, gi = moe.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("arch", ARCHS)
def test_a_zero_router_picks_the_lowest_experts(arch):
    """A zero router gives every token equal probabilities: both sides
    send each token to experts 0 .. k-1 (until their capacity fills)."""
    jcfg, pcfg = _pair(arch)
    jp, x = _moe_inputs(jcfg, 2, 24, seed=1)
    jp["router"] = np.zeros_like(jp["router"])
    tp = params_from_jax(jp, device="cpu")
    want, _ = jmoe.apply_moe(jcfg, jp, jnp.asarray(x))
    got, _ = moe.apply_moe(pcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **Y_TOL)
    jc, pc = _dispatch_both(jcfg, pcfg, jp, tp, x, 0)
    np.testing.assert_array_equal(pc > 0, jc > 0)
    used = (pc > 0).any(axis=(0, 1, 3))        # per expert
    assert used.tolist() == [e < pcfg.top_k for e in range(pcfg.num_experts)]


# ---- the archs -------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg, pcfg = _pair(arch)
    params = jax.tree.map(np.asarray, jax_init(jcfg, jax.random.PRNGKey(0)))
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (B, P + GEN)).astype(np.int32)
    return (arch, jcfg, pcfg, params, params_from_jax(params, device="cpu"),
            toks)


def test_reduced_layouts():
    _, phi = _pair(PHI)
    assert [(s.mixer, s.ffn) for s in phi.layers] == [("attn", "moe")] * 2
    assert (phi.num_experts, phi.top_k, phi.shared_expert) == (4, 2, False)
    _, l4 = _pair(LLAMA4)
    assert [(s.mixer, s.ffn) for s in l4.layers] == [
        ("attn_local", "dense"), ("attn", "moe")]
    assert (l4.num_experts, l4.top_k, l4.shared_expert) == (4, 1, True)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for reduced in (False, True):
        j = jax_config(arch, reduced=reduced)
        p = port_configs.get_config(arch, reduced=reduced)
        assert dataclasses.asdict(p) == dataclasses.asdict(j)
        assert p.padded_vocab == j.padded_vocab
    assert port_configs.get_config(LLAMA4).name == LLAMA4


@pytest.mark.parametrize("arch", ARCHS)
def test_num_params_counts_every_leaf(arch):
    cfg = port_configs.get_config(arch, reduced=True)
    params = init_params(cfg, 0, device="cpu")
    norm = sum(t.numel() for t in params["final_norm"].values())
    assert cfg.num_params() + norm == sum(
        t.numel() for t in tree_flatten(params)[0])
    # the experts a token is not routed to, in every MoE layer; the
    # router stays float32 in the bf16 tree (its init against the
    # reference's: tests/test_torch_init.py)
    dead = 0
    for spec, lay in zip(cfg.layers, params["layers"]):
        if spec.ffn == "moe":
            assert lay["ffn"]["router"].dtype == torch.float32
            assert lay["ffn"]["w_in"].dtype == torch.bfloat16
            one = sum(lay["ffn"][w][0].numel()
                      for w in ("w_in", "w_out", "w_gate"))
            dead += (cfg.num_experts - cfg.top_k) * one
    assert cfg.num_active_params() == cfg.num_params() - dead > 0
    j = jax_config(arch, reduced=True)
    # the reference's count differs by the layernorm biases alone
    bias = 2 * cfg.d_model * cfg.num_layers if cfg.norm == "layernorm" else 0
    assert cfg.num_params() == j.num_params() + bias
    assert cfg.num_active_params() == j.num_active_params() + bias


def test_full_size_counts():
    """The names' sizes: phi3.5 42B with 6.6B active, llama4 400B with
    17B active (the port's count, layernorm biases included)."""
    phi = port_configs.get_config(PHI)
    assert 41.8e9 < phi.num_params() < 42.0e9
    assert 6.5e9 < phi.num_active_params() < 6.7e9
    l4 = port_configs.get_config(LLAMA4)
    assert 396e9 < l4.num_params() < 404e9
    assert 16e9 < l4.num_active_params() < 18e9


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_moe_tree_converts_leaf_for_leaf(arch):
    jcfg = jax_config(arch, reduced=True)
    params = jax.tree.map(np.asarray, jax_init(jcfg, jax.random.PRNGKey(1)))
    got = params_from_jax(params, device="cpu")
    i = next(i for i, s in enumerate(jcfg.layers) if s.ffn == "moe")
    ffn = got["layers"][i]["ffn"]
    e, d, f = jcfg.num_experts, jcfg.d_model, jcfg.moe_d_ff
    assert tuple(ffn["w_in"].shape) == tuple(ffn["w_gate"].shape) == (e, d, f)
    assert tuple(ffn["w_out"].shape) == (e, f, d)
    assert ffn["router"].dtype == torch.float32
    assert ffn["w_in"].dtype == torch.bfloat16
    assert ("shared" in ffn) == jcfg.shared_expert
    for a, t in zip(jax.tree.leaves(params), tree_flatten(got)[0]):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      t.float().numpy())


def _grad_tokens(jcfg, m=3):
    return np.stack([next(token_stream(jcfg.vocab_size, 2, 16, seed=i))
                     for i in range(m)])


def test_lm_loss_and_metrics_match_jax(model):
    _, jcfg, pcfg, params, tparams, _ = model
    toks = _grad_tokens(jcfg)[0]
    want, wm = jax_lm_loss(jcfg, params, {"tokens": jnp.asarray(toks)})
    got, gm = lm_loss(pcfg, tparams, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert gm.keys() == wm.keys() == {"ce", "load_balance", "router_z"}
    for k in gm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-5)
    # "ce" is the loss with the auxiliary terms in it, as the reference's
    assert float(gm["ce"]) == float(got)
    logits = forward(pcfg, tparams, {"tokens": torch.from_numpy(toks).long()})
    labels = torch.from_numpy(toks[:, 1:]).long()
    ce = torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, logits.shape[-1]), labels.reshape(-1))
    n = sum(s.ffn == "moe" for s in pcfg.layers)
    aux = pcfg.router_aux_coef * float(gm["load_balance"]) / n \
        + 1e-3 * float(gm["router_z"]) / n
    np.testing.assert_allclose(float(got), float(ce) + aux, rtol=1e-6)


def test_plane_grads_match_jax(model):
    _, jcfg, pcfg, params, tparams, _ = model
    m = 3
    toks = _grad_tokens(jcfg, m)
    jspec = JaxFlatSpec.of(params, worker_axis=False)
    row = np.asarray(jspec.pack1(params))
    plane = (row[None] + 0.01 * np.random.default_rng(5).standard_normal(
        (m, row.size))).astype(np.float32)
    jl, _, jg = jax.jit(jax_plane_step(
        lambda p, b, r: jax_lm_loss(jcfg, p, b), jspec))(
        jnp.asarray(plane), {"tokens": jnp.asarray(toks)})
    spec = FlatSpec.of(tparams, worker_axis=False)
    pl, _, pg = make_plane_step(lambda p, b, r: lm_loss(pcfg, p, b), spec)(
        torch.from_numpy(plane), {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), atol=1e-5)
    # the router, the experts (and llama4's shared expert) get gradients
    moe_layer = next(i for i, s in enumerate(pcfg.layers) if s.ffn == "moe")
    names = [n for n, _ in _named(tparams)]
    for i, n in enumerate(names):
        if n.startswith(f"layers.{moe_layer}.ffn."):
            o, size = spec.offsets[i], int(np.prod(spec.shapes[i]))
            assert np.abs(pg.numpy()[:, o:o + size]).max() > 0, n


def _named(tree, path=""):
    if isinstance(tree, dict):  # in the plane's (sorted) order
        for k in sorted(tree):
            yield from _named(tree[k], f"{path}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named(v, f"{path}{i}.")
    else:
        yield path[:-1], tree


def test_prefill_and_decode_match_jax(model):
    _, jcfg, pcfg, params, tparams, toks = model
    jl, _, jc = jax_forward(jcfg, params, {"tokens": jnp.asarray(toks[:, :P])},
                            impl="pallas", return_cache=True,
                            cache_len=P + GEN)
    pl, pc = forward(pcfg, tparams, {"tokens": torch.from_numpy(
        toks[:, :P]).long()}, impl="kernel", return_cache=True,
        cache_len=P + GEN)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    jleaves, pleaves = jax.tree.leaves(jc["layers"]), tree_flatten(
        pc["layers"])[0]
    assert len(jleaves) == len(pleaves)
    for a, t in zip(jleaves, pleaves):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), **TOL)
    step = jax.jit(lambda p, t, c: jax_decode_step(jcfg, p, t, c))
    for t in range(P, P + GEN):
        jlog, jc = step(params, jnp.asarray(toks[:, t:t + 1]), jc)
        plog, pc = decode_step(pcfg, tparams,
                               torch.from_numpy(toks[:, t:t + 1]).long(), pc)
        np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), **TOL,
                                   err_msg=f"decode step at position {t}")
    want = jax_generate(jcfg, params, jnp.asarray(toks[:, :P]),
                        max_len=GEN, greedy=True)
    got = serve.generate(pcfg, tparams, torch.from_numpy(toks[:, :P]).long(),
                         max_len=GEN, greedy=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_on_cpu(arch, capsys):
    toks = serve.main(["--arch", arch, "--device", "cpu", "--reduced",
                       "--batch", "2", "--prompt-len", str(P), "--gen", "4"])
    assert f"[serve] {arch}-reduced: batch=2" in capsys.readouterr().out
    assert toks.shape == (2, 4) and int(toks.max()) < 512


# ---- the engine and the checkpoint ------------------------------------------

M, STEPS, CUT = 2, 4, 2


def _phi_engines():
    jcfg, pcfg = _pair(PHI)
    params = jax.tree.map(np.asarray, jax_init(jcfg, jax.random.PRNGKey(0)))
    streams = [token_stream(jcfg.vocab_size, 2, 16, seed=i) for i in range(M)]
    batches = [{"tokens": np.stack([next(st) for st in streams])}
               for _ in range(STEPS)]
    sched = dict(kind="periodic", phase_len=2)
    jeng = JEngine(lambda p, b, r: jax_lm_loss(jcfg, p, b),
                   jopt.Momentum(lr=0.01, mu=0.9), JSched(**sched))
    peng = PhaseEngine(lambda p, b, r: lm_loss(pcfg, p, b),
                       popt.Momentum(lr=0.01, mu=0.9),
                       AveragingSchedule(**sched), device="cpu")
    return jeng, peng, params, batches


@pytest.fixture(scope="module")
def phi_runs():
    jeng, peng, params, batches = _phi_engines()
    jb = [{"tokens": jnp.asarray(b["tokens"])} for b in batches]
    jfinal, jhist, jst = jeng.run(jax.tree.map(jnp.asarray, params), jb,
                                  num_workers=M, seed=3, record_every=1,
                                  return_state=True)
    tparams = params_from_jax(params, device="cpu")
    pfinal, phist, pst = peng.run(tparams, batches, num_workers=M, seed=3,
                                  record_every=1, return_state=True)
    wp = jst.worker_params
    return dict(jfinal=jfinal, jhist=jhist,
                jplane=np.asarray(JaxFlatSpec.of(wp).pack(wp)),
                pfinal=pfinal, phist=phist, pst=pst, peng=peng, jeng=jeng,
                params=params, tparams=tparams, batches=batches)


def test_engine_run_matches_jax(phi_runs):
    r = phi_runs
    assert r["phist"]["averages"] == r["jhist"]["averages"] == STEPS // 2
    for key in ("loss", "dispersion", "disp_trace"):
        assert [t for t, _ in r["phist"][key]] == \
            [t for t, _ in r["jhist"][key]], key
    np.testing.assert_allclose([v for _, v in r["phist"]["loss"]],
                               [float(v) for _, v in r["jhist"]["loss"]],
                               **LM_TOL["loss"])
    np.testing.assert_allclose([v for _, v in r["phist"]["dispersion"]],
                               [float(v) for _, v in r["jhist"]["dispersion"]],
                               **LM_TOL["disp"])
    np.testing.assert_allclose(r["pst"].plane.numpy(), r["jplane"],
                               **LM_TOL["params"])
    cons = np.concatenate([np.asarray(x).reshape(-1) for x in
                           jax.tree.leaves(r["jfinal"])])
    got = np.concatenate([x.reshape(-1).numpy()
                          for x in tree_flatten(r["pfinal"])[0]])
    np.testing.assert_allclose(got, cons, **LM_TOL["params"])


def test_engine_state_checkpoint_resumes_and_loads_in_reference(phi_runs,
                                                                tmp_path):
    r = phi_runs
    peng, batches = r["peng"], r["batches"]
    _, h1, st = peng.run(r["tparams"], batches[:CUT], num_workers=M, seed=3,
                         record_every=1, return_state=True)
    path = str(tmp_path / "moe")
    pio.save_engine_state(path, st)
    loaded, at = pio.load_engine_state(path, peng.init(r["tparams"], M, 3))
    assert at == CUT and torch.equal(loaded.plane, st.plane)
    _, h2, st2 = peng.run(None, batches[CUT:], num_workers=M, seed=3,
                          record_every=1, state=loaded, return_state=True)
    assert torch.equal(st2.plane, r["pst"].plane)
    assert h1["loss"] + h2["loss"] == r["phist"]["loss"]
    jparams = jax.tree.map(jnp.asarray, r["params"])
    jl, jat = jio.load_engine_state(path, r["jeng"].init(jparams, M, 3))
    assert jat == CUT
    wp = jl.worker_params
    np.testing.assert_array_equal(np.asarray(JaxFlatSpec.of(wp).pack(wp)),
                                  st.plane.numpy())
