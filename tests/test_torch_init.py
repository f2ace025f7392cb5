"""The port's model init against the reference's, on the CPU: the same
seed gives the same weights.

- ``rng.truncated_normal`` against ``jax.random.truncated_normal``
  (bounds -2, 2, the inits' law) within 4 float32 ulps, at least 97% of
  draws bitwise (the rest 1-3 ulps off through erfinv's log1p, as
  ``rng.normal``); its two erf constants equal jax's; a chunked draw is
  the one draw; ``rng.uniform(minval=, maxval=)`` bitwise.
- ``init_params(cfg, seed, device="cpu")`` against
  ``repro.models.init_params(cfg, PRNGKey(seed))`` for every arch of
  ``repro_torch.configs.ARCHS`` at ``reduced=True``, in the config's
  dtype and in float32: the same tree, shapes and dtypes, every leaf
  within 4 ulps of its dtype.
- The training CLIs of both packages, given the same flags, start from
  the same weights (within 4 ulps).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax._src.lax import special as lax_special  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.launch import train as ptrain  # noqa: E402
from repro_torch.models import init_params  # noqa: E402

# every arch the port runs (MoE routers stay float32 in a bf16 tree)
ARCHS = tuple(port_configs.ARCHS)


def _key(jkey) -> torch.Tensor:
    return torch.tensor(np.asarray(jkey).astype(np.int64))


def _ulps(got: torch.Tensor, want) -> np.ndarray:
    """|got - want| in units in the last place of ``got``'s dtype
    (float32 or bfloat16), on the monotone integer line of the bits."""
    want = np.asarray(want)
    if got.dtype == torch.bfloat16:
        g = got.view(torch.int16).numpy().astype(np.int64)
        w = want.view(np.int16).astype(np.int64)
        top = 1 << 15
    else:
        g = got.numpy().view(np.int32).astype(np.int64)
        w = want.view(np.int32).astype(np.int64)
        top = 1 << 31
    line = lambda b: np.where(b < 0, -top - b, b)  # noqa: E731
    return np.abs(line(g) - line(w))


def _leaves(tree, path=()):
    """(path, leaf) of nested dicts and lists, in the tree's order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _hold_params(mine, ref, max_ulps=4) -> float:
    """The same tree, shapes and dtypes; every leaf within ``max_ulps``
    of its dtype. Returns the share of entries that are not bitwise."""
    got, want = dict(_leaves(mine)), dict(_leaves(ref))
    assert got.keys() == want.keys()
    off = total = 0
    for path, w in want.items():
        w = np.asarray(w)
        g = got[path]
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype) == f"torch.{w.dtype}", (path, g.dtype, w.dtype)
        d = _ulps(g, w)
        assert d.max(initial=0) <= max_ulps, (path, int(d.max()))
        off += int((d > 0).sum())
        total += d.size
    return off / total


class TestTruncatedNormal:
    @pytest.mark.parametrize("bound", [-2.0, 2.0])
    def test_erf_constants_are_jax_s(self, bound):
        sqrt2 = np.array(np.sqrt(2), np.float32)
        want = jax.jit(lambda v: lax_special.erf(v / sqrt2))(
            jnp.float32(bound))
        assert rng._ERF_AT[bound] == float(want)
        assert np.float32(rng._erf32(bound)) == np.asarray(want)

    def test_refuses_bounds_without_a_pinned_erf(self):
        with pytest.raises(ValueError, match="bounds"):
            rng.truncated_normal(rng.PRNGKey(0), -1.0, 2.0, (4,))

    @pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
    @pytest.mark.parametrize("shape", [(1,), (7, 33), (3, 64, 50)])
    def test_matches_jax(self, seed, shape):
        key = jax.random.split(jax.random.PRNGKey(seed))[1]
        want = np.asarray(jax.random.truncated_normal(key, -2.0, 2.0, shape))
        got = rng.truncated_normal(_key(key), -2.0, 2.0, shape)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        d = _ulps(got, want)
        assert d.max(initial=0) <= 4
        # the share that is not bitwise: about 1% (erfinv's log1p)
        assert (d > 0).mean() <= 0.03
        assert float(got.abs().max()) < 2.0

    def test_a_chunked_draw_is_the_one_draw(self, monkeypatch):
        key = rng.PRNGKey(5)
        whole = rng.truncated_normal(key, -2.0, 2.0, (40, 101))
        monkeypatch.setattr(rng, "_DRAW_CHUNK", 999)
        assert torch.equal(rng.truncated_normal(key, -2.0, 2.0, (40, 101)),
                           whole)

    @pytest.mark.parametrize("seed", [0, 7])
    @pytest.mark.parametrize("lo,hi", [(0.9, 0.999), (0.0, 1.0),
                                       (-3.0, 0.5)])
    def test_uniform_on_a_range_is_jax_s(self, seed, lo, hi):
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed),
                                             (4096,), minval=lo,
                                             maxval=hi))
        got = rng.uniform(rng.PRNGKey(seed), (4096,), minval=lo, maxval=hi)
        np.testing.assert_array_equal(got.numpy(), want)


class TestInitParams:
    @pytest.mark.parametrize("dtype", ["config", "float32"])
    @pytest.mark.parametrize("arch", ARCHS)
    def test_init_params_matches_jax(self, arch, dtype):
        pcfg = port_configs.get_config(arch, reduced=True)
        jcfg = jax_config(arch, reduced=True)
        if dtype == "float32":
            pcfg = dataclasses.replace(pcfg, dtype="float32")
            jcfg = dataclasses.replace(jcfg, dtype="float32")
        share = _hold_params(init_params(pcfg, 3, device="cpu"),
                             jax_init(jcfg, jax.random.PRNGKey(3)))
        assert share <= 0.03

    def test_seeds_differ(self):
        cfg = port_configs.get_config("smollm-360m", reduced=True)
        a = init_params(cfg, 0, device="cpu")["embed"]["tok"]
        b = init_params(cfg, 1, device="cpu")["embed"]["tok"]
        assert not torch.equal(a, b)


class _Started(Exception):
    pass


@pytest.mark.parametrize("argv", [
    ["--arch", "smollm-360m", "--reduced", "--steps", "2", "--workers", "2"],
    ["--arch", "recurrentgemma-2b", "--reduced", "--steps", "2",
     "--workers", "2", "--seed", "11"]])
def test_both_clis_start_from_the_same_weights(argv, monkeypatch):
    """The reference CLI's ``init_params`` result, caught before it
    trains, against the port CLI's ``setup`` with the same flags."""
    seen = {}

    def caught(cfg, key):
        seen["params"] = jax_init(cfg, key)
        raise _Started

    monkeypatch.setattr(jtrain, "init_params", caught)
    with pytest.raises(_Started):
        jtrain.main(argv)
    ap = ptrain.make_parser()
    args = ap.parse_args(argv + ["--device", "cpu"])
    params = ptrain.setup(args, ap)[2]
    assert _hold_params(params, seen["params"]) <= 0.03
