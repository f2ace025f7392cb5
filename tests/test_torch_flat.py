"""The port's flat plane against the JAX reference's, on the CPU: the
same params (JAX-initialized, carried over as numpy) pack to bitwise
equal planes, with equal rounding codes, and unpack back exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import reduced_f32  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core.flat import FlatSpec as JaxFlatSpec  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.flat import (FlatOptSpec, FlatSpec,  # noqa: E402
                                   tree_flatten)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mixed_cfg():
    # reduced smollm in its published bf16, with a few leaves moved to f16
    return get_config("smollm-360m", reduced=True)


@pytest.fixture(scope="module")
def trees():
    """{name: numpy params tree} — f32 and a bf16/f16/f32 mixed tree."""
    f32 = jax.tree.map(np.asarray, jax_init_params(
        reduced_f32("smollm-360m"), jax.random.PRNGKey(0)))
    mixed = jax_init_params(_mixed_cfg(), jax.random.PRNGKey(1))
    mixed["layers"][0]["ffn"]["w_in"] = \
        mixed["layers"][0]["ffn"]["w_in"].astype(jnp.float16)
    mixed["layers"][1]["mixer"]["wq"] = \
        mixed["layers"][1]["mixer"]["wq"].astype(jnp.float32)
    mixed["final_norm"]["scale"] = jnp.linspace(
        -3, 3, 256).astype(jnp.float16)
    return {"f32": f32, "mixed": jax.tree.map(np.asarray, mixed)}


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("name", ["f32", "mixed"])
def test_pack1_bitwise_equal_to_jax(trees, name):
    tree = trees[name]
    want = JaxFlatSpec.of(tree, worker_axis=False).pack1(tree)
    port = params_from_jax(tree, device="cpu")
    spec = FlatSpec.of(port, worker_axis=False)
    np.testing.assert_array_equal(_bits(spec.pack1(port).numpy()),
                                  _bits(want))


@pytest.mark.parametrize("name", ["f32", "mixed"])
def test_rounding_codes_equal_jax(trees, name):
    tree = trees[name]
    want = JaxFlatSpec.of(tree, worker_axis=False).rounding_codes()
    got = FlatSpec.of(params_from_jax(tree, device="cpu"),
                      worker_axis=False).rounding_codes()
    if want is None:
        assert got is None
    else:
        assert set(np.unique(want)) == {0.0, 1.0, 2.0}
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["f32", "mixed"])
def test_unpack1_roundtrip_exact(trees, name):
    port = params_from_jax(trees[name], device="cpu")
    spec = FlatSpec.of(port, worker_axis=False)
    back = spec.unpack1(spec.pack1(port))
    a, td_a = tree_flatten(port)
    b, td_b = tree_flatten(back)
    assert td_a == td_b
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_worker_plane_pack_matches_jax(trees):
    tree = trees["mixed"]
    rng = np.random.default_rng(0)
    # 3 workers, each leaf perturbed per worker, then cast to leaf dtype
    wtree = jax.tree.map(
        lambda a: np.stack([(np.asarray(a, np.float32)
                             + rng.standard_normal(a.shape) * 0.01
                             ).astype(a.dtype) for _ in range(3)]), tree)
    want = JaxFlatSpec.of(wtree).pack(wtree)
    port = params_from_jax(wtree, device="cpu")
    spec = FlatSpec.of(port)
    plane = spec.pack(port)
    np.testing.assert_array_equal(_bits(plane.numpy()), _bits(want))
    for x, y in zip(tree_flatten(port)[0],
                    tree_flatten(spec.unpack(plane))[0]):
        assert torch.equal(x, y)


def test_flat_opt_spec_roundtrip(trees):
    port = params_from_jax(trees["f32"], device="cpu")
    spec = FlatSpec.of(port, worker_axis=False)
    w2 = [torch.stack([x, x + 1]) for x in tree_flatten(port)[0]]
    state = {"m": w2, "v": [x * 2 for x in w2]}
    pspec = FlatSpec.of(w2)
    ospec = FlatOptSpec.of(pspec, state)
    assert ospec is not None and ospec.num_planes == 2
    planes = ospec.pack(state)
    assert all(p.shape == (2, spec.width) for p in planes)
    back = ospec.unpack(planes)
    for x, y in zip(tree_flatten(state)[0], tree_flatten(back)[0]):
        assert torch.equal(x, y)
    # a state that does not mirror the params does not align
    assert FlatOptSpec.of(pspec, {"m": w2[:-1]}) is None


def test_params_from_jax_keeps_structure_and_dtypes(trees):
    tree = trees["mixed"]
    port = params_from_jax(tree, device="cpu")
    jl, jtd = jax.tree.flatten(tree)
    pl, _ = tree_flatten(port)
    assert len(jl) == len(pl) == 2 + 9 * _mixed_cfg().num_layers
    for a, b in zip(jl, pl):
        assert str(b.dtype).split(".")[-1] == a.dtype.name
        np.testing.assert_array_equal(b.float().numpy(),
                                      a.astype(np.float32))
