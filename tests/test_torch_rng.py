"""``repro_torch.rng`` against ``jax.random``, and the draws built on it
against the reference's: the int8 stochastic-rounding uniforms
(``repro.core.compress.row_uniforms``) and the gossip matchings
(``repro.topology.gossip_matrix``). Everything is compared bitwise: a
counter-based generator that differs in one bit is a different
generator."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import compress as jcomp  # noqa: E402
from repro import topology as jtopo  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.core import compress as pcomp  # noqa: E402
from repro_torch import topology as ptopo  # noqa: E402

SEEDS = [0, 1, 7, 12345, 2**31 - 1, -1, -2**31]


def _u32(key_t):
    return key_t.numpy().astype(np.uint32)


def test_jax_defaults_pinned():
    """The layout this port implements: threefry2x32 keys, the
    partitionable counter layout, 32-bit mode."""
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert not jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_split_fold_in_bitwise(seed):
    kj, kp = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    np.testing.assert_array_equal(_u32(kp), np.asarray(kj))
    for num in (1, 2, 3, 7):
        np.testing.assert_array_equal(_u32(rng.split(kp, num)),
                                      np.asarray(jax.random.split(kj, num)))
    for data in (0, 1, 2, 255, 0x676F73, 0x656E63, 2**31 - 1):
        np.testing.assert_array_equal(
            _u32(rng.fold_in(kp, data)),
            np.asarray(jax.random.fold_in(kj, data)))


def test_prng_key_refuses_seeds_beyond_int32():
    with pytest.raises(ValueError, match="int32"):
        rng.PRNGKey(2**31)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_bits_uniform_bernoulli_bitwise(seed):
    kj, kp = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    np.testing.assert_array_equal(
        _u32(rng.random_bits(kp, (3, 37))),
        np.asarray(jax.random.bits(kj, (3, 37))))
    u_j = np.asarray(jax.random.uniform(kj, (4097,), jnp.float32))
    u_p = rng.uniform(kp, (4097,)).numpy()
    np.testing.assert_array_equal(u_p.view(np.uint32), u_j.view(np.uint32))
    # a chunked draw is the same draw
    tail = rng.bits_to_uniform(rng.random_bits(kp, (97,), start=4000))
    np.testing.assert_array_equal(tail.numpy(), u_p[4000:])
    for p in (0.01, 0.1, 0.37, 0.5, 1.0):
        for t in range(1, 41):
            kt_j, kt_p = jax.random.fold_in(kj, t), rng.fold_in(kp, t)
            assert bool(rng.bernoulli(kt_p, p)) == bool(
                jax.random.bernoulli(kt_j, p)), (p, t)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 24, 64, 1625, 1700])
def test_permutation_bitwise(n):
    """``_shuffle``'s round count changes at n = 1626 (one round below,
    two above); both sides of it."""
    for seed in range(3):
        kj, kp = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
        np.testing.assert_array_equal(
            rng.permutation(kp, n).numpy(),
            np.asarray(jax.random.permutation(kj, n)))


@pytest.mark.parametrize("p", [1, 1000, 3001])
def test_row_uniforms_bitwise(p, monkeypatch):
    """The int8 uniforms of rows (0, 3, 5) at several steps, drawn in
    chunks of 1024 columns so the chunked path runs too."""
    monkeypatch.setattr(pcomp, "_UNIFORM_CHUNK", 1024)
    kj = jax.random.split(jax.random.PRNGKey(3))[1]
    kp = rng.split(rng.PRNGKey(3))[1]
    rows = [0, 3, 5]
    for step in (1, 2, 17):
        want = np.asarray(jcomp.row_uniforms(kj, step, jnp.asarray(rows),
                                             p))
        got = pcomp.row_uniforms(kp, step, rows, p).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("m", [2, 4, 8, 24, 64])
def test_gossip_matrix_bitwise(m):
    for seed in range(2):
        kj = jax.random.split(jax.random.PRNGKey(seed))[1]
        kp = rng.split(rng.PRNGKey(seed))[1]
        for step in (1, 2, 3, 10, 128):
            want = np.asarray(jtopo.gossip_matrix(kj, step, m))
            got = ptopo.gossip_matrix(kp, step, m).numpy()
            np.testing.assert_array_equal(got, want)
            assert got.dtype == np.float32


@pytest.mark.parametrize("seed", [0, 7, 12345])
@pytest.mark.parametrize("lo,hi", [(0, 40), (0, 7), (0, 256), (0, 65536),
                                   (0, 65537), (-5, 1_000_003),
                                   (7, 3_000_017), (0, 2**31 - 1),
                                   (-2**31, 2**31 - 1), (3, 3), (5, 2)],
                         ids=lambda v: str(v))
def test_randint_bitwise(seed, lo, hi):
    """``rng.randint`` is ``jax.random.randint`` bit for bit: spans that
    are powers of two and spans that are not (the modulo of the two bit
    streams), spans past 2**16 (the wrapping multiplier), the full int32
    range and empty spans, over several shapes."""
    for shape in [(7,), (13, 5), (2, 3, 4), (200, 8)]:
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed),
                                             shape, lo, hi))
        got = rng.randint(rng.PRNGKey(seed), shape, lo, hi)
        assert got.dtype == torch.int32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want)


def test_randint_refuses_bounds_past_int32():
    with pytest.raises(ValueError, match="int32"):
        rng.randint(rng.PRNGKey(0), (3,), 0, 2**31)


@pytest.mark.parametrize("start_steps", [0, 3, 17])
def test_normal_and_uniform_blocks_are_the_whole_draw(start_steps):
    """``start=``: a block of steps of a (steps, reps, M) draw is that
    slice of the whole draw, bit for bit (the theory simulator draws its
    noise so)."""
    key = rng.PRNGKey(5)
    whole_n = rng.normal(key, (20, 6, 4))
    whole_u = rng.uniform(key, (20, 6))
    n = 3
    blk_n = rng.normal(key, (n, 6, 4), start=start_steps * 24)
    blk_u = rng.uniform(key, (n, 6), start=start_steps * 6)
    assert torch.equal(blk_n, whole_n[start_steps:start_steps + n])
    assert torch.equal(blk_u, whole_u[start_steps:start_steps + n])


@pytest.mark.parametrize("seed", [0, 3])
def test_bits_past_2_32_counters_take_the_high_word(seed):
    """Past 2**32 draws (an expert tensor of llama4, 5.4e9 entries) the
    flat index i runs threefry on the counter pair (i >> 32, i mod
    2**32): jax's partitionable layout, a uint64 iota split into two
    uint32 words (``iota_2x32_shape``, whose low-index words are checked
    here), each pair hashed as jax's threefry primitive hashes it."""
    from jax._src import prng as jprng
    hi, lo = jprng.iota_2x32_shape((3, 5))
    np.testing.assert_array_equal(np.asarray(hi), 0)
    np.testing.assert_array_equal(np.asarray(lo), np.arange(15).reshape(3, 5))
    key = jax.random.PRNGKey(seed)
    start = 2**32 - 6
    i = np.arange(start, start + 12, dtype=np.uint64)
    k1, k2 = np.asarray(key)
    b1, b2 = jprng.threefry2x32_p.bind(
        k1, k2, jnp.asarray((i >> 32).astype(np.uint32)),
        jnp.asarray((i & 0xFFFFFFFF).astype(np.uint32)))
    want = np.asarray(b1) ^ np.asarray(b2)
    got = rng.random_bits(rng.PRNGKey(seed), (12,), start=start)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
