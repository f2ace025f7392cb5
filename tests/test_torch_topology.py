"""``repro_torch.topology`` against ``repro.topology``: every builder's
mixing matrix, its spectrum and communication cost, the eager refusals
of bad worker counts, and the f32 event matrix the engine hands to the
kernels. The builders run the same float64 numpy operations, so
matrices, SLEMs and gaps are compared exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import topology as jtopo  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch import topology as ptopo  # noqa: E402

CASES = [("full", 4), ("full", 24), ("ring", 3), ("ring", 24),
         ("torus", 4), ("torus", 24), ("hypercube", 2), ("hypercube", 64),
         ("groups", 8), ("gossip_pairs", 4), ("gossip_pairs", 24),
         ("disconnected", 5)]


@pytest.mark.parametrize("kind,m", CASES, ids=lambda v: str(v))
def test_builders_match_reference(kind, m):
    tp = ptopo.Topology.build(kind, m, groups=4 if kind == "groups" else None)
    tj = jtopo.Topology.build(kind, m, groups=4 if kind == "groups" else None)
    assert (tp.kind, tp.num_workers, tp.groups) == (tj.kind, tj.num_workers,
                                                   tj.groups)
    if tj.matrix is None:
        assert tp.matrix is None
    else:
        np.testing.assert_array_equal(tp.matrix, tj.matrix)
    np.testing.assert_array_equal(tp.expected_matrix(), tj.expected_matrix())
    assert tp.slem == tj.slem
    assert tp.spectral_gap == tj.spectral_gap
    assert tp.comm_degree == tj.comm_degree
    alive = np.ones(m)
    alive[0] = 0.0
    assert tp.effective_spectral_gap(alive) == tj.effective_spectral_gap(
        alive)
    for wire in ("f32", "bf16", "int8", "one_bit"):
        for events, p in ((1, 1000), (7, 361_821_120)):
            assert ptopo.comm_bytes(tp, events, p, wire) == \
                jtopo.comm_bytes(tj, events, p, wire)


@pytest.mark.parametrize("kind,m", [k for k in CASES
                                    if k[0] != "gossip_pairs"],
                         ids=lambda v: str(v))
def test_event_matrix_f32(kind, m):
    tp = ptopo.Topology.build(kind, m, groups=4 if kind == "groups" else None)
    tj = jtopo.Topology.build(kind, m, groups=4 if kind == "groups" else None)
    got = tp.mixing_matrix(device="cpu")
    assert got.dtype == torch.float32 and got.shape == (m, m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(tj.mixing_matrix()))


def test_gossip_event_matrix_needs_the_key():
    tp = ptopo.Topology.gossip_pairs(4)
    with pytest.raises(ValueError, match="key"):
        tp.mixing_matrix(3)
    kp = rng.split(rng.PRNGKey(0))[1]
    kj = jax.random.split(jax.random.PRNGKey(0))[1]
    np.testing.assert_array_equal(
        tp.mixing_matrix(3, kp).numpy(),
        np.asarray(jtopo.Topology.gossip_pairs(4).mixing_matrix(3, kj)))


@pytest.mark.parametrize("kind,m,groups", [
    ("full", 0, None), ("ring", 2, None), ("torus", 7, None),
    ("torus", 3, None), ("hypercube", 6, None), ("hypercube", 1, None),
    ("groups", 6, 4), ("groups", 6, 0), ("gossip_pairs", 5, None),
    ("gossip_pairs", 0, None), ("disconnected", 0, None), ("star", 4, None)])
def test_bad_worker_counts_refused_alike(kind, m, groups):
    with pytest.raises(Exception) as ej:
        jtopo.Topology.build(kind, m, groups=groups)
    with pytest.raises(Exception) as ep:
        ptopo.Topology.build(kind, m, groups=groups)
    assert type(ep.value) is type(ej.value)
    assert str(ep.value) == str(ej.value)


def test_kinds_and_salt_match():
    assert ptopo.KINDS == jtopo.KINDS
    assert ptopo.MIX_KINDS == jtopo.MIX_KINDS
    assert ptopo._GOSSIP_SALT == jtopo._GOSSIP_SALT
    assert ptopo.Topology.torus_sides(24) == jtopo.Topology.torus_sides(24)
