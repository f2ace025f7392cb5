"""The port's data plane (``repro_torch.data.pipeline``) against the
reference's ``repro.data.pipeline``: the same seeds must give the same
indices, index for index.

- ``WorkerSharder`` in its three modes (permute with epoch wrap-around,
  replacement, dirichlet with its pools and class fractions): every
  ``next_indices`` / ``next_index_block`` call equal;
- ``DeviceDataset``: the arrays moved once and bitwise the inputs,
  ``index_block`` as int32 equal to the reference's from an index list
  and from a sampler, ``num_steps`` and the cursor across calls, and the
  refusals;
- ``worker_batches`` on finite streams (a partial group dropped);
- ``Prefetcher``: order, the producer's error re-raised once and then
  StopIteration, and ``close()`` ending the producer early.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import pipeline as jpipe  # noqa: E402
from repro_torch.data import pipeline as ppipe  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---- WorkerSharder --------------------------------------------------------

class TestWorkerSharder:
    """``WorkerSharder``: the reference's indices, index for index."""

    @pytest.mark.parametrize("n,m,seed,batch", [(23, 3, 0, 5), (64, 4, 7, 16),
                                                (10, 2, 3, 4)])
    def test_sharder_permute_equal_across_epochs(self, n, m, seed, batch):
        """Per-worker permutations, re-drawn at every epoch's end: 12 calls
        cross several epochs (and, at n 10, batches longer than the rest of
        an epoch)."""
        a = jpipe.WorkerSharder(n, m, seed=seed, mode="permute")
        b = ppipe.WorkerSharder(n, m, seed=seed, mode="permute")
        for _ in range(12):
            np.testing.assert_array_equal(b.next_indices(batch),
                                          a.next_indices(batch))
        np.testing.assert_array_equal(b.next_index_block(5, batch),
                                      a.next_index_block(5, batch))

    @pytest.mark.parametrize("seed", [0, 1, 11])
    def test_sharder_replacement_equal(self, seed):
        a = jpipe.WorkerSharder(1000, 6, seed=seed, mode="replacement")
        b = ppipe.WorkerSharder(1000, 6, seed=seed, mode="replacement")
        np.testing.assert_array_equal(b.next_indices(3), a.next_indices(3))
        np.testing.assert_array_equal(b.next_index_block(7, 4),
                                      a.next_index_block(7, 4))
        np.testing.assert_array_equal(b.next_index_block(1, 1),
                                      a.next_index_block(1, 1))

    @pytest.mark.parametrize("alpha", [0.05, 0.5, 50.0])
    def test_sharder_dirichlet_equal(self, alpha):
        labels = np.random.default_rng(2).integers(0, 5, 300)
        a = jpipe.WorkerSharder(300, 8, seed=4, mode="dirichlet",
                                labels=labels, alpha=alpha)
        b = ppipe.WorkerSharder(300, 8, seed=4, mode="dirichlet",
                                labels=labels, alpha=alpha)
        for pa, pb in zip(a._pools, b._pools):
            np.testing.assert_array_equal(pb, pa)
        np.testing.assert_array_equal(b.class_fractions(labels),
                                      a.class_fractions(labels))
        np.testing.assert_array_equal(b.next_indices(6), a.next_indices(6))
        np.testing.assert_array_equal(b.next_index_block(4, 3),
                                      a.next_index_block(4, 3))

    @pytest.mark.parametrize("kw", [dict(mode="bogus"),
                                    dict(mode="dirichlet"),
                                    dict(mode="dirichlet", labels=np.zeros(5)),
                                    dict(mode="dirichlet", labels=np.zeros(50),
                                         alpha=0.0)])
    def test_sharder_refusals(self, kw):
        with pytest.raises(ValueError):
            ppipe.WorkerSharder(50, 4, **kw)
        with pytest.raises((AssertionError, ValueError)):
            jpipe.WorkerSharder(50, 4, **kw)

    def test_class_fractions_needs_dirichlet(self):
        with pytest.raises(ValueError):
            ppipe.WorkerSharder(50, 4, mode="replacement").class_fractions(
                np.zeros(50))


# ---- DeviceDataset -------------------------------------------------------

def _arrays(n=40):
    r = np.random.default_rng(0)
    return {"x": r.standard_normal((n, 3)).astype(np.float32),
            "y": {"t": r.integers(0, 9, n).astype(np.int32)}}


class TestDeviceDataset:
    """``DeviceDataset``: the arrays, the index blocks, the cursor."""

    def test_dataset_arrays_moved_once_and_bitwise(self):
        arrs = _arrays()
        ds = ppipe.DeviceDataset(arrs, 2, batch_size=3, device="cpu")
        assert ds.num_samples == 40 and ds.device == torch.device("cpu")
        np.testing.assert_array_equal(ds.arrays["x"].numpy(), arrs["x"])
        np.testing.assert_array_equal(ds.arrays["y"]["t"].numpy(),
                                      arrs["y"]["t"])
        # a copy: the caller's buffers stay the caller's
        arrs["x"][0, 0] = 99.0
        assert float(ds.arrays["x"][0, 0]) != 99.0
        # a tensor already on the device is shared, not copied
        t = torch.zeros(40, 2)
        assert ppipe.DeviceDataset({"x": t}, 2, batch_size=1,
                                   device="cpu").arrays["x"] is t

    @pytest.mark.parametrize("shape", [(12, 3, 4), (12, 3)])
    def test_dataset_index_list_blocks_and_cursor(self, shape):
        idx = np.random.default_rng(5).integers(0, 40, shape)
        a = jpipe.DeviceDataset(_arrays(), 3, indices=idx)
        b = ppipe.DeviceDataset(_arrays(), 3, indices=idx, device="cpu")
        assert b.num_steps == a.num_steps == 12
        for k in (5, 1, 6):
            ba, bb = a.index_block(k), b.index_block(k)
            assert bb.dtype == np.int32 and bb.shape == (k,) + shape[1:]
            np.testing.assert_array_equal(bb, ba)
            assert b.num_steps == a.num_steps
        assert b.num_steps == 0
        with pytest.raises(ValueError, match="exhausted"):
            b.index_block(1)

    @pytest.mark.parametrize("mode", ["replacement", "permute"])
    def test_dataset_sampler_blocks_equal(self, mode):
        a = jpipe.DeviceDataset(_arrays(), 4, batch_size=5, seed=3, mode=mode)
        b = ppipe.DeviceDataset(_arrays(), 4, batch_size=5, seed=3, mode=mode,
                                device="cpu")
        assert b.num_steps is None and a.num_steps is None
        for k in (3, 8, 1):
            bb = b.index_block(k)
            assert bb.dtype == np.int32
            np.testing.assert_array_equal(bb, a.index_block(k))

    def test_dataset_refusals(self):
        with pytest.raises(ValueError, match="batch_size"):
            ppipe.DeviceDataset(_arrays(), 2, device="cpu")
        with pytest.raises(ValueError, match="leading dims"):
            ppipe.DeviceDataset({"a": np.zeros(3), "b": np.zeros(4)}, 2,
                                batch_size=1, device="cpu")
        with pytest.raises(ValueError, match="indices"):
            ppipe.DeviceDataset(_arrays(), 2, indices=np.zeros((4, 3), int),
                                device="cpu")

    def test_dataset_defaults_to_the_card(self):
        """The default device is CUDA, which refuses here instead of falling
        back to the CPU."""
        if torch.cuda.is_available():
            ds = ppipe.DeviceDataset(_arrays(), 2, batch_size=1)
            assert ds.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="cuda"):
                ppipe.DeviceDataset(_arrays(), 2, batch_size=1)


# ---- worker_batches and the Prefetcher -------------------------------------

class TestStreams:
    """``worker_batches`` and the ``Prefetcher``."""

    @pytest.mark.parametrize("n_items,m", [(12, 4), (13, 4), (3, 4), (0, 2)])
    def test_worker_batches_equal(self, n_items, m):
        items = [np.full((2,), i, np.float32) for i in range(n_items)]
        got = list(ppipe.worker_batches(iter(items), m))
        want = list(jpipe.worker_batches(iter(items), m))
        assert len(got) == len(want) == n_items // m
        for g, w in zip(got, want):
            assert g.shape == (m, 2)
            np.testing.assert_array_equal(g, w)

    def test_prefetcher_keeps_order(self):
        pf = ppipe.Prefetcher(iter(range(25)), depth=2)
        assert list(pf) == list(range(25))
        pf._thread.join(timeout=5.0)
        assert not pf._thread.is_alive()

    def test_prefetcher_reraises_the_producers_error_once(self):
        def gen():
            yield 1
            yield 2
            raise KeyError("boom")

        pf = ppipe.Prefetcher(gen())
        assert next(pf) == 1 and next(pf) == 2
        with pytest.raises(KeyError, match="boom"):
            next(pf)
        with pytest.raises(StopIteration):
            next(pf)
        pf._thread.join(timeout=5.0)
        assert not pf._thread.is_alive()

    def test_prefetcher_close_stops_the_producer(self):
        pulled = []

        def endless():
            i = 0
            while True:
                pulled.append(i)
                yield i
                i += 1

        pf = ppipe.Prefetcher(endless(), depth=2)
        assert next(pf) == 0
        pf.close()
        assert not pf._thread.is_alive()
        n = len(pulled)
        assert n <= 5  # depth 2 ahead, one in hand, one in flight
        with pytest.raises(StopIteration):
            next(pf)
        assert len(pulled) == n
