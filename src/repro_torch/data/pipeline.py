"""Worker-sharded batching and the on-device data plane.

The port's own copy of the reference's ``data/pipeline.py`` (which
imports no JAX, but the port imports nothing of the reference):

- :class:`WorkerSharder` draws each worker's sample indices in the
  paper's two setups — a distinct permutation per worker (``permute``,
  §3.2) or i.i.d. draws from the common pool (``replacement``, Eq. 2) —
  and in label-skewed ``dirichlet`` shards, from the identical numpy
  streams, so both packages see the same indices;
- :func:`worker_batches` groups a single-batch stream into per-worker
  batches with the worker axis first;
- :class:`DeviceDataset` moves an in-memory dataset to the device ONCE
  and hands the engine ``(K, M, B)`` (or ``(K, M)``) int32 index
  blocks: the engine gathers each step's batches on the device, so a
  phase ships K·M·B indices instead of K stacked batches;
- :class:`Prefetcher` double-buffers a streaming source: a daemon thread
  stages block t+1 while block t computes.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from repro_torch.core.flat import tree_flatten, tree_map
from repro_torch.device import resolve_device


class WorkerSharder:
    """Deterministic per-worker sampler over an in-memory dataset.

    Modes: ``permute`` (distinct per-worker epoch permutations, §3.2),
    ``replacement`` (common-pool i.i.d. draws, Eq. 2), and
    ``dirichlet`` — heterogeneous (non-IID) shards: each class's samples
    are split across workers by one Dirichlet(α) draw, and every worker
    samples (with replacement) from its own pool. ``dirichlet`` needs
    ``labels``, the (N,) integer class array."""

    def __init__(self, num_samples: int, num_workers: int, *, seed: int = 0,
                 mode: str = "permute", labels=None, alpha: float = 0.5):
        if mode not in ("permute", "replacement", "dirichlet"):
            raise ValueError(f"unknown sampling mode {mode!r}")
        self.n = num_samples
        self.m = num_workers
        self.mode = mode
        self.alpha = float(alpha)
        if mode == "permute":
            self.rngs = [np.random.default_rng(seed * 10_007 + i)
                         for i in range(num_workers)]
            self._perms = [r.permutation(num_samples) for r in self.rngs]
            self._cursor = [0] * num_workers
        elif mode == "dirichlet":
            if labels is None:
                raise ValueError(
                    "mode='dirichlet' needs the (N,) labels array to "
                    "build label-skewed worker pools")
            labels = np.asarray(labels).reshape(-1)
            if labels.shape[0] != num_samples:
                raise ValueError(
                    f"labels cover {labels.shape[0]} samples, dataset "
                    f"has {num_samples}")
            if self.alpha <= 0:
                raise ValueError(f"dirichlet alpha must be > 0, "
                                 f"got {alpha}")
            self._rng = np.random.default_rng(seed * 10_007)
            self._pools = self._dirichlet_pools(labels)
        else:
            # every worker and every step of a block from ONE stream, in
            # one batched ``integers`` call
            self._rng = np.random.default_rng(seed * 10_007)

    def _dirichlet_pools(self, labels) -> list[np.ndarray]:
        """Per-worker index pools: each class's samples dealt to workers
        in proportion to one Dirichlet(α) draw; a worker dealt nothing
        takes one sample from the largest pool."""
        pools = [[] for _ in range(self.m)]
        for cls in np.unique(labels):
            idx = np.flatnonzero(labels == cls)
            idx = self._rng.permutation(idx)
            p = self._rng.dirichlet(np.full(self.m, self.alpha))
            cuts = np.floor(np.cumsum(p) * len(idx)).astype(int)
            start = 0
            for i, end in enumerate(cuts):
                pools[i].extend(idx[start:end])
                start = end
            pools[-1].extend(idx[start:])
        pools = [np.asarray(sorted(pl), np.int64) for pl in pools]
        for i in range(self.m):
            if len(pools[i]) == 0:
                donor = int(np.argmax([len(pl) for pl in pools]))
                pools[i] = pools[donor][-1:]
                pools[donor] = pools[donor][:-1]
        return pools

    def class_fractions(self, labels) -> np.ndarray:
        """(M, C) class composition of each worker's dirichlet pool."""
        if self.mode != "dirichlet":
            raise ValueError("class_fractions describes dirichlet pools")
        labels = np.asarray(labels).reshape(-1)
        classes = np.unique(labels)
        out = np.zeros((self.m, len(classes)))
        for i, pool in enumerate(self._pools):
            for j, cls in enumerate(classes):
                out[i, j] = np.mean(labels[pool] == cls)
        return out

    def next_indices(self, batch: int) -> np.ndarray:
        """(num_workers, batch) int — each worker's next sample indices."""
        if self.mode == "replacement":
            return self._rng.integers(0, self.n, (self.m, batch))
        if self.mode == "dirichlet":
            return np.stack([
                pool[self._rng.integers(0, len(pool), batch)]
                for pool in self._pools])
        out = np.empty((self.m, batch), np.int64)
        for i in range(self.m):
            idx = []
            while len(idx) < batch:
                take = min(batch - len(idx), self.n - self._cursor[i])
                idx.extend(
                    self._perms[i][self._cursor[i]:self._cursor[i] + take])
                self._cursor[i] += take
                if self._cursor[i] >= self.n:  # a new permutation per epoch
                    self._perms[i] = self.rngs[i].permutation(self.n)
                    self._cursor[i] = 0
            out[i] = np.asarray(idx)
        return out

    def next_index_block(self, steps: int, batch: int) -> np.ndarray:
        """(steps, num_workers, batch) int — a phase block of indices; in
        replacement mode ONE batched draw, equal to ``steps`` successive
        :meth:`next_indices` calls (numpy fills in C order)."""
        if self.mode == "replacement":
            return self._rng.integers(0, self.n, (steps, self.m, batch))
        return np.stack([self.next_indices(batch) for _ in range(steps)])


def worker_batches(stream, num_workers: int):
    """Group a single-batch iterator into (num_workers, ...) stacked
    batches, one batch per worker per step; ends (dropping a partial
    group) when the stream ends."""
    while True:
        group = []
        for _ in range(num_workers):
            try:
                group.append(next(stream))
            except StopIteration:
                return
        yield np.stack(group, axis=0)


class DeviceDataset:
    """An in-memory dataset resident on ``device``; the engine gathers
    each step's batches there from index blocks.

    arrays: a tree of (N, ...) arrays or tensors, moved to ``device``
    (default ``"cuda"``) once, here. Pass either ``batch_size`` (with
    ``mode`` / ``seed``) to sample through :class:`WorkerSharder`, or
    ``indices``, a precomputed (S, M, B) or (S, M) int array, for
    paired-draw protocols (the paper's §3.1 curves)."""

    def __init__(self, arrays, num_workers: int, *, batch_size: int = 0,
                 seed: int = 0, mode: str = "replacement", indices=None,
                 labels=None, alpha: float = 0.5, device="cuda"):
        self.device = resolve_device(device)
        # tensors already on the device are shared, not copied; numpy
        # arrays are copied, so the caller's buffers stay the caller's
        self.arrays = tree_map(
            lambda a: a.to(self.device) if isinstance(a, torch.Tensor)
            else torch.tensor(np.asarray(a), device=self.device), arrays)
        sizes = {x.shape[0] for x in tree_flatten(self.arrays)[0]}
        if len(sizes) != 1:
            raise ValueError(f"inconsistent leading dims {sizes}")
        self.num_samples = sizes.pop()
        self.num_workers = num_workers
        self.batch_size = batch_size
        self._indices = None
        self._cursor = 0
        self.sharder = None
        if indices is None:
            if batch_size <= 0:
                raise ValueError("batch_size required without indices")
            self.sharder = WorkerSharder(self.num_samples, num_workers,
                                         seed=seed, mode=mode,
                                         labels=labels, alpha=alpha)
        else:
            self._indices = np.asarray(indices)
            if (self._indices.ndim not in (2, 3)
                    or self._indices.shape[1] != num_workers):
                raise ValueError(
                    f"indices must be (steps, {num_workers}[, batch]), "
                    f"got {self._indices.shape}")

    @property
    def num_steps(self) -> int | None:
        """Steps left in the precomputed index list (the cursor advances
        across runs); None for an unbounded sampler."""
        if self._indices is None:
            return None
        return len(self._indices) - self._cursor

    def index_block(self, steps: int) -> np.ndarray:
        """(steps, M, B) (or (steps, M) for one-sample batches) int32
        sample indices of the next phase block."""
        if self._indices is not None:
            blk = self._indices[self._cursor:self._cursor + steps]
            if len(blk) != steps:
                raise ValueError(f"index list exhausted: {steps} steps "
                                 f"asked, {len(blk)} left")
            self._cursor += steps
            return np.asarray(blk, np.int32)
        return self.sharder.next_index_block(
            steps, self.batch_size).astype(np.int32)


class Prefetcher:
    """Double-buffered background staging: a daemon thread materialises
    the wrapped iterator's items up to ``depth`` ahead of the consumer.
    The producer's exceptions re-raise at the consumer's ``next()``.
    Call :meth:`close` (or exhaust the iterator) if the consumer stops
    early, so that the producer exits instead of blocking on a full
    queue with staged blocks held."""

    _END = object()

    def __init__(self, it, *, depth: int = 2):
        self._q = queue.Queue(maxsize=max(depth, 1))
        self._err = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._work, args=(iter(it),), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _work(self, it):
        try:
            for item in it:
                if not self._put(item):
                    return
        except BaseException as e:  # re-raised in __next__
            self._err = e
        finally:
            self._put(self._END)

    def close(self):
        """Stop the producer and drop any staged items."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is self._END:
            # stop BEFORE raising, so that a consumer that catches the
            # producer's error and calls next() again gets StopIteration
            # instead of blocking on the empty queue
            self._stop.set()
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        return item
