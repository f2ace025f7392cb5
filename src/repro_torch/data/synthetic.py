"""Deterministic synthetic datasets, numpy only.

A copy of the reference package's generators (the port imports nothing
of it): the same seed gives the identical numpy arrays, so the port and
the reference can be fed the same draws.

- ``token_stream``: markov-ish token sequences with learnable structure
  (next token = a fixed random permutation of the current one, plus
  noise), so LM training loss measurably decreases.
- ``mnist_like``: class-conditional Gaussian blobs rendered as 28x28
  images, the stand-in for the paper's §3.2 MNIST (10 classes,
  separable but noisy).
- ``convex_dataset``: least-squares / logistic-regression data with a
  controllable gradient-variance envelope (sparse features: large rho;
  dense features with label noise: small rho).
"""
from __future__ import annotations

import numpy as np


def token_stream(vocab: int, batch: int, seq: int, *, seed: int = 0,
                 noise: float = 0.1):
    """Infinite iterator of (batch, seq) int32 token arrays."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(vocab)
    while True:
        t = rng.integers(0, vocab, size=(batch, 1))
        cols = [t[:, 0]]
        for _ in range(seq - 1):
            nxt = perm[cols[-1]]
            flip = rng.random(batch) < noise
            nxt = np.where(flip, rng.integers(0, vocab, batch), nxt)
            cols.append(nxt)
        yield np.stack(cols, axis=1).astype(np.int32)


def mnist_like(num: int, *, seed: int = 0, image_size: int = 28,
               num_classes: int = 10, noise: float = 0.35,
               proto_seed: int = 777):
    """(images (N,28,28,1) float32, labels (N,) int32).

    Class prototypes come from ``proto_seed`` (shared between train and
    test splits); ``seed`` only controls sample noise/labels."""
    rng = np.random.default_rng(seed)
    rng_p = np.random.default_rng(proto_seed)
    protos = rng_p.normal(0, 1, size=(num_classes, image_size, image_size, 1))
    # low-pass the prototypes so they look like strokes, not static
    k = np.ones((3, 3)) / 9.0
    for c in range(num_classes):
        img = protos[c, :, :, 0]
        for _ in range(2):
            img = _conv2_same(img, k)
        protos[c, :, :, 0] = img
    labels = rng.integers(0, num_classes, size=num)
    images = protos[labels] + noise * rng.normal(0, 1, size=(num, image_size, image_size, 1))
    return images.astype(np.float32), labels.astype(np.int32)


def _conv2_same(img, k):
    from numpy.lib.stride_tricks import sliding_window_view
    p = k.shape[0] // 2
    pad = np.pad(img, p)
    win = sliding_window_view(pad, k.shape)
    return np.einsum("ijkl,kl->ij", win, k)


def convex_dataset(kind: str, num: int, dim: int, *, sparsity: float = 1.0,
                   noise: float = 0.1, seed: int = 0, w_scale: float = 1.0):
    """Returns (X (N,D), y (N,), w_true (D,)), all float32.

    sparsity < 1 zeroes out a random (1-sparsity) fraction of features per
    sample (tf-idf-like): per-sample gradients then live in small random
    subspaces, so the gradient variance grows fast with ||w-w*||."""
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, size=(num, dim))
    if sparsity < 1.0:
        mask = rng.random((num, dim)) < sparsity
        # keep at least one feature per row
        empty = ~mask.any(axis=1)
        mask[empty, rng.integers(0, dim, empty.sum())] = True
        X = X * mask / np.sqrt(max(sparsity, 1e-12))
    w_true = w_scale * rng.normal(0, 1, size=dim) / np.sqrt(dim)
    z = X @ w_true
    if kind == "ls":
        y = z + noise * rng.normal(0, 1, size=num)
    elif kind == "lr":
        p = 1.0 / (1.0 + np.exp(-z / max(np.std(z), 1e-9)))
        y = np.where(rng.random(num) < p, 1.0, -1.0)
        if noise > 0:  # label flips
            flip = rng.random(num) < noise
            y = np.where(flip, -y, y)
    else:
        raise ValueError(kind)
    return X.astype(np.float32), y.astype(np.float32), w_true.astype(np.float32)
