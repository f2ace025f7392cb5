"""Gossip topologies: mixing-matrix averaging as a scenario axis.

The counterpart of ``repro.topology``. Every averaging event becomes ONE
application of a doubly-stochastic mixing matrix,
``w_i <- sum_j W_ij w_j``, over a communication graph; each event
contracts the consensus deviation by at most the second-largest
eigenvalue modulus (SLEM) of W. The builders (numpy, float64) and their
eager validation are the reference's:

  - ``full``         W = 11ᵀ/M; the engine lowers it to the mean path.
  - ``ring``         degree-2 cycle, M >= 3.
  - ``torus``        2-D periodic a×b grid, composite M.
  - ``hypercube``    neighbours at i XOR 2^k, M a power of two.
  - ``groups``       block-diagonal group means; lowers to the
                     group-mean path.
  - ``gossip_pairs`` a random perfect matching per event, drawn from
                     (decision key, step) by :func:`gossip_matrix` —
                     the reference's matchings, bit for bit.
  - ``disconnected`` W = I.

:meth:`Topology.mixing_matrix` hands the engine an f32 (M, M) tensor on
the plane's device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import cached_property

import numpy as np
import torch

from repro_torch import rng

KINDS = ("full", "ring", "torus", "hypercube", "groups", "gossip_pairs",
         "disconnected")

#: kinds whose events need the generic W @ plane mix; ``full`` and
#: ``groups`` lower to the engine's mean / group-mean paths instead
MIX_KINDS = ("ring", "torus", "hypercube", "gossip_pairs", "disconnected")

_GOSSIP_SALT = 0x676F73  # "gos": decorrelates the per-event matching
#                        # stream from the stochastic schedule's
#                        # fold_in(key, step) Bernoulli stream


def gossip_matrix(key, step: int, num_workers: int,
                  device=None) -> torch.Tensor:
    """The per-event gossip mixing matrix: a uniformly random perfect
    matching of the M workers, each pair averaging — W = ½(I + P), P the
    matching's permutation matrix — drawn from
    ``fold_in(fold_in(key, salt), step)`` as the reference draws it."""
    if num_workers % 2:
        raise ValueError(f"gossip_pairs needs an even worker count, "
                         f"got {num_workers}")
    k = rng.fold_in(rng.fold_in(key, _GOSSIP_SALT), step)
    perm = rng.permutation(k, num_workers)
    a, b = perm[0::2], perm[1::2]
    partner = torch.zeros(num_workers, dtype=torch.int64)
    partner[a] = b
    partner[b] = a
    eye = torch.eye(num_workers, dtype=torch.float32)
    return (0.5 * (eye + eye[partner])).to(device)


def _metropolis(adj: np.ndarray) -> np.ndarray:
    """Metropolis–Hastings weights for a symmetric adjacency (no self
    loops): W_ij = 1/(1 + max(deg_i, deg_j)) on edges, diagonal fills
    each row to 1. Symmetric and doubly stochastic for any graph."""
    deg = adj.sum(1)
    W = np.where(adj, 1.0 / (1.0 + np.maximum(deg[:, None], deg[None, :])),
                 0.0)
    np.fill_diagonal(W, 1.0 - W.sum(1))
    return W


@dataclass(frozen=True, eq=False)
class Topology:
    """A communication graph and its doubly-stochastic mixing matrix:
    ``matrix`` is the static (M, M) float64 W, or None for
    ``gossip_pairs`` (sampled per event). Build through the
    classmethods, which validate the worker count eagerly."""
    kind: str
    num_workers: int
    matrix: np.ndarray | None = field(repr=False)
    groups: int = 1

    # ---- builders --------------------------------------------------------
    @classmethod
    def full(cls, num_workers: int) -> "Topology":
        if num_workers < 1:
            raise ValueError(f"full topology needs >= 1 worker, "
                             f"got {num_workers}")
        W = np.full((num_workers, num_workers), 1.0 / num_workers)
        return cls("full", num_workers, W)

    @classmethod
    def ring(cls, num_workers: int) -> "Topology":
        if num_workers < 3:
            raise ValueError(
                f"ring topology needs >= 3 workers (got {num_workers}): "
                "with 2 the two neighbors coincide — use 'full' (the "
                "pair mean) instead")
        m = num_workers
        i = np.arange(m)
        adj = np.zeros((m, m), bool)
        adj[i, (i + 1) % m] = adj[i, (i - 1) % m] = True
        return cls("ring", m, _metropolis(adj))

    @staticmethod
    def torus_sides(num_workers: int) -> tuple[int, int]:
        """The a×b factorization a torus uses: a is the largest divisor
        of M with 2 <= a <= √M. Raises for prime / too-small M."""
        m = num_workers
        for a in range(math.isqrt(m), 1, -1):
            if m % a == 0:
                return a, m // a
        raise ValueError(
            f"torus topology needs a composite worker count that "
            f"factors into a 2-D grid (got {m}): use 'ring' for a "
            "1-D cycle instead")

    @classmethod
    def torus(cls, num_workers: int) -> "Topology":
        a, b = cls.torus_sides(num_workers)
        m = num_workers
        adj = np.zeros((m, m), bool)
        for n in range(m):
            i, j = divmod(n, b)
            for ni, nj in (((i + 1) % a, j), ((i - 1) % a, j),
                           (i, (j + 1) % b), (i, (j - 1) % b)):
                nb = ni * b + nj
                if nb != n:
                    adj[n, nb] = True
        return cls("torus", m, _metropolis(adj))

    @classmethod
    def hypercube(cls, num_workers: int) -> "Topology":
        m = num_workers
        if m < 2 or m & (m - 1):
            raise ValueError(
                f"hypercube (exponential-graph) topology needs a "
                f"power-of-two worker count >= 2, got {m}")
        adj = np.zeros((m, m), bool)
        for n in range(m):
            for k in range(m.bit_length() - 1):
                adj[n, n ^ (1 << k)] = True
        return cls("hypercube", m, _metropolis(adj))

    @classmethod
    def blocks(cls, num_workers: int, groups: int) -> "Topology":
        """Block-diagonal W: full mean within ``groups`` contiguous
        worker groups (spectral gap 0 for groups > 1)."""
        m = num_workers
        if groups < 1 or m % groups:
            raise ValueError(
                f"groups topology needs a group count >= 1 dividing the "
                f"worker count, got groups={groups} for M={m}")
        per = m // groups
        W = np.zeros((m, m))
        for g in range(groups):
            W[g * per:(g + 1) * per, g * per:(g + 1) * per] = 1.0 / per
        return cls("groups", m, W, groups=groups)

    @classmethod
    def gossip_pairs(cls, num_workers: int) -> "Topology":
        m = num_workers
        if m < 2 or m % 2:
            raise ValueError(
                f"gossip_pairs topology pairs the workers into a "
                f"perfect matching and needs an even count >= 2, "
                f"got {m}")
        return cls("gossip_pairs", m, None)

    @classmethod
    def disconnected(cls, num_workers: int) -> "Topology":
        if num_workers < 1:
            raise ValueError(f"disconnected topology needs >= 1 worker, "
                             f"got {num_workers}")
        return cls("disconnected", num_workers, np.eye(num_workers))

    @classmethod
    def build(cls, kind: str, num_workers: int, *,
              groups: int | None = None) -> "Topology":
        """CLI dispatcher: one builder per kind, same eager validation.
        ``groups`` defaults to 2 only when omitted."""
        if kind not in KINDS:
            raise ValueError(f"unknown topology kind {kind!r}; "
                             f"pick one of {KINDS}")
        if kind == "groups":
            return cls.blocks(num_workers, 2 if groups is None else groups)
        return getattr(cls, kind)(num_workers)

    # ---- spectrum / communication ----------------------------------------
    def expected_matrix(self) -> np.ndarray:
        """E[W] in float64: the matrix itself for deterministic kinds;
        for gossip pairs ½I + ½(J−I)/(M−1)."""
        if self.matrix is not None:
            return np.asarray(self.matrix, np.float64)
        m = self.num_workers
        return (0.5 * np.eye(m)
                + 0.5 * (np.ones((m, m)) - np.eye(m)) / (m - 1))

    @cached_property
    def slem(self) -> float:
        """Second-largest eigenvalue modulus of E[W]."""
        ev = np.linalg.eigvalsh(self.expected_matrix())  # ascending
        if len(ev) < 2:
            return 0.0
        return float(min(1.0, max(abs(ev[0]), ev[-2], 0.0)))

    @cached_property
    def spectral_gap(self) -> float:
        """1 - SLEM of the expected mixing matrix."""
        return 1.0 - self.slem

    def effective_spectral_gap(self, alive) -> float:
        """Spectral gap of the expected mixing matrix restricted to the
        alive workers: off-diagonal mass to or from dead workers dropped
        and refilled on the diagonal, the SLEM gap of the alive-alive
        block (1.0 for a single alive worker)."""
        a = (np.asarray(alive, np.float64).reshape(-1) > 0)
        if a.shape[0] != self.num_workers:
            raise ValueError(f"alive has {a.shape[0]} rows, topology "
                             f"has {self.num_workers}")
        idx = np.flatnonzero(a)
        if len(idx) == 0:
            raise ValueError("effective_spectral_gap needs >= 1 alive "
                             "worker")
        if len(idx) == 1:
            return 1.0
        W = self.expected_matrix()
        af = a.astype(np.float64)
        off = W * (1.0 - np.eye(self.num_workers)) * af[:, None] * af[None, :]
        Wm = off + np.diag(1.0 - off.sum(1))
        ev = np.linalg.eigvalsh(Wm[np.ix_(idx, idx)])
        return 1.0 - float(min(1.0, max(abs(ev[0]), ev[-2], 0.0)))

    @cached_property
    def comm_degree(self) -> float:
        """Mean per-event messages per worker (gossip pairs: 1)."""
        if self.kind == "gossip_pairs":
            return 1.0
        W = self.expected_matrix()
        off = (np.abs(W) > 1e-12) & ~np.eye(self.num_workers, dtype=bool)
        return float(off.sum(1).mean())

    # ---- per-event matrix ------------------------------------------------
    def mixing_matrix(self, step: int = 0, key=None,
                      device=None) -> torch.Tensor:
        """This event's W as an (M, M) float32 tensor on ``device``.
        Deterministic kinds ignore ``(step, key)``; ``gossip_pairs``
        samples the matching from them."""
        if self.kind == "gossip_pairs":
            if key is None:
                raise ValueError("gossip_pairs needs the decision key to "
                                 "sample a matching")
            return gossip_matrix(key, step, self.num_workers, device)
        return torch.tensor(self.matrix, dtype=torch.float32, device=device)


def mix_tree(worker_tree, W):
    """Apply the mixing matrix along the worker axis of every leaf — the
    tree twin of ``W @ plane``: each leaf's rows in float32, mixed with
    the plane twin's arithmetic (:func:`repro_torch.kernels.ref._mix`:
    each output row summed over j in order, one rounded multiply and add
    a term), cast back to the leaf dtype."""
    from repro_torch.core.flat import tree_map
    from repro_torch.kernels.ref import _mix

    def mx(x):
        w = torch.as_tensor(W).to(x.device, torch.float32)
        out = _mix(w, x.float().reshape(x.shape[0], -1))
        return out.reshape(x.shape).to(x.dtype)
    return tree_map(mx, worker_tree)


def comm_bytes(topology: Topology, events: int, p: int,
               wire: str = "f32") -> int:
    """Bytes ONE worker puts on the wire for ``events`` averaging events
    over ``topology``, shipping (1, P) rows in the ``wire`` format: the
    ``adaptive_bytes`` schedule's currency."""
    from repro_torch.core.compress import wire_row_bytes
    return int(round(events * topology.comm_degree)) * wire_row_bytes(
        p, wire)
