"""Location partitioners — the paper's three data-distribution regimes.

A copy of the numpy-only ``repro.data.partition`` (the port imports nothing
of the JAX package).

- `partition_uniform`        : Fig. 2a — every location sees the same,
                               balanced class distribution.
- `partition_class_unbalanced`: Fig. 2b — classes are globally skewed but the
                               skew is identical at every location
                               ("class unbalance"; also the native HAPT case).
- `partition_node_unbalanced` : Fig. 2c/d — each location holds 70% of one
                               "hot" class and 30% spread over the rest; the
                               hot class rotates so each class is hot at
                               n_locations / n_classes locations
                               ("node unbalance").

All partitioners return fixed-shape padded per-location arrays so that the
whole distributed procedure can be vmapped over locations.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class LocationShards(NamedTuple):
    """Padded per-location training shards.

    X:    (L, m_max, d) float32
    y:    (L, m_max)    int32   (0 on padded rows)
    mask: (L, m_max)    float32 (1 = real sample, 0 = padding)
    """

    X: np.ndarray
    y: np.ndarray
    mask: np.ndarray

    @property
    def n_locations(self):
        return self.X.shape[0]

    def location(self, l):
        m = int(self.mask[l].sum())
        return self.X[l, :m], self.y[l, :m]

    def counts(self):
        return self.mask.sum(axis=1).astype(int)


def _pack(per_loc_idx, X, y, pad_to=None):
    X = np.asarray(X)
    y = np.asarray(y)
    L = len(per_loc_idx)
    m_max = pad_to or max(len(ix) for ix in per_loc_idx)
    d = X.shape[1]
    Xo = np.zeros((L, m_max, d), dtype=np.float32)
    yo = np.zeros((L, m_max), dtype=np.int32)
    mo = np.zeros((L, m_max), dtype=np.float32)
    for l, ix in enumerate(per_loc_idx):
        ix = np.asarray(ix)[:m_max]
        Xo[l, : len(ix)] = X[ix]
        yo[l, : len(ix)] = y[ix]
        mo[l, : len(ix)] = 1.0
    return LocationShards(Xo, yo, mo)


def partition_uniform(rng: np.random.Generator, X, y, n_locations: int,
                      pad_to=None) -> LocationShards:
    """Fig. 2a: shuffle globally, deal round-robin -> per-location class
    distributions match the global one."""
    n = len(y)
    perm = rng.permutation(n)
    per_loc = [perm[l::n_locations] for l in range(n_locations)]
    return _pack(per_loc, X, y, pad_to)


def partition_class_unbalanced(rng: np.random.Generator, X, y,
                               n_locations: int, n_classes: int,
                               minor_classes=(2, 5, 6, 7, 8),
                               minor_keep: float = 0.35,
                               pad_to=None) -> LocationShards:
    """Fig. 2b: sub-sample the minor classes globally (every location sees the
    same skew), then deal uniformly."""
    y = np.asarray(y)
    keep = np.ones(len(y), dtype=bool)
    for c in minor_classes:
        idx = np.where(y == c)[0]
        drop = rng.permutation(idx)[int(round(len(idx) * minor_keep)):]
        keep[drop] = False
    kept = np.where(keep)[0]
    perm = kept[rng.permutation(len(kept))]
    per_loc = [perm[l::n_locations] for l in range(n_locations)]
    return _pack(per_loc, X, y, pad_to)


def partition_node_unbalanced(rng: np.random.Generator, X, y,
                              n_locations: int, n_classes: int,
                              hot_frac: float = 0.7,
                              samples_per_location: int | None = None,
                              pad_to=None) -> LocationShards:
    """Fig. 2c/d: location l is "hot" for class l % n_classes; 70% of its
    samples come from the hot class, 30% spread over the others."""
    y = np.asarray(y)
    n = len(y)
    by_class = [list(rng.permutation(np.where(y == c)[0])) for c in range(n_classes)]
    m = samples_per_location or n // n_locations
    n_hot = int(round(m * hot_frac))
    n_cold_each = max(1, (m - n_hot) // (n_classes - 1))

    per_loc = []
    cursors = [0] * n_classes

    def take(c, count):
        pool = by_class[c]
        out = []
        for _ in range(count):
            out.append(pool[cursors[c] % len(pool)])
            cursors[c] += 1
        return out

    for l in range(n_locations):
        hot = l % n_classes
        idx = take(hot, n_hot)
        for c in range(n_classes):
            if c != hot:
                idx += take(c, n_cold_each)
        per_loc.append(np.asarray(idx))
    return _pack(per_loc, X, y, pad_to)
