"""Synthetic stand-ins for the paper's HAPT and MNIST-HOG datasets — the
port of ``repro.data.synth``.

The original files are not available offline, so we generate statistically
matched Gaussian class-cluster data:

- HAPT-like: d=561 features, k=12 classes (6 basic activities + 6 postural
  transitions), skewed class pdf as in Fig. 1 of the paper (static/dynamic
  postures far more frequent than transitions), 21 locations/users.
- MNIST-HOG-like: d=324 HOG features, k=10 digits, 30 locations/users.

Each class c draws x ~ N(mu_c, sigma^2 I) with ||mu_c - mu_c'|| controlled by
`separation`.  Draws come from an explicit ``torch.Generator`` on the
device the data is made on; the streams differ from ``jax.random``'s, so
tests that compare the two packages pass the reference's data across.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SynthSpec(NamedTuple):
    name: str
    n_features: int
    n_classes: int
    n_locations: int
    n_samples: int
    separation: float = 3.0
    noise: float = 1.0
    class_pdf: tuple | None = None  # skewed class frequencies (Fig. 1)


# Class pdf shaped like the paper's Fig. 1: 6 frequent basic activities,
# 6 rare postural transitions.
_HAPT_PDF = tuple([0.14] * 6 + [0.0267] * 6)

HAPT_LIKE = SynthSpec(
    name="hapt",
    n_features=561,
    n_classes=12,
    n_locations=21,
    n_samples=10929,
    separation=4.6,
    noise=1.0,
    class_pdf=_HAPT_PDF,
)

MNIST_HOG_LIKE = SynthSpec(
    name="mnist_hog",
    n_features=324,
    n_classes=10,
    n_locations=30,
    n_samples=12000,
    separation=4.2,
    noise=1.0,
    class_pdf=None,  # balanced by default; partitioners skew it
)


def make_dataset(generator: torch.Generator, spec: SynthSpec,
                 n_samples: int | None = None, class_pdf=None):
    """Returns (X (N, d) float32, y (N,) int32) on the generator's device."""
    n = n_samples or spec.n_samples
    pdf = class_pdf if class_pdf is not None else spec.class_pdf
    dev = generator.device
    mus = torch.randn(spec.n_classes, spec.n_features, generator=generator,
                      device=dev)
    mus = mus / torch.linalg.norm(mus, dim=1, keepdim=True) * spec.separation
    if pdf is None:
        p = torch.ones(spec.n_classes, device=dev)
    else:
        p = torch.tensor(pdf, dtype=torch.float32, device=dev)
    y = torch.multinomial(p / p.sum(), n, replacement=True,
                          generator=generator)
    x = mus[y] + spec.noise * torch.randn(n, spec.n_features,
                                          generator=generator, device=dev)
    return x.float(), y.to(torch.int32)


def train_test_split(generator: torch.Generator, X, y,
                     test_frac: float = 0.3):
    """The paper's 70-30 hold-out (Section 6.1)."""
    n = X.shape[0]
    perm = torch.randperm(n, generator=generator, device=generator.device)
    n_test = int(round(n * test_frac))
    test, train = perm[:n_test], perm[n_test:]
    return (X[train], y[train]), (X[test], y[test])


def numpy_class_pdf(y, k):
    y = np.asarray(y)
    counts = np.bincount(y, minlength=k).astype(np.float64)
    return counts / counts.sum()
