"""Performance indices from the paper (Section 6.1) — the port of the
paper's half of ``repro.training.metrics`` (the language-model metrics
wait for the training slice).

- precision (Eq. 3): fraction of correct predictions (as defined in the paper,
  this is the overall accuracy);
- recall (Eq. 4): per-class accuracy averaged over classes (macro recall);
- F-measure (Eq. 5): harmonic mean of the two;
- PPG (Eq. 6): prediction performance gain of step j over the step-0 local
  model, rho = 1 - (1 - F_j) / (1 - F_0).

`y_pred` may carry leading batch axes over the (m,) sample axis of
`y_true` (one prediction vector per model, where the reference vmaps); the
indices then come out with those leading axes.
"""
from __future__ import annotations

import torch


def _mask(y_true, sample_mask):
    if sample_mask is None:
        return torch.ones(y_true.shape, dtype=torch.float32,
                          device=y_true.device)
    return sample_mask.float()


def precision_index(y_true, y_pred, sample_mask=None):
    """Eq. 3: (1/m) sum I(y_i, y_hat_i)."""
    correct = (y_true == y_pred).float()
    if sample_mask is None:
        return correct.mean(-1)
    return (correct * sample_mask).sum(-1) / sample_mask.sum().clamp(min=1.0)


def _per_class(y_true, y_pred, n_classes, sample_mask):
    """(r_c (..., k) per-class correct fraction, n_c (k,) class counts)."""
    mask = _mask(y_true, sample_mask)
    correct = (y_true == y_pred).float() * mask                   # (..., m)
    in_c = torch.nn.functional.one_hot(
        y_true.long(), n_classes).float() * mask[:, None]         # (m, k)
    n_c = in_c.sum(0)
    r_c = (correct @ in_c) / n_c.clamp(min=1.0)
    return r_c, n_c


def recall_index(y_true, y_pred, n_classes: int, sample_mask=None):
    """Eq. 4: per-class correct fraction, averaged over the classes present."""
    r_c, n_c = _per_class(y_true, y_pred, n_classes, sample_mask)
    present = (n_c > 0).float()
    return (r_c * present).sum(-1) / present.sum().clamp(min=1.0)


def f_measure(y_true, y_pred, n_classes: int, sample_mask=None):
    """Eq. 5: harmonic mean of precision and recall indices."""
    p = precision_index(y_true, y_pred, sample_mask)
    r = recall_index(y_true, y_pred, n_classes, sample_mask)
    return 2.0 * p * r / (p + r).clamp(min=1e-12)


def per_class_accuracy(y_true, y_pred, n_classes: int, sample_mask=None):
    """Per-class correct fraction (Figs. 4/6/8/10)."""
    return _per_class(y_true, y_pred, n_classes, sample_mask)[0]


def ppg(f_step, f_base):
    """Eq. 6: rho = 1 - (1 - F_j)/(1 - F_0); negative => worse than local."""
    f_step = torch.as_tensor(f_step, dtype=torch.float32)
    f_base = torch.as_tensor(f_base, dtype=torch.float32)
    return 1.0 - (1.0 - f_step) / (1.0 - f_base).clamp(min=1e-12)
