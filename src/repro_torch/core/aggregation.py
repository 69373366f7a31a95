"""Model-aggregation operators (paper Sections 4.2 step 4, 4.3, 10) — the
port of ``repro.core.aggregation``.

- consensus_mean:   h = (1/L) sum_l h_l  (the mu- variants)
- majority voting:  most frequent class over the per-model predictions
                    (the mv- variants)
- ema_merge:        dynamic-scenario merge, Eq. 16.

A stacked model is a tensor or a NamedTuple of tensors, each with the
location axis first.
"""
from __future__ import annotations

import torch


def _tree_map(fn, tree, *rest):
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    return type(tree)(*map(fn, tree, *rest))


def consensus_mean(stacked_models, weight_mask=None):
    """Mean over the leading location axis of every leaf.

    weight_mask: optional (L,) weights (e.g. to exclude absent locations in
    the dynamic scenario); normalised internally.
    """
    if weight_mask is None:
        return _tree_map(lambda a: a.mean(0), stacked_models)
    w = weight_mask / weight_mask.sum().clamp(min=1e-12)

    def reduce(a):
        return (a * w.reshape((-1,) + (1,) * (a.ndim - 1))).sum(0)

    return _tree_map(reduce, stacked_models)


def majority_vote(predictions, n_classes: int, valid_mask=None):
    """predictions: (L, m) int class labels -> (m,) most frequent label
    (the lowest label on a tie, as ``jnp.argmax`` picks)."""
    onehot = torch.nn.functional.one_hot(predictions.long(),
                                         n_classes).float()  # (L, m, k)
    if valid_mask is not None:
        onehot = onehot * valid_mask[:, None, None]
    return onehot.sum(0).argmax(-1)


def ema_merge(old_model, new_model, alpha: float):
    """Eq. 16: m_new = alpha * m_old + (1 - alpha) * m'."""
    return _tree_map(lambda o, n: alpha * o + (1.0 - alpha) * n,
                     old_model, new_model)
