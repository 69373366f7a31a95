"""noHTL — the paper's baseline distributed procedure (Algorithm 2); the
port of ``repro.core.nohtl``.

The subset of GTL without the second (GreedyTL) training phase:

  Step 0: local base learners (identical to GTL's Step 0).
  Consensus variant (noHTL_mu): all models go to a single *models collector*,
      which averages them and broadcasts the mean back (2k(s-1)d traffic).
  Majority-voting variant (noHTL_mv): all models go to all locations and each
      prediction is the most frequent class over the L models (ks(s-1)d
      traffic).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import base_learner as bl
from repro_torch.core.aggregation import consensus_mean, majority_vote
from repro_torch.core.gtl import (StackedLinear, predict_linear,
                                  shard_tensors, train_base_models)


class NoHTLResult(NamedTuple):
    base: StackedLinear           # h^(0) per location
    sources: StackedLinear        # what was exchanged (may be corrupted)
    consensus_flat: torch.Tensor  # (k, d+1) mean model (noHTL_mu)


def run_nohtl(shards, k: int, svm_lam: float = 1e-4, svm_lr: float = 0.01,
              svm_steps: int = 600, corrupt_fn=None,
              device="cuda") -> NoHTLResult:
    """Algorithm 2 on `LocationShards`, on `device`.  `corrupt_fn(models)
    -> models` (if given) corrupts the exchanged base models (Section 7):
    the collector's mean and the majority vote run over what was
    exchanged."""
    with bl.fp32_matmuls():
        X, y, mask = shard_tensors(shards, device)
        base = train_base_models(X, y, mask, k, lam=svm_lam, lr=svm_lr,
                                 steps=svm_steps)
        sources = corrupt_fn(base) if corrupt_fn is not None else base
        consensus = consensus_mean(sources.augmented())  # (k, d+1)
    return NoHTLResult(base=base, sources=sources, consensus_flat=consensus)


def predict_consensus(result: NoHTLResult, X):
    return predict_linear(result.consensus_flat, X)


def predict_mv(result: NoHTLResult, X, n_classes: int):
    preds = predict_linear(result.sources.augmented(), X)  # (L, m)
    return majority_vote(preds, n_classes)
