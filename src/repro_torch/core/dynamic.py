"""Dynamic scenario — paper Section 10; the port of ``repro.core.dynamic``.

Devices arrive in batches of `s` per learning phase.  A permanent device (the
"totem" G) stores the running aggregate model m.  Each phase:

  1. the s arriving devices receive m from G,
  2. they run the GTL procedure among themselves, *including m as an
     additional transfer source*,
  3. the phase consensus m' is merged into the running model with the
     exponential moving average of Eq. 16:  m_new = alpha m_old + (1-alpha) m'.

noHTL in the same setting simply averages the arrivals' base models with the
running model (the arrivals do not re-train).

Thanks to linear base learners every aggregate stays a (k, d+1) linear model
(see core.gtl.flatten_gtl), so phases compose exactly.  Phases run over the
first L - L % s locations: a tail of fewer than s arrivals is dropped, as in
the reference.  Each GTL phase is one batched GreedyTL fit of s * k
problems (one Gram launch and kappa scores launches on the cuda route).
The reference's JAX key goes: it only seeds bagging, which this path does
not use.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import base_learner as bl
from repro_torch.core import gtl as gtl_mod
from repro_torch.core.aggregation import consensus_mean, ema_merge
from repro_torch.core.gtl import StackedLinear


class DynamicTrace(NamedTuple):
    # (n_phases, k, d+1) running aggregate after each phase
    models: torch.Tensor
    # (n_phases, s, k, kappa) each GTL phase's GreedyTL picks (None for noHTL)
    selected: torch.Tensor | None = None


def _with_totem(base: StackedLinear, totem_flat):
    """Append the running aggregate model as an extra linear source."""
    return StackedLinear(
        W=torch.cat([base.W, totem_flat[None, :, :-1]], dim=0),
        b=torch.cat([base.b, totem_flat[None, :, -1]], dim=0),
    )


def _phases(shards, s: int, device):
    """(start, X, y, mask) of each phase's arrivals, on `device`."""
    X, y, mask = gtl_mod.shard_tensors(shards, device)
    L = X.shape[0]
    for start in range(0, L - (L % s), s):
        sl = slice(start, start + s)
        yield start, X[sl], y[sl], mask[sl]


def run_dynamic_gtl(shards, k: int, arrivals_per_phase: int,
                    alpha: float = 0.5, kappa: int = 64, lam: float = 3.0,
                    svm_kw: dict | None = None,
                    eval_fn: Callable | None = None, kernel: str = "cuda",
                    device="cuda"):
    """Process locations in arrival order, `arrivals_per_phase` at a time.

    Returns (DynamicTrace, list of eval_fn outputs per phase).
    """
    svm_kw = svm_kw or {}
    d1 = shards.X.shape[-1] + 1
    traces, picks, evals = [], [], []
    with bl.fp32_matmuls():
        totem = torch.zeros(k, d1, device=device)
        for start, X, y, mask in _phases(shards, arrivals_per_phase, device):
            base = gtl_mod.train_base_models(X, y, mask, k, **svm_kw)
            first_phase = start == 0
            sources = base if first_phase else _with_totem(base, totem)
            mdl, flat = gtl_mod.gtl_step2_all(X, y, mask, sources, k, kappa,
                                              lam, kernel)
            m_prime = consensus_mean(flat)
            totem = m_prime if first_phase else ema_merge(totem, m_prime,
                                                          alpha)
            traces.append(totem)
            picks.append(mdl.selected)
            if eval_fn is not None:
                evals.append(eval_fn(totem))
    return DynamicTrace(torch.stack(traces), torch.stack(picks)), evals


def run_dynamic_nohtl(shards, k: int, arrivals_per_phase: int,
                      alpha: float = 0.5, svm_kw: dict | None = None,
                      eval_fn: Callable | None = None, device="cuda"):
    svm_kw = svm_kw or {}
    d1 = shards.X.shape[-1] + 1
    traces, evals = [], []
    with bl.fp32_matmuls():
        totem = torch.zeros(k, d1, device=device)
        for start, X, y, mask in _phases(shards, arrivals_per_phase, device):
            base = gtl_mod.train_base_models(X, y, mask, k, **svm_kw)
            m_prime = consensus_mean(base.augmented())
            totem = m_prime if start == 0 else ema_merge(totem, m_prime,
                                                         alpha)
            traces.append(totem)
            if eval_fn is not None:
                evals.append(eval_fn(totem))
    return DynamicTrace(torch.stack(traces)), evals
