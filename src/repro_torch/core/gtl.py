"""GTL — the paper's distributed learning procedure (Algorithm 1); the port
of ``repro.core.gtl``.

Five steps, executed at every location (batched over the location axis):

  Step 0: train a local base learner (linear SVM) on the local shard.
  Step 1: exchange base models (everybody receives everybody's h^(0)).
  Step 2: re-train locally with GreedyTL, using all received base models as
          transfer sources: h^(2)(x) = w^T x + sum_i beta_i h_i^(0)(x).
  Step 3: exchange the h^(2) models.
  Step 4: aggregate into h^(4) — consensus mean (mu-GTL) or majority voting
          (mv-GTL).

Because the base learners are *linear*, every GTL model collapses exactly to
a (k, d+1) linear model in feature space:

    h(x) = w^T [x;1] + sum_i beta_i (W_i [x;1]) = (w + sum_i beta_i W_i)^T [x;1]

`flatten_gtl` performs that collapse; consensus, EMA merging (dynamic
scenario, ``core/dynamic.py``) and evaluation operate on the flattened
form, while the overhead accounting uses the sparse (w, beta) form actually
sent on the wire.

The exchanged models may be corrupted (Section 7, ``corrupt_fn``,
``core/corruption.py``); each location still puts its own honest model in
its own slot of the received set (Algorithm 1 line 8, ``received_sets``),
so with ``own`` given every location fits and collapses against its own
set.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import base_learner as bl
from repro_torch.core import greedytl as gtl_solver
from repro_torch.core.aggregation import consensus_mean, majority_vote


class StackedLinear(NamedTuple):
    """Per-location linear models. W: (L, k, d), b: (L, k)."""

    W: torch.Tensor
    b: torch.Tensor

    @property
    def n_locations(self):
        return self.W.shape[0]

    def augmented(self):
        """(L, k, d+1) with the bias folded in as the last column."""
        return torch.cat([self.W, self.b[..., None]], dim=-1)


class GTLResult(NamedTuple):
    base: StackedLinear          # h^(0) per location
    sources: StackedLinear       # what was exchanged (may be corrupted)
    gtl_coef: torch.Tensor       # (L, k, n) sparse GreedyTL coefficients, n=d+1+L
    gtl_flat: torch.Tensor       # (L, k, d+1) flattened h^(2)
    consensus_flat: torch.Tensor  # (k, d+1) flattened mu-GTL h^(4)
    gtl_selected: torch.Tensor   # (L, k, kappa) GreedyTL picks, in order


def shard_tensors(shards, device="cuda"):
    """(X, y, mask) of `LocationShards` (numpy) as tensors on `device`."""
    return (torch.as_tensor(shards.X, device=device),
            torch.as_tensor(shards.y, device=device),
            torch.as_tensor(shards.mask, device=device))


# --------------------------------------------------------------- step 0


def train_base_models(shards_X, shards_y, shards_mask, k: int,
                      lam: float = 1e-4, lr: float = 0.01,
                      steps: int = 600) -> StackedLinear:
    """Step 0 at every location (batched over the leading L axis)."""
    mdl = bl.fit_linear_svm(shards_X, shards_y, k, lam=lam, lr=lr,
                            steps=steps, sample_mask=shards_mask)
    return StackedLinear(mdl.W, mdl.b)


# --------------------------------------------------------------- step 2


def source_margins(X, sources: StackedLinear):
    """(..., k, m, L): margin of source model l, class c, on each row of X
    (..., m, d).  The sources are shared (W (L, k, d)) or one set per
    leading index (W (..., L, k, d), as ``received_sets`` gives)."""
    marg = torch.einsum("...md,...lkd->...kml", X, sources.W)
    return marg + sources.b.mT[..., :, None, :]


def received_sets(sources: StackedLinear, own: StackedLinear):
    """Algorithm 1 line 8 (H_src <- H_src U {h_own}): location l's source
    set is `sources` with slot l replaced by own[l], for every location l
    of `own`.  Returns a StackedLinear of W (L, L_src, k, d), b (L, L_src,
    k)."""
    L = own.W.shape[0]
    at = torch.arange(L, device=own.W.device)
    W = sources.W.expand((L,) + sources.W.shape).clone()
    b = sources.b.expand((L,) + sources.b.shape).clone()
    W[at, at] = own.W
    b[at, at] = own.b
    return StackedLinear(W, b)


def _bag_rows(mask, n_bags, bag_size, generator, bag_rows):
    """The bags' row indices (L, n_bags, bag_size): `bag_rows` as given, or
    drawn from `generator`; None without bagging."""
    if n_bags <= 0:
        if bag_rows is not None:
            raise ValueError("bag_rows needs n_bags > 0")
        return None
    if bag_rows is None:
        if generator is None:
            raise ValueError("bagged GreedyTL draws its rows from a "
                             "torch.Generator: pass generator= or bag_rows=")
        return gtl_solver.draw_bag_rows(generator, mask, n_bags, bag_size)
    want = mask.shape[:-1] + (n_bags, bag_size)
    if tuple(bag_rows.shape) != want:
        raise ValueError(f"bag_rows must have shape {want}; got "
                         f"{tuple(bag_rows.shape)}")
    m = mask.shape[-1]
    if bag_rows.numel() and not 0 <= int(bag_rows.min()) <= int(
            bag_rows.max()) < m:
        raise ValueError(f"bag_rows must index the {m} rows of a shard")
    return bag_rows.to(mask.device)


def gtl_step2_all(shards_X, shards_y, shards_mask, sources: StackedLinear,
                  k: int, kappa: int, lam: float, kernel: str = "cuda", *,
                  n_bags: int = 0, bag_size: int = 0, generator=None,
                  bag_rows=None, own: StackedLinear | None = None):
    """Step 2 at every location: one batched GreedyTL fit over all
    (location, class) problems, or with bagging (``n_bags`` > 0) over all
    (location, bag, class) problems.

    `sources` are the models received over the network (possibly
    corrupted, Section 7); `own` are the honest local models, and where
    given each location's slot of `sources` is replaced by its own
    (``received_sets``).  Bags of `bag_size` rows come from `bag_rows`
    (L, n_bags, bag_size) or are drawn from `generator`.

    Returns (model, flat): the GreedyTLModel (coef (L, k, n), selected
    (L, k, kappa)), n = d+1+L_src, and flat (L, k, d+1), the exact linear
    collapse of each location's h^(2) against its source set.
    """
    if own is not None:
        sources = received_sets(sources, own)
    H = source_margins(shards_X, sources)                     # (L, k, m, L_src)
    Y = bl.onehot_pm(shards_y, k) * shards_mask[..., None, :]  # (L, k, m)
    rows = _bag_rows(shards_mask, n_bags, bag_size, generator, bag_rows)
    if rows is None:
        mdl = gtl_solver.greedytl_fit_multiclass(
            shards_X, Y, H, kappa, lam, sample_mask=shards_mask,
            kernel=kernel)
    else:
        mdl = gtl_solver.greedytl_fit_bagged_rows(
            shards_X, Y, H, rows, kappa, lam, kernel=kernel)
    return mdl, flatten_gtl(mdl.coef, sources)


def flatten_gtl(coef, sources: StackedLinear):
    """Collapse h^(2) = (w, beta) + linear sources into (k, d+1) weights.

    coef: (k, n) or (L, k, n) with n = d+1+L_src; sources shared or one set
    per location, as in ``source_margins``.
    """
    d1 = sources.W.shape[-1] + 1
    omega = coef[..., :d1]            # (..., k, d+1)
    beta = coef[..., d1:]             # (..., k, L_src)
    aug = sources.augmented()         # (..., L_src, k, d+1)
    transfer = torch.einsum("...kl,...lke->...ke", beta, aug)
    return omega + transfer


# --------------------------------------------------------------- procedure


def run_gtl(shards, k: int, kappa: int = 64, lam: float = 3.0,
            svm_lam: float = 1e-4, svm_lr: float = 0.01, svm_steps: int = 600,
            n_bags: int = 0, bag_size: int = 0, generator=None,
            bag_rows=None, corrupt_fn=None, kernel: str = "cuda",
            device="cuda") -> GTLResult:
    """Full Algorithm 1 on `LocationShards`, on `device`.
    `corrupt_fn(models) -> models` (if given) corrupts the *exchanged* base
    models at Step 1 (Section 7); each location still includes its own
    honest model in its slot of the received set.  Bagging as in
    ``gtl_step2_all``."""
    with bl.fp32_matmuls():
        X, y, mask = shard_tensors(shards, device)
        base = train_base_models(X, y, mask, k, lam=svm_lam, lr=svm_lr,
                                 steps=svm_steps)
        sources = corrupt_fn(base) if corrupt_fn is not None else base
        mdl, flat = gtl_step2_all(X, y, mask, sources, k, kappa, lam, kernel,
                                  n_bags=n_bags, bag_size=bag_size,
                                  generator=generator, bag_rows=bag_rows,
                                  own=base)
        consensus = consensus_mean(flat)           # (k, d+1) == mu-GTL^(4)
    return GTLResult(base=base, sources=sources, gtl_coef=mdl.coef,
                     gtl_flat=flat, consensus_flat=consensus,
                     gtl_selected=mdl.selected)


def run_gtl_with_aggregators(shards, k: int, n_aggregators: int,
                             kappa: int = 64, lam: float = 3.0,
                             kernel: str = "cuda", device="cuda",
                             **svm_kw) -> GTLResult:
    """Section 9: only `n_aggregators` locations run Step 2; the consensus is
    taken over the aggregators' models only and sent back to everyone.
    n_aggregators == 1 has noHTL_mu-like traffic; == L recovers full GTL.
    """
    with bl.fp32_matmuls():
        X, y, mask = shard_tensors(shards, device)
        base = train_base_models(X, y, mask, k, **svm_kw)
        a = n_aggregators
        mdl, flat = gtl_step2_all(X[:a], y[:a], mask[:a], base, k, kappa,
                                  lam, kernel)
        consensus = consensus_mean(flat)    # (n_agg, k, d+1) -> (k, d+1)
    return GTLResult(base=base, sources=base, gtl_coef=mdl.coef,
                     gtl_flat=flat, consensus_flat=consensus,
                     gtl_selected=mdl.selected)


# --------------------------------------------------------------- prediction


def predict_linear(flat_coef, X):
    """flat_coef: (..., k, d+1) flattened model(s) -> decoded class labels
    (..., m)."""
    ones = torch.ones(X.shape[0], 1, dtype=X.dtype, device=X.device)
    feats = torch.cat([X, ones], dim=1)
    return bl.decode_codewords(feats @ flat_coef.mT)


def predict_majority(flat_coefs, X, n_classes: int):
    """flat_coefs: (L, k, d+1) -> majority vote over the L models."""
    return majority_vote(predict_linear(flat_coefs, X), n_classes)
