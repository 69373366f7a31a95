"""GreedyTL — transfer learning through greedy subset selection; the port of
``repro.core.greedytl``.

Implements the Hypothesis Transfer Learning solver of the paper (Section 3),
following Kuzborskij, Orabona & Caputo, "Transfer learning through greedy
subset selection" (ICIAP 2015):

    h_trg(x) = w^T x + sum_i beta_i h_i_src(x)
    (w*, b*) = argmin  R_hat(h) + lam ||w||^2 + lam ||b||^2
               s.t.    ||w||_0 + ||b||_0 <= kappa

The L0-constrained ridge problem is solved by a regularized least-squares
*forward regression*: at every iteration score each unselected candidate
column of the design matrix Z = [X | 1 | H_src] by its squared correlation
with the current residual (normalised by the regularized column energy),
add the argmax, and re-fit ridge on the selected set.  The selected set
lives in a fixed kappa-slot index buffer and the re-fit is a masked
(kappa x kappa) solve, as in the reference.

Every function takes leading batch axes (the reference vmaps over classes
and locations): the kappa iterations are one Python loop over tensors that
hold all (location, class) problems at once, with no host synchronisation.
`kernel` picks the route where the reference's `use_pallas` did:
``"cuda"`` computes the Gram statistic with the hand-written Gram kernel
and scores + picks every candidate with the scores kernel
(``kernels/greedy_scores``; on CPU tensors those wrappers run their plain
versions); ``"torch"`` is the plain path.  The residual correlation and
the ridge solve are PyTorch ops on both routes, as they are JAX ops outside
any Pallas call in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.greedy_scores import ops as _ops
from repro_torch.kernels.greedy_scores import ref as _ref

KERNELS = ("cuda", "torch")


class GreedyTLModel(NamedTuple):
    """Sparse linear model over the design space [features | source preds].

    coef:      (..., n) dense coefficient vector, zeros outside the selected
               set.  Layout: first `d_feat` entries are omega (features,
               incl. the bias column), the trailing `n_src` entries are beta.
    selected:  (..., kappa) int32 indices into the design space, in the
               order they were picked.
    n_selected: (...) int32, number of used slots.
    """

    coef: torch.Tensor
    selected: torch.Tensor
    n_selected: torch.Tensor

    @property
    def nnz(self):
        return (self.coef != 0).sum()


def _check_kernel(kernel: str):
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}; got {kernel!r}")


def _masked_ridge_solve(G_cols, c, idx, valid, lam):
    """Ridge re-fit restricted to the selected columns, batched.

    G_cols: (B, n, kappa) with G_cols[:, :, s] = G[:, :, idx[:, s]] for the
    valid slots s (anything elsewhere), c: (B, n) label correlations, idx:
    (B, kappa) selected indices (garbage where ~valid), valid: (kappa,)
    bool.  Unused slots are turned into decoupled identity rows with zero
    rhs, so the solve is always a well-posed fixed-shape (kappa, kappa)
    system.
    """
    B, kappa = idx.shape
    safe_idx = torch.where(valid, idx, 0)
    A = torch.gather(G_cols, 1, safe_idx[:, :, None].expand(B, kappa, kappa))
    m2 = valid[:, None] & valid[None, :]
    A = torch.where(m2, A, 0.0) + torch.diag(
        torch.where(valid, lam, 1.0).to(A.dtype))
    b = torch.where(valid, torch.gather(c, 1, safe_idx), 0.0)
    # solve_ex: no host-side singularity check (A is ridge-regularized)
    w = torch.linalg.solve_ex(A, b)[0]
    return torch.where(valid, w, 0.0)


def greedy_pick(G, c, diag, G_cols, w, idx, selected, rows, t: int,
                lam: float, score):
    """Pick t of every problem, in place, given w, the ridge re-fit on the
    t columns picked so far: the residual correlation, the candidates'
    scores and argmax (``score``: the scores kernel's wrapper or its plain
    version), and the pick written into idx[:, t], selected and
    G_cols[:, :, t].

    G: (B, n, n), c and diag: (B, n), G_cols: (B, n, kappa), w: (B,
    kappa), idx: (B, kappa) int64, selected: (B, n) bool, rows: arange(B)
    on G's device.  Launches a fixed sequence of device kernels and reads
    nothing back, so it can be captured in a CUDA graph (the batched solve
    before it cannot)."""
    # residual correlation r_j = c_j - sum_{s in S} G[j, s] w_s
    r_corr = c - (G_cols @ w[:, :, None])[:, :, 0]
    _, j = score(r_corr, diag, selected, lam)
    j = j.long()
    idx[:, t] = j
    selected.scatter_(1, j[:, None], True)
    G_cols[:, :, t] = G[rows, :, j]


def greedytl_from_gram(G, c, kappa: int, lam: float,
                       kernel: str = "cuda") -> GreedyTLModel:
    """Run greedy forward selection given Gram statistics.

    G: (..., n, n) = Z^T Z / m,  c: (..., n) = Z^T y / m.  Returns a
    GreedyTLModel with the same leading axes.  The columns of G that the
    picks select are copied into a (B, n, kappa) buffer as they are picked
    (zero in unused slots, which the zero weights of those slots meet as the
    reference's masked gather does).
    """
    _check_kernel(kernel)
    score = _ops.scores_argmax if kernel == "cuda" else _ref.reference_scores
    batch, n = G.shape[:-2], G.shape[-1]
    G = G.reshape(-1, n, n)
    c = c.reshape(-1, n)
    B = G.shape[0]
    kappa = min(kappa, n)
    diag = torch.diagonal(G, dim1=1, dim2=2).contiguous()
    slots = torch.arange(kappa, device=G.device)
    rows = torch.arange(B, device=G.device)
    idx = torch.full((B, kappa), -1, dtype=torch.int64, device=G.device)
    G_cols = torch.zeros(B, n, kappa, dtype=G.dtype, device=G.device)
    selected = torch.zeros(B, n, dtype=torch.bool, device=G.device)
    for t in range(kappa):
        w = _masked_ridge_solve(G_cols, c, idx, slots < t, lam)
        greedy_pick(G, c, diag, G_cols, w, idx, selected, rows, t, lam,
                    score)

    w = _masked_ridge_solve(G_cols, c, idx,
                            torch.ones_like(slots, dtype=torch.bool), lam)
    coef = torch.zeros(B, n, dtype=G.dtype, device=G.device).scatter_add_(
        1, idx, w)
    return GreedyTLModel(
        coef=coef.reshape(batch + (n,)),
        selected=idx.to(torch.int32).reshape(batch + (kappa,)),
        n_selected=torch.full(batch, kappa, dtype=torch.int32,
                              device=G.device))


def build_design(X, H_src, sample_mask=None):
    """Z = [X | 1 | H_src]; returns (Z, d_feat) where d_feat = d + 1 (bias).

    X: (..., m, d) features, H_src: (..., m, L) source-model margins on the
    same rows (leading axes broadcast).  sample_mask: optional (..., m)
    {0,1} — padded rows are zeroed so they do not contribute to the Gram
    statistics.
    """
    batch = torch.broadcast_shapes(X.shape[:-2], H_src.shape[:-2])
    m, d = X.shape[-2:]
    X = X.expand(batch + (m, d))
    ones = torch.ones(batch + (m, 1), dtype=X.dtype, device=X.device)
    Z = torch.cat([X, ones, H_src.expand(batch + H_src.shape[-2:])], dim=-1)
    if sample_mask is not None:
        Z = Z * sample_mask[..., None]
    return Z, d + 1


def gram_stats(Z, y, sample_mask=None, kernel: str = "cuda"):
    """G = Z^T Z / m_eff and c = Z^T y / m_eff (columns of padded rows are
    0).  Z: (..., m, n), y and sample_mask: (..., m).  With
    ``kernel="cuda"`` G comes from the Gram kernel, one launch for every
    problem of the batch."""
    _check_kernel(kernel)
    if sample_mask is not None:
        y = y * sample_mask
        m_eff = sample_mask.sum(-1).clamp(min=1.0)[..., None]
    else:
        m_eff = torch.tensor(float(Z.shape[-2]), device=Z.device)
    batch, (m, n) = Z.shape[:-2], Z.shape[-2:]
    gram = _ops.gram if kernel == "cuda" else _ref.reference_gram
    G = gram(Z.reshape(-1, m, n)).reshape(batch + (n, n))
    G = G / m_eff[..., None]
    c = (Z.mT @ y[..., None])[..., 0] / m_eff
    return G, c


def greedytl_fit(X, y_pm, H_src, kappa: int, lam: float, sample_mask=None,
                 kernel: str = "cuda"):
    """One binary GreedyTL fit per leading index.  y_pm: (..., m) in
    {-1, +1} (0 on padded rows)."""
    Z, _ = build_design(X, H_src, sample_mask)
    if sample_mask is not None:
        sample_mask = sample_mask.expand(Z.shape[:-1])
    G, c = gram_stats(Z, y_pm.to(Z.dtype), sample_mask, kernel)
    return greedytl_from_gram(G, c, kappa, lam, kernel)


def greedytl_fit_multiclass(X, Y_onehot_pm, H_src_per_class, kappa: int,
                            lam: float, sample_mask=None,
                            kernel: str = "cuda"):
    """One-vs-all GreedyTL: k binary fits sharing the feature block of Z.

    X: (..., m, d); Y_onehot_pm: (..., k, m) with +1/-1 class encodings.
    H_src_per_class: (..., k, m, L) source margins for each class's binary
    problem; sample_mask: (..., m).  Returns a GreedyTLModel with a class
    axis before the last on every leaf.
    """
    mask = None if sample_mask is None else sample_mask[..., None, :]
    return greedytl_fit(X[..., None, :, :], Y_onehot_pm, H_src_per_class,
                        kappa, lam, mask, kernel)


def greedytl_fit_bagged_rows(X, Y_onehot_pm, H_src_per_class, bag_rows,
                             kappa: int, lam: float, kernel: str = "cuda"):
    """The paper's big-dataset workaround (Section 3, last paragraph) on
    given bags: one-vs-all GreedyTL on each bag of rows, the bags' models
    averaged.

    X: (..., m, d); Y_onehot_pm: (..., k, m); H_src_per_class: (..., k, m,
    L); bag_rows: (..., n_bags, bag_size) int row indices into m.  Every
    bag of every leading index is one problem of a single batched fit (one
    Gram launch over ... * n_bags * k problems of bag_size rows), with no
    sample mask inside a bag, as in the reference.  The reductions are the
    reference's: coef is the mean over the bags (so generally denser than
    kappa), selected is bag 0's, n_selected the max over the bags.
    """
    rows = bag_rows.long()
    Xb = torch.take_along_dim(X[..., None, :, :], rows[..., None], -2)
    Yb = torch.take_along_dim(Y_onehot_pm[..., None, :, :],
                              rows[..., None, :], -1)
    Hb = torch.take_along_dim(H_src_per_class[..., None, :, :, :],
                              rows[..., None, :, None], -2)
    mdl = greedytl_fit_multiclass(Xb, Yb, Hb, kappa, lam, kernel=kernel)
    return GreedyTLModel(coef=mdl.coef.mean(-3),
                         selected=mdl.selected.select(-3, 0),
                         n_selected=mdl.n_selected.amax(-2))


def draw_bag_rows(generator, sample_mask, n_bags: int, bag_size: int):
    """(..., n_bags, bag_size) row indices drawn with replacement, with
    probability proportional to sample_mask (..., m), as the reference
    draws each bag (``jax.random.choice(..., replace=True, p=mask /
    sum(mask))``; the streams differ)."""
    p = sample_mask.reshape(-1, sample_mask.shape[-1]).float()
    idx = torch.multinomial(p, n_bags * bag_size, replacement=True,
                            generator=generator)
    return idx.reshape(sample_mask.shape[:-1] + (n_bags, bag_size))


def greedytl_fit_bagged(generator, X, Y_onehot_pm, H_src_per_class,
                        kappa: int, lam: float, n_bags: int, bag_size: int,
                        sample_mask=None, kernel: str = "cuda"):
    """greedytl_fit_bagged_rows on bags drawn from `generator` (a
    torch.Generator on X's device) with probability proportional to
    sample_mask (all rows by default)."""
    if sample_mask is None:
        sample_mask = torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device)
    rows = draw_bag_rows(generator, sample_mask, n_bags, bag_size)
    return greedytl_fit_bagged_rows(X, Y_onehot_pm, H_src_per_class, rows,
                                    kappa, lam, kernel)


def predict_margins(coef, X, H_src_per_class):
    """Margins of the GreedyTL model.  coef: (k, n) with n = d+1+L."""
    d = X.shape[1]
    ones = torch.ones(X.shape[0], 1, dtype=X.dtype, device=X.device)
    feats = torch.cat([X, ones], dim=1)  # (m, d+1)
    omega = coef[:, : d + 1]  # (k, d+1)
    beta = coef[:, d + 1:]  # (k, L)
    lin = feats @ omega.T  # (m, k)
    src = torch.einsum("kml,kl->mk", H_src_per_class, beta)
    return lin + src
