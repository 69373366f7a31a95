"""Step-0 base learner: linear SVM, one-vs-all, with codeword decoding — the
port of ``repro.core.base_learner``.

The paper (Section 4.2, Step 0) trains a Linear Support Vector Machine at
every location.  We use the squared-hinge formulation (differentiable, same
decision function) minimised by full-batch Nesterov gradient descent.  The
reference vmaps the fit over locations; here every tensor may carry leading
batch axes and one Python loop of `steps` iterations runs them together.
The squared-hinge gradient is written out (it is what ``jax.grad`` of the
reference's loss computes).

Multi-class handling follows Section 6.1 exactly: k one-vs-all binary
classifiers, and the final response decodes the sign string against class
codewords with the hinge distance

    y_hat = argmin_c sum_i max(0, 1 - b_hat[i] * b_c[i]).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch


@contextlib.contextmanager
def fp32_matmuls():
    """Full-fp32 matrix products inside the block (TF32 off for cuBLAS and
    cuDNN), the previous settings restored after.  The reference is fp32,
    and a TF32 product moves GreedyTL's argmax."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


class LinearModel(NamedTuple):
    """One-vs-all linear model: W (..., k, d), b (..., k)."""

    W: torch.Tensor
    b: torch.Tensor

    def margins(self, X):
        return X @ self.W.mT + self.b[..., None, :]  # (..., m, k)


def onehot_pm(labels, k):
    """(..., m) int labels -> (..., k, m) in {-1, +1}."""
    oh = torch.nn.functional.one_hot(labels.long(), k).movedim(-1, -2)
    return torch.where(oh > 0, 1.0, -1.0)


def fit_linear_svm(X, labels, k: int, lam: float = 1e-4, lr: float = 0.01,
                   steps: int = 600, sample_mask=None) -> LinearModel:
    """Squared-hinge L2 SVM, one-vs-all over k classes.

    X: (..., m, d), labels: (..., m) int.  sample_mask: (..., m) {0,1} for
    padded rows.  Leading axes are independent fits (the locations).
    """
    m, d = X.shape[-2:]
    batch = X.shape[:-2]
    Yt = onehot_pm(labels, k).mT.to(X.dtype)              # (..., m, k)
    if sample_mask is None:
        sample_mask = torch.ones(X.shape[:-1], dtype=X.dtype,
                                 device=X.device)
    m_eff = sample_mask.sum(-1).clamp(min=1.0)              # (...,)
    # d loss / d f = -2 viol * Y * mask / m_eff, per row and class
    scale = (-2.0 * sample_mask / m_eff[..., None])[..., None] * Yt

    def grad(W, b):
        f = X @ W.mT + b[..., None, :]                      # (..., m, k)
        gf = torch.clamp(1.0 - Yt * f, min=0.0) * scale
        return gf.mT @ X + 2.0 * lam * W, gf.sum(-2) + 2.0 * lam * b

    W = torch.zeros(batch + (k, d), dtype=X.dtype, device=X.device)
    b = torch.zeros(batch + (k,), dtype=X.dtype, device=X.device)
    vW, vb = torch.zeros_like(W), torch.zeros_like(b)
    for _ in range(steps):
        # Nesterov: gradient at the lookahead point.
        gW, gb = grad(W + 0.9 * vW, b + 0.9 * vb)
        vW = 0.9 * vW - lr * gW
        vb = 0.9 * vb - lr * gb
        W = W + vW
        b = b + vb
    return LinearModel(W, b)


def decode_codewords(margins, hard: bool = False):
    """Paper's multi-class decoding (Section 6.1).

    y_hat = argmin_c sum_i max(0, 1 - b_hat[i] * b_c[i]) where b_c is -1
    everywhere except +1 at position c.  With `hard=True` the response string
    is b_hat = sign(margins), literally as written in the paper; the default
    uses the raw margins (loss-based decoding).  margins: (..., m, k); a tie
    picks the lowest class, as ``jnp.argmin`` does.
    """
    b_hat = torch.sign(margins) if hard else margins  # (..., m, k)
    k = margins.shape[-1]
    # codewords: (k, k) = 2*I - 1
    B = 2.0 * torch.eye(k, dtype=margins.dtype, device=margins.device) - 1.0
    # hinge distance between response string and each codeword
    dist = torch.clamp(1.0 - b_hat[..., None, :] * B, min=0.0).sum(-1)
    return dist.argmin(-1)


def predict(model: LinearModel, X):
    return decode_codewords(model.margins(X))
