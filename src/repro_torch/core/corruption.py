"""Malicious-device model corruption (paper Section 7) — the port of
``repro.core.corruption``.

- Malicious1: a fraction of devices send a *fully* corrupted model — every
  parameter replaced by N(0, 1) noise.
- Malicious2: *all* devices send models in which a fraction p of the
  parameters (chosen i.i.d.) is replaced by N(0, 1) noise.

Both operate on stacked per-location models (leading axis L): a tensor, a
NamedTuple of tensors (``gtl.StackedLinear``) or a dict of tensors.  The
noise comes from an explicit ``torch.Generator`` on the models' device, so
its stream differs from the reference's JAX keys.  A generator advances as
it draws: a ``corrupt_fn`` that seeds a fresh one on every call corrupts
every procedure's exchange alike, as a fixed JAX key does in the
reference.
"""
from __future__ import annotations

import torch


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return list(tree.values())
    return list(tree)


def _unflatten(tree, leaves):
    if isinstance(tree, torch.Tensor):
        return leaves[0]
    if isinstance(tree, dict):
        return dict(zip(tree, leaves))
    return type(tree)(*leaves)


def corrupt_malicious1(generator, stacked_models, frac_malicious: float):
    """Replace the models of round(frac * L) devices, chosen by a random
    permutation, with pure noise.

    Returns (corrupted_models, malicious_mask (L,) bool).
    """
    leaves = _leaves(stacked_models)
    L, dev = leaves[0].shape[0], leaves[0].device
    n_bad = int(round(frac_malicious * L))
    perm = torch.randperm(L, generator=generator, device=dev)
    bad = torch.zeros(L, dtype=torch.bool, device=dev)
    bad[perm[:n_bad]] = True
    flat = []
    for leaf in leaves:
        noise = torch.randn(leaf.shape, generator=generator,
                            dtype=leaf.dtype, device=dev)
        flat.append(torch.where(bad.reshape((L,) + (1,) * (leaf.ndim - 1)),
                                noise, leaf))
    return _unflatten(stacked_models, flat), bad


def corrupt_malicious2(generator, stacked_models, frac_params: float):
    """Replace an i.i.d. Bernoulli(frac_params) share of every model's
    parameters with N(0, 1) noise."""
    flat = []
    for leaf in _leaves(stacked_models):
        mask = torch.rand(leaf.shape, generator=generator,
                          device=leaf.device) < frac_params
        noise = torch.randn(leaf.shape, generator=generator,
                            dtype=leaf.dtype, device=leaf.device)
        flat.append(torch.where(mask, noise, leaf))
    return _unflatten(stacked_models, flat)
