"""GreedyTL's Gram statistic and fused candidate scoring + argmax, batched
over a leading axis of independent problems — the port's counterpart of
``repro.kernels.greedy_scores.ops`` (whose functions take one problem).

Where the tensors lie picks the implementation, nothing else does: CUDA
tensors launch the hand-written kernels (csrc/greedy_scores.cu, built with
nvcc on first use); CPU tensors run the plain PyTorch versions (ref.py).
Anything else raises — there is no fallback from the kernel.  Each wrapper
counts its kernel launches in ``<wrapper>.launches``.

The kernels need no padding: ragged m and n are masked inside them (the
JAX wrappers pad to block multiples).  The Gram kernel computes only the
128 x 128 tiles on or above the diagonal (one CTA each, all problems in
one launch) and mirrors them, so G is bit-symmetric; each entry is one
fp32 fused multiply-add chain over Z's rows in order.  The scores kernel
gives each problem a team of lanes (``scores_plan``, from B, n and the
card's SM count); B = 0 returns empty outputs without a launch.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.greedy_scores import ref

SOURCES = (Path(__file__).resolve().parent / "csrc" / "greedy_scores.cu",)
MAX_BATCH = 65535  # the gram kernel's grid.y
# the scores kernel: the lanes per problem and the columns a lane loads per
# pass it is built for, and threads per CTA at most (kScoreCta)
SCORE_TEAMS = (32, 64, 128, 256)
SCORE_COLS = (4, 8)
SCORE_CTA = 256

_sm_counts: dict = {}


def _lib():
    lib = _build.load("greedy_scores", SOURCES)
    if lib.greedy_gram_launch.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.greedy_gram_launch.argtypes = [P, P, I, I, I, P]
        lib.greedy_gram_launch.restype = ctypes.c_int
        lib.greedy_scores_argmax_launch.argtypes = [
            P, P, P, P, P, I, I, ctypes.c_float, I, I, I, P]
        lib.greedy_scores_argmax_launch.restype = ctypes.c_int
        lib.greedy_scores_error_string.argtypes = [ctypes.c_int]
        lib.greedy_scores_error_string.restype = ctypes.c_char_p
    return lib


def _check_device(name, tensors):
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: every tensor must lie on {dev}; got "
                         f"{[str(t.device) for t in tensors]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA (the kernel) or the CPU (its "
                         f"plain version); got {dev}")
    return dev


def _raise_on(lib, rc, name):
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            f"{lib.greedy_scores_error_string(rc).decode()} ({rc})")


def gram(Z):
    """G = Z^T Z per problem.  Z: (B, m, n) float32 -> (B, n, n) float32."""
    if Z.ndim != 3 or min(Z.shape) == 0:
        raise ValueError(f"gram takes a non-empty Z (B, m, n); got shape "
                         f"{tuple(Z.shape)}")
    dev = _check_device("gram", [Z])
    if dev.type == "cpu":
        return ref.reference_gram(Z)
    if Z.dtype != torch.float32:
        raise ValueError(f"the CUDA gram kernel takes float32; got {Z.dtype}")
    B, m, n = Z.shape
    if B > MAX_BATCH:
        raise ValueError(f"the CUDA gram kernel takes at most {MAX_BATCH} "
                         f"problems per launch; got {B}")
    Z = Z.contiguous()
    G = torch.empty(B, n, n, dtype=torch.float32, device=dev)
    lib = _lib()
    rc = lib.greedy_gram_launch(Z.data_ptr(), G.data_ptr(), B, m, n,
                                torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, "gram")
    gram.launches += 1
    return G


def scores_plan(B: int, n: int, sms: int):
    """(lanes per problem, columns a lane loads per pass, problems per CTA)
    of a scores launch on a card of `sms` SMs.  The team is as wide as
    gives each lane two columns or more, and as a fair share of 1024 lanes
    per SM among the B problems allows (at least one warp, at most 256
    lanes); a lane loads 4 columns a pass while 256 lanes cover the row in
    one, 8 past that (more loads in flight per round trip).  Problems are
    packed into CTAs of at most 128 lanes, as many as leaves every SM a
    CTA, so that the grid spreads over all of them (tools/scores_tiles.py
    sweeps the alternatives)."""
    lanes = min(n // 2, sms * 1024 // max(B, 1))
    team = max(t for t in SCORE_TEAMS if t <= max(lanes, SCORE_TEAMS[0]))
    cols = SCORE_COLS[0] if n <= SCORE_TEAMS[-1] * SCORE_COLS[0] \
        else SCORE_COLS[-1]
    per_cta = max(1, min(128 // team, B // sms))
    return team, cols, per_cta


def _sm_count(dev) -> int:
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _sm_counts:
        props = torch.cuda.get_device_properties(i)
        _sm_counts[i] = props.multi_processor_count
    return _sm_counts[i]


def scores_argmax(corr, diag, selected_mask, lam: float):
    """score_j = corr_j^2 / (diag_j + lam), -1e30 on selected columns, and
    each problem's argmax (the lowest index on a tie).

    corr/diag: (B, n) float32; selected_mask: (B, n) bool.  Returns
    (scores (B, n) float32, idx (B,) int32)."""
    if corr.ndim != 2 or corr.shape[1] == 0 \
            or diag.shape != corr.shape or selected_mask.shape != corr.shape:
        raise ValueError(
            f"scores_argmax takes corr, diag, selected_mask of one non-empty "
            f"(B, n) shape; got {tuple(corr.shape)}, {tuple(diag.shape)}, "
            f"{tuple(selected_mask.shape)}")
    if selected_mask.dtype != torch.bool:
        raise ValueError(f"selected_mask must be bool; got "
                         f"{selected_mask.dtype}")
    dev = _check_device("scores_argmax", [corr, diag, selected_mask])
    if dev.type == "cpu":
        return ref.reference_scores(corr, diag, selected_mask, lam)
    if corr.dtype != torch.float32 or diag.dtype != torch.float32:
        raise ValueError(f"the CUDA scores kernel takes float32 corr/diag; "
                         f"got {corr.dtype}/{diag.dtype}")
    B, n = corr.shape
    scores = torch.empty(B, n, dtype=torch.float32, device=dev)
    idx = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:  # as on the CPU; CUDA refuses a grid of no CTAs
        return scores, idx
    corr, diag = corr.contiguous(), diag.contiguous()
    selected_mask = selected_mask.contiguous()
    plan = scores_plan(B, n, _sm_count(dev))
    lib = _lib()
    rc = lib.greedy_scores_argmax_launch(
        corr.data_ptr(), diag.data_ptr(), selected_mask.data_ptr(),
        scores.data_ptr(), idx.data_ptr(), B, n, float(lam), *plan,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, "scores_argmax")
    scores_argmax.launches += 1
    return scores, idx


gram.launches = 0
scores_argmax.launches = 0
