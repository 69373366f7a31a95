"""The GreedyTL scores + argmax kernel's schedule, emulated in numpy, held
against the JAX reference and the port's plain version on the CPU.

The CUDA kernel (src/repro_torch/kernels/greedy_scores/csrc/
greedy_scores.cu) runs only on a card.  What it computes is emulated
here step by step: the plan (``ops.scores_plan``: lanes per problem,
columns a lane loads per pass, problems per CTA); lane l of a team of T
owning columns l, l + T, ... in passes of T * cols columns; each score
corr^2 / (diag + lam) in fp32 (IEEE division, as nvcc's default and
numpy's), -1e30 where selected; each lane's largest (score, column) key
(the score's bits made order-preserving, -0 as +0, NaN largest, above the
column's complement so a tie goes to the lowest column); the warp's
largest key by two redux.sync (the largest score part, then the largest
column part among the lanes that hold it); and for a team of several
warps the same over the warps' keys.  Scores are compared bit for bit
(NaN by place), indices exactly: against the port's plain version
(ref.py), the reference's Pallas kernel (interpret mode) and, for rows
whose every score is -inf, ``jnp.argmax`` of the plain scores (the
reference's wrapper pads a row with selected columns scored -1e30, which
beat -inf).  Edge rows come from ``chip_smoke.scores_edge_rows``, which the
card's checks use too.  One torch thread; the JAX results are computed
once for the module.
"""
import importlib.util
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.greedy_scores import ops as jops  # noqa: E402
from repro_torch.kernels.greedy_scores import ops, ref  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAM = 3.0
SMS = 132  # the H100's SMs
NS = (1, 31, 32, 33, 583, 4097, 16384)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op torch thread while these tests run; restored after."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------ the emulation


def plain_scores(corr, diag, sel, lam):
    with np.errstate(all="ignore"):
        s = (corr * corr) / (diag + np.float32(lam))
    return np.where(sel, np.float32(-1e30), s).astype(np.float32)


def keys(s, j):
    """The kernel's argmax_key of scores s at columns j (uint64)."""
    u = (s + np.float32(0)).astype(np.float32).view(np.uint32)
    u = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    u = np.where(np.isnan(s), np.uint32(0xFFFFFFFF), u).astype(np.uint64)
    return (u << np.uint64(32)) | (np.uint64(0xFFFFFFFF)
                                   - np.asarray(j, np.uint64))


def warp_max(k):
    """Two redux.sync over a warp's 32 keys (last axis)."""
    hi, lo = k >> np.uint64(32), k & np.uint64(0xFFFFFFFF)
    top = hi.max(-1, keepdims=True)
    low = np.where(hi == top, lo, np.uint64(0)).max(-1)
    return (top[..., 0] << np.uint64(32)) | low


def lane_columns(n, team, cols):
    """Each lane's columns in the order it scores them."""
    out = []
    for lane in range(team):
        js = [j0 + k * team for j0 in range(lane, n, team * cols)
              for k in range(cols)]
        out.append([j for j in js if j < n])
    return out


def emulate(corr, diag, sel, lam, team, cols):
    """(scores, idx) as the kernel computes them under (team, cols)."""
    s = plain_scores(corr, diag, sel, lam)
    B, n = s.shape
    best = np.zeros((B, team), np.uint64)
    for lane, js in enumerate(lane_columns(n, team, cols)):
        if js:  # the lane keeps its largest key (lane 0 always has one)
            best[:, lane] = keys(s[:, js], np.array(js)).max(-1)
    warps = warp_max(best.reshape(B, team // 32, 32))
    pad = np.zeros((B, 32 - team // 32), np.uint64)
    top = warp_max(np.concatenate([warps, pad], axis=1))
    idx = (np.uint64(0xFFFFFFFF) - (top & np.uint64(0xFFFFFFFF)))
    return s, idx.astype(np.int32)


def same_scores(a, b):
    nan = np.isnan(b)
    return bool((np.isnan(a) == nan).all()
                and np.array_equal(a[~nan], b[~nan])
                and (np.signbit(a[~nan]) == np.signbit(b[~nan])).all())


def random_rows(seed, B, n, p_sel=0.2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, n)).astype(np.float32),
            (rng.random((B, n)) + 0.05).astype(np.float32),
            rng.random((B, n)) < p_sel)


def torch_plain(corr, diag, sel, lam):
    s, idx = ref.reference_scores(torch.from_numpy(corr),
                                  torch.from_numpy(diag),
                                  torch.from_numpy(sel), lam)
    return s.numpy(), idx.numpy()


# ------------------------------------------------------------------ the plan


@pytest.mark.parametrize("n", NS)
def test_plan_team_width(n):
    """The team is a warp or more, at most 256 lanes, no wider than gives
    each lane two columns (n // 2) nor than the problems' share of 1024
    lanes per SM; a lane loads 4 columns a pass while 256 lanes cover the
    row in one, 8 past that."""
    want = {252: 256 if n >= 512 else 32, 12: 256 if n >= 512 else 32,
            2520: 32}
    for B, team in want.items():
        t, cols, per = ops.scores_plan(B, n, SMS)
        assert t == team, (B, n, t)
        assert t in ops.SCORE_TEAMS and cols in ops.SCORE_COLS
        assert t <= max(32, n // 2) and t <= max(32, SMS * 1024 // B)
        assert cols == (4 if n <= 1024 else 8)


@pytest.mark.parametrize("B", [1, 12, 131, 132, 133, 252, 2520, 70000])
def test_plan_packing_spreads_over_every_sm(B):
    """Problems share a CTA only while every SM still gets one: the grid
    has min(B, SMs) CTAs or more, CTAs hold at most 128 lanes (a team of
    256 alone), and each problem has a slot."""
    for n in (64, 583, 4097):
        team, _, per = ops.scores_plan(B, n, SMS)
        ctas = -(-B // per)
        assert ctas >= min(B, SMS)
        assert per == 1 or team * per <= 128
        assert team * per <= ops.SCORE_CTA and ctas * per >= B


def test_source_builds_what_the_plan_names():
    """The launch function dispatches exactly the teams and column counts
    of ops.SCORE_TEAMS / SCORE_COLS, and caps a CTA at ops.SCORE_CTA."""
    src = open(os.path.join(ROOT, "src/repro_torch/kernels/greedy_scores/"
                                  "csrc/greedy_scores.cu")).read()
    assert f"constexpr int kScoreCta = {ops.SCORE_CTA};" in src
    teams = tuple(int(t) for t in re.findall(
        r"case (\d+):\n      return launch_scores<\1>", src))
    cols = tuple(int(c) for c in re.findall(
        r"if \(cols == (\d+)\)\n    scores_argmax_kernel<kTeam, \1>", src))
    assert teams == ops.SCORE_TEAMS and cols == ops.SCORE_COLS


# ------------------------------------------------------------ the emulation


@pytest.mark.parametrize("team", [32, 64, 128, 256])
@pytest.mark.parametrize("cols", [4, 8])
@pytest.mark.parametrize("n", [33, 583, 4097])
def test_emulated_schedule_matches_plain_version(team, cols, n):
    """Every team width and column count (one pass, several passes, idle
    lanes): scores bit-equal to the plain version's, the same argmax."""
    corr, diag, sel = random_rows(team * n + cols, 3, n)
    corr[0, [n // 5, n - 1]] = 1e3  # a tie across lanes and passes
    diag[0, [n // 5, n - 1]], sel[0, [n // 5, n - 1]] = 1.0, False
    s, idx = emulate(corr, diag, sel, LAM, team, cols)
    want, widx = torch_plain(corr, diag, sel, LAM)
    assert same_scores(s, want)
    np.testing.assert_array_equal(idx, widx)
    assert idx[0] == n // 5


@pytest.mark.parametrize("n", NS)
def test_emulated_edge_rows_match_plain_version(n):
    """The edge rows (all selected, NaN first / mid / last, +-0 ties,
    diag + lam = 0, ties planted across lanes, warps, teams and passes,
    rows of -inf) under the plan the kernel takes at n and at a narrower
    team: the plain version's scores and argmax."""
    corr, diag, sel = CS.scores_edge_rows(n, LAM)
    want, widx = torch_plain(corr, diag, sel, LAM)
    team, cols, _ = ops.scores_plan(len(corr), n, SMS)
    for t in {team, 32}:
        s, idx = emulate(corr, diag, sel, LAM, t, cols)
        assert same_scores(s, want)
        np.testing.assert_array_equal(idx, widx)


@pytest.mark.parametrize("seed", range(6))
def test_key_order_is_the_argmax_rule(seed):
    """Sorting (score, column) pairs by key gives the argmax rule's order:
    NaN above everything, then by value with -0 = +0, then the lower
    column first."""
    rng = np.random.default_rng(seed)
    pool = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, -1e30,
                     1.0, -1.0, 3.5, 1e-40, -1e-40], np.float32)
    s = np.concatenate([pool, rng.normal(size=20).astype(np.float32)])
    s = rng.choice(s, size=64)
    j = rng.permutation(64)
    k = keys(s, j)

    def rule(a, b):  # does a beat b?
        (va, ja), (vb, jb) = a, b
        na, nb = np.isnan(va), np.isnan(vb)
        if na != nb:
            return na
        if not na and va != vb:
            return va > vb
        return ja < jb
    for a in range(64):
        for b in range(64):
            if a != b:
                assert (k[a] > k[b]) == rule((s[a], j[a]), (s[b], j[b]))


def test_empty_batch_on_the_cpu():
    """B = 0: empty outputs of the right shapes and types (the card's
    route returns the same without a launch)."""
    z = torch.zeros(0, 583)
    n0 = ops.scores_argmax.launches
    s, idx = ops.scores_argmax(z, z, z.bool(), LAM)
    assert s.shape == (0, 583) and s.dtype == torch.float32
    assert idx.shape == (0,) and idx.dtype == torch.int32
    assert ops.scores_argmax.launches == n0


# ------------------------------------------------------ against JAX's kernel

JAX_CASES = {"edge-33": 33, "edge-583": 583}


@pytest.fixture(scope="module")
def jax_results():
    """The reference's Pallas scores and argmax (interpret mode) of every
    edge row at n = 33 and 583 and of random rows, and jnp.argmax of the
    plain scores; computed once for the module."""
    out = {}
    rows = {name: CS.scores_edge_rows(n, LAM) for name, n in JAX_CASES.items()}
    rows["random-583"] = random_rows(5, 4, 583)
    for name, (corr, diag, sel) in rows.items():
        got = [jops.scores_argmax(corr[b], diag[b], sel[b].astype(np.float32),
                                  LAM) for b in range(len(corr))]
        plain = jnp.where(jnp.asarray(sel), -1e30,
                          jnp.asarray(corr) ** 2 / (jnp.asarray(diag) + LAM))
        out[name] = dict(
            rows=(corr, diag, sel),
            scores=np.stack([np.asarray(s) for s, _ in got]),
            idx=np.array([int(i) for _, i in got]),
            argmax=np.asarray(jnp.argmax(plain, axis=-1)))
    return out


def _all_neg_inf(s):
    return np.isneginf(s).all(-1)


@pytest.mark.parametrize("name", ["edge-33", "edge-583", "random-583"])
def test_emulated_kernel_matches_jax_pallas(jax_results, name):
    """Scores equal to the reference's Pallas kernel's but for NaN's
    payload, and the same argmax in every row but those of -inf (next
    test), under the plan and under one warp."""
    r = jax_results[name]
    corr, diag, sel = r["rows"]
    team, cols, _ = ops.scores_plan(len(corr), corr.shape[1], SMS)
    finite = ~_all_neg_inf(r["scores"])
    for t in {team, 32}:
        s, idx = emulate(corr, diag, sel, LAM, t, cols)
        assert same_scores(s, r["scores"])
        np.testing.assert_array_equal(idx[finite], r["idx"][finite])


@pytest.mark.parametrize("name", ["edge-33", "edge-583"])
def test_rows_of_neg_inf_against_jnp_argmax(jax_results, name):
    """A row whose every score is -inf: the kernel, the plain version and
    jnp.argmax of the plain scores take column 0; the reference's wrapper
    takes a padded column (index n or more), whose -1e30 beats -inf — a
    deliberate difference (ROADMAP.md)."""
    r = jax_results[name]
    corr, diag, sel = r["rows"]
    n = corr.shape[1]
    rows = _all_neg_inf(r["scores"])
    assert rows.any()
    s, idx = emulate(corr, diag, sel, LAM, *ops.scores_plan(len(corr), n,
                                                            SMS)[:2])
    _, widx = torch_plain(corr, diag, sel, LAM)
    np.testing.assert_array_equal(idx[rows], r["argmax"][rows])
    np.testing.assert_array_equal(widx[rows], r["argmax"][rows])
    assert (idx[rows] == 0).all()
    if n % 256:  # the wrapper pads to its 256-column blocks
        assert (r["idx"][rows] >= n).all()
