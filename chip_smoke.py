#!/usr/bin/env python3
"""Run the PyTorch port (src/repro_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. build every CUDA kernel of the main paths from the sources in this
   checkout (nvcc, sm_90a; one nvcc process per source, all at once);
2. hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes: paged attention (fused update, then attention only
   on the pools it wrote) for a decode tick (S=1), a prefill block (S=16),
   a wrapped ring, null-page padding and an idle lane, slots at position 0
   (every split but one without an admitted key), a wrapped ring under a
   window at S=16, GQA 4 and a bf16 pool; the GreedyTL Gram and scores kernels at the
   HAPT shapes, a ragged case and a case with many selected columns, and
   the scores kernel on the edge rows of its argmax rule (NaN, +-0, ties
   across lanes and passes, rows of -inf; scores_edge_rows) at n = 1 to
   16384;
3. serve full-width qwen3_0_6b (28 layers, random bf16 weights from a
   seed, fp32 page pool) through ContinuousBatcher with the paged layout,
   lazy allocation and kernel="cuda": greedy and sampled requests, one
   best_of=2 request and one forced preemption with resume — with every
   kernel's launch count set to 0 just before and read just after;
4. serve the same requests with kernel="torch" (the plain path) and
   require completions_equivalent (the repo's margin-tolerant token
   parity), finite margins and logprobs, and in-vocabulary tokens;
5. time each kernel, its plain version and one PyTorch library call at
   the decode shape, beside its bound (bytes over the card's memory rate);
   paged attention also at the prefill chunk (B=1, S=16), and at both
   shapes with 1, 2, 4 and 16 block-table entries per CTA (the split);
6. run the paper's learning framework at the full HAPT size
   (``run_scenario("hapt")``: Cloud, GTL steps 0/2/4, noHTL; d=561, k=12,
   L=21, N=10929, kappa=64, 600 SVM steps) with kernel="cuda" (launch
   counts from 0, and no call of a plain version allowed) and then
   kernel="torch"; require equal GreedyTL selections (a first divergence
   only at a tie of the top two scores) and agreeing F-measures; print the
   F rows beside Cloud and the overhead report; time both kernels by
   CUDA-graph replay (Gram's TFLOP/s beside torch.bmm's, and whether G is
   bit-equal to the plain version; the scores kernel back to back and
   inside one captured GreedyTL pick, with its plan and its ptxas
   registers and spills), and each route's wall-clock with a
   stage breakdown and the device's busy share from a torch.profiler
   trace;
7. the paper's other studies at the full HAPT size, each on both routes
   (launch counts from 0 against 1 Gram and kappa scores launches per fit,
   the plain-version spy on the cuda route, wall-clock per route):
   ``run_scenario(corrupt_fn=...)`` with malicious1 and malicious2 at 0.5
   (the corrupted models drawn once and given to both routes; every pick
   equal, the F rows as check_f_rows holds them, mu-GTL beside noHTL_mu);
   ``run_dynamic_gtl`` and ``run_dynamic_nohtl`` at s = 1 (21 phases) and
   s = 4 (5 phases, one location dropped), with every phase's picks
   equal, the totems within 1e-4 and the F trace per phase; ``run_gtl``
   with 4 bags of 128 rows (bags shared by the routes); both kernels'
   times at these shapes; and ``python -m repro_torch.launch.train --arch
   gtl_paper`` in a subprocess, which must exit 0;
8. the no-cache prefill (``make_prefill_step``) of full-width qwen3_0_6b,
   zamba2_2_7b and rwkv6_7b (random bf16 weights from a seed; B=2,
   S=2048): flash attention and the chunked GLA scan held against their
   plain versions (bf16 and fp32; head_dim 64/80/128, GQA, window, chunk
   mask, ragged S; the scan's two modes, Dv 64/128, ragged S, extreme
   decay, Mamba2's stride-0 views; its final state too); each model
   through kernel="cuda" with launch counts from 0 (the scan's device
   kernels per call printed beside its count) and a spy that fails on any
   plain-version call, then kernel="torch" (no launch allowed); prefill
   tokens/s of both routes and a torch.profiler breakdown of the cuda
   route (which fails if the closed-form final state's cumsum still runs
   on a recurrent model); the two routes
   held to each other on the same weights widened to fp32 (every block
   from the same input, and the logits end to end, with the growth of
   their difference over the blocks), and each bf16 route's distance from
   that fp32 result; each
   kernel timed by CUDA-graph replay at the path's shapes beside its plain
   version, its bound and (flash attention) SDPA, with the achieved
   TFLOP/s of the bf16 flash kernel and of SDPA and the scan's registers
   and spills.  Every bf16 flash launch
   of the prefills must go to the tensor-core kernel
   (flash_attention_tc.cu); its ptxas report (registers, shared memory, no
   spills allowed) and its count of HGMMA instructions in the SASS
   (``cuobjdump -sass``, where the toolkit has it; none is a failure) are
   printed after the build.

Prints the card's name and power limit, a JSON line of kernels, and as the
last line ``{"ok": true, "device": {...}}``.  Exits non-zero without a
result when no CUDA device is available or the port is not beside it.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, fp32 on the
# CUDA cores, and bf16 on the tensor cores (dense)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
BF16_TOL = 1e-2  # bf16 output: one ulp below 2.0 is 7.8e-3; fp32 sum order

# GreedyTL at the paper's HAPT size (src/repro/data/synth.py HAPT_LIKE):
# B = L*k = 21*12 problems of m = 365 rows (partition_uniform's m_max over
# 7650 training rows) and n = 561 + 1 + 21 = 583 design columns.
HAPT_B, HAPT_M, HAPT_N = 252, 365, 583
# Gram of a unit-scale design (Z / sqrt(m), so G is O(1) as GreedyTL's
# G = Z^T Z / m is): two fp32 sums of m products in different orders differ
# by about sqrt(m) * 6e-8 = 1.1e-6 at m = 365; 1e-5 leaves room for the tail.
GRAM_TOL = 1e-5
# Scores: one IEEE multiply, add and divide on both sides, so at most an
# ulp apart (2.4e-7 relative), and in practice bit-equal.
SCORES_RTOL = 2.4e-7
# The two routes' G differ only by fp32 summation order (about 1e-6
# relative, above); through a ridge solve with lam = 3 (condition number of
# G_SS / m + lam I at most a few tens here) that moves a score by a few
# 1e-5 relative.  A first divergence of the selections counts as a tie when
# the two picks' scores lie within 1e-4 of the step's top score, relatively,
# under both routes' statistics.
TIE_RTOL = 1e-4


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, reps: int = 10) -> float:
    """Device time of one call of `fn`: `iters` calls captured in a CUDA
    graph, the graph replayed `reps` times between CUDA events (so the
    wrapper's host overhead per call is not what is timed)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def host_ms(fn, iters: int = 50) -> float:
    """Wall time of one eager call, host overhead included."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def paged_inputs(gen, *, B, S, H, KV, hd, psz, P, n_pages, lasts,
                 q_dtype, pool_dtype, pages_held=None):
    """Random paged-attention inputs on the card.  pages_held[b] pages of
    slot b's block-table row are real pages; the rest point at the null
    page 0 (lazy allocation's unallocated tail, or an idle lane)."""
    import torch
    dev = "cuda"
    randn = lambda *shape, dt: torch.randn(  # noqa: E731
        *shape, generator=gen, device=dev).to(dt)
    q = randn(B, S, H, hd, dt=q_dtype)
    kn, vn = randn(B, S, KV, hd, dt=q_dtype), randn(B, S, KV, hd, dt=q_dtype)
    kp = randn(n_pages, psz, KV, hd, dt=pool_dtype)
    vp = randn(n_pages, psz, KV, hd, dt=pool_dtype)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    bt = torch.zeros(B, P, dtype=torch.int32, device=dev)
    nxt = 0
    for b in range(B):
        held = P if pages_held is None else pages_held[b]
        bt[b, :held] = perm[nxt:nxt + held].to(torch.int32)
        nxt += held
    last = torch.tensor(lasts, dtype=torch.int32, device=dev)
    return q, kn, vn, kp, vp, bt, last


def check_paged_attention(ops, ref, gen, cases):
    """Kernel vs plain version on copies of the same inputs: the fused
    update, then attention only on the pools it wrote; each output within
    BF16_TOL (or 1e-4 in fp32) and finite, the pools bit-equal outside the
    null page.  A case's `window` is passed to both.  Returns the max abs
    output error."""
    import torch
    worst = 0.0
    for name, kw in cases:
        kw = dict(kw)
        window = kw.pop("window", 0)
        q, kn, vn, kp, vp, bt, last = paged_inputs(gen, **kw)
        kp2, vp2 = kp.clone(), vp.clone()
        out, _, _ = ops.paged_attention_update(q, kn, vn, kp, vp, bt, last,
                                               window=window)
        want, _, _ = ref.reference_paged_update(q, kn, vn, kp2, vp2, bt,
                                                last, window=window)
        torch.cuda.synchronize()
        pool_err = max((kp[1:] - kp2[1:]).abs().max().item(),
                       (vp[1:] - vp2[1:]).abs().max().item())
        kp2[0], vp2[0] = kp[0], vp[0]  # the null page's racy rows
        only = ops.paged_attention(q, kp, vp, bt, last, window=window)
        only_want = ref.reference_paged_attention_block(q, kp2, vp2, bt,
                                                        last, window=window)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        only_err = (only.float() - only_want.float()).abs().max().item()
        tol = BF16_TOL if q.dtype == torch.bfloat16 else 1e-4
        finite = bool(torch.isfinite(out).all() and torch.isfinite(only).all())
        print(f"paged_attention {name}: max_abs_err={err:.3g} attention-only "
              f"{only_err:.3g} (tol {tol}) pool_err={pool_err:.3g} (tol 0) "
              f"finite={finite}")
        if not (max(err, only_err) <= tol and pool_err == 0 and finite):
            raise AssertionError(f"paged_attention {name}: kernel disagrees "
                                 f"with its plain version")
        worst = max(worst, err, only_err)
    return worst


def requests(cfg, Request, SamplingParams):
    import numpy as np
    rng = np.random.default_rng(13)
    sp = [None,
          SamplingParams(temperature=0.8, top_k=50, seed=1),
          None,
          SamplingParams(temperature=0.9, seed=3),          # best_of=2
          SamplingParams(temperature=0.7, top_p=0.9, seed=4),
          None]
    return [Request(rid=i, prompt=rng.integers(
        1, cfg.vocab_size, 17 + 11 * i).tolist(), max_new=24, sampling=sp[i],
        best_of=2 if i == 3 else 1) for i in range(6)]


def serve(cfg, params, kernel, reqs, ContinuousBatcher, ServingConfig,
          snapshots=None):
    """Drive the batcher to completion, force-preempting rid 1 on its
    third decode tick; returns (batcher, completions, seconds)."""
    import torch
    b = ContinuousBatcher(cfg, params, ServingConfig(
        n_slots=4, capacity=256, cache_layout="paged", kernel=kernel,
        allocation="lazy", prefill_chunk=16), device="cuda")
    b.submit(reqs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ticks = 0
    preempted = False
    while b.step():
        ticks += 1
        if snapshots is not None:
            live = b.engine.slot_pos[[r is not None for r in b.slot_req]]
            snapshots.append(live.copy())
        if ticks == 3:
            preempted = b.preempt(1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if not preempted or b.preemptions < 1:
        raise AssertionError("the forced preemption did not happen")
    return b, list(b.done), secs


def check_completions(cfg, done, reqs):
    import math
    if sorted(c.rid for c in done) != sorted(r.rid for r in reqs):
        raise AssertionError("missing completions")
    for c in done:
        if len(c.tokens) != 24 or not all(0 <= t < cfg.vocab_size
                                          for t in c.tokens):
            raise AssertionError(f"rid {c.rid}: bad tokens {c.tokens}")
        if not all(math.isfinite(x) for x in c.margins + c.logprobs):
            raise AssertionError(f"rid {c.rid}: non-finite margins/logprobs")


def bound_ms(B, S, H, KV, hd, psz, lasts, q_bytes, pool_bytes, P):
    """Least time for one fused update at these inputs: each input read
    once, each output written once (pool entries counted only where this
    data's mask admits them), over the HBM rate; or its fp32 flops over
    the fp32 peak, whichever is larger."""
    entries = sum(min(last + 1, P * psz) for last in lasts)
    rows = S * H // KV
    byts = (B * S * H * hd * q_bytes * 2                  # q in, out
            + 2 * B * S * KV * hd * (q_bytes + pool_bytes)  # new rows
            + 2 * entries * KV * hd * pool_bytes          # K/V read
            + B * P * 4 + B * S * 4 + B * 4)              # table, positions
    flops = 4 * hd * rows * KV * entries
    return roofline_ms(byts, flops)


def roofline_ms(byts, flops, flop_per_s=FP32_FLOP_PER_S):
    """(the larger of bytes over the HBM rate and flops over the given
    peak (fp32 on the CUDA cores by default), in ms; which of the two it
    is)."""
    t_b, t_f = byts / HBM_BYTES_PER_S, flops / flop_per_s
    return 1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


def gram_bound_ms(B, m, n):
    """Least time for B Gram matrices: G is symmetric, so n(n+1)/2 sums of
    m fused multiply-adds each (B*m*n*(n+1) fp32 flops on the CUDA cores),
    or Z read once and G written once over the HBM rate."""
    return roofline_ms(4 * B * (m * n + n * n), B * m * n * (n + 1))


def scores_bound_ms(B, n):
    """Least time for one scoring pass: corr, diag (fp32) and the bool mask
    read once, scores (fp32) and the indices (int32) written once; 3 flops
    per column."""
    return roofline_ms(B * n * (4 + 4 + 1 + 4) + 4 * B, 3 * B * n)


def check_gram(gops, gref, gen, cases):
    """Gram kernel vs plain version on unit-scale designs: within GRAM_TOL,
    finite, and bit-symmetric.  Returns the max abs error."""
    import torch
    worst = 0.0
    for B, m, n in cases:
        Z = torch.randn(B, m, n, generator=gen, device="cuda") / m ** 0.5
        G = gops.gram(Z)
        want = gref.reference_gram(Z)
        torch.cuda.synchronize()
        err = (G - want).abs().max().item()
        rel = err / want.abs().max().item()
        sym = torch.equal(G, G.mT)
        print(f"gram (B={B}, m={m}, n={n}): max_abs_err={err:.3g} "
              f"max_rel_err={rel:.3g} (tol {GRAM_TOL}) bit-symmetric={sym}")
        if not (err <= GRAM_TOL and sym and torch.isfinite(G).all()):
            raise AssertionError(f"gram (B={B}, m={m}, n={n}): kernel "
                                 f"disagrees with its plain version")
        worst = max(worst, err)
    return worst


def scores_edge_rows(n, lam=3.0):
    """Rows (numpy: corr, diag (R, n) float32, selected (R, n) bool) on
    the edges of the scores kernel's argmax rule: every column selected;
    NaN first, mid-row and last (the first NaN wins); +0 and -0 tied;
    diag + lam = 0 (+inf, and NaN where corr is 0 too); equal top scores
    planted across lanes, warps, teams and passes (the lowest index wins);
    every score -inf; -inf beside one selected column (-1e30 wins); and a
    random row.  Columns collapse where n is small."""
    import numpy as np
    rng = np.random.default_rng(n)
    rows = []

    def row():
        c = rng.normal(size=n).astype(np.float32)
        d = (rng.random(n) + 0.05).astype(np.float32)
        return c, d, rng.random(n) < 0.2

    c, d, m = row()
    rows.append((c, d, np.ones(n, bool)))                  # all selected
    for at in (0, n // 2, n - 1):                          # NaN
        c, d, m = row()
        c[at] = np.nan
        c[min(at + 3, n - 1)] = np.nan                     # a later NaN
        m[at] = False
        rows.append((c, d, m))
    c, d, m = row()                                        # +0 / -0 ties
    c[:] = 0.0
    d[:] = np.where(np.arange(n) % 2 == 1, -lam - 1.0, 1.0)
    m[:] = False
    m[0] = n > 1
    rows.append((c, d, m))
    c, d, m = row()                                        # diag + lam = 0
    d[[n // 3, n - 1]] = -lam
    c[[n // 3, n - 1]] = 1.0
    m[[n // 3, n - 1]] = False
    rows.append((c.copy(), d.copy(), m.copy()))
    c[n - 1] = 0.0                                         # 0 / 0: NaN
    rows.append((c, d, m))
    for cols in ([n - 1, 5, 37], [2 * n // 3, n // 3 + 1, 33],
                 [1, 1 + 32, 1 + 24 * 32], [3 + 24 * 256, 3],
                 [n - 1, n - 2]):
        cols = [j % n for j in cols]                       # planted ties
        c, d, m = row()
        c[cols], d[cols], m[cols] = 1e3, 1.0, False
        rows.append((c, d, m))
    c, d, m = row()                                        # all -inf
    c[:], d[:], m[:] = np.inf, -lam - 1.0, False
    rows.append((c.copy(), d.copy(), m.copy()))
    m[n // 2] = True
    rows.append((c, d, m))
    rows.append(row())
    return tuple(np.stack(a) for a in zip(*rows))


def same_scores(s, want):
    """Scores equal bit for bit but for NaN's payload: NaN at the same
    places, elsewhere the same values and the same signs of zero."""
    import torch
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(s), nan):
        return False
    s, want = s.masked_fill(nan, 0.0), want.masked_fill(nan, 0.0)
    return torch.equal(s, want) and torch.equal(torch.signbit(s),
                                                torch.signbit(want))


def check_scores(gops, gref, gen, cases, lam=3.0, edge_ns=()):
    """Scores kernel vs plain version: scores within SCORES_RTOL and the
    argmax indices equal, except where the plain version's scores at the
    two indices are equal (a tie); a planted tie must go to the lowest
    index.  Then scores_edge_rows(n) at each n of edge_ns: scores equal
    but for NaN's payload, and the same argmax in every row.  Returns the
    max abs error of the unselected scores."""
    import torch
    worst = 0.0
    for name, B, n, p_sel, tie in cases:
        corr = torch.randn(B, n, generator=gen, device="cuda")
        diag = torch.rand(B, n, generator=gen, device="cuda") + 0.05
        sel = torch.rand(B, n, generator=gen, device="cuda") < p_sel
        if tie:  # columns 7 and n - 3: the same, largest, unselected score
            corr[:, [7, n - 3]] = 1e3
            diag[:, [7, n - 3]] = 1.0
            sel[:, [7, n - 3]] = False
        s, idx = gops.scores_argmax(corr, diag, sel, lam)
        want, widx = gref.reference_scores(corr, diag, sel, lam)
        torch.cuda.synchronize()
        err = (s - want).abs().max().item()
        close = torch.allclose(s, want, rtol=SCORES_RTOL, atol=0)
        differ = idx != widx
        at_tie = want.gather(1, idx.long()[:, None]) \
            == want.gather(1, widx.long()[:, None])
        bad = int((differ & ~at_tie[:, 0]).sum())
        planted = not tie or bool((idx == 7).all())
        print(f"scores_argmax {name} (B={B}, n={n}, selected "
              f"{float(sel.float().mean()):.2f}): max_abs_err={err:.3g} "
              f"(rtol {SCORES_RTOL}) bit-equal={torch.equal(s, want)} "
              f"argmax differs in {int(differ.sum())} rows, {bad} not at a "
              f"tie; planted tie -> lowest index: {planted}")
        if not (close and bad == 0 and planted):
            raise AssertionError(f"scores_argmax {name}: kernel disagrees "
                                 f"with its plain version")
        worst = max(worst, err)
    for n in edge_ns:
        corr, diag, sel = (torch.from_numpy(a).cuda()
                           for a in scores_edge_rows(n, lam))
        s, idx = gops.scores_argmax(corr, diag, sel, lam)
        want, widx = gref.reference_scores(corr, diag, sel, lam)
        torch.cuda.synchronize()
        same = same_scores(s, want)
        team = gops.scores_plan(len(sel), n, gops._sm_count(sel.device))[0]
        print(f"scores_argmax edge rows (n={n}, team {team} lanes): scores "
              f"equal to the plain version's {same}; argmax {idx.tolist()} "
              f"(plain {widx.tolist()})")
        if not (same and torch.equal(idx, widx)):
            raise AssertionError(f"scores_argmax edge rows (n={n}): kernel "
                                 f"disagrees with its plain version")
    return worst


def pick_inputs(B, m, n, kappa, t, gen, lam=3.0, device="cuda"):
    """GreedyTL's state before pick t at the given shape: G = Z^T Z / m and
    c = Z^T y / m of a random design, picks 0 .. t - 1 made by the plain
    path, and the ridge re-fit w on them.  Returns the arguments of
    greedytl.greedy_pick but for t, lam and score."""
    import torch
    from repro_torch.core import greedytl
    from repro_torch.kernels.greedy_scores import ref as gref
    Z = torch.randn(B, m, n, generator=gen, device=device)
    y = torch.randn(B, m, generator=gen, device=device).sign()
    G = Z.mT @ Z / m
    c = (Z.mT @ y[..., None])[..., 0] / m
    diag = torch.diagonal(G, dim1=1, dim2=2).contiguous()
    rows = torch.arange(B, device=device)
    slots = torch.arange(kappa, device=device)
    idx = torch.full((B, kappa), -1, dtype=torch.long, device=device)
    G_cols = torch.zeros(B, n, kappa, device=device)
    selected = torch.zeros(B, n, dtype=torch.bool, device=device)
    for k in range(t + 1):
        w = greedytl._masked_ridge_solve(G_cols, c, idx, slots < k, lam)
        if k < t:
            greedytl.greedy_pick(G, c, diag, G_cols, w, idx, selected, rows,
                                 k, lam, gref.reference_scores)
    return G, c, diag, G_cols, w, idx, selected, rows


def pick_ms(state, t, score, lam=3.0, iters=10, reps=10, rounds=5):
    """Device time of one GreedyTL pick after its ridge re-fit
    (greedytl.greedy_pick: residual correlation, `score`, index updates),
    captured in a CUDA graph as its kernels run back to back in the loop;
    beside it the same pick with `score` replaced by its precomputed
    result: the difference is the scores' time inside the pick.  Each
    replayed pick ends by restoring `selected`, so every replay picks the
    same columns and gathers the same column of G on both sides (a pick
    that selected a new column each replay would gather a column of G not
    yet in L2 where the other side does not).  The two are timed in turns,
    `rounds` times; returns their medians (pick ms, pick without the
    scores ms).  The state's idx and G_cols are overwritten."""
    from repro_torch.core import greedytl
    G, c, diag, G_cols, w, idx, selected, rows = state
    before = selected.clone()
    fixed = score(c - (G_cols @ w[:, :, None])[:, :, 0], diag, selected, lam)

    def pick(fn):
        def run():
            greedytl.greedy_pick(G, c, diag, G_cols, w, idx, selected, rows,
                                 t, lam, fn)
            selected.copy_(before)
        return run
    times = [(time_ms(pick(score), iters, reps),
              time_ms(pick(lambda *a: fixed), iters, reps))
             for _ in range(rounds)]
    return (sorted(a for a, _ in times)[rounds // 2],
            sorted(b for _, b in times)[rounds // 2])


def step_scores(G, c, prefix, lam):
    """GreedyTL's candidate scores for one problem after the picks in
    `prefix` (plain arithmetic, written out here): ridge re-fit on the
    picked columns, residual correlation, corr^2 / (G_jj + lam), picked
    columns at -inf."""
    import torch
    S = torch.as_tensor(prefix, dtype=torch.long, device=G.device)
    r = c
    if len(S):
        w = torch.linalg.solve(
            G[S][:, S] + lam * torch.eye(len(S), device=G.device), c[S])
        r = c - G[:, S] @ w
    s = r * r / (torch.diagonal(G) + lam)
    s[S] = -float("inf")
    return s


def check_selections(res_c, res_t, lam):
    """Selections of the two routes equal, or, where a problem's picks
    first differ, both picks within TIE_RTOL of the step's top score under
    both routes' statistics.  Returns the number of problems that
    diverged."""
    import numpy as np
    import torch
    from repro_torch.core import base_learner as bl
    from repro_torch.core import greedytl, gtl
    from repro_torch.core.experiment import make_scenario
    sel_c = res_c.gtl.gtl_selected.cpu().numpy()
    sel_t = res_t.gtl.gtl_selected.cpu().numpy()
    diverged = np.argwhere((sel_c != sel_t).any(-1))
    same_base = bool(torch.equal(res_c.gtl.base.W, res_t.gtl.base.W))
    print(f"GreedyTL selections: {sel_c.shape[0] * sel_c.shape[1]} problems "
          f"x {sel_c.shape[2]} picks; {len(diverged)} differ between the "
          f"routes; base models bit-equal: {same_base}")
    if not len(diverged):
        return 0
    shards, _, _ = make_scenario("hapt", 0, device="cuda")
    base = res_t.gtl.base
    k = base.W.shape[1]
    for l, cls in diverged:
        t = int(np.argmax(sel_c[l, cls] != sel_t[l, cls]))
        picks = (int(sel_c[l, cls, t]), int(sel_t[l, cls, t]))
        X = torch.as_tensor(shards.X[l], device="cuda")
        mask = torch.as_tensor(shards.mask[l], device="cuda")
        y = bl.onehot_pm(torch.as_tensor(shards.y[l], device="cuda"),
                         k)[cls] * mask
        H = gtl.source_margins(X, base)[cls]
        Z, _ = greedytl.build_design(X, H, mask)
        gaps = []
        for route in ("cuda", "torch"):
            G, c = greedytl.gram_stats(Z[None], y[None], mask[None],
                                       kernel=route)
            s = step_scores(G[0], c[0], sel_t[l, cls, :t], lam)
            top = s.max()
            gaps += [((top - s[j]) / top).item() for j in picks]
        print(f"  location {l} class {cls}: first differs at pick {t} "
              f"(cuda {picks[0]}, torch {picks[1]}); relative gaps to the "
              f"top score {[f'{g:.3g}' for g in gaps]} (tie tol {TIE_RTOL})")
        if max(gaps) > TIE_RTOL:
            raise AssertionError("the GreedyTL selections differ away from "
                                 "a tie")
    return len(diverged)


def check_f_rows(res_c, res_t, yte, k):
    """Every F-measure row of the two routes agrees within what two
    flipped test predictions can move it: one flip moves precision by
    1/n_test and one class's recall by at most 1/(k n_c), and F by at most
    twice their sum."""
    import numpy as np
    counts = np.bincount(yte.cpu().numpy(), minlength=k)
    flip = 2.0 * (1.0 / len(yte) + 1.0 / (k * counts[counts > 0].min()))
    tol = 2 * flip
    rows_c = dict(res_c.summary_rows())
    rows_t = dict(res_t.summary_rows())
    worst = max(
        max(abs(rows_c[n] - rows_t[n]) for n in rows_c),
        float(np.abs(res_c.f_local - res_t.f_local).max()),
        float(np.abs(res_c.f_gtl2 - res_t.f_gtl2).max()))
    print(f"F-measure rows (kernel=cuda / kernel=torch; max |diff| "
          f"{worst:.3g}, tol {tol:.3g} = two flipped test predictions):")
    for n in rows_c:
        print(f"  {n:14s} {rows_c[n]:.6f} / {rows_t[n]:.6f}")
    print(f"  Cloud {rows_c['Cloud']:.6f} beside mu-GTL(4) "
          f"{rows_c['mu-GTL(4)']:.6f}, noHTL_mu {rows_c['noHTL_mu']:.6f}; "
          f"PPG mu-GTL(4) over local (mean) "
          f"{float(np.mean(res_c.ppg()['gtl4_mu'])):.4f}")
    if worst > tol:
        raise AssertionError("the two routes' F-measures disagree")
    return worst


def learning_breakdown(card, kernel, kappa=64, lam=3.0):
    """Where run_scenario('hapt') spends its time: each stage of
    run_scenario_on run on its own, synchronised, on the same data; and the
    device's busy share over one whole run, from a torch.profiler trace
    (the sum of the device kernels' times over the wall-clock)."""
    import torch
    from repro_torch.core import base_learner as bl
    from repro_torch.core import greedytl, gtl
    from repro_torch.core.experiment import make_scenario, run_scenario
    shards, (Xte, yte), spec = make_scenario("hapt", 0, device="cuda")
    k = spec.n_classes
    stages = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return out

    with bl.fp32_matmuls():
        X, y, mask = gtl.shard_tensors(shards, "cuda")
        timed("Cloud SVM", lambda: bl.fit_linear_svm(
            X.reshape(-1, X.shape[-1]), y.reshape(-1), k,
            sample_mask=mask.reshape(-1)))
        base = timed("local SVMs (GTL step 0)",
                     lambda: gtl.train_base_models(X, y, mask, k))

        def stats():
            H = gtl.source_margins(X, gtl.received_sets(base, base))
            Y = bl.onehot_pm(y, k) * mask[..., None, :]
            Z, _ = greedytl.build_design(X[:, None], H, mask[:, None])
            return greedytl.gram_stats(Z, Y, mask[:, None].expand(Y.shape),
                                       kernel=kernel)
        G, c = timed("design + Gram statistics", stats)
        timed(f"GreedyTL loop ({kappa} picks)",
              lambda: greedytl.greedytl_from_gram(G, c, kappa, lam, kernel))
        timed("local SVMs again (noHTL)",
              lambda: gtl.train_base_models(X, y, mask, k))
    total = sum(stages.values())
    print(f"run_scenario('hapt') stages, kernel={kernel} [{card}]: " + ", ".join(
        f"{n} {1e3 * t:.1f} ms" for n, t in stages.items())
        + f"; sum {1e3 * total:.1f} ms")

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_scenario("hapt", kernel=kernel, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us, launches = 0.0, 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # CPU ops also report the time of what they launched
        t = getattr(e, "self_device_time_total", None)
        dev_us += getattr(e, "self_cuda_time_total", 0) if t is None else t
        launches += e.count
    busy = (f"{1e-3 * dev_us:.1f} ms of device kernel time over {launches} "
            f"device events, busy share {1e-6 * dev_us / wall:.3f}"
            if dev_us > 0 else "device time not measured (the trace held "
            "no device events)")
    print(f"run_scenario('hapt') traced, kernel={kernel} [{card}]: wall "
          f"{1e3 * wall:.1f} ms (profiler on), {busy}")


def two_routes(card, label, fn, expect):
    """fn(kernel) on the cuda route with both kernels' counts from 0 and a
    spy that fails on any call of their plain versions, then on the torch
    route (no launch allowed); prints the launch counts against `expect`
    ((gram, scores_argmax)) and each route's wall-clock.  Returns
    (cuda result, torch result, {route: seconds})."""
    import torch
    from repro_torch.kernels.greedy_scores import ops as gops
    from repro_torch.kernels.greedy_scores import ref as gref
    plain_calls = []
    real = gref.reference_gram, gref.reference_scores

    def spy(fn):
        def call(*a, **kw):
            plain_calls.append(fn.__name__)
            return fn(*a, **kw)
        return call
    secs = {}
    gref.reference_gram, gref.reference_scores = map(spy, real)
    gops.gram.launches = gops.scores_argmax.launches = 0
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_c = fn("cuda")
        torch.cuda.synchronize()
        secs["cuda"] = time.perf_counter() - t0
    finally:
        gref.reference_gram, gref.reference_scores = real
    launches = (gops.gram.launches, gops.scores_argmax.launches)
    print(f"{label} kernel=cuda: launches gram {launches[0]}, scores_argmax "
          f"{launches[1]} (expected {expect[0]}, {expect[1]}); plain "
          f"versions called: {len(plain_calls)}")
    if launches != tuple(expect) or plain_calls:
        raise AssertionError(f"{label}: the cuda route did not run through "
                             f"both kernels alone, as often as expected")
    t0 = time.perf_counter()
    out_t = fn("torch")
    torch.cuda.synchronize()
    secs["torch"] = time.perf_counter() - t0
    if (gops.gram.launches, gops.scores_argmax.launches) != launches:
        raise AssertionError(f"{label}: kernel='torch' launched a kernel")
    print(f"{label} wall-clock [{card}]: kernel=cuda {secs['cuda']:.3f} s, "
          f"kernel=torch {secs['torch']:.3f} s")
    return out_c, out_t, secs


def learning_phase(card, gen):
    """Phase 6: the paper's framework at the full HAPT size through both
    kernels; returns their entries of the kernels line."""
    import torch
    from repro_torch.core.experiment import run_scenario
    from repro_torch.kernels.greedy_scores import ops as gops
    from repro_torch.kernels.greedy_scores import ref as gref

    B, m, n = HAPT_B, HAPT_M, HAPT_N
    gram_err = check_gram(gops, gref, gen, [(B, m, n), (3, 37, 45),
                                            (2, 1, 70)])
    scores_err = check_scores(gops, gref, gen, [
        ("HAPT", B, n, 32 / n, False),
        ("ragged", 5, 45, 0.2, False),
        ("many selected", B, n, 0.9, False),
        ("planted tie", 4, n, 0.5, True)],
        edge_ns=(1, 31, 32, 33, n, 4097, 16384))

    # the main path: counts from 0, and no plain version may run on it
    kappa = 64
    res_c, res_t, secs = two_routes(
        card, "learning path run_scenario('hapt')",
        lambda kernel: run_scenario("hapt", kernel=kernel, device="cuda"),
        (1, kappa))
    launches = {"gram": 1, "scores_argmax": kappa}
    diverged = check_selections(res_c, res_t, 3.0)
    from repro_torch.core.experiment import make_scenario
    _, (_, yte), _ = make_scenario("hapt", 0, device="cuda")
    check_f_rows(res_c, res_t, yte, 12)
    o = res_c.overhead
    print(f"overhead (HAPT, d0={o.d0}, d1={o.d1}): OH^GTL {o.oh_gtl_mb:.2f} "
          f"MB, OH_mu^noHTL {o.oh_nohtl_mu_mb:.2f} MB, OH_mv^noHTL "
          f"{o.oh_nohtl_mv_mb:.2f} MB, OH^cl {o.oh_cloud_mb:.2f} MB, "
          f"gains {o.gains()}")

    # wall-clock per route, in turns (the first runs above include warm-up)
    walls = {route: [t] for route, t in secs.items()}
    for route in ("torch", "cuda", "cuda", "torch"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_scenario("hapt", kernel=route, device="cuda")
        torch.cuda.synchronize()
        walls[route].append(time.perf_counter() - t0)
    print(f"run_scenario('hapt') wall-clock [{card}]: kernel=cuda "
          f"{[round(w, 3) for w in walls['cuda']]} s (first incl. warm-up), "
          f"kernel=torch {[round(w, 3) for w in walls['torch']]} s; "
          f"{diverged} selection divergences at ties")

    for route in ("cuda", "torch"):
        learning_breakdown(card, route)

    # kernel timing at the HAPT shapes (CUDA-graph replay)
    Z = torch.randn(B, m, n, generator=gen, device="cuda") / m ** 0.5
    g_ms = time_ms(lambda: gops.gram(Z), iters=5, reps=4)
    g_plain = time_ms(lambda: gref.reference_gram(Z), iters=5, reps=4)
    Zt = Z.mT
    g_lib = time_ms(lambda: torch.bmm(Zt, Z), iters=5, reps=4)
    g_bound, g_by = gram_bound_ms(B, m, n)
    g_equal = torch.equal(gops.gram(Z), gref.reference_gram(Z))
    g_flop = B * m * n * (n + 1)  # the minimal count (upper triangle)
    corr = torch.randn(B, n, generator=gen, device="cuda")
    diag = torch.rand(B, n, generator=gen, device="cuda") + 0.05
    sel = torch.rand(B, n, generator=gen, device="cuda") < 32 / n
    s_ms = time_ms(lambda: gops.scores_argmax(corr, diag, sel, 3.0))
    s_plain = time_ms(lambda: gref.reference_scores(corr, diag, sel, 3.0))
    s_bound, s_by = scores_bound_ms(B, n)
    p_ms, p_rest = pick_ms(pick_inputs(B, m, n, 64, 32, gen), 32,
                           gops.scores_argmax)
    print(f"gram (B={B}, m={m}, n={n}) [{card}]: kernel {g_ms:.4f} ms, "
          f"plain {g_plain:.4f} ms, torch.bmm {g_lib:.4f} ms, bound "
          f"{g_bound:.4f} ms ({g_by}); TFLOP/s of the minimal count "
          f"{g_flop / g_ms * 1e-9:.1f} (kernel), "
          f"{g_flop / g_lib * 1e-9:.1f} (torch.bmm, which computes both "
          f"halves); G bit-equal to the plain version: {g_equal}")
    print(f"scores_argmax (B={B}, n={n}) [{card}]: kernel {s_ms:.4f} ms "
          f"(back to back), plain {s_plain:.4f} ms, library -, bound "
          f"{s_bound:.5f} ms ({s_by}); plan (lanes, columns a pass, problems "
          f"per CTA) "
          f"{gops.scores_plan(B, n, gops._sm_count(corr.device))}")
    from repro_torch.kernels import _build
    print("scores_argmax_kernel ptxas (lanes per problem: registers, spilled "
          "bytes): " + ", ".join(f"{t}: {r}, {sp}" for t, (r, sp) in sorted(
              scores_ptxas(_build, gops).items())))
    print(f"GreedyTL pick 32 of 64 after its ridge re-fit (B={B}, n={n}), "
          f"one CUDA graph, median of 5 [{card}]: {p_ms:.4f} ms, without the "
          f"scores {p_rest:.4f} ms: scores inside the pick "
          f"{p_ms - p_rest:.4f} ms")
    src = "src/repro_torch/kernels/greedy_scores/csrc/greedy_scores.cu"
    tpu = "src/repro/kernels/greedy_scores/greedy_scores.py"
    return [
        {"name": "gram", "route": "cuda", "source": src,
         "replaces": f"{tpu}:54", "launches": launches["gram"],
         "max_abs_err": gram_err, "ms": g_ms, "plain_ms": g_plain,
         "bound_ms": g_bound, "bound_by": g_by, "library_ms": g_lib},
        {"name": "scores_argmax", "route": "cuda", "source": src,
         "replaces": f"{tpu}:93", "launches": launches["scores_argmax"],
         "max_abs_err": scores_err, "ms": s_ms, "plain_ms": s_plain,
         "bound_ms": s_bound, "bound_by": s_by, "library_ms": None},
    ]

# ------------------------------------------- the paper's other studies

# the tolerance the CPU tests hold the totem to (tests/test_torch_dynamic.py)
TOTEM_TOL = 1e-4
# bagged GreedyTL: bags of 128 of a location's 365 rows (paper Section 3:
# GreedyTL on small random subsamples of a large local dataset)
N_BAGS, BAG_SIZE = 4, 128


def same_picks(label, sel_c, sel_t):
    """Every GreedyTL pick of every problem equal across the routes."""
    import torch
    differ = int((sel_c != sel_t).any(-1).sum())
    print(f"{label}: {sel_c.numel() // sel_c.shape[-1]} problems x "
          f"{sel_c.shape[-1]} picks; {differ} problems differ between the "
          f"routes")
    if not torch.equal(sel_c, sel_t):
        raise AssertionError(f"{label}: the routes picked different columns")


def studies_phase(card):
    """Phase 7: the paper's malicious-device (Section 7) and dynamic
    (Section 10) studies, bagged GreedyTL and the gtl_paper launcher at the
    full HAPT size, each on both routes."""
    import torch
    from repro_torch.core import corruption, dynamic, greedytl, gtl
    from repro_torch.core.experiment import make_scenario, run_scenario
    from repro_torch.training import metrics as M
    kappa = 64
    shards, (Xte, yte), spec = make_scenario("hapt", 0, device="cuda")
    k, L = spec.n_classes, spec.n_locations

    # Section 7: the corrupted models drawn once (from the cuda route's
    # honest models) and handed to both routes, GTL and noHTL alike
    for i, (kind, corrupt) in enumerate((
            ("malicious1", lambda g, m: corruption.corrupt_malicious1(
                g, m, 0.5)[0]),
            ("malicious2", lambda g, m: corruption.corrupt_malicious2(
                g, m, 0.5)))):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        drawn = []

        def corrupt_fn(models, corrupt=corrupt, gen=gen, drawn=drawn):
            if not drawn:
                drawn[:] = [models, corrupt(gen, models)]
            drawn.append(torch.equal(models.W, drawn[0].W)
                         and torch.equal(models.b, drawn[0].b))
            return drawn[1]
        res_c, res_t, _ = two_routes(
            card, f"Section 7 {kind} 0.5 run_scenario('hapt')",
            lambda kernel: run_scenario("hapt", corrupt_fn=corrupt_fn,
                                        kernel=kernel, device="cuda"),
            (1, kappa))
        changed = (drawn[1].W != drawn[0].W).float()
        print(f"  {kind}: share of parameters replaced "
              f"{float(changed.mean()):.4f}, locations whose model changed "
              f"{int(changed.flatten(1).amax(1).sum())} of {L}; honest "
              f"models bit-equal at every call: {all(drawn[2:])}")
        same_picks(f"  {kind} GreedyTL selections", res_c.gtl.gtl_selected,
                   res_t.gtl.gtl_selected)
        check_f_rows(res_c, res_t, yte, k)
        print(f"  {kind} at 0.5 [{card}]: mu-GTL(4) {res_c.f_gtl4_mu:.6f} "
              f"against noHTL_mu {res_c.f_nohtl_mu:.6f} (mv-GTL(4) "
              f"{res_c.f_gtl4_mv:.6f}, noHTL_mv {res_c.f_nohtl_mv:.6f}, "
              f"Cloud {res_c.f_cloud:.6f})")

    # Section 10: arrivals in phases around the totem
    def f_of(model):
        return float(M.f_measure(yte, gtl.predict_linear(model, Xte), k))
    for s in (1, 4):
        n_ph = L // s
        (tr_c, f_c), (tr_t, f_t), _ = two_routes(
            card, f"Section 10 run_dynamic_gtl s={s} ({n_ph} phases)",
            lambda kernel: dynamic.run_dynamic_gtl(
                shards, k, s, kappa=kappa, eval_fn=f_of, kernel=kernel,
                device="cuda"), (n_ph, n_ph * kappa))
        same_picks(f"  s={s} GreedyTL selections, every phase", tr_c.selected,
                   tr_t.selected)
        gap = float((tr_c.models - tr_t.models).abs().max())
        print(f"  s={s} totem: max |cuda - torch| over the phases {gap:.3g} "
              f"(tol {TOTEM_TOL}); locations dropped as a tail: {L % s}")
        if gap > TOTEM_TOL:
            raise AssertionError(f"s={s}: the routes' totems disagree")
        (nt, f_n), _, _ = two_routes(
            card, f"Section 10 run_dynamic_nohtl s={s}",
            lambda kernel: dynamic.run_dynamic_nohtl(
                shards, k, s, eval_fn=f_of, device="cuda"), (0, 0))
        print(f"  s={s} F per phase (GTL cuda / GTL torch / noHTL):")
        for p in range(n_ph):
            print(f"    phase {p + 1:2d}: {f_c[p]:.6f} / {f_t[p]:.6f} / "
                  f"{f_n[p]:.6f}")

    # bagged GreedyTL: the bags drawn once, shared by both routes
    mask = torch.as_tensor(shards.mask, device="cuda")
    rows = greedytl.draw_bag_rows(torch.Generator(device="cuda").manual_seed(
        5), mask, N_BAGS, BAG_SIZE)
    res_c, res_t, _ = two_routes(
        card, f"bagged run_gtl (n_bags={N_BAGS}, bag_size={BAG_SIZE}: "
              f"{L * N_BAGS * k} problems of {BAG_SIZE} rows)",
        lambda kernel: gtl.run_gtl(shards, k, kappa=kappa, n_bags=N_BAGS,
                                   bag_size=BAG_SIZE, bag_rows=rows,
                                   kernel=kernel, device="cuda"), (1, kappa))
    same_picks("  bagged, bag 0's GreedyTL selections", res_c.gtl_selected,
               res_t.gtl_selected)
    support = torch.equal(res_c.gtl_coef != 0, res_t.gtl_coef != 0)
    nnz = float((res_c.gtl_coef != 0).sum(-1).float().mean())
    gap = float((res_c.gtl_coef - res_t.gtl_coef).abs().max())
    print(f"  bagged: supports of the bags' mean equal across routes "
          f"{support} (mean nonzeros per problem {nnz:.1f} of {kappa} picks "
          f"a bag); max |coef cuda - torch| {gap:.3g}; mu-GTL(4) F "
          f"{f_of(res_c.consensus_flat):.6f} / "
          f"{f_of(res_t.consensus_flat):.6f}")
    if not support:
        raise AssertionError("bagged: the routes' supports differ")

    # both kernels timed at these studies' shapes (CUDA-graph replay): a
    # dynamic phase's s * k problems of m = 365 rows against L_src = s or
    # s + 1 sources, and the bagged fit's problems of BAG_SIZE rows
    from repro_torch.kernels.greedy_scores import ops as gops
    from repro_torch.kernels.greedy_scores import ref as gref
    gen = torch.Generator(device="cuda").manual_seed(9)
    m = shards.X.shape[1]
    d1 = shards.X.shape[-1] + 1
    for what, B, m_rows, n in (("s=1 first phase", k, m, d1 + 1),
                               ("s=1 later phases", k, m, d1 + 2),
                               ("s=4 first phase", 4 * k, m, d1 + 4),
                               ("s=4 later phases", 4 * k, m, d1 + 5),
                               ("bagged", L * N_BAGS * k, BAG_SIZE, d1 + L)):
        Z = torch.randn(B, m_rows, n, generator=gen,
                        device="cuda") / m_rows ** 0.5
        g_ms = time_ms(lambda: gops.gram(Z), iters=5, reps=4)
        g_plain = time_ms(lambda: gref.reference_gram(Z), iters=5, reps=4)
        Zt = Z.mT
        g_lib = time_ms(lambda: torch.bmm(Zt, Z), iters=5, reps=4)
        g_bound, g_by = gram_bound_ms(B, m_rows, n)
        corr = torch.randn(B, n, generator=gen, device="cuda")
        diag = torch.rand(B, n, generator=gen, device="cuda") + 0.05
        sel = torch.rand(B, n, generator=gen, device="cuda") < 32 / n
        s_ms = time_ms(lambda: gops.scores_argmax(corr, diag, sel, 3.0))
        s_plain = time_ms(lambda: gref.reference_scores(corr, diag, sel, 3.0))
        s_bound, s_by = scores_bound_ms(B, n)
        print(f"{what} shapes [{card}]: gram (B={B}, m={m_rows}, n={n}) "
              f"kernel {g_ms:.4f} ms, plain {g_plain:.4f} ms, torch.bmm "
              f"{g_lib:.4f} ms, bound {g_bound:.5f} ms ({g_by}); "
              f"scores_argmax (B={B}, n={n}) kernel {s_ms:.4f} ms, plain "
              f"{s_plain:.4f} ms, bound {s_bound:.6f} ms ({s_by})")

    # the launcher, as the README starts the reproduction
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gtl_paper"], cwd=HERE, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src")))
    print(f"python -m repro_torch.launch.train --arch gtl_paper: rc "
          f"{proc.returncode} in {time.perf_counter() - t0:.1f} s "
          f"[{card}]")
    for line in proc.stdout.splitlines():
        print(f"  | {line}")
    if proc.returncode != 0:
        print(proc.stderr[-4000:])
        raise AssertionError("the gtl_paper launcher failed")


# ---------------------------------------------------------------- prefill

# the prefill phase's shape: two sequences of 2048 tokens (a multiple of the
# reference kernels' 128- and 64-row blocks)
PREFILL_B, PREFILL_S = 2, 2048
# launches of one make_prefill_step call per architecture: (flash, scan)
PREFILL_LAUNCHES = {"qwen3_0_6b": (28, 0),   # one per attention layer
                    "zamba2_2_7b": (6, 54),  # 6 shared-block calls, 54 Mamba2
                    "rwkv6_7b": (0, 32)}     # one per RWKV6 layer
# flash attention vs its plain version: the online softmax sums in another
# order than the materialized one (fp32, about 1e-6); bf16 output: one ulp
# below 2.0 is 7.8e-3
FLASH_FP32_TOL = 1e-5
# the scan vs its plain version (the same sub-chunks, sums in another
# order): |err| <= tol * (1 + |want|); bf16 y is rounded once (one ulp is
# 2^-8 = 3.9e-3 relative)
SCAN_FP32_TOL = 1e-4
SCAN_BF16_TOL = 1e-2
# the kernel's final state vs the plain version's (fp32 both, from the same
# bf16 or fp32 inputs; the chunks' states summed and passed in another
# order): |err| <= tol * (1 + |want|)
SCAN_STATE_TOL = 1e-4
# The two routes, held to each other.  In bf16 they are not comparable bit
# for bit: both round activations to bf16 (2^-9 relative) at different
# places (the plain attention rounds its probabilities to bf16 before the
# PV product, the kernels keep them in fp32).  On the same weights widened
# to fp32 only the summation order differs, about 1e-6 relative per block;
# but a deep stack amplifies any difference, and the random-init RWKV6
# stack does so about 1.5-fold per block (PERF.md).  So:
# - every block is run on both routes from the same fp32 input (teacher
#   forcing along the plain route): outputs within BLOCK_FP32_RTOL of the
#   block output's largest magnitude — the routes compute one function;
# - end to end, the fp32 routes' logits must differ by less than
#   FP32_VS_BF16 of what bf16 rounding moves the plain route's logits
#   (max |diff|, and positions whose argmax flips);
# - each bf16 route's rms distance from the fp32 logits: the cuda route's
#   at most BF16_NOISE_RATIO times the torch route's (both carry bf16
#   rounding noise of one size; a kernel error would show as more).
BLOCK_FP32_RTOL = 1e-4
FP32_VS_BF16 = 0.25
BF16_NOISE_RATIO = 2.0


def flash_bound_ms(B, S, H, KV, hd, elem_bytes, window=0):
    """Least time for one causal flash attention: q, k, v read once and
    the output written once over the HBM rate, or 4 * hd flops (QK^T and
    PV) per admitted (query, key) pair per head at the tensor-core peak of
    the inputs' type, whichever is larger."""
    pairs = sum(min(i + 1, window) if window else i + 1 for i in range(S))
    byts = B * S * (2 * H + 2 * KV) * hd * elem_bytes
    peak = BF16_FLOP_PER_S if elem_bytes == 2 else FP32_FLOP_PER_S
    return roofline_ms(byts, 4 * hd * pairs * B * H, peak)


def scan_bound_ms(B, S, H, Dk, Dv, elem_bytes, q_bytes, ld_bytes):
    """Least time for one scan: the recurrence's 4 * Dk * Dv fp32 flops per
    token and head (state update and read) at the fp32 peak, or the inputs
    read once (q_bytes and ld_bytes: their distinct bytes, which for
    Mamba2's broadcast views are per token, not per head) and y written
    once over the HBM rate."""
    byts = q_bytes + ld_bytes + 2 * B * S * H * Dv * elem_bytes
    return roofline_ms(byts, 4 * Dk * Dv * B * S * H)


SCAN_KERNELS = ("chunk_state_kernel", "pass_kernel", "output_kernel")


def scan_ptxas(_build, sops):
    """ptxas's registers and spill bytes of the scan's device kernels as
    the main paths run them (bf16, Dk = 64): {kernel: (registers, spill
    stores + loads in bytes)}."""
    out, entry, spill = {}, None, 0
    for line in _build.build_log("ssm_scan", sops.SOURCES).splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            entry = next((k for k in SCAN_KERNELS if k in fn), None)
            if entry != "pass_kernel" and "I13__nv_bfloat16Li64E" not in fn:
                entry = None
        elif entry and "spill stores" in line:
            spill = sum(int(w) for w in line.replace(",", " ").split()
                        if w.isdigit()) - int(line.split()[0])
        elif entry and "Used" in line and "registers" in line:
            out[entry] = (int(line.split("Used")[1].split()[0]), spill)
            entry = None
    return out


def scores_ptxas(_build, gops):
    """ptxas's registers and spill bytes of the scores kernel, per team
    width it is built for: {lanes: (registers, spill stores + loads in
    bytes)}."""
    import re
    out, team, spill = {}, None, 0
    for line in _build.build_log("greedy_scores", gops.SOURCES).splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            hit = re.search(r"scores_argmax_kernelILi(\d+)E", fn)
            team = int(hit.group(1)) if hit else None
        elif team and "spill stores" in line:
            spill = sum(int(w) for w in line.replace(",", " ").split()
                        if w.isdigit()) - int(line.split()[0])
        elif team and "Used" in line and "registers" in line:
            out[team] = (int(line.split("Used")[1].split()[0]), spill)
            team = None
    return out


def flash_tc_report(_build, fops):
    """The bf16 tensor-core flash kernel as built: ptxas's registers and
    spills and the dynamic shared memory per instantiation, and its HGMMA
    instructions in the SASS.  Raises on a spill or on SASS without
    HGMMA."""
    import ctypes
    from pathlib import Path
    lib = _build.load("flash_attention", fops.SOURCES)
    lib.flash_attention_tc_smem_bytes.restype = ctypes.c_int
    entry, spills = None, []
    for line in _build.build_log("flash_attention", fops.SOURCES).splitlines():
        if "Compiling entry function" in line:
            entry = line if "flash_tc_kernel" in line else None
        elif entry and ("registers" in line or "spill" in line):
            hd = entry.split("flash_tc_kernelILi")[1].split("E")[0]
            print(f"  flash_tc_kernel<{hd}> ptxas: {line.strip()}"
                  + (f"; dynamic shared memory "
                     f"{lib.flash_attention_tc_smem_bytes(int(hd))} bytes"
                     if "registers" in line else ""))
            if "spill" in line and not line.strip().startswith(
                    "0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                    "spill loads"):
                spills.append(hd)
    if spills:
        raise AssertionError(f"flash_tc_kernel spills registers (head_dim "
                             f"{spills})")
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    if not cuobjdump.exists():
        print("  flash_tc_kernel SASS: cuobjdump not in the toolkit, not "
              "counted")
        return
    sass = subprocess.run(
        [str(cuobjdump), "-sass",
         str(_build.library_path("flash_attention", fops.SOURCES))],
        capture_output=True, text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("flash_tc_kernelILi")[1].split("E")[0] \
                if "flash_tc_kernel" in line else None
            if fn:
                counts[fn] = 0
        elif fn and "HGMMA" in line:
            counts[fn] += 1
    print(f"  flash_tc_kernel SASS: HGMMA instructions per head_dim {counts}")
    if not counts or not all(counts.values()):
        raise AssertionError("the tensor-core flash kernel's SASS holds no "
                             "HGMMA instruction")


def check_flash(fops, fref, gen):
    """Flash kernel vs plain version; returns the max abs error."""
    import torch
    cases = [  # (name, B, S, H, KV, hd, window, chunk, dtype)
        ("qwen3 path", 2, 2048, 16, 8, 128, 0, 0, torch.bfloat16),
        ("zamba2 path", 2, 2048, 32, 32, 80, 0, 0, torch.bfloat16),
        ("hd 64 GQA 2 fp32", 2, 512, 8, 4, 64, 0, 0, torch.float32),
        ("hd 128 fp32", 1, 512, 4, 4, 128, 0, 0, torch.float32),
        ("hd 80 GQA 4", 2, 384, 8, 2, 80, 0, 0, torch.bfloat16),
        ("window 256", 1, 1024, 16, 8, 128, 256, 0, torch.bfloat16),
        ("window 100 fp32", 1, 700, 4, 2, 64, 100, 0, torch.float32),
        ("chunk 256", 1, 1024, 4, 2, 128, 0, 256, torch.bfloat16),
        ("ragged S=1000", 2, 1000, 16, 8, 128, 0, 0, torch.bfloat16),
        ("ragged S=1000 fp32", 1, 1000, 4, 1, 80, 0, 0, torch.float32),
    ]
    worst = 0.0
    for name, B, S, H, KV, hd, window, chunk, dt in cases:
        q = torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dt)
        k = torch.randn(B, S, KV, hd, generator=gen, device="cuda").to(dt)
        v = torch.randn(B, S, KV, hd, generator=gen, device="cuda").to(dt)
        out = fops.flash_attention(q, k, v, window=window, chunk=chunk)
        want = fref.reference_attention(q, k, v, window=window, chunk=chunk)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        tol = BF16_TOL if dt == torch.bfloat16 else FLASH_FP32_TOL
        # bf16: both sides round an fp32 result once, so where the kernel
        # keeps fp32 precision (p split in two bf16 terms) they are mostly
        # bit-equal, and differ by one ulp near a rounding boundary
        same = "" if dt != torch.bfloat16 else \
            f", bit-equal {(out == want).float().mean().item():.4f}"
        print(f"flash_attention {name} (B={B}, S={S}, H={H}, KV={KV}, "
              f"hd={hd}, window={window}, chunk={chunk}, "
              f"{str(dt).split('.')[-1]}): max_abs_err={err:.3g} (tol {tol})"
              f"{same}")
        if not (err <= tol and torch.isfinite(out).all()):
            raise AssertionError(f"flash_attention {name}: kernel disagrees "
                                 f"with its plain version")
        worst = max(worst, err)
    return worst


def _scan_inputs(gen, B, S, H, Dk, Dv, dt, *, bonus, decay=None,
                 mamba=False):
    """Random scan inputs on the card.  mamba: q/k broadcast over heads and
    ld over Dk (stride-0 views, as mamba2_block passes them).  decay: ld =
    -decay * |N(0, 1)|; else -softplus(N(0, 1))."""
    import torch
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    if mamba:
        q = r(B, S, Dk).to(dt)[:, :, None].expand(B, S, H, Dk)
        k = r(B, S, Dk).to(dt)[:, :, None].expand(B, S, H, Dk)
        z = r(B, S, H, 1)
    else:
        q, k, z = r(B, S, H, Dk).to(dt), r(B, S, H, Dk).to(dt), r(B, S, H, Dk)
    # mamba: the activation before the broadcast (an elementwise op on an
    # expanded view would copy it), so that ld's Dk stride is 0
    ld = -decay * z.abs() if decay else -torch.nn.functional.softplus(z)
    ld = ld.expand(B, S, H, Dk)
    v = r(B, S, H, Dv).to(dt)
    u = r(H, Dk).abs().to(dt) if bonus else None
    return q, k, v, ld, u


def check_scan(sops, sref, gen):
    """Scan kernel vs plain version; returns the max abs error."""
    import torch
    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # (name, B, S, H, Dk, Dv, dtype, bonus, decay, mamba)
        ("zamba2 path (Mamba2, stride-0 views)", 2, 2048, 80, 64, 64, bf,
         False, None, True),
        ("rwkv6 path (bonus)", 2, 2048, 64, 64, 64, bf, True, None, False),
        ("Mamba2 fp32", 2, 512, 8, 64, 64, f32, False, None, False),
        ("bonus fp32", 2, 512, 8, 64, 64, f32, True, None, False),
        ("Dv 128 bonus", 1, 512, 4, 64, 128, bf, True, None, False),
        ("Dv 128 fp32", 1, 256, 4, 64, 128, f32, False, None, False),
        ("ragged S=1000", 2, 1000, 8, 64, 64, bf, True, None, False),
        ("ragged S=1000 fp32 Mamba2", 1, 1000, 8, 64, 64, f32, False, None,
         True),
        ("extreme decay -30|N|", 1, 512, 4, 64, 64, f32, False, 30.0, False),
        ("extreme decay bonus", 1, 512, 4, 64, 64, f32, True, 30.0, False),
    ]
    worst = 0.0
    for name, B, S, H, Dk, Dv, dt, bonus, decay, mamba in cases:
        q, k, v, ld, u = _scan_inputs(gen, B, S, H, Dk, Dv, dt, bonus=bonus,
                                      decay=decay, mamba=mamba)
        y, st = sops.ssm_scan(q, k, v, ld, u=u)
        want = sref.reference_scan(q, k, v, ld, u=u)
        pad = (-S) % sref.SUB  # the plain version's state, zero-padded rows
        _, want_st = sref.chunked_scan(*(torch.nn.functional.pad(
            a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v, ld)), u=u)
        torch.cuda.synchronize()
        diff = (y.float() - want.float()).abs()
        err = diff.max().item()
        tol = SCAN_BF16_TOL if dt == bf else SCAN_FP32_TOL
        ratio = (diff / (1 + want.float().abs())).max().item() / tol
        sdiff = (st - want_st).abs()
        s_ratio = (sdiff / (1 + want_st.abs())).max().item() / SCAN_STATE_TOL
        print(f"ssm_scan {name} (B={B}, S={S}, H={H}, Dk={Dk}, Dv={Dv}, "
              f"{str(dt).split('.')[-1]}): max_abs_err={err:.3g}, worst "
              f"|err| / (tol * (1 + |want|)) = {ratio:.3g} (tol {tol}); "
              f"final state max_abs_err={sdiff.max().item():.3g}, worst "
              f"ratio {s_ratio:.3g} (tol {SCAN_STATE_TOL})")
        if not (ratio <= 1 and s_ratio <= 1 and torch.isfinite(y).all()
                and torch.isfinite(st).all()):
            raise AssertionError(f"ssm_scan {name}: kernel disagrees with "
                                 f"its plain version")
        worst = max(worst, err)
    return worst


def compare_routes(name, c16, t16, c32, t32):
    """The routes' logits end to end: fp32 against fp32, and each bf16
    route against the fp32 result.  Returns a list of failures."""
    import torch
    ref_am = t32.argmax(-1)
    d32 = (c32 - t32).abs().max().item()
    flips32 = int((c32.argmax(-1) != ref_am).sum())
    d16 = (t16.float() - t32).abs().max().item()
    flips16 = int((t16.float().argmax(-1) != ref_am).sum())
    print(f"prefill {name} fp32 logits cuda vs torch: max |diff| {d32:.4g}, "
          f"argmax differs at {flips32} of {ref_am.numel()} positions; bf16 "
          f"rounding moves the torch route by max |diff| {d16:.4g} and "
          f"{flips16} argmaxes (tol: fp32 below {FP32_VS_BF16} of bf16)")
    rms = {}
    for route, x in (("cuda", c16), ("torch", t16)):
        d = x.float() - t32
        rms[route] = d.square().mean().sqrt().item()
        agree = (x.float().argmax(-1) == ref_am).float().mean().item()
        print(f"prefill {name} bf16 kernel={route} vs fp32: rms |diff| "
              f"{rms[route]:.4g}, max |diff| {d.abs().max().item():.4g}, "
              f"argmax agrees at {agree:.4f} of positions")
    print(f"prefill {name} bf16 cuda vs torch: max |diff| "
          f"{(c16.float() - t16.float()).abs().max().item():.4g}; rms "
          f"distance ratio cuda/torch {rms['cuda'] / rms['torch']:.3f} "
          f"(tol {BF16_NOISE_RATIO})")
    fails = []
    if not all(torch.isfinite(x).all() for x in (c16, t16, c32, t32)):
        fails.append(f"{name}: non-finite logits")
    if d32 > FP32_VS_BF16 * d16 or flips32 > FP32_VS_BF16 * flips16:
        fails.append(f"{name}: the fp32 routes differ beyond the tolerance")
    if rms["cuda"] > BF16_NOISE_RATIO * rms["torch"]:
        fails.append(f"{name}: the cuda route's bf16 logits are farther from "
                     f"fp32 than the tolerance allows")
    return fails


BLOCKS = ("_attn_mlp_block", "_rwkv_block", "_mamba_block")


def _wrapped_blocks(TT, wrap):
    """Replace the transformer's block functions by wrap(name, original)
    until the returned restore function is called."""
    real = {n: getattr(TT, n) for n in BLOCKS}
    for n, fn in real.items():
        setattr(TT, n, wrap(n, fn))

    def restore():
        for n, fn in real.items():
            setattr(TT, n, fn)
    return restore


def _block_out(out):
    return out[0] if isinstance(out, tuple) else out  # attention: (h, cache)


def blockwise_parity(name, TT, params, cfg, toks):
    """Every block of a plain-route forward also run on the kernel route
    from the same input (its output discarded): the largest
    |cuda - torch| relative to the block output's largest magnitude, over
    the blocks.  Returns a list of failures."""
    worst = []

    def wrap(n, fn):
        def call(*a, kernel, **kw):
            out = fn(*a, kernel=kernel, **kw)
            if kernel == "torch":
                h = _block_out(out)
                h2 = _block_out(fn(*a, kernel="cuda", **kw))
                worst.append(((h2 - h).abs().max() / h.abs().max()).item())
            return out
        return call
    restore = _wrapped_blocks(TT, wrap)
    try:
        TT.forward(params, cfg, toks, kernel="torch")
    finally:
        restore()
    top = max(range(len(worst)), key=worst.__getitem__)
    print(f"prefill {name} fp32 blockwise cuda vs torch: {len(worst)} blocks, "
          f"worst max |diff| / max |out| {worst[top]:.3g} at block {top}, "
          f"first {worst[0]:.3g} (tol {BLOCK_FP32_RTOL})")
    if worst[top] > BLOCK_FP32_RTOL:
        return [f"{name}: a block's fp32 outputs differ between the routes"]
    return []


def free_running(name, TT, params, cfg, toks, make_prefill_step):
    """Both routes' full forwards, each block's output recorded: how the
    routes' difference grows with depth.  Returns (cuda logits, torch
    logits)."""
    outs = {"cuda": [], "torch": []}

    def wrap(n, fn):
        def call(*a, kernel, **kw):
            out = fn(*a, kernel=kernel, **kw)
            outs[kernel].append(_block_out(out))
            return out
        return call
    restore = _wrapped_blocks(TT, wrap)
    try:
        c = make_prefill_step(cfg, kernel="cuda")(params, toks)
        t = make_prefill_step(cfg, kernel="torch")(params, toks)
    finally:
        restore()
    d = [(x - y).abs().max().item() for x, y in zip(outs["cuda"],
                                                    outs["torch"])]
    n = len(d)
    growth = (d[-1] / d[0]) ** (1 / (n - 1)) if n > 1 and d[0] > 0 else 0.0
    print(f"prefill {name} fp32 free-running cuda vs torch, max |diff| of "
          f"block outputs: after block 0 {d[0]:.3g}, block {n // 2} "
          f"{d[n // 2]:.3g}, block {n - 1} {d[-1]:.3g} (max |out| "
          f"{outs['torch'][-1].abs().max().item():.3g}); growth "
          f"{growth:.3f} per block")
    return c, t


def device_breakdown(card, name, fn):
    """One call of `fn` under torch.profiler: the device's kernel time by
    kernel name (top five) and its busy share of the wall-clock.  Returns
    the number of calls of each host-side ATen op in the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, ops = [], {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            if e.key.startswith("aten::"):
                ops[e.key] = ops.get(e.key, 0) + e.count
            continue
        t = getattr(e, "self_device_time_total", None)
        rows.append((getattr(e, "self_cuda_time_total", 0) if t is None
                     else t, e.count, e.key))
    dev_us = sum(r[0] for r in rows)
    if dev_us == 0:
        print(f"prefill {name} traced [{card}]: device time not measured "
              f"(the trace held no device events)")
        return ops
    top = sorted(rows, reverse=True)[:5]
    print(f"prefill {name} traced, kernel=cuda [{card}]: wall "
          f"{1e3 * wall:.1f} ms (profiler on), {1e-3 * dev_us:.1f} ms of "
          f"device kernel time over {sum(r[1] for r in rows)} device events, "
          f"busy share {1e-6 * dev_us / wall:.3f}; top: " + "; ".join(
              f"{k[:60]} x{c} {1e-3 * t:.1f} ms" for t, c, k in top))
    return ops


def _widen(tree):
    """A parameter tree with every leaf widened to fp32 (a copy)."""
    if isinstance(tree, dict):
        return {k: _widen(v) for k, v in tree.items()}
    return tree.float()


def prefill_phase(card, gen):
    """Phase 8: the no-cache prefill of three architectures at full width
    through both kernels; returns their entries of the kernels line."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.base_learner import fp32_matmuls
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.kernels.ssm_scan import ref as sref
    from repro_torch.models import layers as Lyr
    from repro_torch.models import transformer as TT
    from repro_torch.models.params import init_params
    from repro_torch.serving.serve_step import make_prefill_step

    flash_err = check_flash(fops, fref, gen)
    scan_err = check_scan(sops, sref, gen)

    # the plain versions the cuda route must not reach
    plain = [(fref, "reference_attention"), (sref, "chunked_scan"),
             (Lyr, "multi_head_attention"), (Lyr, "chunked_attention")]
    plain_calls = []

    def spy(fn):
        def call(*a, **kw):
            plain_calls.append(fn.__name__)
            return fn(*a, **kw)
        return call

    B, S = PREFILL_B, PREFILL_S
    launches = {"flash_attention": 0, "ssm_scan": 0}
    fails = []
    for arch, expect in PREFILL_LAUNCHES.items():
        cfg = get_config(arch)
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                             device="cuda")
        toks = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                             generator=torch.Generator(device="cuda")
                             .manual_seed(1))
        step_c = make_prefill_step(cfg, kernel="cuda")
        step_t = make_prefill_step(cfg, kernel="torch")
        saved = [getattr(m, n) for m, n in plain]
        for (m, n), fn in zip(plain, saved):
            setattr(m, n, spy(fn))
        fops.flash_attention.launches = sops.ssm_scan.launches = 0
        fops.flash_attention.launches_tensor_core = 0
        fops.flash_attention.launches_cuda_core = 0
        try:
            torch.cuda.synchronize()
            logits_c = step_c(params, toks)
            torch.cuda.synchronize()
        finally:
            for (m, n), fn in zip(plain, saved):
                setattr(m, n, fn)
        got = (fops.flash_attention.launches, sops.ssm_scan.launches)
        tc = (fops.flash_attention.launches_tensor_core,
              fops.flash_attention.launches_cuda_core)
        print(f"prefill {arch} (B={B}, S={S}) kernel=cuda: launches flash "
              f"{got[0]} (tensor-core kernel {tc[0]}, CUDA-core kernel "
              f"{tc[1]}), scan {got[1]} ({sops.device_kernels()} device "
              f"kernels per scan call) (expected {expect}); plain versions "
              f"called: {len(plain_calls)}")
        if got != expect or plain_calls or tc != (got[0], 0):
            raise AssertionError(f"{arch}: the prefill did not run through "
                                 f"the kernels alone")
        launches["flash_attention"] += got[0]
        launches["ssm_scan"] += got[1]
        logits_t = step_t(params, toks)
        torch.cuda.synchronize()
        if (fops.flash_attention.launches, sops.ssm_scan.launches) != got:
            raise AssertionError(f"{arch}: kernel='torch' launched a kernel")
        if tuple(logits_c.shape) != (B, S, cfg.vocab_size):
            raise AssertionError(f"{arch}: logits of shape "
                                 f"{tuple(logits_c.shape)}")
        # wall-clock per route, in turns, after the warm-up calls above
        walls = {"cuda": [], "torch": []}
        for route in ("torch", "cuda", "cuda", "torch"):
            step = step_c if route == "cuda" else step_t
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(params, toks)
            torch.cuda.synchronize()
            walls[route].append(time.perf_counter() - t0)
        tps = {r: B * S / min(w) for r, w in walls.items()}
        print(f"prefill {arch} wall-clock [{card}]: kernel=cuda "
              f"{[round(w, 4) for w in walls['cuda']]} s, kernel=torch "
              f"{[round(w, 4) for w in walls['torch']]} s; tokens/s (best "
              f"of two) cuda {tps['cuda']:.0f}, torch {tps['torch']:.0f}")
        aten = device_breakdown(card, arch, lambda: step_c(params, toks))
        # the scan kernel writes the final state: the closed form (cumsum,
        # exp, einsum per layer) must not run on the cuda route
        n_cumsum = aten.get("aten::cumsum", 0)
        print(f"prefill {arch} kernel=cuda: aten::cumsum calls in the trace "
              f"{n_cumsum} (the closed-form final state: gone if 0)")
        if expect[1] and n_cumsum:
            raise AssertionError(f"{arch}: the scan's closed-form final "
                                 f"state still runs")

        # the same weights in fp32: the routes held to each other
        params32 = _widen(params)
        del params
        torch.cuda.empty_cache()
        cfg32 = cfg.replace(dtype="float32")
        with fp32_matmuls():
            c32, t32 = free_running(arch, TT, params32, cfg32, toks,
                                    make_prefill_step)
            fails += blockwise_parity(arch, TT, params32, cfg32, toks)
            torch.cuda.synchronize()
        del params32
        fails += compare_routes(arch, logits_c, logits_t, c32, t32)
        del logits_c, logits_t, c32, t32, step_c, step_t
        torch.cuda.empty_cache()

    # kernel timing at the path's shapes (CUDA-graph replay)
    bf = torch.bfloat16
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(bf)  # noqa: E731
    flash_rows = {}
    for arch, H, KV, hd in (("qwen3_0_6b", 16, 8, 128),
                            ("zamba2_2_7b", 32, 32, 80)):
        q, k, v = r(B, S, H, hd), r(B, S, KV, hd), r(B, S, KV, hd)
        qs, ks, vs = (a.transpose(1, 2) for a in (q, k, v))
        ms = time_ms(lambda: fops.flash_attention(q, k, v), iters=10, reps=5)
        p_ms = time_ms(lambda: fref.reference_attention(q, k, v), iters=2,
                       reps=3)
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True, enable_gqa=True), iters=10, reps=5)
        bnd, by = flash_bound_ms(B, S, H, KV, hd, 2)
        flash_rows[arch] = (ms, p_ms, lib, bnd, by)
        # the causal work: 4 * hd flops per admitted (query, key) pair
        tflop = 4 * hd * (S * (S + 1) // 2) * B * H / 1e12
        print(f"flash_attention {arch} (B={B}, S={S}, H={H}, KV={KV}, "
              f"hd={hd}, bf16) [{card}]: kernel {ms:.4f} ms "
              f"({tflop / ms * 1e3:.1f} TFLOP/s), plain {p_ms:.4f} ms, sdpa "
              f"{lib:.4f} ms ({tflop / lib * 1e3:.1f} TFLOP/s), bound "
              f"{bnd:.4f} ms ({by})")
    scan_rows = {}
    from repro_torch.kernels import _build
    regs = scan_ptxas(_build, sops)
    for arch, H, mamba in (("zamba2_2_7b", 80, True), ("rwkv6_7b", 64, False)):
        q, k, v, ld, u = _scan_inputs(gen, B, S, H, 64, 64, bf,
                                      bonus=not mamba, mamba=mamba)
        ms = time_ms(lambda: sops._launch(q, k, v, ld, u), iters=10, reps=5)
        p_ms = time_ms(lambda: sref.reference_scan(q, k, v, ld, u=u),
                       iters=2, reps=3)
        # distinct input bytes of q and k (bf16), and of ld (fp32)
        per_tok = (2 * B * S * 64 * 2, B * S * H * 4) if mamba else \
            (2 * B * S * H * 64 * 2, B * S * H * 64 * 4)
        bnd, by = scan_bound_ms(B, S, H, 64, 64, 2, *per_tok)
        scan_rows[arch] = (ms, p_ms, bnd, by)
        print(f"ssm_scan {arch} (B={B}, S={S}, H={H}, Dk=Dv=64, bf16"
              f"{', stride-0 q/k/ld' if mamba else ', bonus'}) [{card}]: "
              f"kernel {ms:.4f} ms ({sops.device_kernels()} device kernels), "
              f"plain {p_ms:.4f} ms, library -, bound {bnd:.4f} ms ({by}); "
              f"registers, spilled bytes: " + ", ".join(
                  f"{k} {regs.get(k, ('?', '?'))[0]}, {regs.get(k, ('?', '?'))[1]}"
                  for k in SCAN_KERNELS))

    if fails:
        raise AssertionError("; ".join(fails))
    fm, fp, fl, fb, fby = flash_rows["qwen3_0_6b"]
    sm, sp, sb, sby = scan_rows["zamba2_2_7b"]
    return [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention_tc.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:80",
         "launches": launches["flash_attention"], "max_abs_err": flash_err,
         "ms": fm, "plain_ms": fp, "bound_ms": fb, "bound_by": fby,
         "library_ms": fl},
        {"name": "ssm_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
         "replaces": "src/repro/kernels/ssm_scan/ssm_scan.py:77",
         "launches": launches["ssm_scan"], "max_abs_err": scan_err,
         "ms": sm, "plain_ms": sp, "bound_ms": sb, "bound_by": sby,
         "library_ms": None},
    ]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.greedy_scores import ops as gops
    from repro_torch.kernels.paged_attention import ops, ref
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.models.params import init_params
    from repro_torch.serving import (ContinuousBatcher, Request,
                                     SamplingParams, ServingConfig,
                                     completions_equivalent)
    from repro_torch.serving.kvcache import paged_cache_bytes

    card = card_line()
    print(f"card: {card}")

    # 1. build, one nvcc per source, all at once
    libs = {"paged_attention": ops.SOURCES, "greedy_scores": gops.SOURCES,
            "flash_attention": fops.SOURCES, "ssm_scan": sops.SOURCES}
    t0 = time.perf_counter()
    _build.build_all(libs)
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, sources in libs.items():
        for line in _build.build_log(name, sources).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}:", line.strip())
    flash_tc_report(_build, fops)

    # 2. kernel vs plain at the main path's shapes (qwen3_0_6b: H=16,
    #    KV=8, hd=128, page 16, capacity 256 -> 16 pages per slot)
    cfg = get_config("qwen3_0_6b")
    H, KV, hd, psz, P = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 16, 16
    n_pages = 1 + 4 * P
    full = dict(H=H, KV=KV, hd=hd, psz=psz, P=P, n_pages=n_pages,
                q_dtype=torch.bfloat16, pool_dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        ("decode S=1", dict(full, B=4, S=1, lasts=[17, 60, 130, 255])),
        ("prefill S=16", dict(full, B=1, S=16, lasts=[47])),
        ("ring wrap", dict(full, B=2, S=1, lasts=[256, 3 * 256 + 77])),
        ("null-page padding + idle lane",
         dict(full, B=3, S=1, lasts=[20, 40, 0], pages_held=[2, 3, 0])),
        ("fp32 S=4", dict(full, B=2, S=4, lasts=[9, 33],
                          q_dtype=torch.float32)),
        # every split but the first without an admitted key
        ("last=0", dict(full, B=3, S=1, lasts=[0, 0, 17])),
        ("ring wrap + window S=16",
         dict(full, B=2, S=16, lasts=[300, 3 * 256 + 77], window=40)),
        ("GQA 4 (KV=4)", dict(full, KV=4, B=4, S=1, lasts=[17, 60, 130,
                                                           255])),
        ("GQA 4 (KV=4) S=16", dict(full, KV=4, B=1, S=16, lasts=[47])),
        ("bf16 pool S=4", dict(full, B=2, S=4, lasts=[9, 33],
                               pool_dtype=torch.bfloat16)),
    ]
    max_err = check_paged_attention(ops, ref, gen, cases)

    # 3. the main path through the kernel, counts from 0
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    reqs = requests(cfg, Request, SamplingParams)
    snapshots = []
    ops.paged_attention_update.launches = 0
    ops.paged_attention.launches = 0
    b_cuda, done_cuda, secs_cuda = serve(
        cfg, params, "cuda", reqs, ContinuousBatcher, ServingConfig,
        snapshots)
    launches = ops.paged_attention_update.launches \
        + ops.paged_attention.launches
    dispatches = b_cuda.decode_dispatches + b_cuda.prefill_dispatches
    print(f"main path kernel=cuda: {dispatches} dispatches "
          f"({b_cuda.decode_dispatches} decode, {b_cuda.prefill_dispatches} "
          f"prefill), paged_attention launches={launches} "
          f"(= {cfg.n_layers} layers x dispatches: "
          f"{launches == cfg.n_layers * dispatches}), preemptions="
          f"{b_cuda.preemptions}, cow_copies={b_cuda.cow_copies}, "
          f"page_growths={b_cuda.page_growths}")
    if launches == 0 or launches != cfg.n_layers * dispatches:
        raise AssertionError("the main path did not run paged attention "
                             "through the kernel on every layer")
    check_completions(cfg, done_cuda, reqs)

    # 4. the same requests through the plain path
    reqs2 = requests(cfg, Request, SamplingParams)
    _, done_torch, secs_torch = serve(cfg, params, "torch", reqs2,
                                      ContinuousBatcher, ServingConfig)
    check_completions(cfg, done_torch, reqs2)
    equiv = completions_equivalent(done_cuda, done_torch)
    n_same = sum(a.tokens == b.tokens for a, b in zip(
        sorted(done_cuda, key=lambda c: c.rid),
        sorted(done_torch, key=lambda c: c.rid)))
    print(f"completions_equivalent(cuda, torch) = {equiv} "
          f"({n_same}/{len(done_cuda)} token-identical)")
    if not equiv:
        raise AssertionError("kernel='cuda' and kernel='torch' completions "
                             "are not equivalent")
    n_tok = sum(len(c.tokens) for c in done_cuda)
    pool_bytes = b_cuda.cache_nbytes()
    print(f"throughput [{card}]: kernel=cuda {n_tok / secs_cuda:.1f} tok/s "
          f"({secs_cuda:.3f} s), kernel=torch {n_tok / secs_torch:.1f} tok/s "
          f"({secs_torch:.3f} s), {n_tok} tokens, 4 slots")
    print(f"pool bytes: engine {pool_bytes} (fp32 pool), paged_cache_bytes "
          f"(bf16 cfg dtype) "
          f"{paged_cache_bytes(cfg, 4, 256, b_cuda.engine.n_pages)}")

    # 5. timing at the busiest decode tick of the run
    lasts = max(snapshots, key=len).tolist()
    B = len(lasts)
    q, kn, vn, kp, vp, bt, last = paged_inputs(
        gen, **dict(full, B=B, S=1, lasts=lasts))
    kp2, vp2 = kp.clone(), vp.clone()
    ms = time_ms(lambda: ops.paged_attention_update(
        q, kn, vn, kp, vp, bt, last))
    plain_ms = time_ms(lambda: ref.reference_paged_update(
        q, kn, vn, kp2, vp2, bt, last))
    # yardstick: one SDPA call on the rings gathered beforehand (the
    # gather and the scatter are not timed; the port never calls it)
    ring = torch.arange(P * psz, device="cuda")
    g_idx = (bt[:, ring // psz] * psz + ring % psz).long()
    kr = kp.view(-1, KV, hd)[g_idx].to(q.dtype).transpose(1, 2)
    vr = vp.view(-1, KV, hd)[g_idx].to(q.dtype).transpose(1, 2)
    k_pos = ref.ring_positions(last, P * psz)
    mask = ((k_pos >= 0) & (k_pos <= last[:, None]))[:, None, None, :]
    qs = q.transpose(1, 2)
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, kr, vr, attn_mask=mask, enable_gqa=True))
    wall_ms = host_ms(lambda: ops.paged_attention_update(
        q, kn, vn, kp, vp, bt, last))
    b_ms, b_by = bound_ms(B, 1, H, KV, hd, psz, lasts, 2, 4, P)
    qp, knp, vnp, kpp, vpp, btp, lastp = paged_inputs(
        gen, **dict(full, B=1, S=16, lasts=[47]))
    pre_ms = time_ms(lambda: ops.paged_attention_update(
        qp, knp, vnp, kpp, vpp, btp, lastp))
    pre_b, pre_by = bound_ms(1, 16, H, KV, hd, psz, [47], 2, 4, P)
    # the ring split: block-table entries per CTA (16: the whole ring in
    # one CTA, no merge), at both shapes; ops.PAGES_PER_SPLIT is shipped
    for pps in (1, 2, 4, 16):
        sweep = [time_ms(lambda a=a: ops._launch(
            *a, None, 0, pages_per_split=pps)) for a in (
                (q, kn, vn, kp, vp, bt, last),
                (qp, knp, vnp, kpp, vpp, btp, lastp))]
        print(f"paged_attention split sweep pages_per_split={pps}"
              f"{' (shipped)' if pps == ops.PAGES_PER_SPLIT else ''} "
              f"[{card}]: decode {sweep[0]:.4f} ms, prefill chunk "
              f"{sweep[1]:.4f} ms")
    print(f"paged_attention decode B={B} S=1 lasts={lasts} [{card}]: "
          f"kernel {ms:.4f} ms (device, CUDA graph; {wall_ms:.4f} ms per "
          f"eager call with the wrapper), plain {plain_ms:.4f} ms, sdpa "
          f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    print(f"paged_attention prefill B=1 S=16 last=47 [{card}]: kernel "
          f"{pre_ms:.4f} ms, bound {pre_b:.5f} ms ({pre_by})")

    # 6. the paper's learning framework
    learning = learning_phase(card, gen)

    # 7. its malicious, dynamic and bagged studies and the launcher
    studies_phase(card)

    # 8. the no-cache prefill of three architectures
    del params
    torch.cuda.empty_cache()
    prefill = prefill_phase(card, gen)

    print(json.dumps({"kernels": [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attention/csrc/"
                  "paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/paged_attention.py:157",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": lib_ms,
    }] + learning + prefill}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
