#!/usr/bin/env python3
"""Run the PyTorch port (src/repro_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. build every CUDA kernel of the main path from the sources in this
   checkout (nvcc, sm_90a);
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes: paged attention for a decode tick (S=1), a prefill
   block (S=16), a wrapped ring and null-page padding;
3. serve full-width qwen3_0_6b (28 layers, random bf16 weights from a
   seed, fp32 page pool) through ContinuousBatcher with the paged layout,
   lazy allocation and kernel="cuda": greedy and sampled requests, one
   best_of=2 request and one forced preemption with resume — with every
   kernel's launch count set to 0 just before and read just after;
4. serve the same requests with kernel="torch" (the plain path) and
   require completions_equivalent (the repo's margin-tolerant token
   parity), finite margins and logprobs, and in-vocabulary tokens;
5. time each kernel, its plain version and one PyTorch library call at
   the decode shape, beside its bound (bytes over the card's memory rate).

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

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, and fp32 on the
# CUDA cores (the kernel's arithmetic is fp32 FMA, not tensor cores)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TOL = 1e-2  # bf16 output: one ulp below 2.0 is 7.8e-3; fp32 sum order


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
    """Kernel vs plain version on copies of the same inputs; the output
    within BF16_TOL (or 1e-4 in fp32) and the pools bit-equal outside the
    null page.  Returns the max abs output error."""
    import torch
    worst = 0.0
    for name, kw in cases:
        q, kn, vn, kp, vp, bt, last = paged_inputs(gen, **kw)
        kp2, vp2 = kp.clone(), vp.clone()
        out, _, _ = ops.paged_attention_update(q, kn, vn, kp, vp, bt, last)
        want, _, _ = ref.reference_paged_update(q, kn, vn, kp2, vp2, bt,
                                                last)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        pool_err = max((kp[1:] - kp2[1:]).abs().max().item(),
                       (vp[1:] - vp2[1:]).abs().max().item())
        tol = BF16_TOL if q.dtype == torch.bfloat16 else 1e-4
        print(f"paged_attention {name}: max_abs_err={err:.3g} "
              f"(tol {tol}) pool_err={pool_err:.3g} (tol 0)")
        if not (err <= tol and pool_err == 0 and torch.isfinite(out).all()):
            raise AssertionError(f"paged_attention {name}: kernel disagrees "
                                 f"with its plain version")
        worst = max(worst, err)
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
    t_b, t_f = byts / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import ops, ref
    from repro_torch.models.params import init_params
    from repro_torch.serving import (ContinuousBatcher, Request,
                                     SamplingParams, ServingConfig,
                                     completions_equivalent)
    from repro_torch.serving.kvcache import paged_cache_bytes

    card = card_line()
    print(f"card: {card}")

    # 1. build
    t0 = time.perf_counter()
    _build.load("paged_attention", ops.SOURCES)
    print(f"built paged_attention in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log("paged_attention", ops.SOURCES).splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

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
    print(f"paged_attention decode B={B} S=1 lasts={lasts} [{card}]: "
          f"kernel {ms:.4f} ms (device, CUDA graph; {wall_ms:.4f} ms per "
          f"eager call with the wrapper), plain {plain_ms:.4f} ms, sdpa "
          f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    qp, knp, vnp, kpp, vpp, btp, lastp = paged_inputs(
        gen, **dict(full, B=1, S=16, lasts=[47]))
    pre_ms = time_ms(lambda: ops.paged_attention_update(
        qp, knp, vnp, kpp, vpp, btp, lastp))
    pre_b, _ = bound_ms(1, 16, H, KV, hd, psz, [47], 2, 4, P)
    print(f"paged_attention prefill B=1 S=16 last=47 [{card}]: kernel "
          f"{pre_ms:.4f} ms, bound {pre_b:.5f} ms")

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
    }]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
