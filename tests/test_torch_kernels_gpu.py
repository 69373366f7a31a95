"""The port's CUDA kernels (paged attention; GreedyTL's Gram and scores;
flash attention and the chunked GLA scan of the no-cache prefill) against
their plain PyTorch versions, on the card.  Marked ``gpu``: without a CUDA device each test skips (a CUDA
kernel has no interpret mode).  Imports no JAX, so it runs on a machine
with the card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.paged_attention import ops, ref  # noqa: E402

PSZ = 16


def _inputs(seed, B, S, H, KV, hd, P, n_pages, lasts, held=None):
    """held[b] real pages at the head of slot b's block-table row, the
    rest the null page 0 (lazy allocation's tail; 0 held: an idle lane)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    bt = rng.permutation(np.arange(1, n_pages))[:B * P].reshape(B, P)
    for b, h in enumerate(held or []):
        bt[b, h:] = 0
    return dict(q=f(B, S, H, hd), k_new=f(B, S, KV, hd),
                v_new=f(B, S, KV, hd), k_pool=f(n_pages, PSZ, KV, hd),
                v_pool=f(n_pages, PSZ, KV, hd),
                block_table=bt.astype(np.int32),
                last_pos=np.array(lasts, np.int32))


def _paged_pair(x, dt, pool_dt=torch.float32):
    """The inputs on the card twice: for the kernel and for the plain
    version (each writes its own pools)."""
    a = {k: torch.from_numpy(v).cuda() for k, v in x.items()}
    for k in ("q", "k_new", "v_new"):
        a[k] = a[k].to(dt)
    for k in ("k_pool", "v_pool"):
        a[k] = a[k].to(pool_dt)
    return a, {k: v.clone() for k, v in a.items()}


def _assert_paged_close(out, want, dt):
    """bf16 within 1e-2 (one output ulp; fp32 sum order), fp32 within
    1e-5; finite."""
    tol = 1e-2 if dt == torch.bfloat16 else 1e-5
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


# qwen3_0_6b's heads (H=16, KV=8, hd=128), 16 pages of 16 per slot, bf16 q
# and an fp32 pool, 4 slots, unless a case says otherwise; held[b] pages of
# slot b's row are real, the rest the null page
PAGED_BASE = dict(q="bfloat16", pool="float32", S=1, window=0, KV=8,
                  hd=128, held=None)
PAGED_CASES = {
    "decode-fp32": dict(q="float32", lasts=[17, 60, 130, 255]),
    "decode-bf16": dict(lasts=[17, 60, 130, 255]),
    "prefill-ring-wrap": dict(S=16, lasts=[15, 40, 256, 3 * 256 + 77]),
    "window": dict(q="float32", S=4, lasts=[9, 33, 100, 200], window=40),
    # one admitted entry: every split but the first has no admitted key
    "last0": dict(q="float32", lasts=[0, 17, 0, 255]),
    # slot 2 an idle lane (no page held: every entry the null page)
    "idle-lane": dict(lasts=[20, 40, 0, 90], held=[2, 3, 0, 6]),
    "prefill-ring-wrap-window": dict(q="float32", S=16,
                                     lasts=[15, 300, 3 * 256 + 77, 600],
                                     window=40),
    "gqa4": dict(KV=4, lasts=[17, 60, 130, 255]),
    "gqa4-prefill": dict(q="float32", S=16, KV=4,
                         lasts=[15, 40, 256, 3 * 256 + 77]),
    # the other pool dtype and head dims
    "bf16-pool": dict(pool="bfloat16", S=4, lasts=[9, 33, 100, 200]),
    "fp32-q-bf16-pool": dict(q="float32", pool="bfloat16",
                             lasts=[17, 60, 130, 255]),
    "hd64": dict(hd=64, S=4, lasts=[9, 33, 100, 200]),
    "hd256": dict(q="float32", hd=256, lasts=[17, 60, 130, 255]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_attention_kernel_matches_plain_version(case):
    """The CUDA kernel (built with nvcc on first use) against its plain
    version, fused update and then attention only on the pools it wrote:
    the output within 1e-2 for bf16 (one output ulp; fp32 sum order) or
    1e-5 for fp32, the written pool rows bit-equal, every output finite.
    The ring is split over CTAs (ops.PAGES_PER_SPLIT block-table entries
    each), so these cases hold splits with no admitted key, an idle lane
    on the null page, a wrapped ring under a window, GQA 4, both pool
    dtypes and head dims 64/128/256."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    c = dict(PAGED_BASE, **PAGED_CASES[case])
    dt = getattr(torch, c["q"])
    x = _inputs(9, B=4, S=c["S"], H=16, KV=c["KV"], hd=c["hd"], P=16,
                n_pages=65, lasts=c["lasts"], held=c["held"])
    a, b = _paged_pair(x, dt, getattr(torch, c["pool"]))
    window = c["window"]
    n = ops.paged_attention_update.launches
    out, _, _ = ops.paged_attention_update(
        a["q"], a["k_new"], a["v_new"], a["k_pool"], a["v_pool"],
        a["block_table"], a["last_pos"], window=window)
    want, _, _ = ref.reference_paged_update(
        b["q"], b["k_new"], b["v_new"], b["k_pool"], b["v_pool"],
        b["block_table"], b["last_pos"], window=window)
    torch.cuda.synchronize()
    assert ops.paged_attention_update.launches == n + 1
    _assert_paged_close(out, want, dt)
    assert torch.equal(a["k_pool"][1:], b["k_pool"][1:])
    assert torch.equal(a["v_pool"][1:], b["v_pool"][1:])
    # attention only, on the same (now written) pools
    b["k_pool"][0], b["v_pool"][0] = a["k_pool"][0], a["v_pool"][0]
    n = ops.paged_attention.launches
    out = ops.paged_attention(a["q"], a["k_pool"], a["v_pool"],
                              a["block_table"], a["last_pos"], window=window)
    want = ref.reference_paged_attention_block(
        b["q"], b["k_pool"], b["v_pool"], b["block_table"], b["last_pos"],
        window=window)
    torch.cuda.synchronize()
    assert ops.paged_attention.launches == n + 1
    _assert_paged_close(out, want, dt)


@pytest.mark.gpu
def test_paged_attention_survives_cuda_graph_replay():
    """The fused update captured once in a CUDA graph and replayed three
    times on fresh inputs copied into the captured tensors: every replay
    matches the plain version.  A split-merge ticket that did not reset
    itself would leave later replays unmerged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    shape = dict(B=4, S=1, H=16, KV=8, hd=128, P=16, n_pages=65)
    runs = [_inputs(20 + i, **shape, lasts=lasts) for i, lasts in enumerate(
        [[17, 60, 130, 255], [18, 0, 300, 40], [5, 61, 3 * 256 + 9, 255],
         [200, 100, 50, 25]])]
    a, _ = _paged_pair(runs[0], torch.bfloat16)
    call = lambda: ops.paged_attention_update(  # noqa: E731
        a["q"], a["k_new"], a["v_new"], a["k_pool"], a["v_pool"],
        a["block_table"], a["last_pos"])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()  # build and load the kernel outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, _, _ = call()
    for x in runs[1:]:
        fresh, b = _paged_pair(x, torch.bfloat16)
        for k, v in fresh.items():
            a[k].copy_(v)
        graph.replay()
        want, _, _ = ref.reference_paged_update(
            b["q"], b["k_new"], b["v_new"], b["k_pool"], b["v_pool"],
            b["block_table"], b["last_pos"])
        torch.cuda.synchronize()
        _assert_paged_close(out, want, torch.bfloat16)
        assert torch.equal(a["k_pool"][1:], b["k_pool"][1:])


@pytest.mark.gpu
def test_cuda_path_raises_instead_of_falling_back():
    """A tensor the kernel does not take raises on the card; nothing
    silently runs the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = _inputs(3, B=1, S=1, H=4, KV=2, hd=96, P=2, n_pages=4, lasts=[3])
    a = {k: torch.from_numpy(v).cuda() for k, v in x.items()}
    with pytest.raises(ValueError):  # head_dim 96 is not built
        ops.paged_attention_update(
            a["q"], a["k_new"], a["v_new"], a["k_pool"], a["v_pool"],
            a["block_table"], a["last_pos"])


@pytest.mark.gpu
@pytest.mark.parametrize("B,m,n", [(252, 365, 583), (3, 37, 45), (2, 1, 70),
                                   (2, 40, 129), (3, 50, 128), (2, 33, 300)])
def test_gram_kernel_matches_plain_version(B, m, n):
    """The GreedyTL Gram kernel against its plain version at the HAPT
    shapes (252 problems, 365 rows, 583 design columns) and ragged ones
    (n one column past a 128 tile, n exactly one tile, m one row past a
    16-row stage): within 1e-5 on a unit-scale design (two fp32 sums of m
    products in different orders) and bit-symmetric."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.greedy_scores import ops as gops
    from repro_torch.kernels.greedy_scores import ref as gref
    rng = np.random.default_rng(m * n)
    Z = torch.from_numpy(
        (rng.normal(size=(B, m, n)) / np.sqrt(m)).astype(np.float32)).cuda()
    n0 = gops.gram.launches
    G = gops.gram(Z)
    want = gref.reference_gram(Z)
    torch.cuda.synchronize()
    assert gops.gram.launches == n0 + 1
    torch.testing.assert_close(G, want, rtol=0, atol=1e-5)
    assert torch.equal(G, G.mT)


@pytest.mark.gpu
@pytest.mark.parametrize("B,n,p_sel,tie", [(252, 583, 0.05, False),
                                           (252, 583, 0.9, False),
                                           (5, 45, 0.2, True)])
def test_scores_argmax_kernel_matches_plain_version(B, n, p_sel, tie):
    """The fused scoring + argmax kernel against its plain version: scores
    within one ulp, the same index per row; a planted tie goes to the
    lowest index."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.greedy_scores import ops as gops
    from repro_torch.kernels.greedy_scores import ref as gref
    rng = np.random.default_rng(n)
    corr = rng.normal(size=(B, n)).astype(np.float32)
    diag = (rng.random((B, n)) + 0.05).astype(np.float32)
    sel = rng.random((B, n)) < p_sel
    if tie:
        corr[:, [7, n - 3]], diag[:, [7, n - 3]] = 1e3, 1.0
        sel[:, [7, n - 3]] = False
    args = [torch.from_numpy(a).cuda() for a in (corr, diag, sel)]
    s, idx = gops.scores_argmax(*args, 3.0)
    want, widx = gref.reference_scores(*args, 3.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(s, want, rtol=2.4e-7, atol=0)
    assert torch.equal(idx, widx)
    if tie:
        assert (idx == 7).all()


@pytest.mark.gpu
def test_learning_path_runs_through_both_kernels():
    """A reduced HAPT scenario on the card: kernel="cuda" launches the
    Gram kernel once and the scores kernel kappa times; kernel="torch"
    picks the same columns and gives the same F-measure rows (within 1e-6:
    the same picks give the same models up to fp32 summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.experiment import run_scenario
    from repro_torch.kernels.greedy_scores import ops as gops
    kw = dict(n_samples=2000, kappa=8, svm_steps=50, device="cuda")
    g0, s0 = gops.gram.launches, gops.scores_argmax.launches
    got = run_scenario("hapt", kernel="cuda", **kw)
    assert (gops.gram.launches - g0, gops.scores_argmax.launches - s0) \
        == (1, 8)
    want = run_scenario("hapt", kernel="torch", **kw)
    assert torch.equal(got.gtl.gtl_selected, want.gtl.gtl_selected)
    for (name, a), (_, b) in zip(got.summary_rows(), want.summary_rows()):
        assert a == pytest.approx(b, abs=1e-6), name


# ----------------------------------------------- no-cache prefill kernels


def _cuda(a, dt=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).cuda().to(dt)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,hd,window,chunk", [
    (2, 256, 16, 8, 128, 0, 0),      # qwen3_0_6b's heads, GQA 2
    (2, 256, 32, 32, 80, 0, 0),      # zamba2_2_7b's shared attention
    (1, 1000, 4, 2, 64, 0, 0),       # ragged S (not a multiple of 64)
    (2, 300, 4, 1, 64, 100, 0),      # sliding window, GQA 4
    (1, 512, 2, 2, 128, 0, 128),     # chunked-local mask
    (1, 77, 8, 4, 80, 16, 32),       # every mask term, one partial block
])
def test_flash_attention_kernel_matches_plain_version(dtype, B, S, H, KV, hd,
                                                      window, chunk):
    """The flash-attention kernel against its plain version (full fp32
    softmax): within 1e-5 in fp32 (the online softmax sums in another
    order) and 1e-2 in bf16 (one output ulp below 2.0 is 7.8e-3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(S * hd + window)
    q = _cuda(rng.normal(size=(B, S, H, hd)), dt)
    k = _cuda(rng.normal(size=(B, S, KV, hd)), dt)
    v = _cuda(rng.normal(size=(B, S, KV, hd)), dt)
    n = fops.flash_attention.launches
    out = fops.flash_attention(q, k, v, window=window, chunk=chunk)
    want = fref.reference_attention(q, k, v, window=window, chunk=chunk)
    torch.cuda.synchronize()
    assert fops.flash_attention.launches == n + 1
    assert out.dtype == dt and out.shape == q.shape
    tol = 1e-5 if dt == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_flash_attention_raises_instead_of_falling_back():
    """A CUDA tensor the kernel does not take (head_dim 96, a strided
    view) raises; nothing silently runs the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import ops as fops
    q = torch.randn(1, 64, 2, 96, device="cuda")
    with pytest.raises(ValueError):
        fops.flash_attention(q, q, q)
    q = torch.randn(1, 64, 2, 128, device="cuda")
    with pytest.raises(ValueError):
        fops.flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                             q.transpose(1, 2))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,hd,window,chunk", [
    (3, 1, 4, 4, 128, 0, 0),       # S = 1: 127 of the CTA's rows past S
    (3, 63, 4, 2, 64, 0, 0),       # S < 64: one warpgroup's rows all past S
    (3, 129, 8, 2, 80, 0, 0),      # one row into the second q block
    (2, 1000, 8, 4, 128, 0, 0),    # ragged S, GQA 2
    (3, 1000, 4, 1, 80, 0, 0),     # GQA 4, hd 80 (two panels, zero filled)
    (1, 1000, 4, 2, 64, 100, 0),   # window: rows whose first key block is
                                   # fully masked (m still -1e30, p = 0)
    (2, 520, 4, 4, 80, 0, 96),     # chunk edges inside the key blocks
    (1, 1000, 2, 1, 128, 64, 200),  # window and chunk, GQA 2
])
def test_flash_attention_tensor_core_kernel(B, S, H, KV, hd, window, chunk):
    """The bf16 tensor-core kernel (wgmma on TMA-fed tiles, p split into
    two bf16 terms) against its plain version: within 1e-2 (one output ulp
    below 2.0 is 7.8e-3; fp32 sum order), finite, and launched as the
    tensor-core variant."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    rng = np.random.default_rng(B * S + hd + window + chunk)
    q = _cuda(rng.normal(size=(B, S, H, hd)), torch.bfloat16)
    k = _cuda(rng.normal(size=(B, S, KV, hd)), torch.bfloat16)
    v = _cuda(rng.normal(size=(B, S, KV, hd)), torch.bfloat16)
    n = fops.flash_attention.launches_tensor_core
    out = fops.flash_attention(q, k, v, window=window, chunk=chunk)
    want = fref.reference_attention(q, k, v, window=window, chunk=chunk)
    torch.cuda.synchronize()
    assert fops.flash_attention.launches_tensor_core == n + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), want.float(), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.gpu
def test_flash_attention_kernel_follows_the_dtype():
    """bf16 launches the tensor-core kernel and fp32 the CUDA-core one, as
    the launch reports; both count in ``launches``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import ops as fops
    f = fops.flash_attention
    for dt, variant in ((torch.bfloat16, "launches_tensor_core"),
                        (torch.float32, "launches_cuda_core")):
        q = torch.randn(2, 192, 4, 64, device="cuda").to(dt)
        before = (f.launches, f.launches_tensor_core, f.launches_cuda_core)
        f(q, q, q)
        torch.cuda.synchronize()
        after = (f.launches, f.launches_tensor_core, f.launches_cuda_core)
        want = (before[0] + 1,
                before[1] + (variant == "launches_tensor_core"),
                before[2] + (variant == "launches_cuda_core"))
        assert after == want, (dt, before, after)


@pytest.mark.gpu
def test_flash_attention_tensor_core_kernel_raises():
    """bf16 inputs the tensor-core kernel does not take raise: a strided
    view, and a contiguous tensor whose base is not 16-byte aligned (TMA
    reads from 16-byte aligned addresses)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import ops as fops
    n = fops.flash_attention.launches
    q = torch.randn(1, 2, 64, 128, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fops.flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                             q.transpose(1, 2))
    flat = torch.randn(64 * 2 * 128 + 1, device="cuda", dtype=torch.bfloat16)
    q = flat[1:].view(1, 64, 2, 128)
    assert q.is_contiguous()
    with pytest.raises(ValueError):
        fops.flash_attention(q, q, q)
    assert fops.flash_attention.launches == n


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Dk,Dv,bonus,decay", [
    (2, 256, 4, 64, 64, False, 1.0),     # Mamba2 mode
    (2, 256, 4, 64, 64, True, 1.0),      # RWKV6 bonus mode
    (1, 200, 2, 64, 128, True, 1.0),     # Dv 128, ragged S
    (1, 50, 3, 32, 64, False, 1.0),      # S < one sub-chunk multiple
    (1, 128, 2, 64, 64, False, 30.0),    # extreme decay
    (1, 128, 2, 64, 64, True, 30.0),
])
def test_ssm_scan_kernel_matches_plain_version(dtype, B, S, H, Dk, Dv, bonus,
                                               decay):
    """The scan kernel against its plain version (the same 16-row
    sub-chunks, torch ops): within 1e-4 in fp32 (sums in another order)
    and 1e-2 relative in bf16 (y is rounded to bf16 once); finite under
    decays of -30 |N(0, 1)| per step, where the weights underflow to 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.kernels.ssm_scan import ref as sref
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(S + Dv + int(bonus))
    q = _cuda(rng.normal(size=(B, S, H, Dk)), dt)
    k = _cuda(rng.normal(size=(B, S, H, Dk)), dt)
    v = _cuda(rng.normal(size=(B, S, H, Dv)), dt)
    z = rng.normal(size=(B, S, H, Dk))
    ld = _cuda(-np.abs(z) * decay if decay > 1 else -np.log1p(np.exp(z)))
    u = _cuda(np.abs(rng.normal(size=(H, Dk)))) if bonus else None
    n = sops.ssm_scan.launches
    y, st = sops.ssm_scan(q, k, v, ld, u=u)
    want = sref.reference_scan(q, k, v, ld, u=u)
    torch.cuda.synchronize()
    assert sops.ssm_scan.launches == n + 1
    assert y.dtype == dt and y.shape == v.shape
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    tol = 1e-4 if dt == torch.float32 else 1e-2
    torch.testing.assert_close(y.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_ssm_scan_reads_stride0_views():
    """Mamba2's layout: q/k broadcast over heads and ld over Dk as stride-0
    views; the kernel reads them as given, equal to contiguous copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.ssm_scan import ops as sops
    B, S, H, N, Dv = 2, 192, 6, 64, 64
    g = torch.Generator(device="cuda").manual_seed(0)
    C = torch.randn(B, S, N, generator=g, device="cuda")
    Bm = torch.randn(B, S, N, generator=g, device="cuda")
    v = torch.randn(B, S, H, Dv, generator=g, device="cuda")
    ld = -torch.rand(B, S, H, generator=g, device="cuda")
    views = (C[:, :, None].expand(B, S, H, N), Bm[:, :, None].expand(B, S, H, N),
             v, ld[..., None].expand(B, S, H, N))
    y_view, _ = sops.ssm_scan(*views)
    y_copy, _ = sops.ssm_scan(*(a.contiguous() for a in views))
    torch.cuda.synchronize()
    torch.testing.assert_close(y_view, y_copy, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,flash,scan", [("qwen3_0_6b", 2, 0),
                                             ("zamba2_2_7b", 2, 2),
                                             ("rwkv6_7b", 0, 2)])
def test_prefill_path_runs_through_the_kernels(arch, flash, scan):
    """make_prefill_step at smoke widths on the card: kernel="cuda"
    launches flash attention once per attention layer (zamba2: per shared
    block call) and the scan once per recurrent layer; kernel="torch"
    launches neither; the logits agree within 1e-4 (fp32, TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.base_learner import fp32_matmuls
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.models.params import init_params
    from repro_torch.serving.serve_step import make_prefill_step
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 128), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    with fp32_matmuls():
        f0, s0 = fops.flash_attention.launches, sops.ssm_scan.launches
        got = make_prefill_step(cfg, kernel="cuda")(params, toks)
        assert (fops.flash_attention.launches - f0,
                sops.ssm_scan.launches - s0) == (flash, scan)
        want = make_prefill_step(cfg, kernel="torch")(params, toks)
        assert (fops.flash_attention.launches - f0,
                sops.ssm_scan.launches - s0) == (flash, scan)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ------------------------------------- the scan's chunks and final state
# (the kernel cuts the sequence into chunks of SCAN_CHUNK rows that run in
# parallel with their states passed between them, and writes the final
# state itself)

SCAN_CHUNK = 256  # csrc/ssm_scan.cu kChunk


def _scan_inputs(seed, B, S, H, Dk, Dv, dt, bonus, decay=1.0, mamba=False):
    """q, k, v in `dt`, ld = -softplus(N(0, 1)) (or -decay |N(0, 1)| when
    decay > 1), u for the bonus mode; mamba: q/k stride-0 views over heads
    and ld over Dk, as mamba2_block passes them."""
    rng = np.random.default_rng(seed)
    if mamba:
        q = _cuda(rng.normal(size=(B, S, 1, Dk)), dt).expand(B, S, H, Dk)
        k = _cuda(rng.normal(size=(B, S, 1, Dk)), dt).expand(B, S, H, Dk)
        z = rng.normal(size=(B, S, H, 1))
    else:
        q = _cuda(rng.normal(size=(B, S, H, Dk)), dt)
        k = _cuda(rng.normal(size=(B, S, H, Dk)), dt)
        z = rng.normal(size=(B, S, H, Dk))
    ld = _cuda(-np.abs(z) * decay if decay > 1 else -np.log1p(np.exp(z)))
    if mamba:
        ld = ld.expand(B, S, H, Dk)
    v = _cuda(rng.normal(size=(B, S, H, Dv)), dt)
    u = _cuda(np.abs(rng.normal(size=(H, Dk)))) if bonus else None
    return q, k, v, ld, u


def _plain_scan(sref, q, k, v, ld, u):
    """The plain version's y and its final state (the state of a run on the
    sequence zero-padded to whole 16-row sub-chunks)."""
    S = q.shape[1]
    pad = (-S) % sref.SUB
    _, st = sref.chunked_scan(*(torch.nn.functional.pad(
        a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v, ld)), u=u)
    return sref.reference_scan(q, k, v, ld, u=u), st


def _assert_scan_close(y, st, want_y, want_st, dt):
    """y within 1e-4 (fp32: sums in another order) or 1e-2 (bf16: y
    rounded once) of the plain version; the fp32 final state within
    1e-4 * (1 + |want|) of the plain version's (the chunks' states are
    summed and passed in another order than its sub-chunks'); finite."""
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    tol = 1e-4 if dt == torch.float32 else 1e-2
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
    assert st.dtype == torch.float32
    torch.testing.assert_close(st, want_st, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,Dk,Dv,bonus,mamba", [
    (1, 64, 64, False, False),                  # S = 1
    (1, 64, 64, True, False),
    (37, 32, 64, True, False),                  # S below one chunk
    (SCAN_CHUNK, 64, 64, False, True),          # S exactly one chunk
    (SCAN_CHUNK + 1, 64, 128, True, False),     # one row into a 2nd chunk
    (SCAN_CHUNK + 1, 128, 64, False, True),
    (1000, 128, 128, True, False),              # ragged S
    (1000, 32, 64, False, True),
    (777, 64, 128, False, False),
    (256, 128, 64, True, True),                 # bonus, one decay per row
])
def test_ssm_scan_chunk_edges(dtype, S, Dk, Dv, bonus, mamba):
    """The chunked kernel at chunk edges (S = 1, below a chunk, exactly
    one, one row past, ragged), both modes, Dk 32/64/128, Dv 64/128, the
    stride-0 Mamba2 views: y and the final state against the plain
    version (tolerances in _assert_scan_close); one launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.kernels.ssm_scan import ref as sref
    dt = getattr(torch, dtype)
    q, k, v, ld, u = _scan_inputs(S * Dk + Dv, 2, S, 3, Dk, Dv, dt, bonus,
                                  mamba=mamba)
    n = sops.ssm_scan.launches
    y, st = sops.ssm_scan(q, k, v, ld, u=u)
    want_y, want_st = _plain_scan(sref, q, k, v, ld, u)
    torch.cuda.synchronize()
    assert sops._lib().ssm_scan_chunk_rows() == SCAN_CHUNK
    assert sops.ssm_scan.launches == n + 1
    assert y.dtype == dt and y.shape == v.shape
    assert st.shape == (2, 3, Dk, Dv)
    _assert_scan_close(y, st, want_y, want_st, dt)


@pytest.mark.gpu
@pytest.mark.parametrize("bonus,mamba", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_ssm_scan_extreme_decay_chunks(bonus, mamba):
    """Decays of -30 |N(0, 1)| per step over several chunks (|cum| in the
    thousands, where a factorised exp(cum) . exp(-cum) would overflow),
    per-channel and per-row (stride-0) decays: y and the final state
    finite and within tolerance of the plain version (_assert_scan_close),
    and of the exact sequential scan: the state within 1e-4 * (1 + |want|),
    y within 1e-3 * (1 + |want|).  Why 1e-3 for y there: a 16-row
    sub-chunk's fp32 cumsum reaches |cum| ~ 1000 here (one ulp 6e-5), and
    the exponents of the kernel and of the plain version (which round
    alike) carry that ulp, up to ~2e-4 relative off the exact scan."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.kernels.ssm_scan import ref as sref
    from repro_torch.models.ssm import gla_scan_exact
    q, k, v, ld, u = _scan_inputs(7 + bonus + 2 * mamba, 1, 300, 4, 64, 64,
                                  torch.float32, bonus, decay=30.0,
                                  mamba=mamba)
    y, st = sops.ssm_scan(q, k, v, ld, u=u)
    want_y, want_st = _plain_scan(sref, q, k, v, ld, u)
    exact_y, exact_st = gla_scan_exact(q, k, v, ld, u=u)
    torch.cuda.synchronize()
    _assert_scan_close(y, st, want_y, want_st, torch.float32)
    torch.testing.assert_close(y, exact_y.float(), rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(st, exact_st, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("bonus", [False, True])
def test_ssm_scan_final_state_matches_closed_form(bonus):
    """The kernel's final state against ops.final_state, the closed form
    the CPU route returns: within 1e-3 * (1 + |want|).  The closed form
    sums ld over the whole sequence in fp32 (|cum| ~ 200 at S = 256, one
    ulp 1.5e-5) and clamps its exponents at -30; its exponents are then a
    few 1e-5 off, the kernel's not (it sums each chunk's weights from the
    chunk's end), and the clamp moves a term by under e^-30 |k||v|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.ssm_scan import ops as sops
    q, k, v, ld, u = _scan_inputs(11 + bonus, 2, 256, 4, 64, 64,
                                  torch.float32, bonus)
    _, st = sops.ssm_scan(q, k, v, ld, u=u)
    want = sops.final_state(k, v, ld)
    torch.cuda.synchronize()
    torch.testing.assert_close(st, want, rtol=1e-3, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("mamba", [False, True])
def test_ssm_scan_survives_cuda_graph_replay(mamba):
    """One call captured in a CUDA graph and replayed three times on fresh
    inputs copied into the captured tensors: each replay gives the same y
    and final state, bit for bit, as an eager call on those inputs (the
    kernel keeps nothing on the device between launches; its scratch is
    the call's).  mamba: q/k/ld passed as stride-0 views of the captured
    tensors, as mamba2_block passes them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.ssm_scan import ops as sops
    B, S, H, D = 2, 200, 4, 64
    hq, dl = (1, 1) if mamba else (H, D)

    def inputs(seed):  # the tensors themselves, before any broadcast
        rng = np.random.default_rng(seed)
        bf = torch.bfloat16
        return (_cuda(rng.normal(size=(B, S, hq, D)), bf),
                _cuda(rng.normal(size=(B, S, hq, D)), bf),
                _cuda(rng.normal(size=(B, S, H, D)), bf),
                _cuda(-np.log1p(np.exp(rng.normal(size=(B, S, H, dl))))),
                _cuda(np.abs(rng.normal(size=(H, D)))))

    def call(q, k, v, ld, u):
        e = lambda t: t.expand(B, S, H, D)  # noqa: E731
        return sops.ssm_scan(e(q), e(k), v, e(ld), u=None if mamba else u)

    held = inputs(30)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call(*held)  # build and load the kernel outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n = sops.ssm_scan.launches
    with torch.cuda.graph(graph):
        y, st = call(*held)
    assert sops.ssm_scan.launches == n + 1
    for seed in (31, 32, 33):
        fresh = inputs(seed)
        for dst, src in zip(held, fresh):
            dst.copy_(src)
        graph.replay()
        want_y, want_st = call(*fresh)
        torch.cuda.synchronize()
        assert torch.equal(y, want_y) and torch.equal(st, want_st)


@pytest.mark.gpu
def test_paged_attention_two_streams_at_once():
    """Two splitting launches that run at the same time on two streams,
    many times over, each on its own inputs: both outputs match the plain
    version.  Each stream has its own tickets; tickets shared by the two
    would let one launch merge the other's partials."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    shape = dict(B=4, S=1, H=16, KV=8, hd=128, P=16, n_pages=65)
    xs = [_inputs(40 + i, **shape, lasts=lasts) for i, lasts in enumerate(
        [[17, 60, 130, 255], [200, 100, 3 * 256 + 9, 25]])]
    pairs = [_paged_pair(x, torch.bfloat16) for x in xs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):  # hold both queues while they fill, so
            torch.cuda._sleep(20_000_000)  # their launches then run at once
    outs = [[], []]
    for _ in range(50):
        for i, (s, (a, _)) in enumerate(zip(streams, pairs)):
            with torch.cuda.stream(s):
                out, _, _ = ops.paged_attention_update(
                    a["q"], a["k_new"], a["v_new"], a["k_pool"],
                    a["v_pool"], a["block_table"], a["last_pos"])
                outs[i].append(out)
    for s in streams:
        torch.cuda.current_stream().wait_stream(s)
    for i, (_, b) in enumerate(pairs):
        want, _, _ = ref.reference_paged_update(
            b["q"], b["k_new"], b["v_new"], b["k_pool"], b["v_pool"],
            b["block_table"], b["last_pos"])
        torch.cuda.synchronize()
        for out in outs[i]:
            _assert_paged_close(out, want, torch.bfloat16)


# --------------------------------- the scores kernel's teams and its launch

SCORE_NS = (1, 31, 32, 33, 583, 4097, 16384)


def _chip_smoke():
    """chip_smoke.py (the repo root's), for its scores edge rows and
    comparison."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _scores_case(seed, B, n, p_sel=0.2):
    rng = np.random.default_rng(seed)
    return (_cuda(rng.normal(size=(B, n))),
            _cuda(rng.random((B, n)) + 0.05),
            torch.from_numpy(rng.random((B, n)) < p_sel).cuda())


@pytest.mark.gpu
@pytest.mark.parametrize("B,n", [(252, n) for n in SCORE_NS]
                         + [(70000, 33), (70000, 583), (1, 583)])
def test_scores_argmax_kernel_team_widths(B, n):
    """The scores kernel at every team width its plan gives (rows of 1 to
    16384 columns: one warp, wider teams, several passes) and at batches
    past 65535 (the grid is one-dimensional): scores equal to the plain
    version's, the same argmax, one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.greedy_scores import ops as gops
    from repro_torch.kernels.greedy_scores import ref as gref
    args = _scores_case(n + B, B, n)
    n0 = gops.scores_argmax.launches
    s, idx = gops.scores_argmax(*args, 3.0)
    want, widx = gref.reference_scores(*args, 3.0)
    torch.cuda.synchronize()
    assert gops.scores_argmax.launches == n0 + 1
    assert torch.equal(s, want) and torch.equal(idx, widx)


@pytest.mark.gpu
@pytest.mark.parametrize("n", SCORE_NS)
def test_scores_argmax_kernel_edge_rows(n):
    """Every column selected; NaN first, mid-row and last; +0/-0 ties;
    diag + lam = 0; equal top scores across lanes, warps, teams and
    passes; rows of -inf: scores equal but for NaN's payload, and the same
    argmax as the plain version in every row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.greedy_scores import ops as gops
    from repro_torch.kernels.greedy_scores import ref as gref
    cs = _chip_smoke()
    args = [torch.from_numpy(a).cuda() for a in cs.scores_edge_rows(n)]
    s, idx = gops.scores_argmax(*args, 3.0)
    want, widx = gref.reference_scores(*args, 3.0)
    torch.cuda.synchronize()
    assert cs.same_scores(s, want)
    assert torch.equal(idx, widx)


@pytest.mark.gpu
def test_scores_argmax_survives_cuda_graph_replay():
    """One call captured in a CUDA graph and replayed three times on fresh
    inputs copied into the captured tensors: each replay bit-equal to an
    eager call (the plan is fixed at capture; the kernel keeps nothing
    between launches)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.greedy_scores import ops as gops
    held = _scores_case(50, 252, 583)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gops.scores_argmax(*held, 3.0)  # build and load outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        s, idx = gops.scores_argmax(*held, 3.0)
    for seed in (51, 52, 53):
        fresh = _scores_case(seed, 252, 583)
        for dst, src in zip(held, fresh):
            dst.copy_(src)
        graph.replay()
        want_s, want_idx = gops.scores_argmax(*fresh, 3.0)
        torch.cuda.synchronize()
        assert torch.equal(s, want_s) and torch.equal(idx, want_idx)


@pytest.mark.gpu
@pytest.mark.parametrize("writer", ["matmul", "elementwise"])
def test_scores_argmax_sees_corr_written_just_before(writer):
    """A kernel rewrites corr immediately before each call on the same
    stream (a long matmul into it, or an elementwise op), as the residual
    correlation does in GreedyTL's loop: every call reads the new values
    (no read of the scores kernel may run ahead of the kernel before
    it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.greedy_scores import ops as gops
    from repro_torch.kernels.greedy_scores import ref as gref
    B, n, K = 252, 583, 4096
    rng = np.random.default_rng(60)
    corr, diag, sel = _scores_case(61, B, n)
    A = _cuda(rng.normal(size=(B, K)) / np.sqrt(K))
    W = _cuda(rng.normal(size=(K, n)))
    outs = []
    for i in range(12):
        if writer == "matmul":
            torch.matmul(A * (i + 1), W, out=corr)
        else:
            torch.mul(A[:, i:i + 1], W[i], out=corr)
        s, idx = gops.scores_argmax(corr, diag, sel, 3.0)
        outs.append((corr.clone(), s, idx))
    for c, s, idx in outs:
        want, widx = gref.reference_scores(c, diag, sel, 3.0)
        torch.cuda.synchronize()
        assert torch.equal(s, want) and torch.equal(idx, widx)


@pytest.mark.gpu
def test_scores_argmax_two_streams_at_once():
    """Launches on two streams that run at the same time, many times over,
    each on its own inputs: every output matches the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.greedy_scores import ops as gops
    from repro_torch.kernels.greedy_scores import ref as gref
    cases = [_scores_case(70, 252, 583), _scores_case(71, 12, 4097)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            torch.cuda._sleep(20_000_000)
    outs = [[], []]
    for _ in range(50):
        for i, (s, args) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(s):
                outs[i].append(gops.scores_argmax(*args, 3.0))
    for s in streams:
        torch.cuda.current_stream().wait_stream(s)
    for args, got in zip(cases, outs):
        want, widx = gref.reference_scores(*args, 3.0)
        torch.cuda.synchronize()
        for s, idx in got:
            assert torch.equal(s, want) and torch.equal(idx, widx)


@pytest.mark.gpu
def test_scores_argmax_empty_batch_on_the_card():
    """B = 0: empty outputs of the right shapes and types, as on the CPU,
    and no launch (CUDA refuses a grid of no CTAs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.greedy_scores import ops as gops
    corr, diag, sel = _scores_case(80, 0, 583)
    n0 = gops.scores_argmax.launches
    s, idx = gops.scores_argmax(corr, diag, sel, 3.0)
    torch.cuda.synchronize()
    assert gops.scores_argmax.launches == n0
    assert s.shape == (0, 583) and s.dtype == torch.float32 and s.is_cuda
    assert idx.shape == (0,) and idx.dtype == torch.int32 and idx.is_cuda


@pytest.mark.gpu
@pytest.mark.parametrize("team,cols,per_cta", [(48, 4, 1), (32, 5, 1),
                                               (32, 8, 9), (256, 4, 2),
                                               (64, 8, 0)])
def test_scores_argmax_launch_refuses_a_bad_plan(team, cols, per_cta):
    """The launch function refuses a team or a column count it is not
    built for and a CTA of more than 256 threads, and the wrapper's check
    raises on its code: no launch error is swallowed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.greedy_scores import ops as gops
    corr, diag, sel = _scores_case(81, 4, 33)
    s = torch.empty_like(corr)
    idx = torch.empty(4, dtype=torch.int32, device="cuda")
    lib = gops._lib()
    rc = lib.greedy_scores_argmax_launch(
        corr.data_ptr(), diag.data_ptr(), sel.data_ptr(), s.data_ptr(),
        idx.data_ptr(), 4, 33, 3.0, team, cols, per_cta,
        torch.cuda.current_stream().cuda_stream)
    assert rc != 0
    with pytest.raises(RuntimeError, match="scores_argmax kernel launch"):
        gops._raise_on(lib, rc, "scores_argmax")


# ------------------------- the paper's malicious, dynamic and bagged studies

# (B, m, n) of the Gram launches of these studies at the HAPT size: a dynamic
# phase's s * k problems of 365 rows against s (first phase) or s + 1
# sources (s = 1 and 4), and the bagged fit's 21 * 4 * 12 problems of 128
# rows against 21 sources
STUDY_SHAPES = [(12, 365, 563), (12, 365, 564), (48, 365, 566),
                (48, 365, 567), (1008, 128, 583)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,m,n", STUDY_SHAPES)
def test_greedy_kernels_at_study_shapes(B, m, n):
    """Both GreedyTL kernels against their plain versions at the dynamic
    and bagged studies' shapes: G within 1e-5 on a unit-scale design and
    bit-symmetric; scores within one ulp and the same argmax per row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.kernels.greedy_scores import ops as gops
    from repro_torch.kernels.greedy_scores import ref as gref
    rng = np.random.default_rng(B * n)
    Z = _cuda(rng.normal(size=(B, m, n)) / np.sqrt(m))
    G = gops.gram(Z)
    torch.testing.assert_close(G, gref.reference_gram(Z), rtol=0, atol=1e-5)
    assert torch.equal(G, G.mT)
    corr = _cuda(rng.normal(size=(B, n)))
    diag = _cuda(rng.random((B, n)) + 0.05)
    sel = torch.from_numpy(rng.random((B, n)) < 0.05).cuda()
    s, idx = gops.scores_argmax(corr, diag, sel, 3.0)
    want, widx = gref.reference_scores(corr, diag, sel, 3.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(s, want, rtol=2.4e-7, atol=0)
    assert torch.equal(idx, widx)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["malicious1", "malicious2"])
def test_corrupted_gtl_routes_pick_the_same_columns(kind):
    """run_gtl on a reduced HAPT scenario with half the exchange corrupted
    (the same corrupted tensors on both routes): kernel="cuda" launches
    the Gram kernel once and the scores kernel kappa times, and picks the
    columns kernel="torch" picks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import corruption, gtl
    from repro_torch.core.experiment import make_scenario
    from repro_torch.kernels.greedy_scores import ops as gops
    shards, _, _ = make_scenario("hapt", 0, 2000, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    drawn = []

    def corrupt_fn(models):
        if not drawn:
            drawn.append(corruption.corrupt_malicious1(gen, models, 0.5)[0]
                         if kind == "malicious1" else
                         corruption.corrupt_malicious2(gen, models, 0.5))
        return drawn[0]
    kw = dict(kappa=8, svm_steps=50, corrupt_fn=corrupt_fn, device="cuda")
    g0, s0 = gops.gram.launches, gops.scores_argmax.launches
    got = gtl.run_gtl(shards, 12, kernel="cuda", **kw)
    assert (gops.gram.launches - g0, gops.scores_argmax.launches - s0) \
        == (1, 8)
    want = gtl.run_gtl(shards, 12, kernel="torch", **kw)
    assert torch.equal(got.sources.W, want.sources.W)
    assert torch.equal(got.gtl_selected, want.gtl_selected)
