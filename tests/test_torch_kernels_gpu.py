"""The port's CUDA kernels (paged attention; GreedyTL's Gram and scores)
against their plain PyTorch versions, on the card.  Marked ``gpu``: without a CUDA device each test skips (a CUDA
kernel has no interpret mode).  Imports no JAX, so it runs on a machine
with the card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.paged_attention import ops, ref  # noqa: E402

PSZ = 16


def _inputs(seed, B, S, H, KV, hd, P, n_pages, lasts):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    bt = rng.permutation(np.arange(1, n_pages))[:B * P].reshape(B, P)
    return dict(q=f(B, S, H, hd), k_new=f(B, S, KV, hd),
                v_new=f(B, S, KV, hd), k_pool=f(n_pages, PSZ, KV, hd),
                v_pool=f(n_pages, PSZ, KV, hd),
                block_table=bt.astype(np.int32),
                last_pos=np.array(lasts, np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype,S,lasts,window", [
    ("float32", 1, [17, 60, 130, 255], 0),
    ("bfloat16", 1, [17, 60, 130, 255], 0),
    ("bfloat16", 16, [15, 40, 256, 3 * 256 + 77], 0),  # prefill, ring wrap
    ("float32", 4, [9, 33, 100, 200], 40),             # window
])
def test_paged_attention_kernel_matches_plain_version(q_dtype, S, lasts,
                                                      window):
    """The CUDA kernel (built with nvcc on first use) against its plain
    version at the qwen3_0_6b shapes (H=16, KV=8, hd=128, 16 pages of 16
    per slot): the output within 1e-2 for bf16 (one output ulp; fp32 sum
    order) or 1e-5 for fp32, the written pool rows bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dt = getattr(torch, q_dtype)
    x = _inputs(9, B=4, S=S, H=16, KV=8, hd=128, P=16, n_pages=65,
                lasts=lasts)
    a = {k: torch.from_numpy(v).cuda() for k, v in x.items()}
    for k in ("q", "k_new", "v_new"):
        a[k] = a[k].to(dt)
    b = {k: v.clone() for k, v in a.items()}
    n = ops.paged_attention_update.launches
    out, _, _ = ops.paged_attention_update(
        a["q"], a["k_new"], a["v_new"], a["k_pool"], a["v_pool"],
        a["block_table"], a["last_pos"], window=window)
    want, _, _ = ref.reference_paged_update(
        b["q"], b["k_new"], b["v_new"], b["k_pool"], b["v_pool"],
        b["block_table"], b["last_pos"], window=window)
    torch.cuda.synchronize()
    assert ops.paged_attention_update.launches == n + 1
    tol = 1e-2 if dt == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(a["k_pool"][1:], b["k_pool"][1:])
    assert torch.equal(a["v_pool"][1:], b["v_pool"][1:])


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
@pytest.mark.parametrize("B,m,n", [(252, 365, 583), (3, 37, 45), (2, 1, 70)])
def test_gram_kernel_matches_plain_version(B, m, n):
    """The GreedyTL Gram kernel against its plain version at the HAPT
    shapes (252 problems, 365 rows, 583 design columns) and ragged ones:
    within 1e-5 on a unit-scale design (two fp32 sums of m products in
    different orders) and bit-symmetric."""
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
