"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``: without a CUDA device each test skips (a CUDA
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
