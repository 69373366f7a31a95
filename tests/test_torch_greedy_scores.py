"""The port's GreedyTL kernel wrappers vs the JAX reference's.

On the CPU the port's ``ops.gram`` / ``ops.scores_argmax`` run the kernels'
plain versions (ref.py); the JAX side runs its Pallas kernels in interpret
mode, as tests/test_kernels.py does.  Same numpy inputs, fp32.  Z is
scaled by 1/sqrt(m) so that G has the O(1) entries that GreedyTL's
G = Z^T Z / m has: G within atol 1e-5 (fp32 sums over m rows in another
order, about sqrt(m) * 6e-8); scores within atol 1e-5 and the argmax
index equal.  The CUDA kernels themselves run only on a card:
tests/test_torch_kernels_gpu.py holds them against these plain versions
there."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.greedy_scores import ops as jops  # noqa: E402
from repro_torch.kernels.greedy_scores import ops, ref  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op torch thread while these tests run; restored after."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _scores_inputs(seed, B, n):
    rng = np.random.default_rng(seed)
    corr = rng.normal(size=(B, n)).astype(np.float32)
    diag = (np.abs(rng.normal(size=(B, n))) + 0.05).astype(np.float32)
    sel = rng.random((B, n)) < 0.2
    return corr, diag, sel


# ragged m and n (no block multiple of the JAX kernel's 128), and the
# HAPT design width n = 561 + 1 + 21
@pytest.mark.parametrize("B,m,n", [(2, 37, 45), (2, 130, 200), (1, 60, 583)])
def test_gram_matches_jax(B, m, n):
    rng = np.random.default_rng(m * n)
    Z = (rng.normal(size=(B, m, n)) / np.sqrt(m)).astype(np.float32)
    G = ops.gram(torch.from_numpy(Z))
    assert G.shape == (B, n, n) and G.dtype == torch.float32
    for b in range(B):
        want = np.asarray(jops.gram(Z[b]))
        np.testing.assert_allclose(G[b].numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("n,lam", [(45, 3.0), (583, 3.0), (300, 0.01)])
def test_scores_argmax_matches_jax(n, lam):
    B = 3
    corr, diag, sel = _scores_inputs(n, B, n)
    s, idx = ops.scores_argmax(torch.from_numpy(corr), torch.from_numpy(diag),
                               torch.from_numpy(sel), lam)
    assert s.shape == (B, n) and idx.dtype == torch.int32
    for b in range(B):
        js, jidx = jops.scores_argmax(corr[b], diag[b],
                                      sel[b].astype(np.float32), lam)
        np.testing.assert_allclose(s[b].numpy(), np.asarray(js), rtol=0,
                                   atol=TOL)
        assert int(idx[b]) == int(jidx)


def test_scores_argmax_tie_takes_lowest_index():
    """Equal top scores: both packages pick the lowest index, and a selected
    column never wins even with the largest raw score."""
    n = 300
    corr = np.zeros((2, n), np.float32)
    diag = np.ones((2, n), np.float32)
    corr[:, [17, 200, 260]] = 2.0       # a three-way tie
    corr[:, 5] = 9.0                    # largest, but selected
    sel = np.zeros((2, n), bool)
    sel[:, 5] = True
    sel[1, 17] = True                   # row 1: the tie is 200 vs 260
    _, idx = ops.scores_argmax(torch.from_numpy(corr), torch.from_numpy(diag),
                               torch.from_numpy(sel), 3.0)
    assert idx.tolist() == [17, 200]
    for b in range(2):
        _, jidx = jops.scores_argmax(corr[b], diag[b],
                                     sel[b].astype(np.float32), 3.0)
        assert int(jidx) == int(idx[b])


def test_cpu_wrappers_run_plain_versions_and_count_no_launch():
    Z = torch.randn(2, 9, 7, generator=torch.Generator().manual_seed(0))
    n_gram, n_scores = ops.gram.launches, ops.scores_argmax.launches
    torch.testing.assert_close(ops.gram(Z), ref.reference_gram(Z), rtol=0,
                               atol=0)
    corr, diag, sel = (torch.from_numpy(a) for a in _scores_inputs(1, 2, 7))
    s, i = ops.scores_argmax(corr, diag, sel, 1.0)
    rs, ri = ref.reference_scores(corr, diag, sel, 1.0)
    assert torch.equal(s, rs) and torch.equal(i, ri)
    assert (ops.gram.launches, ops.scores_argmax.launches) == (n_gram,
                                                               n_scores)


@pytest.mark.parametrize("bad", ["gram_2d", "gram_empty", "scores_shape",
                                 "scores_mask_dtype", "mixed_devices"])
def test_wrappers_reject_bad_inputs(bad):
    corr, diag, sel = (torch.from_numpy(a) for a in _scores_inputs(2, 2, 8))
    with pytest.raises(ValueError):
        if bad == "gram_2d":
            ops.gram(torch.zeros(4, 3))
        elif bad == "gram_empty":
            ops.gram(torch.zeros(1, 0, 3))
        elif bad == "scores_shape":
            ops.scores_argmax(corr, diag[:, :4], sel, 1.0)
        elif bad == "scores_mask_dtype":
            ops.scores_argmax(corr, diag, sel.float(), 1.0)
        else:
            ops.scores_argmax(corr, diag.to("meta"), sel, 1.0)
