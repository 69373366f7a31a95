"""The port's GreedyTL solver and Step-0 SVM vs the JAX reference's.

Same numpy inputs through ``repro.core`` and ``repro_torch.core``, on the
CPU, fp32, at smoke widths (d=32 features, L=5 sources, so n = 38 design
columns; k=4 classes).  Both kernel routes of the port run: on CPU tensors
``kernel="cuda"`` goes through the kernel wrappers, which run their plain
versions.  Tolerances: Gram statistics within atol 1e-5 (fp32 sums in
another order); GreedyTL selections equal and coefficients within atol
1e-5 (the same ridge solves, LAPACK on both sides); SVM weights within
atol 1e-4 after 100 Nesterov steps (fp32 rounding accumulated over the
steps)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import base_learner as jbl  # noqa: E402
from repro.core import greedytl as jgt  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro_torch.core import aggregation as agg  # noqa: E402
from repro_torch.core import base_learner as bl  # noqa: E402
from repro_torch.core import greedytl as gt  # noqa: E402

TOL = 1e-5
ROUTES = ("torch", "cuda")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op torch thread while these tests run; restored after."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _problems(seed, B=4, m=60, d=32, L=5, n_pad=8):
    """B binary problems: features, +-1 labels (0 on padded rows), source
    margins with one informative source, and a mask with n_pad padded
    rows."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(m, d)).astype(np.float32)
    w = rng.normal(size=(B, d)).astype(np.float32)
    y = np.sign(X @ w.T + 0.3 * rng.normal(size=(m, B))).T.astype(np.float32)
    H = (0.1 * rng.normal(size=(B, m, L))).astype(np.float32)
    H[:, :, 0] = 0.9 * y + 0.1 * rng.normal(size=(B, m))
    mask = np.ones(m, np.float32)
    mask[m - n_pad:] = 0.0
    return X, y * mask, H, mask


@jax.jit
def _jax_stats_jit(X, y, H, mask):
    def one(yb, Hb):
        Z, _ = jgt.build_design(X, Hb, mask)
        return jgt.gram_stats(Z, yb, mask)
    return jax.vmap(one)(y, H)


def _jax_stats(X, y, H, mask):
    """The reference's G, c of each problem (numpy copies)."""
    G, c = _jax_stats_jit(X, y, H, mask)
    return np.array(G), np.array(c)


@pytest.mark.parametrize("kernel", ROUTES)
def test_gram_stats_matches_jax(kernel):
    X, y, H, mask = _problems(0)
    G_want, c_want = _jax_stats(X, y, H, mask)
    Z, d_feat = gt.build_design(torch.from_numpy(X), torch.from_numpy(H),
                                torch.from_numpy(mask))
    assert d_feat == X.shape[1] + 1 and Z.shape == (4, 60, 38)
    G, c = gt.gram_stats(Z, torch.from_numpy(y),
                         torch.from_numpy(mask).expand(4, 60), kernel=kernel)
    np.testing.assert_allclose(G.numpy(), G_want, rtol=0, atol=TOL)
    np.testing.assert_allclose(c.numpy(), c_want, rtol=0, atol=TOL)


@pytest.mark.parametrize("kernel", ROUTES)
def test_greedytl_from_gram_matches_jax(kernel):
    """Fed the reference's own G and c: the same picks in the same order,
    coefficients within atol 1e-5."""
    kappa, lam = 12, 3.0
    G, c = _jax_stats(*_problems(1))
    want = jax.vmap(lambda g, cc: jgt.greedytl_from_gram(g, cc, kappa, lam))(
        jnp.asarray(G), jnp.asarray(c))
    got = gt.greedytl_from_gram(torch.from_numpy(G), torch.from_numpy(c),
                                kappa, lam, kernel=kernel)
    np.testing.assert_array_equal(got.selected.numpy(),
                                  np.asarray(want.selected))
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(want.coef),
                               rtol=0, atol=TOL)
    assert got.n_selected.tolist() == np.asarray(want.n_selected).tolist()
    assert int(got.nnz) == int(jnp.sum(want.coef != 0))


@pytest.mark.parametrize("kernel", ROUTES)
def test_greedytl_fit_multiclass_matches_jax(kernel):
    """k one-vs-all fits sharing X, padded rows masked out; kappa = n, so
    every column is picked, the last ones on small residuals."""
    X, y, H, mask = _problems(2)
    want = jgt.greedytl_fit_multiclass(jnp.asarray(X), jnp.asarray(y),
                                       jnp.asarray(H), 38, 0.1,
                                       sample_mask=jnp.asarray(mask))
    got = gt.greedytl_fit_multiclass(torch.from_numpy(X), torch.from_numpy(y),
                                     torch.from_numpy(H), 38, 0.1,
                                     sample_mask=torch.from_numpy(mask),
                                     kernel=kernel)
    np.testing.assert_array_equal(got.selected.numpy(),
                                  np.asarray(want.selected))
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(want.coef),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(
        gt.predict_margins(got.coef, torch.from_numpy(X),
                           torch.from_numpy(H)).numpy(),
        np.asarray(jgt.predict_margins(want.coef, jnp.asarray(X),
                                       jnp.asarray(H))), rtol=0, atol=1e-4)


def test_unknown_kernel_raises():
    with pytest.raises(ValueError):
        gt.greedytl_from_gram(torch.eye(5), torch.ones(5), 4, 1.0,
                              kernel="pallas")


def test_fit_linear_svm_matches_jax():
    """Step 0 at three locations at once against the reference's vmap:
    W and b within atol 1e-4 after 100 steps; padded rows ignored."""
    rng = np.random.default_rng(4)
    L, m, d, k = 3, 40, 32, 4
    X = rng.normal(size=(L, m, d)).astype(np.float32)
    y = rng.integers(0, k, size=(L, m)).astype(np.int32)
    X += 0.8 * np.eye(k, d, dtype=np.float32)[y] * 3
    mask = np.ones((L, m), np.float32)
    mask[1, 30:] = 0.0
    X[1, 30:] = 1e3  # garbage on padded rows must not matter
    want = jax.vmap(lambda a, b, c: jbl.fit_linear_svm(
        a, b, k, steps=100, sample_mask=c))(jnp.asarray(X), jnp.asarray(y),
                                            jnp.asarray(mask))
    got = bl.fit_linear_svm(torch.from_numpy(X), torch.from_numpy(y), k,
                            steps=100, sample_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.W.numpy(), np.asarray(want.W), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got.b.numpy(), np.asarray(want.b), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("hard", [False, True])
def test_decode_codewords_and_majority_vote_match_jax(hard):
    """Codeword decoding and majority voting, ties included: both pick the
    lowest class (margins drawn from a few values so ties occur)."""
    rng = np.random.default_rng(5)
    margins = rng.choice([-1.5, -0.5, 0.0, 0.5, 1.5],
                         size=(50, 4)).astype(np.float32)
    got = bl.decode_codewords(torch.from_numpy(margins), hard=hard)
    want = jbl.decode_codewords(jnp.asarray(margins), hard=hard)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    preds = rng.integers(0, 4, size=(4, 50))
    np.testing.assert_array_equal(
        agg.majority_vote(torch.from_numpy(preds), 4).numpy(),
        np.asarray(jagg.majority_vote(jnp.asarray(preds), 4)))
    np.testing.assert_array_equal(
        bl.onehot_pm(torch.from_numpy(preds[0]), 4).numpy(),
        np.asarray(jbl.onehot_pm(jnp.asarray(preds[0]), 4)))


def test_aggregation_matches_jax():
    rng = np.random.default_rng(6)
    W = rng.normal(size=(5, 4, 7)).astype(np.float32)
    b = rng.normal(size=(5, 4)).astype(np.float32)
    wm = np.array([1, 0, 1, 1, 0], np.float32)
    for weights in (None, wm):
        tw = None if weights is None else torch.from_numpy(weights)
        jw = None if weights is None else jnp.asarray(weights)
        got = agg.consensus_mean(bl.LinearModel(torch.from_numpy(W),
                                                torch.from_numpy(b)), tw)
        want = jagg.consensus_mean(jbl.LinearModel(jnp.asarray(W),
                                                   jnp.asarray(b)), jw)
        np.testing.assert_allclose(got.W.numpy(), np.asarray(want.W),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.b.numpy(), np.asarray(want.b),
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        agg.ema_merge(torch.from_numpy(W), torch.from_numpy(2 * W),
                      0.25).numpy(),
        np.asarray(jagg.ema_merge(jnp.asarray(W), jnp.asarray(2 * W), 0.25)),
        rtol=0, atol=1e-6)
