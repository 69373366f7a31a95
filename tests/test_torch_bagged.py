"""The port's bagged GreedyTL (paper Section 3, last paragraph: several
GreedyTL fits on random subsamples of a large local dataset, averaged) vs
the JAX reference's `greedytl_fit_bagged` and `run_gtl(n_bags=...)`.

`jax.random.choice`'s stream cannot be matched, so the reference's bag row
indices are rebuilt in JAX exactly as it draws them (one key per location
from `split(key, L)`, then `split(loc_key, n_bags)`, then `choice(k, m,
(bag_size,), True, p=mask / sum(mask))`) and carried across through numpy
to the port's `greedytl_fit_bagged_rows` / `run_gtl(bag_rows=...)`.
Inputs: the smoke widths of tests/test_torch_greedytl.py for the solver
(d=32, L=5 sources, k=4, m=60 rows of which 8 padded); the reference's
HAPT layout (d=561, k=12, L=21; 600 samples, kappa=8, 40 SVM steps) for
the procedure.  Tolerances: the averaged coef within 1e-5 for the solver
on equal inputs and for the procedure (whose base models agree within
fp32 rounding); bag 0's picks, in order, and n_selected equal.  The
torch.Generator wrapper is held to the reference's sampling rule (rows in
range, padded rows never drawn).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import gtl as jgtl  # noqa: E402
from repro.core import greedytl as jgt  # noqa: E402
from repro.core.experiment import make_scenario as jax_make_scenario  # noqa: E402
from repro_torch.core import gtl  # noqa: E402
from repro_torch.core import greedytl as gt  # noqa: E402

TOL = 1e-5
N_BAGS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread while this module runs; restored after."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bag_rows(key, mask, n_bags, bag_size):
    """The reference's bag rows for one location's mask (m,)."""
    m = mask.shape[-1]

    def one(k):
        return jax.random.choice(k, m, shape=(bag_size,), replace=True,
                                 p=mask / jnp.sum(mask))
    return jax.vmap(one)(jax.random.split(key, n_bags))


def _problem(seed, m=60, d=32, L=5, k=4, n_pad=8):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(m, d)).astype(np.float32)
    y = rng.integers(0, k, size=m)
    mask = np.ones(m, np.float32)
    mask[m - n_pad:] = 0.0
    Y = (np.where(np.arange(k)[:, None] == y, 1.0, -1.0)
         * mask).astype(np.float32)
    H = rng.normal(size=(k, m, L)).astype(np.float32)
    return X, Y, H, mask


CASES = ((6, 20), (12, 40))  # (kappa, bag_size)


@pytest.fixture(scope="module")
def solver():
    """The reference's greedytl_fit_bagged and its bag rows for each case
    of CASES, once."""
    out = {}
    for kappa, bag_size in CASES:
        X, Y, H, mask = _problem(kappa + bag_size)
        key = jax.random.PRNGKey(bag_size)
        want = jgt.greedytl_fit_bagged(key, X, Y, H, kappa, 3.0, N_BAGS,
                                       bag_size, sample_mask=mask)
        out[kappa, bag_size] = dict(
            inputs=(X, Y, H), want=jax.tree.map(np.array, want),
            rows=np.array(_bag_rows(key, mask, N_BAGS, bag_size)))
    return out


@pytest.mark.parametrize("kernel", ["torch", "cuda"])
@pytest.mark.parametrize("case", CASES)
def test_bagged_fit_matches_jax(solver, kernel, case):
    """greedytl_fit_bagged_rows on the reference's bags: the bags' mean
    coef, bag 0's picks and n_selected (the max over bags)."""
    kappa, bag_size = case
    ref = solver[case]
    rows = torch.from_numpy(ref["rows"])
    assert rows.shape == (N_BAGS, bag_size) and int(rows.max()) < 52
    got = gt.greedytl_fit_bagged_rows(
        *map(torch.from_numpy, ref["inputs"]), rows, kappa, 3.0,
        kernel=kernel)
    want = ref["want"]
    np.testing.assert_allclose(got.coef.numpy(), want.coef, rtol=0,
                               atol=TOL)
    np.testing.assert_array_equal(got.selected.numpy(), want.selected)
    np.testing.assert_array_equal(got.n_selected.numpy(), want.n_selected)


def test_drawn_bags_follow_the_mask():
    """greedytl_fit_bagged draws bag_size rows per bag with replacement
    from the unmasked rows only, one draw per generator state."""
    X, Y, H, mask = _problem(1)
    t = [torch.from_numpy(a) for a in (X, Y, H, mask)]
    rows = gt.draw_bag_rows(torch.Generator().manual_seed(0),
                            torch.from_numpy(np.stack([mask, mask])), 4, 50)
    assert rows.shape == (2, 4, 50)
    assert int(rows.min()) >= 0 and int(rows.max()) < 52
    a = gt.greedytl_fit_bagged(torch.Generator().manual_seed(0), *t[:3], 6,
                               3.0, 4, 50, sample_mask=t[3], kernel="torch")
    b = gt.greedytl_fit_bagged_rows(*t[:3], rows[0], 6, 3.0, kernel="torch")
    assert torch.equal(a.coef, b.coef)
    assert torch.equal(a.selected, b.selected)


@pytest.fixture(scope="module")
def hapt():
    """The reference's run_gtl with bagging on HAPT-layout shards, and the
    bag rows it drew, once."""
    shards, _, _ = jax_make_scenario("hapt", 0, 600)
    key = jax.random.PRNGKey(11)
    bag_size = 12
    want = jgtl.run_gtl(key, shards, 12, kappa=8, svm_steps=40,
                        n_bags=N_BAGS, bag_size=bag_size)
    rows = jax.vmap(lambda k, m: _bag_rows(k, m, N_BAGS, bag_size))(
        jax.random.split(key, shards.X.shape[0]), jnp.asarray(shards.mask))
    return dict(shards=shards, want=want, rows=np.array(rows))


@pytest.mark.parametrize("kernel", ["torch", "cuda"])
def test_run_gtl_bagged_matches_jax(hapt, kernel):
    """run_gtl(n_bags=3, bag_size=12) with the reference's bags: every
    location's averaged coef (one batched fit of 21 * 3 * 12 problems), its
    flattened h^(2) and the mu-consensus."""
    want = hapt["want"]
    got = gtl.run_gtl(hapt["shards"], 12, kappa=8, svm_steps=40,
                      n_bags=N_BAGS, bag_size=12,
                      bag_rows=torch.from_numpy(hapt["rows"]),
                      kernel=kernel, device="cpu")
    assert got.gtl_selected.shape == (21, 12, 8)
    np.testing.assert_array_equal(got.gtl_coef.numpy() != 0,
                                  np.array(want.gtl_coef) != 0)
    np.testing.assert_allclose(got.gtl_coef.numpy(), np.array(want.gtl_coef),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got.consensus_flat.numpy(),
                               np.array(want.consensus_flat), rtol=0,
                               atol=1e-4)


def test_run_gtl_bagging_arguments():
    """Bagging takes its rows from bag_rows of shape (L, n_bags, bag_size)
    or draws them from generator=; anything else raises."""
    mask = torch.ones(2, 5)
    with pytest.raises(ValueError, match="generator"):
        gtl._bag_rows(mask, 2, 4, None, None)
    with pytest.raises(ValueError, match="shape"):
        gtl._bag_rows(mask, 2, 4, None, torch.zeros(2, 2, 3, dtype=int))
    with pytest.raises(ValueError, match="index"):
        gtl._bag_rows(mask, 2, 4, None, torch.full((2, 2, 4), 5))
    with pytest.raises(ValueError, match="n_bags"):
        gtl._bag_rows(mask, 0, 0, None, torch.zeros(2, 2, 3, dtype=int))
    assert gtl._bag_rows(mask, 0, 0, None, None) is None
    rows = gtl._bag_rows(mask, 2, 4, torch.Generator().manual_seed(0), None)
    assert rows.shape == (2, 2, 4) and int(rows.max()) < 5
