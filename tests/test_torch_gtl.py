"""The port's learning framework (Cloud / GTL / noHTL, metrics, overhead)
vs the JAX reference's, on the reference's own data.

The reference's synthetic HAPT-layout scenario (d=561 features, k=12
classes, L=21 locations; 1000 samples, kappa=16, 60 SVM steps) is computed
once for the module: its shards and test set (numpy) go to the port's
`run_scenario_on` on the CPU, and its `run_scenario`, `run_gtl` and
`run_nohtl` results are the reference.  One reference run serves every
test, to keep the JAX side's CPU time down.  Tolerances: model weights
within atol 1e-4 (fp32 rounding over the SVM steps); GreedyTL supports
(the selected sets) equal; labels equal; F-measures and per-class
accuracies within 1e-6 (fp32 rounding of the indices only).  Smaller
pieces (the SVM, the solver, decoding) are held at smoke widths in
tests/test_torch_greedytl.py."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import gtl as jgtl  # noqa: E402
from repro.core import nohtl as jnohtl  # noqa: E402
from repro.core.experiment import make_scenario as jax_make_scenario  # noqa: E402
from repro.core.experiment import run_scenario as jax_run_scenario  # noqa: E402
from repro.training import metrics as JM  # noqa: E402
from repro_torch.core import gtl  # noqa: E402
from repro_torch.core import nohtl  # noqa: E402
from repro_torch.core.experiment import (SCENARIOS, make_scenario,  # noqa: E402
                                         run_scenario, run_scenario_on)
from repro_torch.training import metrics as M  # noqa: E402

W_TOL = 1e-4
F_TOL = 1e-6
K, KAPPA, STEPS = 12, 16, 60


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op torch thread while these tests run; restored after."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def hapt():
    """The reference at the paper's HAPT layout, once for the module: its
    data, its run_scenario, and its GTL and noHTL runs on the same shards
    (which reuse run_scenario's compiled functions)."""
    shards, (Xte, yte), _ = jax_make_scenario("hapt", 0, 1000)
    want = jax_run_scenario("hapt", n_samples=1000, kappa=KAPPA,
                            svm_steps=STEPS)
    return dict(
        shards=shards, Xte=np.array(Xte), yte=np.array(yte), want=want,
        gtl=jgtl.run_gtl(jax.random.PRNGKey(1000), shards, K, kappa=KAPPA,
                         svm_steps=STEPS),
        nohtl=jnohtl.run_nohtl(shards, K, svm_steps=STEPS))


@pytest.fixture(scope="module")
def port_hapt(hapt):
    """The port's run_scenario_on on the reference's shards and test set
    (kernel="cuda": on CPU tensors, the kernels' plain versions)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run_scenario_on(
            hapt["shards"], (hapt["Xte"], hapt["yte"]), K, name="hapt",
            kappa=KAPPA, svm_steps=STEPS, n_samples=1000, d_point=561,
            d_raw=1178, kernel="cuda", device="cpu")
    finally:
        torch.set_num_threads(prev)


def _close(got, want, tol=W_TOL):
    np.testing.assert_allclose(got.cpu().numpy(), np.asarray(want), rtol=0,
                               atol=tol)


def _same_predictions(mine, ref, Xte, predict):
    """The port's prediction function on the port's weights and on the
    reference's weights gives the same labels (so equal F-measures); the
    function itself is held against the reference in
    tests/test_torch_greedytl.py."""
    X = torch.from_numpy(Xte)
    want = predict(torch.from_numpy(np.array(ref)), X)
    assert torch.equal(predict(mine, X), want)


def test_run_gtl_matches_jax(hapt, port_hapt):
    """Algorithm 1 at the HAPT layout (n = 583 design columns, 252
    GreedyTL problems): base models, GreedyTL's selected sets and
    coefficients, the flattened h^(2) and the mu-consensus h^(4), and the
    labels each predicts on the test set."""
    want, got = hapt["gtl"], port_hapt.gtl
    _close(got.base.W, want.base.W)
    _close(got.base.b, want.base.b)
    np.testing.assert_array_equal(got.gtl_coef.numpy() != 0,
                                  np.asarray(want.gtl_coef) != 0)
    sel = got.gtl_selected.long()
    assert sel.shape == (21, K, KAPPA)
    assert bool((torch.gather(got.gtl_coef, 2, sel) != 0).all())
    _close(got.gtl_coef, want.gtl_coef)
    _close(got.gtl_flat, want.gtl_flat)
    _close(got.consensus_flat, want.consensus_flat)
    Xte = hapt["Xte"]
    _same_predictions(got.gtl_flat, want.gtl_flat, Xte, gtl.predict_linear)
    _same_predictions(got.consensus_flat, want.consensus_flat, Xte,
                      gtl.predict_linear)
    _same_predictions(got.gtl_flat, want.gtl_flat, Xte,
                      lambda c, X: gtl.predict_majority(c, X, K))


def test_run_nohtl_matches_jax(hapt):
    """Algorithm 2: the collector's mean model and the labels of noHTL_mu
    and noHTL_mv."""
    want = hapt["nohtl"]
    got = nohtl.run_nohtl(hapt["shards"], K, svm_steps=STEPS, device="cpu")
    _close(got.consensus_flat, want.consensus_flat)
    _same_predictions(got.consensus_flat, want.consensus_flat, hapt["Xte"],
                      gtl.predict_linear)
    _same_predictions(got.sources.augmented(), want.sources.augmented(),
                      hapt["Xte"], lambda c, X: gtl.predict_majority(c, X, K))


@pytest.mark.parametrize("masked", [False, True])
def test_metrics_match_jax(masked):
    """Precision, recall, F, per-class accuracy and PPG on the same labels,
    with a batch of prediction vectors (the port's form of the
    reference's vmap) and an absent class."""
    rng = np.random.default_rng(7)
    k, m = 5, 90
    y = rng.integers(0, k - 1, size=m).astype(np.int32)  # class 4 absent
    preds = np.where(rng.random((3, m)) < 0.7, y,
                     rng.integers(0, k, size=(3, m))).astype(np.int32)
    mask = (rng.random(m) < 0.8).astype(np.float32) if masked else None
    tm = None if mask is None else torch.from_numpy(mask)
    jm = None if mask is None else jnp.asarray(mask)
    yt, pt = torch.from_numpy(y), torch.from_numpy(preds)
    for name in ("precision_index", "f_measure", "recall_index",
                 "per_class_accuracy"):
        args = () if name == "precision_index" else (k,)
        got = getattr(M, name)(yt, pt, *args, sample_mask=tm)
        want = [np.asarray(getattr(JM, name)(jnp.asarray(y), jnp.asarray(p),
                                             *args, sample_mask=jm))
                for p in preds]
        np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=0,
                                   atol=F_TOL, err_msg=name)
    f = M.f_measure(yt, pt, k).numpy()
    np.testing.assert_allclose(M.ppg(f[1:], f[0]).numpy(),
                               np.asarray(JM.ppg(f[1:], f[0])), rtol=0,
                               atol=F_TOL)


def test_hapt_layout_matches_jax(hapt, port_hapt):
    """run_scenario_on, fed the reference's HAPT shards (d=561, k=12, L=21),
    against the reference's run_scenario: every F-measure row (Cloud,
    local, GTL(2), mu/mv-GTL(4), noHTL mu/mv), per-location F, per-class
    accuracy, PPG and the overhead report."""
    want, got = hapt["want"], port_hapt
    for (name, mine), (_, ref) in zip(got.summary_rows(),
                                      want.summary_rows()):
        assert mine == pytest.approx(ref, abs=F_TOL), name
    np.testing.assert_allclose(got.f_local, want.f_local, rtol=0, atol=F_TOL)
    np.testing.assert_allclose(got.f_gtl2, want.f_gtl2, rtol=0, atol=F_TOL)
    for name in want.per_class:
        np.testing.assert_allclose(got.per_class[name], want.per_class[name],
                                   rtol=0, atol=F_TOL, err_msg=name)
    for name, v in want.ppg().items():
        np.testing.assert_allclose(got.ppg()[name], v, rtol=0, atol=1e-5,
                                   err_msg=name)
    assert dataclasses.asdict(got.overhead) == dataclasses.asdict(
        want.overhead)
    assert got.overhead.gains() == pytest.approx(want.overhead.gains())


def test_aggregators_subset_matches_full_gtl(hapt, port_hapt):
    """Section 9: with 2 aggregators, Step 2 runs at locations 0 and 1 only
    and gives their models of the full run; the consensus is their mean."""
    got = gtl.run_gtl_with_aggregators(hapt["shards"], K, 2, kappa=KAPPA,
                                       steps=STEPS, device="cpu")
    full = port_hapt.gtl
    assert torch.equal(got.gtl_selected, full.gtl_selected[:2])
    _close(got.gtl_coef, full.gtl_coef[:2].numpy(), 1e-6)
    _close(got.consensus_flat, full.gtl_flat[:2].mean(0).numpy(), 1e-6)


@pytest.mark.parametrize("name", SCENARIOS)
def test_make_scenario_layouts(name):
    """The port's own data: every scenario's shapes and partition rule
    (drawn from the port's generator; the streams differ from JAX's)."""
    shards, (Xte, yte), spec = make_scenario(name, 0, 900, device="cpu")
    L, d = spec.n_locations, spec.n_features
    assert shards.X.shape[0] == L and shards.X.shape[2] == d
    assert Xte.shape == (270, d) and yte.dtype == torch.int32
    counts = shards.counts()
    if name == "mnist_node_unbalanced":  # 70% of each shard is its hot class
        hot = [np.mean(shards.location(l)[1] == l % spec.n_classes)
               for l in range(L)]
        assert min(hot) > 0.6
    elif name != "mnist_class_unbalanced":
        assert counts.sum() == 630 and counts.max() - counts.min() <= 1


def test_run_scenario_makes_its_own_data_on_the_device():
    """The port's own entry point on its own generator's data: the HAPT
    shapes and a sane result (Cloud at least as good as a local model)."""
    r = run_scenario("hapt", n_samples=800, kappa=8, svm_steps=30,
                     device="cpu")
    assert r.f_local.shape == (21,) and r.f_gtl2.shape == (21,)
    assert r.gtl.gtl_coef.shape == (21, 12, 561 + 1 + 21)
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0
               for _, v in r.summary_rows())
    assert r.f_cloud >= r.f_local.mean()
    assert r.overhead.s == 21 and r.overhead.d1 == 8
