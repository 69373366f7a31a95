"""The port's malicious-device corruption (paper Section 7) and the
corrupted GTL / noHTL procedures vs the JAX reference.

The corruption functions draw from a torch.Generator, whose streams cannot
match JAX's permutation / bernoulli / normal, so their own properties are
checked as tests/test_corruption.py checks the reference's.  For parity,
the reference's corrupted models are carried across through numpy: the
reference's `run_scenario("mnist_balanced")` (the layout of the paper's
Tables 1 and 3: d=324, k=10, L=30; 1500 samples, kappa=8, 40 SVM steps)
runs once per corruption (malicious1 and malicious2 at 0.5) with a
corrupt_fn that records what it was given and what it returned, and a spy
on its Step 2 that records GreedyTL's coefficients.  The port's
`run_scenario_on` gets the same shards, test set and `corrupt_fn=lambda _:
carried`.  Tolerances: GreedyTL supports equal; weights within 1e-4 (fp32
rounding over the SVM steps); F rows and per-class accuracies within 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import corruption as jcorr  # noqa: E402
from repro.core import gtl as jgtl  # noqa: E402
from repro.core.experiment import make_scenario as jax_make_scenario  # noqa: E402
from repro.core.experiment import run_scenario as jax_run_scenario  # noqa: E402
from repro_torch.core import gtl  # noqa: E402
from repro_torch.core.corruption import (corrupt_malicious1,  # noqa: E402
                                         corrupt_malicious2)
from repro_torch.core.experiment import run_scenario_on  # noqa: E402

W_TOL = 1e-4
F_TOL = 1e-6
N, K, KAPPA, STEPS, LAM = 1500, 10, 8, 40, 3.0
KINDS = {
    "malicious1": lambda key, m: jcorr.corrupt_malicious1(key, m, 0.5)[0],
    "malicious2": lambda key, m: jcorr.corrupt_malicious2(key, m, 0.5),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread while this module runs; restored after."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(models):
    return gtl.StackedLinear(*(np.array(a) for a in models))


def _torch(models):
    return gtl.StackedLinear(*(torch.from_numpy(np.array(a)) for a in models))


@pytest.fixture(scope="module")
def mnist():
    """The reference's corrupted studies on one set of MNIST-layout shards,
    each once: its ScenarioResult, the honest base models its corrupt_fn
    was given, the corrupted models it returned, and Step 2's coef."""
    shards, (Xte, yte), _ = jax_make_scenario("mnist_balanced", 0, N)
    runs = {}
    for seed, (kind, corrupt) in enumerate(KINDS.items()):
        key = jax.random.PRNGKey(7 + seed)
        given, step2 = [], []

        def cf(models):
            given.append((models, corrupt(key, models)))
            return given[-1][1]

        def spy(*a, _real=jgtl.gtl_step2_all, **kw):
            step2.append(_real(*a, **kw))
            return step2[-1]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jgtl, "gtl_step2_all", spy)
            want = jax_run_scenario("mnist_balanced", n_samples=N,
                                    kappa=KAPPA, svm_steps=STEPS,
                                    corrupt_fn=cf)
        runs[kind] = dict(want=want, base=_np(given[0][0]),
                          carried=_np(given[0][1]),
                          coef=np.array(step2[0][0]),
                          flat=np.array(step2[0][1]))
    return dict(shards=shards, Xte=np.array(Xte), yte=np.array(yte),
                runs=runs)


@pytest.fixture(scope="module")
def port_runs(mnist):
    """The port's run_scenario_on with each reference corruption carried
    in (kernel="cuda": on CPU tensors, the kernels' plain versions)."""
    out = {}
    for kind, ref in mnist["runs"].items():
        carried = _torch(ref["carried"])
        out[kind] = run_scenario_on(
            mnist["shards"], (mnist["Xte"], mnist["yte"]), K,
            name="mnist_balanced", kappa=KAPPA, svm_steps=STEPS,
            corrupt_fn=lambda _, c=carried: c, n_samples=N, d_point=324,
            d_raw=640, kernel="cuda", device="cpu")
    return out


def _close(got, want, tol=W_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


def _models(rng, L, k, d):
    return {"W": torch.from_numpy(rng.normal(size=(L, k, d)).astype(
                np.float32)),
            "b": torch.from_numpy(rng.normal(size=(L, k)).astype(np.float32))}


@pytest.mark.parametrize("form", ["dict", "stacked"])
@pytest.mark.parametrize("frac,n_bad", [(0.25, 2), (0.5, 4), (0.0, 0)])
def test_malicious1_corrupts_exact_count(form, frac, n_bad):
    """round(frac * L) devices are replaced whole, and `bad` marks exactly
    the changed rows, on a dict of stacked tensors and on a StackedLinear."""
    models = _models(np.random.default_rng(0), 8, 3, 20)
    if form == "stacked":
        models = gtl.StackedLinear(models["W"], models["b"])
    gen = torch.Generator().manual_seed(0)
    corrupted, bad = corrupt_malicious1(gen, models, frac)
    assert type(corrupted) is type(models)
    assert int(bad.sum()) == n_bad
    get = (lambda m, f: m[f]) if form == "dict" else getattr
    for f, axes in (("W", (1, 2)), ("b", (1,))):
        changed = (get(corrupted, f) != get(models, f)).any(dim=axes)
        assert torch.equal(changed, bad), f
        assert torch.equal(get(corrupted, f)[~bad], get(models, f)[~bad])


def test_malicious2_corrupts_expected_fraction():
    """About half of every leaf is replaced at frac_params 0.5."""
    models = _models(np.random.default_rng(1), 4, 8, 200)
    gen = torch.Generator().manual_seed(1)
    corrupted = corrupt_malicious2(gen, models, 0.5)
    frac = float((corrupted["W"] != models["W"]).float().mean())
    assert 0.45 < frac < 0.55
    assert corrupted["b"].shape == models["b"].shape


@pytest.mark.parametrize("kind", list(KINDS))
def test_corrupted_gtl_matches_jax(mnist, port_runs, kind):
    """GTL under a corrupted exchange: the honest base models, the
    exchanged models (the carried corruption itself), GreedyTL's supports
    and coefficients, and the flattened h^(2) of every location (each
    collapsed against its own received set)."""
    ref, got = mnist["runs"][kind], port_runs[kind].gtl
    _close(got.base.W, ref["base"].W)
    _close(got.base.b, ref["base"].b)
    assert torch.equal(got.sources.W, torch.from_numpy(ref["carried"].W))
    np.testing.assert_array_equal(got.gtl_coef.numpy() != 0,
                                  ref["coef"] != 0)
    _close(got.gtl_coef, ref["coef"])
    _close(got.gtl_flat, ref["flat"])
    _close(got.consensus_flat, ref["flat"].mean(0))


@pytest.mark.parametrize("kind", list(KINDS))
def test_corrupted_scenario_rows_match_jax(mnist, port_runs, kind):
    """Every F row (GTL and noHTL over the corrupted exchange, the honest
    local models, Cloud), per-location F and per-class accuracy."""
    want, got = mnist["runs"][kind]["want"], port_runs[kind]
    for (name, mine), (_, ref) in zip(got.summary_rows(),
                                      want.summary_rows()):
        assert mine == pytest.approx(ref, abs=F_TOL), name
    _close(got.f_local, want.f_local, F_TOL)
    _close(got.f_gtl2, want.f_gtl2, F_TOL)
    for name in want.per_class:
        _close(got.per_class[name], want.per_class[name], F_TOL)


def test_own_slot_substitution(mnist):
    """Algorithm 1 line 8: location 0's slot of the received set carries
    noise, and location 0 must still fit against its own honest model.  The
    port's Step 2 with own= picks the reference's columns at every
    location; without the substitution location 0 would pick others."""
    ref = mnist["runs"]["malicious1"]
    base = ref["base"]
    noise = np.random.default_rng(3)
    received = gtl.StackedLinear(
        base.W.copy(), base.b.copy())
    received.W[0] = noise.normal(size=base.W[0].shape)
    received.b[0] = noise.normal(size=base.b[0].shape)
    shards = mnist["shards"]
    want, _ = jgtl.gtl_step2_all(
        jax.random.PRNGKey(0), shards.X, shards.y, shards.mask,
        jgtl.StackedLinear(received.W, received.b), K, KAPPA, LAM,
        own=jgtl.StackedLinear(base.W, base.b))
    want = np.array(want)
    X, y, mask = gtl.shard_tensors(shards, "cpu")
    sources = gtl.StackedLinear(*map(torch.from_numpy, received))
    got, _ = gtl.gtl_step2_all(X, y, mask, sources, K, KAPPA, LAM, "cuda",
                               own=_torch(base))
    np.testing.assert_array_equal(got.coef.numpy() != 0, want != 0)
    _close(got.coef, want)
    plain, _ = gtl.gtl_step2_all(X, y, mask, sources, K, KAPPA, LAM, "cuda")
    assert not torch.equal(plain.selected[0], got.selected[0])
    assert torch.equal(plain.selected[1:], got.selected[1:])
