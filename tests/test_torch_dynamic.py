"""The port's dynamic scenario (paper Section 10: devices arriving in
phases around a totem that keeps an EMA of the models) vs the JAX
reference's `run_dynamic_gtl` / `run_dynamic_nohtl`.

Data: the reference's HAPT-layout rows (`make_dataset`, d=561, k=12; 800
samples, 70/30 split) partitioned over L=8 locations by the reference's
`partition_uniform`, 40 SVM steps, kappa=8.  Arrivals of s=1 (8 phases;
the first has one source, the later ones two: the arrival and the totem)
and s=3 (2 phases of 3 + 1 sources; the last 2 locations are a tail the
reference drops).  The reference runs once per s; a spy on its Step 2
records each phase's GreedyTL coefficients.  Tolerances: each phase's
GreedyTL supports equal; the totem after every phase within 1e-4 (fp32
rounding over the SVM steps); each phase's F within 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import dynamic as jdyn  # noqa: E402
from repro.core import gtl as jgtl  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro.data import synth as jsynth  # noqa: E402
from repro.training import metrics as JM  # noqa: E402
from repro_torch.core import gtl  # noqa: E402
from repro_torch.core.dynamic import (run_dynamic_gtl,  # noqa: E402
                                      run_dynamic_nohtl)
from repro_torch.training import metrics as M  # noqa: E402

W_TOL = 1e-4
F_TOL = 1e-6
N, L, K, KAPPA, STEPS = 800, 8, 12, 8, 40
ARRIVALS = (1, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread while this module runs; restored after."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ref():
    """The reference's data and its dynamic GTL and noHTL runs at each s,
    once: totem traces, per-phase F, and each GTL phase's coef."""
    key = jax.random.PRNGKey(0)
    X, y = jsynth.make_dataset(key, jsynth.HAPT_LIKE, N)
    (Xtr, ytr), (Xte, yte) = jsynth.train_test_split(
        jax.random.fold_in(key, 1), X, y)
    shards = jpart.partition_uniform(np.random.default_rng(0),
                                     np.asarray(Xtr), np.asarray(ytr), L)

    def eval_fn(model):
        return float(JM.f_measure(yte, jgtl.predict_linear(model, Xte), K))

    runs = {}
    for s in ARRIVALS:
        coefs = []

        def spy(*a, _real=jgtl.gtl_step2_all, **kw):
            out = _real(*a, **kw)
            coefs.append(np.array(out[0]))
            return out
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jgtl, "gtl_step2_all", spy)
            trace, f = jdyn.run_dynamic_gtl(
                jax.random.PRNGKey(1), shards, K, s, kappa=KAPPA,
                svm_kw=dict(steps=STEPS), eval_fn=eval_fn)
        ntrace, nf = jdyn.run_dynamic_nohtl(shards, K, s,
                                            svm_kw=dict(steps=STEPS),
                                            eval_fn=eval_fn)
        runs[s] = dict(totem=np.array(trace.models), f=f, coef=coefs,
                       nohtl_totem=np.array(ntrace.models), nohtl_f=nf)
    return dict(shards=shards, Xte=torch.from_numpy(np.array(Xte)),
                yte=torch.from_numpy(np.array(yte)), runs=runs)


def _eval(ref):
    def eval_fn(model):
        return float(M.f_measure(ref["yte"], gtl.predict_linear(
            model, ref["Xte"]), K))
    return eval_fn


@pytest.mark.parametrize("s", ARRIVALS)
def test_dynamic_gtl_matches_jax(ref, s):
    """Per phase: the arrivals' GreedyTL supports (against s or s + 1
    sources), the totem after the EMA merge, and its F on the test set;
    the phases cover L - L % s locations."""
    want = ref["runs"][s]
    trace, f = run_dynamic_gtl(ref["shards"], K, s, kappa=KAPPA,
                               svm_kw=dict(steps=STEPS),
                               eval_fn=_eval(ref), kernel="cuda",
                               device="cpu")
    n_phases = L // s
    assert trace.models.shape == (n_phases, K, 561 + 1)
    assert trace.selected.shape == (n_phases, s, K, KAPPA)
    assert len(want["coef"]) == n_phases
    for p, coef in enumerate(want["coef"]):
        n_src = s if p == 0 else s + 1
        assert coef.shape == (s, K, 561 + 1 + n_src)
        support = torch.zeros(coef.shape, dtype=torch.bool).scatter_(
            -1, trace.selected[p].long(), True)
        np.testing.assert_array_equal(support.numpy(), coef != 0,
                                      err_msg=f"phase {p}")
    np.testing.assert_allclose(trace.models.numpy(), want["totem"], rtol=0,
                               atol=W_TOL)
    np.testing.assert_allclose(f, want["f"], rtol=0, atol=F_TOL)


@pytest.mark.parametrize("s", ARRIVALS)
def test_dynamic_nohtl_matches_jax(ref, s):
    """noHTL in phases: the arrivals' mean merged into the totem, and its
    F after every phase."""
    want = ref["runs"][s]
    trace, f = run_dynamic_nohtl(ref["shards"], K, s,
                                 svm_kw=dict(steps=STEPS),
                                 eval_fn=_eval(ref), device="cpu")
    assert trace.selected is None
    np.testing.assert_allclose(trace.models.numpy(), want["nohtl_totem"],
                               rtol=0, atol=W_TOL)
    np.testing.assert_allclose(f, want["nohtl_f"], rtol=0, atol=F_TOL)
