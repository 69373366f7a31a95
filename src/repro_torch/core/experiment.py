"""End-to-end experiment harness for the paper's comparative study; the
port of ``repro.core.experiment``.

Runs one scenario (dataset generator + partitioner) through:
  - Cloud      : linear SVM with access to the full training set,
  - GTL        : Algorithm 1 (steps 0/2/4, mu and mv aggregation),
  - noHTL      : Algorithm 2 (mu and mv variants),
and reports the paper's indices (F-measure per step/location, PPG,
per-class accuracy, empirical network overhead).

`run_scenario` makes the scenario's data on `device` from a torch
generator; `run_scenario_on` runs the study on shards and a test set the
caller provides (the tests hand it the JAX reference's own data).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import base_learner as bl
from repro_torch.core import gtl as gtl_mod
from repro_torch.core import nohtl as nohtl_mod
from repro_torch.core import overhead as oh
from repro_torch.data import partition as part_mod
from repro_torch.data import synth as synth_mod
from repro_torch.training import metrics as M


@dataclass
class ScenarioResult:
    name: str
    f_local: np.ndarray          # (L,) F of h^(0) per location
    f_gtl2: np.ndarray           # (L,) F of h^(2) per location
    f_gtl4_mu: float             # F of mu-GTL^(4)
    f_gtl4_mv: float             # F of mv-GTL^(4)
    f_nohtl_mu: float
    f_nohtl_mv: float
    f_cloud: float
    per_class: dict = field(default_factory=dict)
    overhead: oh.OverheadReport | None = None
    gtl: gtl_mod.GTLResult | None = None  # the GTL run's models and picks

    def ppg(self):
        f0 = self.f_local
        return {
            "gtl2": np.asarray(M.ppg(self.f_gtl2, f0)),
            "gtl4_mu": np.asarray(M.ppg(self.f_gtl4_mu, f0)),
            "nohtl_mu": np.asarray(M.ppg(self.f_nohtl_mu, f0)),
            "nohtl_mv": np.asarray(M.ppg(self.f_nohtl_mv, f0)),
        }

    def summary_rows(self):
        return [
            ("local(mean)", float(self.f_local.mean())),
            ("GTL(2)(mean)", float(self.f_gtl2.mean())),
            ("mu-GTL(4)", self.f_gtl4_mu),
            ("mv-GTL(4)", self.f_gtl4_mv),
            ("noHTL_mu", self.f_nohtl_mu),
            ("noHTL_mv", self.f_nohtl_mv),
            ("Cloud", self.f_cloud),
        ]


SCENARIOS = ("hapt", "mnist_balanced", "mnist_class_unbalanced",
             "mnist_node_unbalanced")


def make_scenario(name: str, seed: int = 0, n_samples: int | None = None,
                  device="cuda"):
    """Returns (shards (numpy LocationShards), (X_test, y_test) tensors on
    `device`, spec).  The data are drawn on `device`; the partitioners are
    numpy."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    if name == "hapt":
        spec = synth_mod.HAPT_LIKE
    elif name in SCENARIOS:
        spec = synth_mod.MNIST_HOG_LIKE
    else:
        raise ValueError(name)
    X, y = synth_mod.make_dataset(gen, spec, n_samples)
    (Xtr, ytr), test = synth_mod.train_test_split(gen, X, y)
    Xtr, ytr = Xtr.cpu().numpy(), ytr.cpu().numpy()
    L, k = spec.n_locations, spec.n_classes
    if name in ("hapt", "mnist_balanced"):
        # HAPT: native class unbalance, uniform across locations
        shards = part_mod.partition_uniform(rng, Xtr, ytr, L)
    elif name == "mnist_class_unbalanced":
        shards = part_mod.partition_class_unbalanced(rng, Xtr, ytr, L, k)
    else:
        shards = part_mod.partition_node_unbalanced(rng, Xtr, ytr, L, k)
    return shards, test, spec


def run_scenario(name: str, seed: int = 0, n_samples: int | None = None,
                 kappa: int = 64, lam: float = 3.0, svm_steps: int = 600,
                 corrupt_fn=None, raw_dims=None, kernel: str = "cuda",
                 device="cuda") -> ScenarioResult:
    shards, test, spec = make_scenario(name, seed, n_samples, device)
    return run_scenario_on(
        shards, test, spec.n_classes, name=name, kappa=kappa, lam=lam,
        svm_steps=svm_steps, corrupt_fn=corrupt_fn,
        n_samples=spec.n_samples if n_samples is None else n_samples,
        d_point=spec.n_features,
        d_raw=raw_dims if raw_dims is not None else
        (1178 if name == "hapt" else 640),
        kernel=kernel, device=device)


def run_scenario_on(shards, test, k: int, *, name: str = "custom",
                    kappa: int = 64, lam: float = 3.0, svm_steps: int = 600,
                    corrupt_fn=None, n_samples: int | None = None,
                    d_point: int | None = None, d_raw: int | None = None,
                    kernel: str = "cuda", device="cuda") -> ScenarioResult:
    """The study on given `LocationShards` and test set (numpy arrays or
    tensors).  `corrupt_fn(models) -> models` (if given) corrupts the
    models GTL and noHTL exchange (Section 7); the local F and the
    overhead stay on the honest base models.  `n_samples` and `d_point`
    size the Cloud overhead (the nominal dataset; default: the rows and
    width given); `d_raw` the raw one (none by default)."""
    with bl.fp32_matmuls():
        Xte = torch.as_tensor(test[0], device=device)
        yte = torch.as_tensor(test[1], device=device)

        # --- Cloud: one SVM on the concatenated training set
        X, y, mask = gtl_mod.shard_tensors(shards, device)
        cloud = bl.fit_linear_svm(X.reshape(-1, X.shape[-1]), y.reshape(-1),
                                  k, steps=svm_steps,
                                  sample_mask=mask.reshape(-1))
        f_cloud = float(M.f_measure(yte, bl.predict(cloud, Xte), k))

        # --- GTL
        res = gtl_mod.run_gtl(shards, k, kappa=kappa, lam=lam,
                              svm_steps=svm_steps, corrupt_fn=corrupt_fn,
                              kernel=kernel, device=device)
        aug0 = res.base.augmented()  # honest local models, (L, k, d+1)
        f_local = M.f_measure(yte, gtl_mod.predict_linear(aug0, Xte), k)
        f_gtl2 = M.f_measure(yte, gtl_mod.predict_linear(res.gtl_flat, Xte),
                             k)
        pred_mu = gtl_mod.predict_linear(res.consensus_flat, Xte)
        f_gtl4_mu = float(M.f_measure(yte, pred_mu, k))
        pred_mv = gtl_mod.predict_majority(res.gtl_flat, Xte, k)
        f_gtl4_mv = float(M.f_measure(yte, pred_mv, k))

        # --- noHTL
        nres = nohtl_mod.run_nohtl(shards, k, svm_steps=svm_steps,
                                   corrupt_fn=corrupt_fn, device=device)
        pred_nohtl_mu = nohtl_mod.predict_consensus(nres, Xte)
        f_nohtl_mu = float(M.f_measure(yte, pred_nohtl_mu, k))
        f_nohtl_mv = float(M.f_measure(
            yte, nohtl_mod.predict_mv(nres, Xte, k), k))

        # --- per-class accuracy (Figs. 4/6/8/10)
        per_class = {
            "local": M.per_class_accuracy(
                yte, gtl_mod.predict_linear(aug0[0], Xte), k),
            "gtl2": M.per_class_accuracy(
                yte, gtl_mod.predict_linear(res.gtl_flat[0], Xte), k),
            "gtl4": M.per_class_accuracy(yte, pred_mu, k),
            "nohtl": M.per_class_accuracy(yte, pred_nohtl_mu, k),
        }

    # --- empirical overhead (Table 6/7).  Cloud ships the FULL dataset
    # (train+test) at the nominal dataset size.
    d0, d1 = oh.measured_nnz_from_models(aug0.cpu().numpy(),
                                         res.gtl_coef.cpu().numpy())
    if n_samples is None:
        n_samples = int(np.asarray(shards.mask).sum()) + len(yte)
    report = oh.OverheadReport(
        s=shards.X.shape[0], k=k, d0=d0, d1=d1, n_samples=n_samples,
        d_point=d_point if d_point is not None else shards.X.shape[-1],
        d_raw=d_raw)

    return ScenarioResult(
        name=name, f_local=f_local.cpu().numpy(),
        f_gtl2=f_gtl2.cpu().numpy(), f_gtl4_mu=f_gtl4_mu,
        f_gtl4_mv=f_gtl4_mv, f_nohtl_mu=f_nohtl_mu, f_nohtl_mv=f_nohtl_mv,
        f_cloud=f_cloud,
        per_class={n: v.cpu().numpy() for n, v in per_class.items()},
        overhead=report, gtl=res)
