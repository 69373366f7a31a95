"""Network-overhead accounting — paper Section 8, 8.1 and 10.

A copy of the numpy-only ``repro.core.overhead`` (the port imports nothing
of the JAX package).

All quantities count *coefficients*; `to_mb` converts with 8 bytes/coef
(float64 on the wire — this is what reproduces the paper's Table 6 exactly:
HAPT OH^cl = 10929 x 561 x 8B = 49MB vs the paper's 48MB, OH^(0) =
21*20*562*12*8B = 21.6MB vs the paper's 20MB; with 4B none of the paper's MB
figures match).  Cloud overhead counts the *full* dataset (train+test), as
the paper's 48/148MB figures imply.

Closed forms (paper equation numbers):

    OH^(0)        = s (s-1) d0 k                    (8)
    OH^(1)        = s (s-1) d1 k                    (9)
    OH^GTL        = OH^(0) + OH^(1)                 (7)
    OH_mu^noHTL   = 2 k (s-1) dbar0                 (10)
    OH_mv^noHTL   = k s (s-1) d0                    (11)
    OH^up         = 2 k s^2 d0                      (12)
    G_lower       = 1 - 2 k s^2 d0 / (N dc)         (14)
    G_lower (mu_D form) ~ 1 - 2 k s / mu_D          (15)
    OH^G          = d0 k (s+1)                      (17)
    OH^dynGTL     = OH^GTL + OH^G                   (18)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BYTES_PER_COEF = 8


def nnz(coef, tol: float = 0.0):
    """Number of non-null coefficients of a model (d^(0), d^(1) in the paper)."""
    a = np.asarray(coef)
    if tol == 0.0:
        return int(np.sum(a != 0))
    return int(np.sum(np.abs(a) > tol))


def oh_step0(s: int, k: int, d0: int) -> int:
    return s * (s - 1) * d0 * k


def oh_step1(s: int, k: int, d1: int) -> int:
    return s * (s - 1) * d1 * k


def oh_gtl(s: int, k: int, d0: int, d1: int) -> int:
    return oh_step0(s, k, d0) + oh_step1(s, k, d1)


def oh_nohtl_mu(s: int, k: int, dbar0: int) -> int:
    # every device sends its model to the collector (s-1 transfers) and the
    # collector sends the mean back (s-1 transfers): 2 k (s-1) dbar0
    return 2 * k * (s - 1) * dbar0


def oh_nohtl_mv(s: int, k: int, d0: int) -> int:
    return k * s * (s - 1) * d0


def oh_cloud(n_samples: int, d_point: int) -> int:
    """Centralised solution: ship every data point (OH^cl / OH^raw)."""
    return n_samples * d_point


def oh_upper_bound(s: int, k: int, d0: int) -> int:
    """Eq. 12: OH^up = 2 k s^2 d0 (pessimistic; assumes d1 < d0 << shipping)."""
    return 2 * k * s * s * d0


def gain(oh_dist: float, oh_cloud_: float) -> float:
    return 1.0 - oh_dist / oh_cloud_


def gain_lower_bound(s: int, k: int, d0: int, n_samples: int, d_point: int) -> float:
    """Eq. 14."""
    return 1.0 - (2.0 * k * s * s * d0) / (n_samples * d_point)


def gain_lower_bound_mu(s: int, k: int, mu_d: float) -> float:
    """Eq. 15 (per-location form): 1 - 2ks/mu_D."""
    return 1.0 - (2.0 * k * s) / mu_d


def oh_dynamic_gateway(s: int, k: int, d0: int) -> int:
    """Eq. 17: traffic between the permanent device G and s arrivals."""
    return d0 * k * (s + 1)


def oh_dyn_gtl(s: int, k: int, d0: int, d1: int) -> int:
    """Eq. 18."""
    return oh_gtl(s, k, d0, d1) + oh_dynamic_gateway(s, k, d0)


def to_mb(n_coefs: float) -> float:
    return n_coefs * BYTES_PER_COEF / (1024.0 * 1024.0)


@dataclass
class OverheadReport:
    """Empirical Table-6/7-style report for one experiment."""

    s: int
    k: int
    d0: int
    d1: int
    n_samples: int
    d_point: int
    d_raw: int | None = None  # raw (pre-feature-extraction) dimensionality

    @property
    def oh0_mb(self):
        return to_mb(oh_step0(self.s, self.k, self.d0))

    @property
    def oh1_mb(self):
        return to_mb(oh_step1(self.s, self.k, self.d1))

    @property
    def oh_gtl_mb(self):
        return self.oh0_mb + self.oh1_mb

    @property
    def oh_cloud_mb(self):
        return to_mb(oh_cloud(self.n_samples, self.d_point))

    @property
    def oh_raw_mb(self):
        if self.d_raw is None:
            return None
        return to_mb(oh_cloud(self.n_samples, self.d_raw))

    @property
    def oh_nohtl_mu_mb(self):
        return to_mb(oh_nohtl_mu(self.s, self.k, self.d0))

    @property
    def oh_nohtl_mv_mb(self):
        return to_mb(oh_nohtl_mv(self.s, self.k, self.d0))

    def gains(self):
        cl = self.oh_cloud_mb
        out = {
            "gain_gtl": gain(self.oh_gtl_mb, cl),
            "gain_nohtl_mu": gain(self.oh_nohtl_mu_mb, cl),
            "gain_nohtl_mv": gain(self.oh_nohtl_mv_mb, cl),
        }
        if self.d_raw is not None:
            raw = self.oh_raw_mb
            out.update(
                gain_gtl_raw=gain(self.oh_gtl_mb, raw),
                gain_nohtl_mu_raw=gain(self.oh_nohtl_mu_mb, raw),
                gain_nohtl_mv_raw=gain(self.oh_nohtl_mv_mb, raw),
            )
        return out


def measured_nnz_from_models(base_coef, gtl_coef, tol: float = 1e-8):
    """d^(0), d^(1) measured from actual model tensors (per-class averages)."""
    b = np.asarray(base_coef)
    g = np.asarray(gtl_coef)
    d0 = float(np.mean(np.sum(np.abs(b) > tol, axis=-1)))
    d1 = float(np.mean(np.sum(np.abs(g) > tol, axis=-1)))
    return int(round(d0)), int(round(d1))
