"""Core: the paper's contribution — communication-efficient distributed
learning via Hypothesis Transfer Learning (GreedyTL) and consensus
baselines.  The port of ``repro.core``; still to come: the cross-pod
adaptation."""

from repro_torch.core.greedytl import (  # noqa: F401
    GreedyTLModel,
    greedytl_from_gram,
    greedytl_fit,
    greedytl_fit_multiclass,
    greedytl_fit_bagged,
)
from repro_torch.core.base_learner import LinearModel, fit_linear_svm, decode_codewords  # noqa: F401
from repro_torch.core.gtl import run_gtl, run_gtl_with_aggregators, GTLResult  # noqa: F401
from repro_torch.core.nohtl import run_nohtl, NoHTLResult  # noqa: F401
from repro_torch.core.aggregation import consensus_mean, majority_vote, ema_merge  # noqa: F401
from repro_torch.core.corruption import corrupt_malicious1, corrupt_malicious2  # noqa: F401
from repro_torch.core import overhead  # noqa: F401
from repro_torch.training import metrics  # noqa: F401
