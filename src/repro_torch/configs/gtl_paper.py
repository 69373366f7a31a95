"""The paper's own model: one-vs-all linear classifiers + GreedyTL transfer
(HAPT-like defaults) — the same entry as ``repro.configs.gtl_paper``."""
from dataclasses import dataclass


@dataclass(frozen=True)
class GTLPaperConfig:
    name: str = "gtl-paper"
    arch_type: str = "linear"
    n_features: int = 561
    n_classes: int = 12
    n_locations: int = 21
    kappa: int = 64
    lam: float = 3.0
    citation: str = "DOI 10.1016/j.pmcj.2017.07.014"


CONFIG = GTLPaperConfig()


def smoke():
    return GTLPaperConfig(n_features=32, n_classes=4, n_locations=5, kappa=12)
