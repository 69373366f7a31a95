"""`ServingConfig`: the declarative construction surface of one serving
replica — the port's counterpart of ``repro.serving.config``.

Same fields, defaults and validation rules, with three differences:

- ``kernel`` takes ``"torch"`` (the plain paged path, JAX's "xla") or
  ``"cuda"`` (the hand-written paged-attention kernel, JAX's "pallas");
- ``mesh``, ``telemetry`` and the legacy ``use_pallas`` flag are not
  ported;
- ``cache_layout="dense"`` validates, but the port's batcher runs the
  paged layout only (the dense ring is a later slice) and raises for it.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.layers import PAGED_KERNELS as _KERNELS
from repro_torch.serving.kvcache import DEFAULT_PAGE_SIZE
from repro_torch.serving.sampling import SamplingParams

_PREFILL_MODES = ("chunked", "decode")
_CACHE_LAYOUTS = ("dense", "paged")
_ALLOCATIONS = ("worst_case", "lazy")


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Everything needed to construct one serving replica (engine shape,
    admission policy, decode defaults).  Frozen: a config can be shared,
    compared, and carried in a fleet list."""

    # pool shape
    n_slots: int = 4
    capacity: int = 256
    cache_layout: str = "dense"
    page_size: int = DEFAULT_PAGE_SIZE
    n_pages: int | None = None
    # dispatch flavor
    kernel: str = "torch"
    # admission / prefill policy
    allocation: str = "worst_case"
    prefill_mode: str = "chunked"
    prefill_chunk: int = 16
    share_prefix: bool = True
    min_quantum: int = 0
    # request defaults
    default_sampling: SamplingParams | None = None
    bos_token: int | None = None

    def __post_init__(self):
        if self.prefill_mode not in _PREFILL_MODES:
            raise ValueError(
                f"prefill_mode={self.prefill_mode!r}: accepted values are "
                f"{_PREFILL_MODES}")
        if self.cache_layout not in _CACHE_LAYOUTS:
            raise ValueError(
                f"cache_layout={self.cache_layout!r}: accepted values are "
                f"{_CACHE_LAYOUTS}")
        if self.kernel not in _KERNELS:
            raise ValueError(
                f"kernel={self.kernel!r}: accepted values are {_KERNELS}")
        if self.allocation not in _ALLOCATIONS:
            raise ValueError(
                f"allocation={self.allocation!r}: accepted values are "
                f"{_ALLOCATIONS}")
        if self.n_slots < 1:
            raise ValueError(f"n_slots={self.n_slots}: need >= 1 slot")
        if self.capacity < 2:
            raise ValueError(
                f"capacity={self.capacity}: a sequence needs at least one "
                f"prompt token and one generated token")
        if self.page_size < 1:
            raise ValueError(f"page_size={self.page_size}: need >= 1")
        if self.n_pages is not None and self.n_pages < 2:
            raise ValueError(
                f"n_pages={self.n_pages}: need at least the null page "
                f"plus one usable page")
        if self.kernel == "cuda" and self.cache_layout != "paged":
            raise ValueError(
                "kernel='cuda' selects the paged-attention kernel — it "
                "needs cache_layout='paged'")
        if self.cache_layout == "dense" and self.allocation != "worst_case":
            # dense slots own worst-case lanes by construction
            object.__setattr__(self, "allocation", "worst_case")
        if self.prefill_chunk < 1:
            object.__setattr__(self, "prefill_chunk", 1)
        if self.min_quantum < 0:
            object.__setattr__(self, "min_quantum", 0)
