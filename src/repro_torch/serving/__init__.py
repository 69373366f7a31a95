"""Paged serving stack of the port (scheduler -> engine -> steps ->
model), the counterpart of ``repro.serving`` on the paged layout."""
from repro_torch.serving.config import ServingConfig  # noqa: F401
from repro_torch.serving.engine import PagedEngine  # noqa: F401
from repro_torch.serving.sampling import SamplingParams  # noqa: F401
from repro_torch.serving.scheduler import (  # noqa: F401
    Completion, ContinuousBatcher, PageAllocator, RecomputeRecipe, Request,
    completions_equivalent)
