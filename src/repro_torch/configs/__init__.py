"""Architecture registry of the port: one module per ported architecture,
each with a full ``CONFIG`` (the published dimensions) and a ``smoke()``
reduced variant for CPU tests — the same names as ``repro.configs``."""
from __future__ import annotations

import importlib

ARCHS = (
    "qwen3_0_6b",
    "zamba2_2_7b",
    "rwkv6_7b",
    "gtl_paper",  # the paper's own (linear) model as a config entry
)

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def _module(name: str):
    mod_name = _ALIASES.get(name, name).replace("-", "_")
    if mod_name not in ARCHS:
        raise ValueError(
            f"{name!r}: the port covers {ARCHS}; other architectures are "
            f"still JAX-only (see ROADMAP.md)")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    return _module(name).smoke()
