"""Architecture registry of the port. Only the architectures the port
serves so far are registered; each keeps the reference's module name."""
from __future__ import annotations

import importlib

from .base import ModelConfig, get_config, list_configs, register  # noqa: F401

_MODULES = ("deepseek_moe_16b",)

_loaded = False


def _load_all() -> None:
    global _loaded
    if _loaded:
        return
    for m in _MODULES:
        importlib.import_module(f"{__name__}.{m}")
    _loaded = True
