"""Architecture registry of the port. Only the architectures the port
serves so far are registered (the causal text models: attention-only,
mamba and hybrid); each keeps the reference's module name."""
from __future__ import annotations

import importlib

from .base import ModelConfig, get_config, list_configs, register  # noqa: F401

_MODULES = (
    "deepseek_moe_16b",
    "gemma3_27b",
    "hymba_1_5b",
    "mistral_nemo_12b",
    "qwen3_moe_30b_a3b",
    "gemma_7b",
    "falcon_mamba_7b",
    "gemma2_9b",
    # the paper's evaluated models
    "mixtral_8x7b",
    "qwen15_moe_a2_7b",
    "qwen2_57b_a14b",
)

_loaded = False


def _load_all() -> None:
    global _loaded
    if _loaded:
        return
    for m in _MODULES:
        importlib.import_module(f"{__name__}.{m}")
    _loaded = True
