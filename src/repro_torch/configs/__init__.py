"""Architecture registry of the port: every architecture of the reference
(its assigned pool and the paper's own evaluation models), each keeping the
reference's module name."""
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
    "hubert_xlarge",
    "gemma2_9b",
    "llava_next_mistral_7b",
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


# The ten architectures assigned from the public pool.
ASSIGNED_ARCHS = (
    "deepseek-moe-16b",
    "gemma3-27b",
    "hymba-1.5b",
    "mistral-nemo-12b",
    "qwen3-moe-30b-a3b",
    "gemma-7b",
    "falcon-mamba-7b",
    "hubert-xlarge",
    "gemma2-9b",
    "llava-next-mistral-7b",
)

PAPER_ARCHS = ("mixtral-8x7b", "qwen1.5-moe-a2.7b", "qwen2-57b-a14b")
