"""Config registry: ``get_config("deepseek-v2-lite-16b")`` / ``--arch`` lookup."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ArchConfig

_ARCH_MODULES = {
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "chatglm3-6b": "chatglm3_6b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "yi-34b": "yi_34b",
    "mamba2-370m": "mamba2_370m",
    "qwen2-72b": "qwen2_72b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "musicgen-medium": "musicgen_medium",
}

ASSIGNED_ARCHS: List[str] = list(_ARCH_MODULES)


def get_config(name: str) -> ArchConfig:
    if name in _ARCH_MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
        return mod.CONFIG
    from repro_torch.configs.paper_models import PAPER_MODELS
    if name in PAPER_MODELS:
        return PAPER_MODELS[name]
    raise KeyError(f"unknown arch {name!r}; known: {ASSIGNED_ARCHS} + paper models")


def all_configs() -> Dict[str, ArchConfig]:
    return {n: get_config(n) for n in ASSIGNED_ARCHS}
