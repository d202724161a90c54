"""Architecture registry: one module per assigned architecture, selectable via
``--arch <id>``.  A copy of ``repro/configs`` (pure data); the model families
that ``repro_torch.models`` does not build yet are refused by
``models.registry.build_model``."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ArchConfig, InputShape, INPUT_SHAPES  # noqa: F401

_ARCH_MODULES = {
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2p7b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "starcoder2-7b": "repro_torch.configs.starcoder2_7b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "hymba-1.5b": "repro_torch.configs.hymba_1p5b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite",
}


def get_arch(name: str) -> ArchConfig:
    reduced = name.endswith("-reduced")
    base = name[: -len("-reduced")] if reduced else name
    if base not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_ARCH_MODULES)}")
    cfg = importlib.import_module(_ARCH_MODULES[base]).CONFIG
    return cfg.reduced() if reduced else cfg


def list_archs() -> List[str]:
    return sorted(_ARCH_MODULES)


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]


def all_configs() -> Dict[str, ArchConfig]:
    return {n: get_arch(n) for n in list_archs()}
