"""Architecture configs (the published shapes) — counterpart of
`repro/configs/__init__.py`.

Each module defines `CONFIG: ModelConfig` with the published
architecture parameters (sources in each file's docstring), the same
values as the reference's.  `get_config(name)` / `ARCH_NAMES` /
`ALIASES` are the registry the launcher uses.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import (
    ALL_SHAPES,
    SHAPES_BY_NAME,
    ModelConfig,
    ShapeConfig,
    shapes_for,
)

ARCH_NAMES = (
    "qwen2_moe_a2_7b",
    "granite_moe_1b_a400m",
    "internvl2_26b",
    "qwen1_5_0_5b",
    "deepseek_67b",
    "qwen2_5_32b",
    "gemma2_27b",
    "whisper_tiny",
    "recurrentgemma_2b",
    "mamba2_2_7b",
)

# hyphenated aliases matching the assignment sheet
ALIASES = {
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "internvl2-26b": "internvl2_26b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "deepseek-67b": "deepseek_67b",
    "qwen2.5-32b": "qwen2_5_32b",
    "gemma2-27b": "gemma2_27b",
    "whisper-tiny": "whisper_tiny",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "mamba2-2.7b": "mamba2_2_7b",
}


def get_config(name: str) -> ModelConfig:
    key = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if key not in ARCH_NAMES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{key}").CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_NAMES}
