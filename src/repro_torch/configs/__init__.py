"""Architecture registry: the 10 assigned configs + reduced smoke variants.

``get(name)`` / ``get_smoke(name)`` / ``ARCHS`` — names use the assignment
ids (dashes), module files use underscores.  The values are the JAX
package's (``repro/configs``).
"""
from __future__ import annotations

import importlib
from typing import List

from ..models.common import ModelConfig
from .shapes import SHAPES, ShapeCell, cell_skip_reason, input_specs

_MODULES = {
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "granite-3-8b": "granite_3_8b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "nemotron-4-340b": "nemotron_4_340b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "whisper-small": "whisper_small",
    "zamba2-7b": "zamba2_7b",
    "mamba2-2.7b": "mamba2_2_7b",
    "pixtral-12b": "pixtral_12b",
}

ARCHS: List[str] = list(_MODULES)


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {ARCHS}")
    return importlib.import_module(f"{__name__}.{_MODULES[name]}")


def get(name: str) -> ModelConfig:
    return _mod(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _mod(name).SMOKE


__all__ = [
    "ARCHS",
    "get",
    "get_smoke",
    "SHAPES",
    "ShapeCell",
    "cell_skip_reason",
    "input_specs",
]
