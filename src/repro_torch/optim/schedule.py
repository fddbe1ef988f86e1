"""LR schedules (warmup + cosine decay)."""
from __future__ import annotations

import math

import torch

from ..core.quantizers import true_div


def warmup_cosine(step: torch.Tensor, *, warmup: int = 100, total: int = 10000, floor: float = 0.1) -> torch.Tensor:
    s = step.to(torch.float32)
    warm = torch.clamp_max(true_div(s, float(max(1, warmup))), 1.0)
    prog = torch.clamp(true_div(s - warmup, float(max(1, total - warmup))), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
