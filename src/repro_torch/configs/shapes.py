"""Assigned input-shape cells and their shape-only input specs.

LM transformer shapes are seq_len x global_batch.  ``decode_*`` / ``long_*``
lower ``serve_step`` (one new token with a KV cache of seq_len), NOT
``train_step``.  ``long_500k`` needs sub-quadratic attention — it runs for
SSM / hybrid / SWA archs and is SKIPPED for pure full-attention archs
(recorded per-cell).  :func:`input_specs` returns meta-device tensors where
the JAX package (``repro/configs/shapes.py``) returns ``ShapeDtypeStruct``s:
shapes and dtypes, no storage.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def cell_skip_reason(cfg: ModelConfig, cell: ShapeCell) -> Optional[str]:
    """None = run; otherwise the documented reason this cell is skipped."""
    if cell.name == "long_500k":
        sub_quadratic = (
            cfg.family in ("ssm", "hybrid") or cfg.sliding_window is not None
        )
        if not sub_quadratic:
            return (
                "pure full-attention arch: O(L^2) attention at 524k is "
                "intentionally unsupported (DESIGN.md §6)"
            )
    return None


def input_specs(cfg: ModelConfig, cell: ShapeCell, dtype=torch.int32) -> Dict[str, torch.Tensor]:
    """Meta-device stand-ins for every model input (no allocation)."""
    B, S = cell.batch, cell.seq

    def tok(shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    def emb(shape):
        return torch.empty(shape, dtype=cfg.param_dtype, device="meta")

    if cell.kind == "decode":
        return {"tokens": tok((B, 1))}

    if cfg.family == "encdec":
        specs = {
            "enc_frames": emb((B, cfg.enc_seq, cfg.d_model)),
            "tokens": tok((B, S)),
        }
    elif cfg.family == "vlm":
        specs = {"embeds": emb((B, S, cfg.d_model))}
    else:
        specs = {"tokens": tok((B, S))}
    if cell.kind == "train":
        specs["labels"] = tok((B, S))
    return specs
