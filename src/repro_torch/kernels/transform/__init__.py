"""Blockwise 4-point transform kernels in CUDA, each beside its plain version."""
from .kernel import LAUNCHES, reset_launches
from .ops import (
    AMP_1AXIS,
    MAT,
    apply_axis_f64,
    fwd_pipeline,
    inv_pipeline,
    transform_fwd,
    transform_inv,
)

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "AMP_1AXIS",
    "MAT",
    "apply_axis_f64",
    "fwd_pipeline",
    "inv_pipeline",
    "transform_fwd",
    "transform_inv",
]
