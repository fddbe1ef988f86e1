"""The 32x32 bitplane transpose in CUDA, beside its plain version."""
from .kernel import LAUNCHES, reset_launches
from .ops import TILE_GROUPS, bitplane_decode, bitplane_encode, ref_decode, ref_encode

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "TILE_GROUPS",
    "bitplane_encode",
    "bitplane_decode",
    "ref_encode",
    "ref_decode",
]
