"""The fast tier's classify+reduce kernel in CUDA, beside its plain version."""
from .kernel import LAUNCHES, reset_launches
from .ops import VALID_BS, block_stats

__all__ = ["LAUNCHES", "reset_launches", "VALID_BS", "block_stats"]
