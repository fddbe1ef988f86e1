from .adamw import AdamWConfig, init_state, update
from .schedule import warmup_cosine

__all__ = ["AdamWConfig", "init_state", "update", "warmup_cosine"]
