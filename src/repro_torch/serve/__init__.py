"""Serving layer: the async multi-tenant KV-offload service
(:mod:`.offload`).  The decode steps are not ported yet."""
from .offload import (  # noqa: F401
    DecodeStateCache,
    OffloadError,
    OffloadService,
    blob_key,
)

__all__ = [
    "DecodeStateCache",
    "OffloadError",
    "OffloadService",
    "blob_key",
]
