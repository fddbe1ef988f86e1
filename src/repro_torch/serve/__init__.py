"""Serving layer: the single-device decode step (:mod:`.step`) and the
async multi-tenant KV-offload service (:mod:`.offload`).

Only the offload service is imported eagerly — ``step`` pulls the model
stack and is imported by the launcher that needs it."""
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
