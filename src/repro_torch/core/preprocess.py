"""Preprocessor module (paper §3.2 "Preprocessor", Appendix A.1).

Instances:
  * Identity        — module bypass.

``forward`` returns the data to compress, the updated config and
serializable meta; ``inverse`` reverses it during decompression.  Both take
and return torch tensors.
"""
from __future__ import annotations

import abc
from typing import Any, Dict, Tuple

import torch

from .config import CompressionConfig


class Preprocessor(abc.ABC):
    name: str = "abstract"

    @abc.abstractmethod
    def forward(
        self, data: torch.Tensor, conf: CompressionConfig
    ) -> Tuple[torch.Tensor, CompressionConfig, Dict[str, Any]]: ...

    @abc.abstractmethod
    def inverse(
        self, data: torch.Tensor, conf: CompressionConfig, meta: Dict[str, Any]
    ) -> torch.Tensor: ...


class Identity(Preprocessor):
    name = "identity"

    def forward(self, data, conf):
        return data, conf, {}

    def inverse(self, data, conf, meta):
        return data


_REGISTRY = {
    "identity": Identity,
}


def make(name: str, **kw) -> Preprocessor:
    return _REGISTRY[name](**kw)
