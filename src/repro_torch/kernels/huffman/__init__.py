"""Huffman stream pack in CUDA, beside its plain version: the stream half of
``core.encoders.HuffmanEncoder`` for codes that lie on the card."""
from .kernel import LAUNCHES, reset_launches
from .ops import pack

__all__ = ["LAUNCHES", "reset_launches", "pack"]
