"""Bytes over seconds of the ``huffman`` spans of decompress calls (the
coded stream in)."""
from portbench.harness import readers

UNIT, BETTER, SOURCE = "MB/s", "higher", "program_span"
LAYER, MOVES = "Huffman coder", "decompress_MBps"


def read(run):
    return readers.span_MBps(run, "decompress", "huffman")
