"""Bytes over seconds of the ``huffman`` spans of compress calls (codes in),
outside the chunk contest."""
from portbench.harness import readers

UNIT, BETTER, SOURCE = "MB/s", "higher", "program_span"
LAYER, MOVES = "Huffman coder", "compress_MBps"


def read(run):
    return readers.span_MBps(run, "compress", "huffman")
