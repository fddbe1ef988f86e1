"""Bytes over seconds of the Huffman coder's ``huffman_pack`` spans of
compress calls (codes in), outside the chunk contest: the stream packing
half of the coder, without the table build (``huffman_table``)."""
from portbench.harness import readers

UNIT, BETTER, SOURCE = "MB/s", "higher", "program_span"
LAYER, MOVES = "Huffman coder", "compress_MBps"


def read(run):
    return readers.span_MBps(run, "compress", "huffman_pack")
