"""Bytes over seconds of the ``lossless`` spans of compress calls (bytes
in), outside the chunk contest."""
from portbench.harness import readers

UNIT, BETTER, SOURCE = "MB/s", "higher", "program_span"
LAYER, MOVES = "lossless backend", "compress_MBps"


def read(run):
    return readers.span_MBps(run, "compress", "lossless")
