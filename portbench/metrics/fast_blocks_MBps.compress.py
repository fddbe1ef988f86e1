"""Bytes over seconds of the fast tier's ``quantize`` spans of compress
calls: the block encode, i.e. device residuals, the copy to the host and
plane packing."""
from portbench.harness import readers

UNIT, BETTER, SOURCE = "MB/s", "higher", "program_span"
LAYER, MOVES = "fast tier blocks", "compress_MBps"


def read(run):
    return readers.span_MBps(run, "compress", "quantize")
