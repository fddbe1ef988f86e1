"""Bytes over seconds of the fast tier's ``quantize`` spans of compress
calls: the block encode, i.e. device residuals, the copy to the host and
plane packing."""
from portbench.harness import readers

UNIT, BETTER, SOURCE = "MB/s", "higher", "program_span"
#: the fast cell's one end-to-end metric besides setup_s: its rates are
#: per-layer there (compress_MBps.fast, decompress_MBps.fast)
LAYER, MOVES = "fast tier blocks", "ratio"


def read(run):
    return readers.span_MBps(run, "compress", "quantize")
