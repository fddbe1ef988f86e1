"""Bytes over seconds of the fast tier's ``unpack`` spans of decompress
calls: the host's plane unpack into the int64 residual grid (decoded field
bytes out)."""
from portbench.harness import readers

UNIT, BETTER, SOURCE = "MB/s", "higher", "program_span"
#: the fast cell's one end-to-end metric besides setup_s: its rates are
#: per-layer there (compress_MBps.fast, decompress_MBps.fast)
LAYER, MOVES = "fast tier blocks", "ratio"


def read(run):
    return readers.span_MBps(run, "decompress", "unpack")
