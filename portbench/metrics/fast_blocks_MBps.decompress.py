"""Bytes over seconds of the fast tier's ``unpack`` spans of decompress
calls: the host's plane unpack into the int64 residual grid (decoded field
bytes out)."""
from portbench.harness import readers

UNIT, BETTER, SOURCE = "MB/s", "higher", "program_span"
LAYER, MOVES = "fast tier blocks", "decompress_MBps"


def read(run):
    return readers.span_MBps(run, "decompress", "unpack")
