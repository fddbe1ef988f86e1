"""Bytes over seconds of the ``to_host`` spans of compress calls (every
device-to-host copy of the program), outside the chunk contest."""
from portbench.harness import readers

UNIT, BETTER, SOURCE = "MB/s", "higher", "program_span"
LAYER, MOVES = "host-device copies", "compress_MBps"


def read(run):
    return readers.span_MBps(run, "compress", "to_host")
