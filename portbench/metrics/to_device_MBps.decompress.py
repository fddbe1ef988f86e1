"""Bytes over seconds of the ``to_device`` spans of decompress calls (the
decoders' host-to-device copies)."""
from portbench.harness import readers

UNIT, BETTER, SOURCE = "MB/s", "higher", "program_span"
LAYER, MOVES = "host-device copies", "decompress_MBps"


def read(run):
    return readers.span_MBps(run, "decompress", "to_device")
