"""``to_device_MBps.decompress`` in the fast tier's cell: bytes over seconds
of the ``to_device`` spans of decompress calls."""
from portbench.harness import readers

UNIT, BETTER, SOURCE = "MB/s", "higher", "program_span"
#: the fast cell's one end-to-end metric besides setup_s: its rates are
#: per-layer there (compress_MBps.fast, decompress_MBps.fast)
LAYER, MOVES = "host-device copies", "ratio"


def read(run):
    return readers.span_MBps(run, "decompress", "to_device")
