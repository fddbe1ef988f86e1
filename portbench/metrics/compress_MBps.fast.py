"""``compress_MBps`` of the fast tier's cell, read per layer: all field bytes
compressed in the window over the summed seconds of every compress call.
The fast tier's calls are paced by the host alone, whose pace moves its
runs too widely for an end-to-end bound, so this rate carries none."""
from portbench.harness import readers

UNIT, BETTER, SOURCE = "MB/s", "higher", "host_clock"
#: the fast cell's one end-to-end metric besides setup_s: its rates are
#: per-layer there (compress_MBps.fast, decompress_MBps.fast)
LAYER, MOVES = "entry points", "ratio"


def read(run):
    return readers.call_MBps(run, "compress")
