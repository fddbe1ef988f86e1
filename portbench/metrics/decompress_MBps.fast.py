"""``decompress_MBps`` of the fast tier's cell, read per layer: all field
bytes decompressed in the window over the summed seconds of every
decompress call.  Host-paced like ``compress_MBps.fast``, so it carries no
end-to-end bound."""
from portbench.harness import readers

UNIT, BETTER, SOURCE = "MB/s", "higher", "host_clock"
#: the fast cell's one end-to-end metric besides setup_s: its rates are
#: per-layer there (compress_MBps.fast, decompress_MBps.fast)
LAYER, MOVES = "entry points", "ratio"


def read(run):
    return readers.call_MBps(run, "decompress")
