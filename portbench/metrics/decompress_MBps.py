"""All field bytes decompressed in the window over the summed seconds of
every decompress call (blob on the host, field on the device, then a
synchronise)."""
from portbench.harness import readers

UNIT, BETTER, SOURCE = "MB/s", "higher", "host_clock"


def read(run):
    return readers.call_MBps(run, "decompress")
