"""All field bytes compressed in the window over the summed seconds of every
compress call (each ends with a synchronise; the blob is on the host)."""
from portbench.harness import readers

UNIT, BETTER, SOURCE = "MB/s", "higher", "host_clock"


def read(run):
    return readers.call_MBps(run, "compress")
