"""Share of the bandwidth bound of the Lorenzo encode kernels: 12 bytes an
element of every field compressed, over the peak, over their device time.
Read only where each compress launched the encode once, on the whole field,
and the trace holds one encode kernel for each launch: a trace that lost
some would count every field's bytes over part of their time."""
import re

from portbench import roofline
from portbench.harness import readers

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "kernels", "compress_MBps"
KERNELS = re.compile(r"\bencode_[12]d_kernel\b")
COUNTERS = ("lorenzo.encode_1d", "lorenzo.encode_2d")


def read(run):
    calls = run.done
    launched = sum(run.launches.get(k, 0) for k in COUNTERS)
    if not calls or launched != len(calls):
        return None
    if sum(1 for name, _, _ in (run.ops or []) if KERNELS.search(name)) != launched:
        return None
    nbytes = sum(roofline.lorenzo_encode_bytes(c.elements) for c in calls)
    return roofline.share(nbytes, readers.device_seconds(run, KERNELS), run.device_name)
