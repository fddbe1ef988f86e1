"""Share of the traced compress seconds spent in the chunk contest's
``select`` spans (sample estimates and trial runoffs)."""
from portbench.harness import readers

UNIT, BETTER, SOURCE = "%", "lower", "program_span"
LAYER, MOVES = "chunk contest", "compress_MBps"


def read(run):
    _, select_s, count = readers.span_totals(run, "compress", "select", skip=())
    total = sum(c.compress_s for c in run.done)
    return 100.0 * select_s / total if count and total > 0 else None
