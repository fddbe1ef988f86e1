"""Bytes over seconds of the ``predict`` spans of compress calls (the
predictor and quantizer on the card), outside the chunk contest."""
from portbench.harness import readers

UNIT, BETTER, SOURCE = "MB/s", "higher", "program_span"
LAYER, MOVES = "predictors and quantizers", "compress_MBps"


def read(run):
    return readers.span_MBps(run, "compress", "predict")
