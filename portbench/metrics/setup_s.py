"""Process start to the first timed call: imports, the CUDA context, the
kernel libraries (built on a checkout's first run), the fields made on the
device and one warm-up field of each kind."""
UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(run):
    return run.setup_s
