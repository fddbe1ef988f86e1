"""All field bytes of the window over all their blobs' bytes."""
UNIT, BETTER, SOURCE = "x", "higher", "host_clock"


def read(run):
    calls = run.done
    blob = sum(len(c.blob) for c in calls)
    return sum(c.nbytes for c in calls) / blob if calls and blob else None
