"""Program captures and re-captures booked while the window's transform
calls ran (``observability/compute.py``): calls of the row counts set-up
already scored should replay the walk's program."""


def read(run):
    return run.counters.get("captures")
