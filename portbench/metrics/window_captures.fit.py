"""Program captures and re-captures booked while the window's fits ran
(``observability/compute.py``): a fit of shapes set-up already fitted
should replay every program."""


def read(run):
    return run.counters.get("captures")
