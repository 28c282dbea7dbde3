"""Host milliseconds of a transform call: its wall time minus the device's
busy time inside it, averaged over the traced calls (stacking the vector
column, the host copies, the per-row output objects)."""
from portbench.harness import trace


def read(run):
    if not run.traced:
        return None
    vals = [((t["span"][1] - t["span"][0])
             - trace.busy_us(run.tracer, [t["span"]])) / 1e3
            for t in run.traced]
    return sum(vals) / len(vals)
