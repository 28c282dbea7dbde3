"""Milliseconds from a fit's call to the start of the program's
``train.boosting`` range: collecting and stacking the DataFrame, the host
edges, the bins' transfer and application, the loop's set-up."""
from portbench.harness import layers


def read(run):
    vals = []
    for t in run.traced:
        b = layers.range_in(run, "train.boosting", t["span"])
        if b is not None:
            vals.append((b[0] - t["span"][0]) / 1e3)
    return sum(vals) / len(vals) if vals else None
