"""Milliseconds of the program's ``train.boosting`` range per iteration:
the growers, the objective and the score updates, ending in the sync that
brings the trees to the host."""
from portbench.harness import layers


def read(run):
    vals = []
    for t in run.traced:
        b = layers.range_in(run, "train.boosting", t["span"])
        if b is not None:
            vals.append((b[1] - b[0]) / 1e3 / t["iterations"])
    return sum(vals) / len(vals) if vals else None
