"""The device's idle share of the traced transform calls' wall time, in percent:
100 x (1 - the union of its kernels, copies and fills / the wall)."""
from portbench.harness import layers


def read(run):
    return layers.idle_pct(run)
