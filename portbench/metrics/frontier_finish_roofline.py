"""``frontier_finish_kernel``'s share of its roofline: one scan of every
searched node's histogram (``work/frontier_finish.py``) at the chip's
peaks, over the kernel's device time in the traced fits."""
from portbench.harness import layers
from portbench.work import frontier_finish


def read(run):
    F, B = int(run.config["num_features"]), int(run.config["max_bin"])
    return layers.roofline_pct(
        run, lambda t: frontier_finish.least_s(t["booster"], F, B),
        "frontier_finish_kernel")
