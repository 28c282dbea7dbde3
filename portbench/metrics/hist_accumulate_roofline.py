"""``hist_accumulate_kernel``'s share of its roofline: the histogram work
the fit's trees need (``work/hist_accumulate.py``: the root and each
split's smaller child) at the chip's peaks, over the kernel's device time
in the traced fits."""
from portbench.harness import layers
from portbench.work import hist_accumulate


def read(run):
    F, B = int(run.config["num_features"]), int(run.config["max_bin"])
    return layers.roofline_pct(
        run, lambda t: hist_accumulate.least_s(t["booster"], t["rows"], F, B),
        "hist_accumulate_kernel")
