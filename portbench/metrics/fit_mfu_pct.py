"""The whole fit's share of the chip: its least time (``work/fit.py``,
bound by HBM bytes, LambdaRank's pairs by operations) over the traced
fits' wall time, in percent."""
import numpy as np

from portbench.work import fit


def read(run):
    if not run.traced:
        return None
    F, B = int(run.config["num_features"]), int(run.config["max_bin"])
    gp = run.state.get("group_ptr")
    pairs = None
    if gp is not None:
        pairs = run.state.get("pairs")
        if pairs is None:
            pairs = run.state["pairs"] = fit.ranking_pairs(
                run.state["y"].cpu().numpy(), np.asarray(gp))
    least = sum(fit.least_s(t["booster"], t["rows"], F, B, pairs)
                for t in run.traced)
    wall = sum(e - s for s, e in (t["span"] for t in run.traced)) / 1e6
    return 100.0 * least / wall
