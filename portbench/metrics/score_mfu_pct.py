"""The whole transform call's share of the chip: the walk's least work
(``work/gbdt_walk.py``) over the traced calls' wall time, in percent."""
from portbench.harness import bench
from portbench.work import gbdt_walk


def read(run):
    if not run.traced:
        return None
    driver = bench.module("drivers", run.traffic["driver"])
    visits = driver.count_visits(run)
    least = sum(gbdt_walk.least_s(**run.state["walk_shape"],
                                  visits=visits[t["frame"]])
                for t in run.traced)
    wall = sum(e - s for s, e in (t["span"] for t in run.traced)) / 1e6
    return 100.0 * least / wall
