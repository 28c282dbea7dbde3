"""The tree walk's share of its roofline: the least work of the traced
transform calls (``work/gbdt_walk.py``, visits counted by the reference's
walk of the same rows) over the device's kernel time inside them."""
from portbench.harness import bench, layers
from portbench.work import gbdt_walk


def read(run):
    if not run.traced:
        return None
    driver = bench.module("drivers", run.traffic["driver"])
    visits = driver.count_visits(run)
    least_s = sum(gbdt_walk.least_s(**run.state["walk_shape"],
                                    visits=visits[t["frame"]])
                  for t in run.traced)
    took = sum(layers.kernel_us(run, t["span"]) for t in run.traced) / 1e6
    return 100.0 * least_s / took if took > 0 else None
