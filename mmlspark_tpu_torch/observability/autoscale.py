"""Per-class autoscale signal from the federated fleet view.

An own copy of the JAX package's ``observability/autoscale.py``, verbatim apart from module
paths.

The ROADMAP's serving-fleet item names this exactly: "an autoscale signal
derived from the queue-delay EWMA the shedder already computes, served
fleet-wide by TopologyService".  The :class:`AutoscaleAdvisor` turns the
fleet-merged telemetry into a **desired-replica recommendation per request
class**:

- **queue-delay EWMA** (``mmlspark_serving_queue_delay_ewma_seconds``,
  mean over the class's workers) against ``target_queue_delay_s``;
- **queue depth** (``mmlspark_serving_queue_depth``, summed) against
  ``depth_per_replica``;
- **shed rate** (``mmlspark_serving_requests_total{status=shed}`` over
  ``{status=received}``, differenced over ``window_s`` like the SLO
  windows) against ``shed_tolerance``;
- **device-time saturation** (the cost ledger:
  ``mmlspark_request_class_device_seconds_total`` differenced over the
  same window) against the class's device-seconds budget — each replica
  contributes 1 device-second per wall-second, derated by
  ``target_device_utilization``.  This is cost-aware pressure: the fleet
  scales on *projected device-time saturation*, not just on the queue
  symptoms that lag it.

The scalar ``pressure`` is the max of the four ratios — any one signal
saturating is reason enough to scale.  Anti-flap machinery: a
**hysteresis band** (``down_threshold < pressure < up_threshold`` holds
the previous recommendation), a **cooldown** after every change, and a
**decay** path — when the overload drains, the recommendation halves back
toward the live replica count instead of snapping, and only sustained
calm recommends dropping below it.  Everything runs on the injectable
clock; the recommendation is recomputed on every federation poll and
served on ``GET /fleet/autoscale``.
"""
from __future__ import annotations

import collections
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .metrics import MetricsRegistry, get_registry
# the ONE cumulative edge-differencing + ring-maintenance implementation —
# the shed-rate window and the SLO burn windows must never drift onto
# different math (or different eviction behavior under high cadence)
from .attribution import _window_delta
from .slo import coalesce_append, window_fraction

__all__ = ["AutoscaleAdvisor"]


class AutoscaleAdvisor:
    """Desired-replica recommendations per request class.

    ``recommend(view, workers_by_class)`` is pure with respect to the
    fleet: the view is the telemetry, ``workers_by_class`` the live
    replicas; state per class (previous recommendation, last-change time,
    shed-counter history, calm streak) lives here so hysteresis and
    cooldown survive across polls.  Classes gone from the fleet take
    their state and their desired-replicas GAUGE series with them (a
    frozen gauge would scrape stale recommendations forever); the
    ``recommendations_total`` counter children stay — they are history
    and hold no object references, the ``uninstrument_breaker``
    convention."""

    EWMA_FAMILY = "mmlspark_serving_queue_delay_ewma_seconds"
    DEPTH_FAMILY = "mmlspark_serving_queue_depth"
    REQUESTS_FAMILY = "mmlspark_serving_requests_total"
    CLASS_DEVICE_FAMILY = "mmlspark_request_class_device_seconds_total"

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 clock: Callable[[], float] = time.monotonic,
                 target_queue_delay_s: float = 0.1,
                 shed_tolerance: float = 0.02,
                 depth_per_replica: float = 64.0,
                 target_device_utilization: float = 0.8,
                 window_s: float = 300.0,
                 up_threshold: float = 1.0, down_threshold: float = 0.5,
                 cooldown_s: float = 60.0, calm_s_for_downscale: float = 300.0,
                 min_replicas: int = 1, max_replicas: int = 64,
                 max_step_up: float = 4.0):
        if not down_threshold < up_threshold:
            raise ValueError("down_threshold must be < up_threshold")
        self.registry = registry if registry is not None else get_registry()
        self.clock = clock
        self.target_queue_delay_s = float(target_queue_delay_s)
        self.shed_tolerance = float(shed_tolerance)
        self.depth_per_replica = float(depth_per_replica)
        if not 0.0 < target_device_utilization <= 1.0:
            raise ValueError("target_device_utilization must be in (0, 1]")
        self.target_device_utilization = float(target_device_utilization)
        self.window_s = float(window_s)
        self.up_threshold = float(up_threshold)
        self.down_threshold = float(down_threshold)
        self.cooldown_s = float(cooldown_s)
        # TIME-based (on the injectable clock), like every other anti-flap
        # bound here: a per-call streak would let two on-demand GETs
        # milliseconds apart count as "sustained calm"
        self.calm_s_for_downscale = float(calm_s_for_downscale)
        self.min_replicas = max(0, int(min_replicas))
        self.max_replicas = int(max_replicas)
        self.max_step_up = float(max_step_up)
        # ring-span guard (see slo.coalesce_append): on-demand callers at
        # any cadence must never age the shed window's edge out of the
        # bounded per-class history (deque maxlen 4096 below)
        self._min_spacing_s = 2.0 * self.window_s / 4096
        self._lock = threading.Lock()
        self._state: Dict[str, Dict] = {}
        from .instruments import instrument_autoscaler
        self._m = instrument_autoscaler(self, self.registry)

    # ------------------------------------------------------------- signals
    def _signals(self, view, workers: List[Dict], now: float,
                 st: Dict) -> Dict[str, float]:
        hist = st["hist"]
        dev_hist = st["dev_hist"]
        addrs = {f"{w['host']}:{w['port']}" for w in workers}
        coverage = frozenset(
            sid for w in workers
            if (sid := w.get("server_id")) is not None
            and view.workers.get(sid, {}).get("ok", False))
        if coverage != st.get("coverage"):
            # scrape coverage changed (a worker's /metrics blipped, or it
            # rejoined with its lifetime counters): cumulative counts are
            # not comparable across the change — re-baseline the shed
            # window rather than read a lifetime's sheds as in-window
            # (the instantaneous EWMA/depth gauges keep steering meanwhile)
            hist.clear()
            dev_hist.clear()
            st["coverage"] = coverage
        ewmas = [v for labels, v in view.gauge_values(self.EWMA_FAMILY)
                 if labels.get("server") in addrs and v == v]  # NaN out
        depth = sum(v for labels, v in view.gauge_values(self.DEPTH_FAMILY)
                    if labels.get("server") in addrs and v == v)
        shed = recv = 0.0
        for labels, v in view.counters.get(self.REQUESTS_FAMILY, {}).items():
            d = dict(labels)
            if d.get("server") not in addrs:
                continue
            if d.get("status") == "shed":
                shed += v
            elif d.get("status") == "received":
                recv += v
        if hist and recv < hist[-1][2]:
            # cumulative received went backwards: a replica restarted with
            # fresh counters or left the class — counter-reset semantics,
            # same rule as the SLO windows (a negative diff must read as
            # "no data yet", never as a signal)
            hist.clear()
        coalesce_append(hist, (now, shed, recv), self._min_spacing_s)
        # cost-aware signal: the class's cumulative device-time
        # spend from the attribution ledger, differenced over the same
        # window into a device-seconds-per-wall-second rate
        dev = sum(v for labels, v in
                  view.counters.get(self.CLASS_DEVICE_FAMILY, {}).items()
                  if dict(labels).get("server") in addrs)
        if dev_hist and dev < dev_hist[-1][1]:
            dev_hist.clear()
        coalesce_append(dev_hist, (now, dev), self._min_spacing_s)
        w = _window_delta(list(dev_hist), now, self.window_s)
        return {
            "queue_delay_ewma_s": sum(ewmas) / len(ewmas) if ewmas else 0.0,
            "queue_depth": depth,
            "shed_rate": window_fraction(list(hist), now, self.window_s),
            "device_seconds_per_s": (w[1][0] / w[0]) if w else 0.0,
        }

    # ------------------------------------------------------------ decision
    def recommend(self, view, workers_by_class: Dict[str, List[Dict]],
                  now: Optional[float] = None) -> Dict[str, Dict]:
        """Recompute the desired-replica recommendation for every live
        class from one fleet view.  Returns the ``GET /fleet/autoscale``
        payload: ``{class: {current, desired, reason, pressure, signals,
        cooldown_remaining_s}}``."""
        now = self.clock() if now is None else float(now)
        out: Dict[str, Dict] = {}
        bookings: List[Tuple[str, int, str]] = []
        for klass in sorted(workers_by_class):
            workers = workers_by_class[klass]
            n = len(workers)
            # the whole read-decide-write sequence holds the state lock:
            # concurrent ticks (background poll + on-demand ?refresh=1)
            # must never interleave on calm streaks / last_change /
            # desired — a lost update here IS a flap.  Registry bookings
            # drain after release (LCK discipline).
            with self._lock:
                st = self._state.setdefault(klass, {
                    "desired": None, "last_change": -math.inf,
                    "calm_since": None,
                    "hist": collections.deque(maxlen=4096),
                    "dev_hist": collections.deque(maxlen=4096)})
                signals = self._signals(view, workers, now, st)
                # telemetry-blind guard: when NONE of the class's workers
                # scraped ok (and ids were known to check), absent gauges
                # would read as pressure 0 — "calm" — during exactly the
                # overload that times scrapes out.  Hold the previous
                # recommendation instead; the SLO engine's held_partial_view
                # rule, applied to the scaling signal.
                known_ids = [w.get("server_id") for w in workers
                             if w.get("server_id") is not None]
                if known_ids and not st.get("coverage"):
                    st["calm_since"] = None
                    prev = st["desired"] if st["desired"] is not None else n
                    st["desired"] = prev
                    bookings.append((klass, prev, "hold"))
                    out[klass] = {
                        "current": n, "desired": prev,
                        "reason": "telemetry_blind", "pressure": None,
                        "signals": signals,
                        "cooldown_remaining_s": round(max(
                            0.0, self.cooldown_s
                            - (now - st["last_change"])), 3)}
                    continue
                pressure = max(
                    signals["queue_delay_ewma_s"] / self.target_queue_delay_s,
                    signals["shed_rate"] / self.shed_tolerance,
                    signals["queue_depth"]
                    / (max(1, n) * self.depth_per_replica),
                    # cost-aware: measured device-seconds burn rate vs the
                    # class's derated budget of one device-second per
                    # wall-second per replica — saturating device time is
                    # scale-up pressure before the queues ever feel it
                    signals["device_seconds_per_s"]
                    / (max(1, n) * self.target_device_utilization))
                prev = st["desired"] if st["desired"] is not None else n
                cooldown_left = self.cooldown_s - (now - st["last_change"])
                in_cooldown = cooldown_left > 0
                if pressure >= self.up_threshold:
                    st["calm_since"] = None
                    if in_cooldown:
                        desired, reason = prev, "cooldown"
                    else:
                        # bounded proportional growth: never more than
                        # max_step_up x current, never less than one extra
                        want = math.ceil(n * min(pressure, self.max_step_up))
                        desired = max(prev, min(self.max_replicas,
                                                max(n + 1, want)))
                        reason = "scale_up" if desired > prev else "hold"
                elif pressure < self.down_threshold:
                    if st["calm_since"] is None:
                        st["calm_since"] = now
                    if in_cooldown:
                        desired, reason = prev, "cooldown"
                    elif prev > n:
                        # drain: halve the surplus back toward the live count
                        desired = max(n, prev - max(1, (prev - n + 1) // 2))
                        reason = "decay"
                    elif n > self.min_replicas and \
                            now - st["calm_since"] >= self.calm_s_for_downscale:
                        desired, reason = n - 1, "scale_down"
                    else:
                        desired, reason = min(prev, n), "hold"
                else:
                    # hysteresis band: neither overloaded nor provably calm
                    # — hold the previous recommendation (no flapping
                    # between polls that straddle one threshold)
                    st["calm_since"] = None
                    desired, reason = prev, "hysteresis_band"
                if desired != prev:
                    st["last_change"] = now
                    cooldown_left = self.cooldown_s
                st["desired"] = desired
            direction = "up" if desired > prev else \
                "down" if desired < prev else "hold"
            bookings.append((klass, desired, direction))
            out[klass] = {
                "current": n, "desired": desired, "reason": reason,
                "pressure": round(pressure, 4), "signals": signals,
                "cooldown_remaining_s": round(max(0.0, cooldown_left), 3)}
        for klass, desired, direction in bookings:
            self._m["desired"].set(desired, **{"class": klass})
            self._m["recommendations"].inc(
                **{"class": klass, "direction": direction})
        # classes gone from the fleet drop their state AND gauge series
        with self._lock:
            dead = [k for k in self._state if k not in workers_by_class]
            for k in dead:
                self._state.pop(k)
        for k in dead:
            self._m["desired"].remove(**{"class": k})
        return out
