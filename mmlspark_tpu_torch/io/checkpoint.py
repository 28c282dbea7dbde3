"""Atomic training checkpoints — crash-safe snapshots with async writes.

Production TPU training treats preemption as a routine event (PAPERS:
Gemma-on-Cloud-TPU fine-tuning; Snap ML's restartable out-of-core
streaming): a multi-hour boosting or DNN run must survive a killed worker
by checkpoint/resume instead of restarting from row zero.  This module is
the one copy of the durability mechanics every training path rides:

- :func:`atomic_write` — the sanctioned writer for ANYTHING under a
  checkpoint directory: content lands in a same-directory temp file and is
  published with ``os.replace``, so a crash mid-write can never tear the
  only copy.  graft-lint RES003 bans direct ``open(..., "w"/"wb")`` in the
  checkpoint modules precisely so this contract cannot erode.
- :class:`CheckpointManager` — step-numbered single-file ``.npz``
  snapshots (arrays + one JSON meta blob) with keep-last-K retention, a
  background writer thread (serialization and disk I/O happen OFF the
  training thread — device work never waits on disk), and torn-snapshot
  fallback on load: resume tries the newest snapshot, and anything that
  fails to parse is skipped (with a booked ``torn_skipped`` resume) in
  favour of the previous one.

Instrumentation (all labelled by ``site``): ``mmlspark_checkpoint_
{save_seconds,bytes,saves_total,resumes_total}`` plus the
``mmlspark_checkpoint_last_success_age_seconds`` gauge — a climbing age on
a run that is supposed to checkpoint every N iterations IS the alert.
Resume and save-failure ring events ride ``core.logging.log_event``.
"""
from __future__ import annotations

import io
import json
import os
import queue
import re
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from ..utils.concurrency import make_lock

__all__ = ["atomic_write", "CheckpointManager", "checkpoint_instruments",
           "book_resume", "check_resume_arg", "snapshot_steps",
           "SNAPSHOT_RE", "topology_stanza", "topology_delta",
           "book_reshard", "RESUME_REQUIRED", "resume_required_error"]

#: step-numbered snapshot filename shape: ``ckpt_0000000042.npz`` — the
#: extension is pinned to ``.npz`` exactly: an operator-copied
#: ``ckpt_0000000042.npz.bak`` must read as a FOREIGN file, never as a
#: snapshot whose open would then surface as a confusing torn_skipped
SNAPSHOT_RE = re.compile(r"^(?P<prefix>.+)_(?P<step>\d{10})\.npz$")


@contextmanager
def atomic_write(path: str, mode: str = "wb"):
    """Write-then-publish: yields a file object on ``<path>.tmp-<pid>``;
    on clean exit the temp file is fsync'd and ``os.replace``d over
    ``path`` (atomic on POSIX — readers see the old bytes or the new
    bytes, never a torn mix).  On error the temp file is removed and the
    prior ``path`` content, if any, is untouched.  The single sanctioned
    writer for checkpoint artifacts (graft-lint RES003)."""
    if mode not in ("w", "wb"):
        raise ValueError(f"atomic_write mode must be 'w' or 'wb', got {mode!r}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    f = open(tmp, mode)  # graft-lint: disable=RES003 — this IS the writer
    try:
        yield f
        f.flush()
        os.fsync(f.fileno())
        f.close()
        os.replace(tmp, path)
    except BaseException:
        f.close()
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


#: sentinel distinguishing "caller did not hand us the directory" from a
#: genuinely absent one — check_resume_arg must not guess either way
_DIR_UNCHECKED = object()


def check_resume_arg(resume: str,
                     checkpoint_dir: Any = _DIR_UNCHECKED) -> None:
    """Shared knob validation for every checkpointing driver: a typo'd
    resume value silently restarting from iteration zero is the exact
    loss this layer exists to prevent — reject it loudly.  ``'must'``
    is ``'auto'`` that additionally REQUIRES a usable snapshot:
    a preemption-restart script passes it so a wiped disk raises instead
    of silently retraining from zero.

    Drivers pass ``checkpoint_dir=`` so the 'must'-with-nowhere-to-resume
    contract lives HERE, once: ``'must'`` with no directory is the
    silent-retrain trap in its sneakiest form (a checkpoint-dir env var
    that didn't propagate to the restart) and raises
    :func:`resume_required_error` instead of quietly training from zero."""
    if resume not in ("auto", "never", "must"):
        raise ValueError(
            f"resume must be 'auto', 'never' or 'must', got {resume!r} "
            "(docs/RESILIENCE.md: training fault tolerance)")
    if checkpoint_dir is not _DIR_UNCHECKED and resume == "must" \
            and not checkpoint_dir:
        raise resume_required_error(checkpoint_dir)


#: shared raise for ``resume='must'`` with nothing to restore — one
#: message so all three drivers fail identically
RESUME_REQUIRED = (
    "resume='must' but no usable snapshot exists in {directory!r} — the "
    "checkpoint directory is empty, wiped, or every snapshot is torn.  A "
    "preemption-restart script must not silently retrain from zero; point "
    "at the surviving checkpoint_dir or pass resume='auto' to accept a "
    "fresh start (docs/RESILIENCE.md: elastic resume)")


def resume_required_error(directory: Optional[str]) -> FileNotFoundError:
    return FileNotFoundError(RESUME_REQUIRED.format(
        directory=directory or "<no checkpoint_dir>"))


def checkpoint_instruments(registry=None) -> Dict[str, Any]:
    """Register (idempotently) and return the checkpoint metric families.
    One shared booking surface so the booster manager here and the trainer
    checkpointer in ``parallel/checkpoint.py`` report into the SAME
    families, distinguished only by their ``site`` label."""
    from ..observability.metrics import get_registry
    reg = registry if registry is not None else get_registry()
    return {
        "save_seconds": reg.histogram(
            "mmlspark_checkpoint_save_seconds",
            "wall time to serialize+publish one snapshot (background "
            "writer thread; the training loop never waits on this)",
            labels=("site",)),
        "bytes": reg.histogram(
            "mmlspark_checkpoint_bytes",
            "published snapshot size in bytes", labels=("site",)),
        "saves": reg.counter(
            "mmlspark_checkpoint_saves_total",
            "snapshot save attempts by outcome", labels=("site", "result")),
        "resumes": reg.counter(
            "mmlspark_checkpoint_resumes_total",
            "resume loads by outcome (ok / torn_skipped / none)",
            labels=("site", "result")),
        "last_age": reg.gauge(
            "mmlspark_checkpoint_last_success_age_seconds",
            "seconds since the last successful snapshot publish (inf "
            "until the first save) — a climbing age on a checkpointing "
            "run is the page", labels=("site",)),
        "reshard": reg.counter(
            "mmlspark_reshard_total",
            "resumes that re-sharded state onto a changed topology "
            "(elastic resume), by driver and direction "
            "(shrink / grow / reshape)", labels=("driver", "direction")),
    }


def book_resume(site: str, result: str, step: Optional[int] = None,
                registry=None, path: str = "", **fields) -> None:
    """Book one resume outcome (counter + ring event) — the ONE booking
    path for the ``checkpoint_resume`` family.  Extra keyword fields ride
    the ring event (e.g. ``files=`` for ``foreign_skipped``)."""
    checkpoint_instruments(registry)["resumes"].inc(site=site, result=result)
    from ..core.logging import log_event
    log_event({"event": "checkpoint_resume", "site": site, "result": result,
               "step": step, "path": path, **fields})


def snapshot_steps(directory: str, prefix: str = "ckpt",
                   foreign: Optional[List[str]] = None) -> List[int]:
    """Sorted (ascending) step numbers of published snapshots in
    ``directory``.  Anything that does not parse as
    ``<prefix>_<10 digits>.npz`` — temp files, operator-copied backups,
    editor artifacts — is a FOREIGN name: ignored, and appended to
    ``foreign`` when the caller wants to book the skip (elastic resume: a
    stray file beside the snapshots must never fail the resume path)."""
    steps = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for name in names:
        m = SNAPSHOT_RE.match(name)
        if m and m.group("prefix") == prefix:
            steps.append(int(m.group("step")))
        elif foreign is not None and not name.startswith(".") \
                and ".tmp-" not in name:
            # our own in-flight temp files are not "foreign" — they are
            # the atomic writer mid-publish (or crash debris it tolerates)
            foreign.append(name)
    return sorted(steps)


# ---------------------------------------------------------------------------
# topology stanza (elastic resume) — recorded, allowed to differ
# ---------------------------------------------------------------------------

def topology_stanza(mesh=None, **extra) -> Dict[str, Any]:
    """The topology half of a snapshot's identity: device count, mesh
    shape, shard count — RECORDED so a resume knows what it left, but
    never part of the must-match fingerprint, because the fleet a
    preempted run restarts on is rarely the fleet it lost.  ``mesh``
    fills the device/mesh fields from a ``jax.sharding.Mesh``; drivers
    add their own geometry (``shard_count``, ``num_tiles``, ...) via
    ``extra``."""
    stanza: Dict[str, Any] = {}
    if mesh is not None:
        stanza["device_count"] = int(mesh.devices.size)
        stanza["mesh_axes"] = {str(a): int(s) for a, s in
                               zip(mesh.axis_names, mesh.devices.shape)}
    stanza.update({k: v for k, v in extra.items() if v is not None})
    return stanza


#: width keys in precedence order: the first one present on both sides,
#: numeric, and DIFFERENT decides shrink-vs-grow; everything else is a
#: "reshape".  ``tile_rows`` (not num_tiles) is the streamed width: a
#: smaller tile is a smaller host budget — a shrink — even though the
#: tile COUNT grows.
_WIDTH_KEYS = ("shard_count", "tile_rows", "device_count")


def topology_delta(saved: Optional[Dict[str, Any]],
                   current: Dict[str, Any]) -> Dict[str, Any]:
    """Compare a snapshot's recorded topology to the resuming run's.
    Returns ``{"changed": bool, "direction": shrink|grow|reshape|same,
    "fields": {key: [old, new]}}`` — the delta drivers book (and return
    in extras) so an operator can see a resume re-sharded, in which
    direction, and by how much.  ``saved=None`` means the snapshot
    predates topology recording: that is UNKNOWN, not a change — booking
    a spurious reshard on every pre-upgrade same-mesh resume would cry
    wolf on the very signal this exists for."""
    if saved is None:
        return {"changed": False, "direction": "same", "fields": {}}
    fields = {}
    for key in sorted(set(saved) | set(current)):
        old, new = saved.get(key), current.get(key)
        if old != new:
            fields[key] = [old, new]
    direction = "same"
    if fields:
        direction = "reshape"
        for key in _WIDTH_KEYS:
            old, new = saved.get(key), current.get(key)
            if isinstance(old, (int, float)) and isinstance(new, (int, float)) \
                    and old != new:
                direction = "shrink" if new < old else "grow"
                break
    return {"changed": bool(fields), "direction": direction,
            "fields": fields}


def book_reshard(driver: str, delta: Dict[str, Any],
                 registry=None) -> None:
    """Book one topology-changing resume: the ``mmlspark_reshard_total``
    counter plus a ``resume_topology_delta`` ring event carrying the
    full field-by-field delta."""
    checkpoint_instruments(registry)["reshard"].inc(
        driver=driver, direction=delta.get("direction", "reshape"))
    from ..core.logging import log_event
    log_event({"event": "resume_topology_delta", "driver": driver,
               "direction": delta.get("direction"),
               "fields": delta.get("fields", {})})


class CheckpointManager:
    """Step-numbered atomic ``.npz`` snapshots with async publication.

    ``save(step, arrays, meta)`` enqueues one snapshot: ``arrays`` is a
    dict of array-likes (device arrays welcome — ``np.asarray`` runs on
    the writer thread, so the device-to-host fetch itself happens off the
    training thread) or a zero-arg callable returning one (materialization
    fully deferred); ``meta`` is any JSON-serializable dict.  The writer
    thread serializes to ``<prefix>_<step>.npz`` via :func:`atomic_write`
    and prunes snapshots beyond ``keep_last``.

    Failure containment: a failed save books ``result="error"`` + a ring
    event and the run continues — durability is best-effort per snapshot,
    and the previous snapshot is still intact because publication is
    atomic.  ``load_latest`` walks newest-to-oldest, skipping (and
    booking) torn snapshots.

    NOT safe for two concurrent writers on one directory (the retention
    pass would prune each other's files) — one training run owns one
    checkpoint dir, the same contract every production checkpoint layout
    assumes.
    """

    _META_KEY = "__meta__"

    def __init__(self, directory: str, *, site: str = "checkpoint",
                 keep_last: int = 3, prefix: str = "ckpt",
                 registry=None,
                 clock: Callable[[], float] = time.monotonic):
        if keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        self.directory = str(directory)
        self.site = site
        self.keep_last = int(keep_last)
        self.prefix = prefix
        self._clock = clock
        self._registry = registry
        self._m = checkpoint_instruments(registry)
        self._last_success_at: Optional[float] = None
        self._m["last_age"].set_function(self._age, site=site)
        self.saves_ok = 0
        self.saves_failed = 0
        self.saves_coalesced = 0
        self.last_error: Optional[BaseException] = None
        self._q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._lock = make_lock("CheckpointManager._lock")
        os.makedirs(self.directory, exist_ok=True)

    # ---------------------------------------------------------------- save
    def _age(self) -> float:
        with self._lock:
            t = self._last_success_at
        return float("inf") if t is None else max(0.0, self._clock() - t)

    def path_for(self, step: int) -> str:
        return os.path.join(self.directory,
                            f"{self.prefix}_{int(step):010d}.npz")

    def save(self, step: int,
             arrays: Union[Dict[str, Any], Callable[[], Dict[str, Any]]],
             meta: Optional[Dict[str, Any]] = None, *,
             block: bool = False) -> None:
        """Enqueue one snapshot for background publication.  ``block=True``
        waits for THIS snapshot (and everything queued before it) to land
        — the final pre-exit checkpoint wants that; periodic saves do not.

        Backpressure by coalescing: when the writer is slower than the
        save cadence, only the NEWEST still-pending periodic snapshot is
        kept — older pending ones are dropped (booked ``coalesced``)
        before this one enqueues.  Host memory is then bounded at ~two
        payloads (one in flight + one pending) instead of growing without
        limit on slow storage — the exact storage this layer targets.
        Blocking saves drain everything first, so nothing a caller waited
        on is ever dropped."""
        self._ensure_thread()
        if not block:
            while True:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break
                self._q.task_done()
                self.saves_coalesced += 1
                self._m["saves"].inc(site=self.site, result="coalesced")
        self._q.put((int(step), arrays, dict(meta or {})))
        if block:
            self.wait()

    def wait(self) -> None:
        """Drain every queued save (including any in flight)."""
        self._q.join()

    def close(self) -> None:
        """Drain pending saves, retire the writer thread, and unhook the
        last-success-age gauge — a FINISHED run's age must not keep
        climbing in the shared registry (the gauge is the "checkpoints
        stopped landing" page, and a closed manager is not an outage), and
        the callback closure must not pin the manager alive.  A later save
        restarts the worker and re-registers the gauge."""
        self.wait()
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            self._q.put(None)
            t.join()
        self._m["last_age"].remove(site=self.site)

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                # re-opening after close(): the age gauge comes back too
                self._m["last_age"].set_function(self._age, site=self.site)
                self._thread = threading.Thread(
                    target=self._writer, name=f"ckpt-writer:{self.site}",
                    daemon=True)
                self._thread.start()

    def _writer(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, arrays, meta = item
            try:
                self._write_one(step, arrays, meta)
            except BaseException as exc:  # noqa: BLE001 — best-effort save
                self.saves_failed += 1
                self.last_error = exc
                self._m["saves"].inc(site=self.site, result="error")
                from ..core.logging import log_event
                log_event({"event": "checkpoint_save_failed",
                           "site": self.site, "step": step,
                           "error": repr(exc)})
            finally:
                self._q.task_done()

    def _write_one(self, step: int, arrays, meta: Dict[str, Any]) -> None:
        t0 = self._clock()
        if callable(arrays):
            arrays = arrays()
        payload = {k: np.asarray(v) for k, v in arrays.items()}
        if self._META_KEY in payload:
            raise ValueError(f"array key {self._META_KEY!r} is reserved")
        meta_bytes = json.dumps(meta, default=float).encode()
        payload[self._META_KEY] = np.frombuffer(meta_bytes, dtype=np.uint8)
        path = self.path_for(step)
        with atomic_write(path, "wb") as f:
            np.savez(f, **payload)
        nbytes = os.path.getsize(path)
        self._prune()
        dt = self._clock() - t0
        with self._lock:
            self._last_success_at = self._clock()
        self.saves_ok += 1
        self._m["save_seconds"].observe(dt, site=self.site)
        self._m["bytes"].observe(float(nbytes), site=self.site)
        self._m["saves"].inc(site=self.site, result="ok")

    def _prune(self) -> None:
        steps = snapshot_steps(self.directory, self.prefix)
        for step in steps[:-self.keep_last]:
            try:
                os.unlink(self.path_for(step))
            except OSError:
                pass  # already gone — retention is best-effort

    # ---------------------------------------------------------------- load
    def steps(self) -> List[int]:
        return snapshot_steps(self.directory, self.prefix)

    def load(self, step: int) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        """Load one snapshot; raises on a torn/unreadable file."""
        with open(self.path_for(step), "rb") as f:
            data = f.read()
        with np.load(io.BytesIO(data), allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files if k != self._META_KEY}
            meta_raw = z[self._META_KEY].tobytes() if self._META_KEY in z.files \
                else b"{}"
        meta = json.loads(meta_raw.decode())
        if not isinstance(meta, dict):
            raise ValueError("snapshot meta is not a JSON object")
        return arrays, meta

    def load_latest(self, current_topology: Optional[Dict[str, Any]] = None
                    ) -> Optional[
            Tuple[int, Dict[str, np.ndarray], Dict[str, Any]]]:
        """Newest valid snapshot, or None.  A torn newest snapshot (crash
        artifact, truncated copy) is skipped — booked + ring-evented — and
        the previous one restores instead: durability degrades one step,
        never to zero.

        Foreign filenames beside the snapshots (operator copies, editor
        backups, unparseable names) are skipped with ONE booked
        ``foreign_skipped`` + ring event instead of failing the resume
        path.  A snapshot evicted by keep-last-K retention
        between the directory listing and the open falls back to the
        next-oldest — and if the stale listing exhausted itself that way
        while a newer snapshot was landing, the walk re-lists once
        (booked ``evicted_skipped`` per vanished file).

        With ``current_topology`` given, the returned ``meta`` carries
        ``meta["topology_delta"]`` — :func:`topology_delta` of the
        snapshot's recorded topology stanza against the resuming run's —
        so drivers know they are re-sharding before they rebuild state.
        """
        skipped_booked: set = set()   # steps already booked torn/evicted —
        for relist in range(2):       # the re-list walk must not re-count
            foreign: List[str] = []   # the same artifact
            steps = snapshot_steps(self.directory, self.prefix,
                                   foreign=foreign)
            if foreign and relist == 0:
                book_resume(self.site, "foreign_skipped",
                            registry=self._registry,
                            files=sorted(foreign)[:16])
            evicted_midwalk = False
            for step in reversed(steps):
                try:
                    arrays, meta = self.load(step)
                except FileNotFoundError:
                    # keep-last-K retention raced the walk: the listed
                    # file is gone, the next-oldest (or a re-list) serves
                    if step not in skipped_booked:
                        skipped_booked.add(step)
                        book_resume(self.site, "evicted_skipped", step,
                                    registry=self._registry,
                                    path=self.path_for(step))
                    evicted_midwalk = True
                    continue
                except Exception:  # noqa: BLE001 — torn snapshot: fall back
                    if step not in skipped_booked:
                        skipped_booked.add(step)
                        book_resume(self.site, "torn_skipped", step,
                                    registry=self._registry,
                                    path=self.path_for(step))
                    continue
                if current_topology is not None:
                    meta = dict(meta, topology_delta=topology_delta(
                        meta.get("topology"), current_topology))
                book_resume(self.site, "ok", step, registry=self._registry,
                            path=self.path_for(step))
                return step, arrays, meta
            if not evicted_midwalk:
                break
            # every listed snapshot vanished mid-walk — retention only
            # evicts when a NEWER snapshot landed, so a fresh listing
            # has something to serve; retry exactly once
        book_resume(self.site, "none", registry=self._registry)
        return None
