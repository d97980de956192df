"""Unified run telemetry: metrics registry + flight recorder.

The port's own copy of ``horovod_tpu/core/telemetry.py`` (pure Python; the
port imports nothing of the JAX package). The reference observes
per-tensor lifecycle through the Timeline (``horovod/common/timeline.cc``)
and detects stuck collectives with the stall inspector
(``horovod/common/stall_inspector.cc``), but neither exports run-wide
metrics nor leaves a post-mortem record when a rank dies. This module is
the port's single telemetry surface:

* a process-wide, lock-cheap :class:`Registry` of counters, gauges and
  bounded histograms (label cardinality capped so a runaway label value
  cannot blow up memory or the wire format);
* a fixed-size :class:`FlightRecorder` ring of recent structured events
  (step begin/end, collective launches, sentinel verdicts, watchdog
  expiries) that dumps atomically to ``flight_<rank>.jsonl`` on abnormal
  exit;
* Prometheus text rendering (:func:`render_prometheus`) and a compact
  cumulative-delta export (:func:`export_delta`) for a coordinator to
  collect;
* :func:`assemble_incident` — the cross-rank post-mortem: surviving rings
  and a coordinator journal tail lined up into one
  ``incident_<failure_seq>.json``.

Every recording call is host-side only: values handed to the registry or
the ring must already live on the host (no ``.item()`` on a CUDA tensor
inside a step loop just to record it).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .logging import get_logger

ENABLE_ENV = "HOROVOD_TELEMETRY"
RING_ENV = "HOROVOD_TELEMETRY_RING"
FLIGHT_DIR_ENV = "HOROVOD_FLIGHT_DIR"

DEFAULT_RING = 256
MAX_SERIES_PER_METRIC = 64
DEFAULT_BUCKETS = (0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0, 60.0)

# How many trailing events per rank an incident report keeps.
INCIDENT_TAIL = 64


def _env_rank() -> int:
    # HOROVOD_PROCESS_ID is what the port's launch environment gives each
    # worker (``core/context_api.py``); the others cover foreign launchers.
    for var in ("HOROVOD_PROCESS_ID", "HOROVOD_RANK", "PMI_RANK",
                "OMPI_COMM_WORLD_RANK"):
        v = os.environ.get(var)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                pass
    return 0


def _series_id(name: str, labels: Dict[str, Any]) -> str:
    """Render ``name{k="v",...}`` — the Prometheus sample id doubles as
    the wire/journal key so merges are plain dict updates."""
    if not labels:
        return name
    inner = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in sorted(labels.items())
    )
    return "%s{%s}" % (name, inner)


def inject_label(sid: str, key: str, value: Any) -> str:
    """Insert one label into a series id (used to tag per-rank samples)."""
    pair = '%s="%s"' % (key, value)
    if sid.endswith("}"):
        name, _, rest = sid.partition("{")
        return "%s{%s,%s" % (name, pair, rest)
    return "%s{%s}" % (sid, pair)


class Registry:
    """Lock-cheap metrics registry.

    One lock guards three flat dicts keyed by Prometheus sample id; an
    increment is a dict update under the lock (sub-microsecond), so the
    registry is safe to hit from the step loop, the watchdog thread and
    the coordinator poll thread at once.  Per metric name at most
    ``max_series`` distinct label sets are kept; overflow increments the
    ``hvd_telemetry_series_dropped_total`` self-counter instead of
    growing without bound.
    """

    def __init__(self, max_series: int = MAX_SERIES_PER_METRIC):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        # name -> (boundaries, {sid_prefix: [bucket counts..., +inf]}, sums, counts)
        self._hist_bounds: Dict[str, Tuple[float, ...]] = {}
        self._hist_counts: Dict[str, List[int]] = {}
        self._hist_sum: Dict[str, float] = {}
        self._hist_n: Dict[str, int] = {}
        self._series_per_name: Dict[str, int] = {}
        self._max_series = max_series
        self._dropped = 0
        self._dirty: set = set()

    def _admit(self, store: Dict[str, Any], name: str, sid: str) -> bool:
        if sid in store:
            return True
        n = self._series_per_name.get(name, 0)
        if n >= self._max_series:
            self._dropped += 1
            return False
        self._series_per_name[name] = n + 1
        return True

    def inc(self, name: str, value: float = 1.0, **labels: Any) -> None:
        sid = _series_id(name, labels)
        with self._lock:
            if not self._admit(self._counters, name, sid):
                return
            self._counters[sid] = self._counters.get(sid, 0.0) + value
            self._dirty.add(("c", sid))

    def set_gauge(self, name: str, value: float, **labels: Any) -> None:
        sid = _series_id(name, labels)
        with self._lock:
            if not self._admit(self._gauges, name, sid):
                return
            self._gauges[sid] = float(value)
            self._dirty.add(("g", sid))

    def observe(self, name: str, value: float,
                buckets: Optional[Tuple[float, ...]] = None,
                **labels: Any) -> None:
        sid = _series_id(name, labels)
        with self._lock:
            bounds = self._hist_bounds.get(name)
            if bounds is None:
                bounds = tuple(buckets or DEFAULT_BUCKETS)
                self._hist_bounds[name] = bounds
            if not self._admit(self._hist_n, name, sid):
                return
            counts = self._hist_counts.get(sid)
            if counts is None:
                counts = [0] * (len(bounds) + 1)
                self._hist_counts[sid] = counts
            i = 0
            while i < len(bounds) and value > bounds[i]:
                i += 1
            counts[i] += 1
            self._hist_sum[sid] = self._hist_sum.get(sid, 0.0) + value
            self._hist_n[sid] = self._hist_n.get(sid, 0) + 1
            self._dirty.add(("h", sid))

    # -- export ----------------------------------------------------------

    def _flatten_hist_locked(self, sid: str) -> Dict[str, float]:
        """Histograms go over the wire as plain monotone counters
        (``_bucket{le=..}``, ``_sum``, ``_count``) so the coordinator
        can aggregate them with the same sum-merge as counters."""
        name, _, rest = sid.partition("{")
        labels = "{" + rest if rest else ""
        bounds = self._hist_bounds.get(name, DEFAULT_BUCKETS)
        out: Dict[str, float] = {}
        cum = 0
        for b, c in zip(tuple(bounds) + (float("inf"),),
                        self._hist_counts.get(sid, [])):
            cum += c
            le = "+Inf" if b == float("inf") else repr(b)
            base = "%s_bucket" % name
            bsid = _series_id(base, {})
            if labels:
                bsid = base + labels
            out[inject_label(bsid, "le", le)] = float(cum)
        out["%s_sum%s" % (name, labels)] = self._hist_sum.get(sid, 0.0)
        out["%s_count%s" % (name, labels)] = float(self._hist_n.get(sid, 0))
        return out

    def export(self, dirty_only: bool = False) -> Dict[str, Dict[str, float]]:
        """Compact snapshot: ``{"c": {sid: cumulative}, "g": {sid: v}}``.

        With ``dirty_only`` the dicts carry only series touched since the
        previous dirty export (values stay cumulative, so a lost push is
        healed by the next one).
        """
        with self._lock:
            if dirty_only:
                dirty, self._dirty = self._dirty, set()
                c = {s: self._counters[s] for k, s in dirty
                     if k == "c" and s in self._counters}
                g = {s: self._gauges[s] for k, s in dirty
                     if k == "g" and s in self._gauges}
                for k, s in dirty:
                    if k == "h":
                        c.update(self._flatten_hist_locked(s))
            else:
                c = dict(self._counters)
                g = dict(self._gauges)
                for s in self._hist_n:
                    c.update(self._flatten_hist_locked(s))
            if self._dropped:
                c["hvd_telemetry_series_dropped_total"] = float(self._dropped)
        return {"c": c, "g": g}

    def counter_value(self, name: str, **labels: Any) -> float:
        with self._lock:
            return self._counters.get(_series_id(name, labels), 0.0)

    def gauge_value(self, name: str, **labels: Any) -> Optional[float]:
        with self._lock:
            return self._gauges.get(_series_id(name, labels))


def render_prometheus(per_rank: Dict[Any, Dict[str, Dict[str, float]]]) -> str:
    """Prometheus text exposition from per-rank compact snapshots.

    Per-rank samples get a ``rank`` label injected; the fleet rollup is
    emitted with no ``rank`` label — counters SUMMED across ranks, gauges
    AVERAGED (a sum of per-rank ``hvd_step_mfu_proxy``/wall gauges would
    be meaningless; the across-rank mean is the fleet MFU-proxy the
    coordinator dashboard wants).
    """
    lines: List[str] = []
    typed: set = set()
    rollup: Dict[str, float] = {}
    g_sum: Dict[str, float] = {}
    g_n: Dict[str, int] = {}

    def _emit(sid: str, value: float, kind: str) -> None:
        name = sid.partition("{")[0]
        if name not in typed:
            typed.add(name)
            lines.append("# TYPE %s %s" % (name, kind))
        if value == int(value):
            lines.append("%s %d" % (sid, int(value)))
        else:
            lines.append("%s %s" % (sid, repr(value)))

    for rank in sorted(per_rank, key=str):
        snap = per_rank[rank]
        for sid, v in sorted(snap.get("c", {}).items()):
            _emit(inject_label(sid, "rank", rank), v, "counter")
            rollup[sid] = rollup.get(sid, 0.0) + v
        for sid, v in sorted(snap.get("g", {}).items()):
            _emit(inject_label(sid, "rank", rank), v, "gauge")
            g_sum[sid] = g_sum.get(sid, 0.0) + v
            g_n[sid] = g_n.get(sid, 0) + 1
    for sid, v in sorted(rollup.items()):
        _emit(sid, v, "counter")
    for sid, v in sorted(g_sum.items()):
        _emit(sid, v / g_n[sid], "gauge")
    return "\n".join(lines) + "\n"


class FlightRecorder:
    """Fixed-size ring of recent structured events.

    ``record`` is an append under a lock; the ring never grows past its
    construction size, so it is safe to leave armed for the whole run.
    ``dump`` writes JSONL atomically (tmp + ``os.replace``), so a dump
    racing a crash never leaves a torn file.
    """

    def __init__(self, size: int = DEFAULT_RING):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(8, int(size)))

    def record(self, kind: str, **fields: Any) -> None:
        ev = {"t": time.time(), "kind": kind}
        ev.update(fields)
        with self._lock:
            self._ring.append(ev)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def dump(self, path: str) -> str:
        events = self.events()
        tmp = "%s.tmp.%d" % (path, os.getpid())
        with open(tmp, "w") as f:
            for ev in events:
                f.write(json.dumps(ev, default=str) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path


class Telemetry:
    """One registry + one ring + the rank identity, per process."""

    def __init__(self, rank: Optional[int] = None,
                 enabled: Optional[bool] = None,
                 ring_size: Optional[int] = None):
        if enabled is None:
            enabled = os.environ.get(ENABLE_ENV, "1").lower() not in (
                "0", "false", "no", "off")
        if ring_size is None:
            try:
                ring_size = int(os.environ.get(RING_ENV, str(DEFAULT_RING)))
            except ValueError:
                ring_size = DEFAULT_RING
        self.enabled = bool(enabled)
        self.rank = _env_rank() if rank is None else int(rank)
        self.registry = Registry()
        self.ring = FlightRecorder(ring_size)
        self._dump_lock = threading.Lock()


_lock = threading.Lock()
_active: Optional[Telemetry] = None


def active() -> Telemetry:
    """The process singleton, built lazily from env on first use."""
    global _active
    t = _active
    if t is None:
        with _lock:
            if _active is None:
                _active = Telemetry()
            t = _active
    return t


def configure(rank: Optional[int] = None, enabled: Optional[bool] = None,
              ring_size: Optional[int] = None) -> Telemetry:
    """(Re)build the singleton — called from ``hvd.init`` and tests."""
    global _active
    with _lock:
        _active = Telemetry(rank=rank, enabled=enabled, ring_size=ring_size)
        return _active


def reset() -> None:
    global _active
    with _lock:
        _active = None


def enabled() -> bool:
    return active().enabled


# -- module-level conveniences (no-ops when telemetry is disabled) -------

def inc(name: str, value: float = 1.0, **labels: Any) -> None:
    t = active()
    if t.enabled:
        t.registry.inc(name, value, **labels)


def set_gauge(name: str, value: float, **labels: Any) -> None:
    t = active()
    if t.enabled:
        t.registry.set_gauge(name, value, **labels)


def observe(name: str, value: float, **labels: Any) -> None:
    t = active()
    if t.enabled:
        t.registry.observe(name, value, **labels)


def record_event(kind: str, **fields: Any) -> None:
    t = active()
    if t.enabled:
        t.ring.record(kind, **fields)


def export_delta() -> Optional[Dict[str, Dict[str, float]]]:
    """Compact cumulative delta for the coordinator push; None when
    disabled or nothing changed since the last export."""
    t = active()
    if not t.enabled:
        return None
    snap = t.registry.export(dirty_only=True)
    if not snap["c"] and not snap["g"]:
        return None
    return snap


def dump_flight(reason: str, directory: Optional[str] = None) -> Optional[str]:
    """Atomically dump the ring to ``flight_<rank>.jsonl``.

    Safe on the ``os._exit`` paths (no atexit reliance); returns the
    path, or None when telemetry is disabled or no dump dir is known.
    Re-entrant calls re-dump — last writer wins, which is fine because
    later dumps strictly contain more history.
    """
    t = active()
    if not t.enabled:
        return None
    d = directory or os.environ.get(FLIGHT_DIR_ENV)
    if not d:
        return None
    try:
        with t._dump_lock:
            t.ring.record("flight_dump", reason=reason, rank=t.rank)
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, "flight_%d.jsonl" % t.rank)
            return t.ring.dump(path)
    except OSError as exc:  # a dying process must never die *harder* here
        get_logger().warning("flight dump failed: %s", exc)
        return None


# -- incident assembly (launcher side) -----------------------------------

def load_flight_dumps(directory: str) -> Dict[int, List[Dict[str, Any]]]:
    """Read every ``flight_<rank>.jsonl`` under ``directory``."""
    out: Dict[int, List[Dict[str, Any]]] = {}
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for fn in names:
        if not (fn.startswith("flight_") and fn.endswith(".jsonl")):
            continue
        try:
            rank = int(fn[len("flight_"):-len(".jsonl")])
        except ValueError:
            continue
        events = []
        try:
            with open(os.path.join(directory, fn)) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        events.append(json.loads(line))
        except (OSError, ValueError):
            continue
        out[rank] = events
    return out


def assemble_incident(directory: str, failure_seq: int,
                      journal_tail: Optional[List[Dict[str, Any]]] = None,
                      coordinator_metrics: Optional[Dict[Any, Any]] = None,
                      failure: Optional[Dict[str, Any]] = None,
                      tail: int = INCIDENT_TAIL) -> Optional[str]:
    """Line up every surviving rank's last events around the failure.

    Writes ``incident_<failure_seq>.json`` into ``directory`` (atomic),
    embedding the per-rank event tails, the coordinator journal tail and
    the coordinator's last per-rank metrics snapshot (which carries the
    *victim's* last-known step even though the victim never dumped).
    """
    dumps = load_flight_dumps(directory)
    # Name the rollback target: the newest manifest any rank published
    # before the failure. The caller's failure dict (the launcher scans the
    # commit dir) wins; otherwise fall back to the manifest_publish events
    # in the rank dumps.
    last_manifest = (failure or {}).get("last_manifest")
    if last_manifest is None:
        seqs = [ev.get("seq") for evs in dumps.values() for ev in evs
                if ev.get("kind") == "manifest_publish"
                and ev.get("seq") is not None]
        last_manifest = max(seqs) if seqs else None
    report = {
        "failure_seq": int(failure_seq),
        "created": time.time(),
        "failure": failure or {},
        "last_manifest": last_manifest,
        "ranks": {str(r): evs[-tail:] for r, evs in sorted(dumps.items())},
        "journal_tail": list(journal_tail or []),
        "coordinator_metrics": {
            str(k): v for k, v in (coordinator_metrics or {}).items()},
    }
    path = os.path.join(directory, "incident_%d.json" % int(failure_seq))
    tmp = "%s.tmp.%d" % (path, os.getpid())
    try:
        with open(tmp, "w") as f:
            json.dump(report, f, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError as exc:
        get_logger().warning("incident assembly failed: %s", exc)
        return None
    get_logger().info("telemetry: incident report %s (%d rank dumps)",
                      path, len(dumps))
    return path
