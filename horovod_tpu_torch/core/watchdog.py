"""Step deadline monitor: failure containment for the data plane.

Counterpart of ``horovod_tpu/core/watchdog.py``. In upstream Horovod the
collective itself errors when a peer dies (an NCCL abort, a Gloo timeout)
and the worker raises ``HorovodInternalError``, which ``@hvd.elastic.run``
catches. A step whose NCCL kernel waits on a peer that hung never errors:
the card spins in the kernel and the host waits forever. This module bounds
that wait.

- :func:`monitored_call` runs the step on a watcher-visible daemon thread
  (the device set in it, as in the caller), records a CUDA event after it
  and waits on that event there, while the caller waits in short ticks
  against the deadline. On expiry the caller unblocks: every
  ``torch.distributed`` communicator is aborted, so the next collective
  fails fast instead of queuing behind the hung NCCL kernel, and
  ``HorovodInternalError`` is raised — or the process hard-exits with
  ``RESTART_EXIT_CODE`` (73) when ``HOROVOD_STEP_TIMEOUT_ACTION=exit``.
- Per-step heartbeats (:meth:`StepMonitor.heartbeat`) expose steps
  completed and in-flight seconds, through the telemetry registry too.
- :meth:`StepMonitor.step_span` is the heartbeat window without the
  thread, for ``DistributedOptimizer.step``.
- :meth:`StepMonitor.notify_peer_failure` and
  :meth:`StepMonitor.clear_peer_failure` are the hooks through which a
  peer-liveness watcher arms a short grace deadline on the in-flight step.
  The watcher that polls an elastic coordinator for peer deaths belongs to
  the port's host runtime, a later slice (ROADMAP.md, section A).

Deadlines (env-driven, 0 disables):

- ``HOROVOD_STEP_TIMEOUT_SECONDS`` — ceiling on one monitored step. The
  first call of each step kind gets it times
  ``HOROVOD_STEP_TIMEOUT_COMPILE_MULTIPLIER`` (default 10): it builds the
  kernels and makes the NCCL communicators.
- ``HOROVOD_PEER_FAILURE_GRACE_SECONDS`` — how long after a peer-death
  notification the in-flight step may still complete. Default 5.

With no deadline armed ``monitored_call`` is a direct call — no thread, no
event, no wait.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, Optional

from . import telemetry as _telemetry
from .exceptions import HorovodInternalError
from .logging import get_logger

#: env: absolute per-step deadline in seconds (0 = disabled).
STEP_TIMEOUT_ENV = "HOROVOD_STEP_TIMEOUT_SECONDS"

#: env: grace window after a peer-death notification (0 = disabled).
PEER_GRACE_ENV = "HOROVOD_PEER_FAILURE_GRACE_SECONDS"

#: env: step-timeout scale for the first invocation of each step kind.
COMPILE_MULT_ENV = "HOROVOD_STEP_TIMEOUT_COMPILE_MULTIPLIER"

#: env: "raise" (default) raises HorovodInternalError in the blocked
#: caller; "exit" hard-exits with RESTART_EXIT_CODE, for callers that
#: cannot unwind (a process whose NCCL kernel never finishes cannot free
#: the card's work queue; exiting lets the launcher relaunch it).
ACTION_ENV = "HOROVOD_STEP_TIMEOUT_ACTION"

DEFAULT_PEER_GRACE_S = 5.0
DEFAULT_COMPILE_MULT = 10.0

#: watcher/caller tick, seconds.
_TICK_S = 0.25


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return float(v)
    except ValueError:
        return default


def _is_runtime_error(exc: BaseException) -> bool:
    """True for collective failures a dead or aborted peer produces:
    ``torch.distributed``'s errors (gloo's connection reset, NCCL's abort
    and watchdog errors). Matched by name: the concrete types move between
    torch versions."""
    for klass in type(exc).__mro__:
        if klass.__name__ in ("DistBackendError", "DistNetworkError",
                              "DistError"):
            return True
    return False


def abort_communicators() -> bool:
    """Abort every ``torch.distributed`` communicator of this process (the
    world and its groups, NCCL's ``ncclCommAbort`` on the card), so a
    collective queued behind a hung one fails at once instead of waiting.
    The world is gone afterwards: the next collective raises, and a
    recovery starts a new one. True when there was a world to abort."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return False
    from torch.distributed import distributed_c10d as c10d
    c10d._abort_process_group()
    return True


class StepMonitor:
    """Process-wide monitor of train steps (one per process — use the
    module-level :func:`monitor` accessor)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._steps_completed = 0
        self._inflight_since: Optional[float] = None
        self._inflight_what: Optional[str] = None
        # Peer death: (monotonic time observed, description).
        self._peer_failure: Optional[tuple] = None
        # Completions per step kind: the first of a kind builds kernels and
        # communicators and gets the compile multiplier on its deadline.
        self._completed_by_what: Dict[str, int] = {}
        self._queue = None         # fetch-thread work queue, lazy
        self._last_step_end: Optional[float] = None
        #: Set when an expiry aborted the communicators.
        self.aborted: Optional[str] = None

    # -- configuration (re-read per step: tests and launchers set env late) --

    @property
    def step_timeout_s(self) -> float:
        return _env_float(STEP_TIMEOUT_ENV, 0.0)

    @property
    def peer_grace_s(self) -> float:
        return _env_float(PEER_GRACE_ENV, DEFAULT_PEER_GRACE_S)

    @property
    def compile_mult(self) -> float:
        return max(_env_float(COMPILE_MULT_ENV, DEFAULT_COMPILE_MULT), 1.0)

    @property
    def action(self) -> str:
        return os.environ.get(ACTION_ENV, "raise").lower()

    # -- heartbeats ---------------------------------------------------------

    def heartbeat(self) -> Dict[str, Any]:
        """Step progress snapshot, published through the telemetry registry
        too (``hvd_heartbeat_*`` and ``hvd_sentinel_*`` gauges). The keys
        are the reference's; the port has no coordinator client, so
        ``control_plane_lost`` is always None."""
        from . import sentinel as _sentinel
        with self._lock:
            now = time.monotonic()
            hb = {
                "steps_completed": self._steps_completed,
                "in_flight": self._inflight_since is not None,
                "in_flight_what": self._inflight_what,
                "in_flight_seconds": (now - self._inflight_since
                                      if self._inflight_since is not None
                                      else 0.0),
                "peer_failure": (self._peer_failure[1]
                                 if self._peer_failure else None),
                "control_plane_lost": None,
                "sentinel": _sentinel.counters(),
            }
        _telemetry.set_gauge("hvd_heartbeat_steps_completed",
                             hb["steps_completed"])
        _telemetry.set_gauge("hvd_heartbeat_in_flight",
                             1.0 if hb["in_flight"] else 0.0)
        _telemetry.set_gauge("hvd_heartbeat_in_flight_seconds",
                             hb["in_flight_seconds"])
        for k, v in hb["sentinel"].items():
            _telemetry.set_gauge("hvd_sentinel_%s" % k, float(v))
        return hb

    # -- peer liveness (hooks) ------------------------------------------------

    def notify_peer_failure(self, info: str) -> None:
        """Arm the peer-death deadline on the in-flight step (called by a
        peer-liveness watcher; tests inject directly)."""
        first = False
        with self._lock:
            if self._peer_failure is None:
                self._peer_failure = (time.monotonic(), info)
                first = True
        if first:
            _telemetry.inc("hvd_peer_failures_total")
            _telemetry.record_event("rescue", reason=info,
                                    grace_s=self.peer_grace_s)
            _telemetry.dump_flight("peer_failure")
        get_logger().warning(
            "peer failure notified: %s — arming %.1fs grace deadline on "
            "the in-flight step (%s)", info, self.peer_grace_s,
            PEER_GRACE_ENV)

    def clear_peer_failure(self) -> None:
        with self._lock:
            self._peer_failure = None

    # -- deadline evaluation ------------------------------------------------

    def deadline_reason(self, started: float,
                        timeout_scale: float = 1.0) -> Optional[str]:
        """Why the in-flight step (started at monotonic ``started``) must
        be abandoned now — or None."""
        now = time.monotonic()
        timeout = self.step_timeout_s * timeout_scale
        if timeout > 0 and now - started >= timeout:
            scaled = (f" x{timeout_scale:.0f} first-call allowance "
                      f"({COMPILE_MULT_ENV})" if timeout_scale != 1.0
                      else "")
            return (f"step exceeded {STEP_TIMEOUT_ENV}="
                    f"{self.step_timeout_s:g}s{scaled}")
        with self._lock:
            pf = self._peer_failure
        if pf is not None and now - pf[0] >= self.peer_grace_s:
            return (f"peer died ({pf[1]}); in-flight collective cannot "
                    f"complete ({PEER_GRACE_ENV}={self.peer_grace_s:g}s "
                    "elapsed)")
        return None

    def armed(self) -> bool:
        if self.step_timeout_s > 0:
            return True
        with self._lock:
            return self._peer_failure is not None and self.peer_grace_s > 0

    # -- heartbeat-only spans (DistributedOptimizer.step) ----------------------

    def step_span(self, what: str = "step"):
        """Heartbeat window WITHOUT moving the call to the fetch thread —
        for ``DistributedOptimizer.step`` called by a user's loop: it keeps
        the heartbeat honest and the step telemetry flowing."""
        import contextlib

        @contextlib.contextmanager
        def span():
            with self._lock:
                started = self._inflight_since = time.monotonic()
                self._inflight_what = what
            self._note_step_begin(what, started)
            try:
                yield
                with self._lock:
                    self._steps_completed += 1
                self._note_step_done(what, started)
            finally:
                with self._lock:
                    self._inflight_since = None
                    self._inflight_what = None
        return span()

    # -- the monitored call -------------------------------------------------

    def _note_step_begin(self, what: str, now: float) -> None:
        """The gap since the previous step's end is the host-side data wait
        (``hvd_step_data_wait_seconds``). Host clocks only."""
        with self._lock:
            last_end = self._last_step_end
        if last_end is not None:
            _telemetry.set_gauge("hvd_step_data_wait_seconds",
                                 max(now - last_end, 0.0), what=what)
        _telemetry.record_event("step_begin", what=what)

    def _note_step_done(self, what: str, started: Optional[float]) -> None:
        """Per-step counters, histogram and a ring event, from host scalars
        the monitor already holds."""
        end = time.monotonic()
        dt = (end - started) if started is not None else 0.0
        with self._lock:
            n = self._steps_completed
            self._last_step_end = end
        _telemetry.inc("hvd_steps_total", what=what)
        _telemetry.observe("hvd_step_seconds", dt, what=what)
        _telemetry.set_gauge("hvd_last_step", n)
        _telemetry.set_gauge("hvd_step_wall_seconds", dt, what=what)
        _telemetry.record_event("step_end", what=what, step=n,
                                seconds=round(dt, 6))

    def _fetch_worker(self, q, device) -> None:
        """Fetch-thread loop. DAEMON on purpose: after a deadline expiry it
        stays parked in the dead collective; a non-daemon thread there would
        hang interpreter shutdown. The worker owns ``q`` (never reads
        ``self._queue`` for work): after an expiry it must exit instead of
        racing a replacement worker for the new queue's items."""
        import torch
        if device is not None:
            torch.cuda.set_device(device)
        while self._queue is q:
            fn, box = q.get()
            try:
                box["result"] = fn()
            except BaseException as e:   # noqa: BLE001 — relayed to caller
                box["error"] = e
            box["done"].set()

    def _fail(self, reason: str):
        msg = (f"monitored step abandoned: {reason}; the data-plane "
               "transport is considered lost — re-init required")
        with self._lock:
            # The fetch thread is parked in the dead collective; orphan it
            # (daemon) so a later step gets a fresh worker.
            self._queue = None
        get_logger().error("%s", msg)
        _telemetry.inc("hvd_watchdog_expiries_total")
        _telemetry.record_event("watchdog_expiry", reason=reason)
        # Dump BEFORE the exit below: os._exit skips atexit hooks.
        _telemetry.dump_flight("watchdog_expiry")
        if self.action == "exit":
            from .sentinel import RESTART_EXIT_CODE
            os._exit(RESTART_EXIT_CODE)
        if abort_communicators():
            self.aborted = reason
        raise HorovodInternalError(msg)

    def monitored_call(self, fn: Callable[[], Any],
                       what: str = "train_step") -> Any:
        """Run ``fn`` (one step) and wait until the card has finished its
        work, under the step and peer deadlines. Unarmed: a direct call
        with only heartbeat accounting."""
        begun = time.monotonic()
        with self._lock:
            self._inflight_since = begun
            self._inflight_what = what
            first_of_kind = self._completed_by_what.get(what, 0) == 0
        scale = self.compile_mult if first_of_kind else 1.0
        self._note_step_begin(what, begun)
        try:
            if not self.armed():
                out = fn()
                self._complete(what, begun)
                return out
            if self._queue is None:
                import queue

                import torch
                q = self._queue = queue.Queue()
                device = (torch.cuda.current_device()
                          if torch.cuda.is_available()
                          and torch.cuda.is_initialized() else None)
                threading.Thread(target=self._fetch_worker,
                                 args=(q, device), daemon=True,
                                 name="hvd-step-fetch").start()

            def run_and_wait():
                import torch
                out = fn()
                if torch.cuda.is_available() and torch.cuda.is_initialized():
                    # The step's kernels, NCCL's included, are done when
                    # the event recorded after them is.
                    ev = torch.cuda.Event()
                    ev.record()
                    ev.synchronize()
                return out

            box = {"done": threading.Event()}
            self._queue.put((run_and_wait, box))
            while True:
                if box["done"].wait(timeout=_TICK_S):
                    if "error" in box:
                        err = box["error"]
                        if _is_runtime_error(err):
                            raise HorovodInternalError(
                                f"collective runtime error inside "
                                f"monitored {what}: {err}") from err
                        raise err
                    self._complete(what, begun)
                    return box["result"]
                reason = self.deadline_reason(begun, timeout_scale=scale)
                if reason is not None:
                    return self._fail(reason)
        finally:
            with self._lock:
                self._inflight_since = None
                self._inflight_what = None

    def _complete(self, what: str, started: float) -> None:
        with self._lock:
            self._steps_completed += 1
            self._completed_by_what[what] = \
                self._completed_by_what.get(what, 0) + 1
        self._note_step_done(what, started)


_monitor: Optional[StepMonitor] = None
_monitor_lock = threading.Lock()


def monitor() -> StepMonitor:
    """The process-wide StepMonitor."""
    global _monitor
    if _monitor is None:
        with _monitor_lock:
            if _monitor is None:
                _monitor = StepMonitor()
    return _monitor


def monitored_step(fn: Callable, what: str = "train_step") -> Callable:
    """Wrap a step callable so every call runs under the monitor. Armed,
    the wrapped step returns after the card has finished it. Attributes a
    step carries (``sentinel``, ``chosen``) pass through."""
    def wrapped(*args, **kwargs):
        return monitor().monitored_call(lambda: fn(*args, **kwargs),
                                        what=what)
    for attr in ("sentinel", "chosen"):
        if hasattr(fn, attr):
            setattr(wrapped, attr, getattr(fn, attr))
    wrapped.__wrapped__ = fn
    return wrapped
