"""HTTP inference server: dynamic batching over a hot-swappable model.

The port's copy of ``horovod_tpu/serving/server.py``. The serve path keeps
its invariants:

- **Bounded shapes**: requests are coalesced within a short window
  (``HOROVOD_SERVING_BATCH_WINDOW_MS``) and padded up to one of a fixed
  set of bucket sizes (``HOROVOD_SERVING_BUCKETS``), so the forward sees
  only ``len(buckets)`` batch shapes, whatever the traffic.
- **No dropped requests across swaps**: the batcher reads
  ``registry.current()`` once per batch (RCU, ``serving/registry.py``)
  and uses that reference for the whole device call; a swap landing
  mid-batch affects only the next batch.
- **Overload degrades, never cascades**: admission is bounded. A request
  arriving past ``HOROVOD_SERVING_QUEUE_MAX`` queued requests is shed with
  429 and ``Retry-After``. Requests may carry a deadline (JSON
  ``deadline_s`` or the ``X-HVD-Deadline-S`` header); expired ones are
  dropped before batching. ``drain()`` stops admission (503), finishes the
  in-flight work, then fires the drained callbacks.

The model-specific half (stacking request dicts, padding to ``n``,
calling the model, unstacking) lives in the ``forward`` callable,
``forward(payload, inputs, padded_n) -> list of per-request results``, so
the server stays workload-agnostic.

Surfaces: ``POST /predict``; ``POST /generate`` (autoregressive decode
through an attached ``serving.decode.DecodeEngine``); ``GET /healthz``
(readiness: 503 while draining, before a model is placed, or when the
served model is staler than ``HOROVOD_SERVING_MAX_STALENESS_SECONDS``);
``GET /livez`` (liveness: 200 whenever the process serves HTTP); and
``GET /metrics``, the Prometheus text of ``core/telemetry.py`` with the
``hvd_serving_*`` series under this process's serving rank label.

It keeps the request counter (``_req_count``) that the reference's replica
fault schedule reads; the ``replica_kill`` and ``replica_hang`` faults
themselves, and the publish watcher (``start_watch``), come with the
fault harness and the registry's adoption from a store, which the port
does not have yet.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, List, Optional, Sequence, Tuple

from ..core import telemetry as _telemetry
from ..core.logging import get_logger
from . import constants as SC
from .registry import ModelRegistry


def pad_to_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest configured bucket >= ``n`` (the largest bucket caps the
    batch size the batcher assembles, so ``n`` always fits)."""
    for b in buckets:
        if n <= b:
            return int(b)
    return int(buckets[-1])


def jsonable(value: Any) -> Any:
    """Best-effort JSON coercion for forward outputs (numpy and torch
    scalars and arrays)."""
    if hasattr(value, "tolist"):
        return value.tolist()
    if hasattr(value, "item"):
        return value.item()
    return value


class _Pending:
    __slots__ = ("inputs", "event", "result", "error", "status",
                 "model_seq", "t0", "deadline")

    def __init__(self, inputs: Any, t0: float,
                 deadline: Optional[float] = None):
        self.inputs = inputs
        self.event = threading.Event()
        self.result: Any = None
        self.error: Optional[str] = None
        #: HTTP status the handler replies with when ``error`` is set.
        self.status = 503
        self.model_seq: Optional[int] = None
        self.t0 = t0
        #: Absolute ``time.monotonic()`` drop-dead time (None = none).
        self.deadline = deadline


class InferenceServer:
    """One serving process: HTTP frontend and batcher."""

    def __init__(self, registry: ModelRegistry,
                 forward: Callable[[Any, List[Any], int], List[Any]],
                 bind_host: str = "127.0.0.1",
                 buckets: Optional[Sequence[int]] = None,
                 window_s: Optional[float] = None,
                 request_timeout_s: float = 30.0,
                 rank: Optional[int] = None,
                 decode_engine: Optional[Any] = None):
        self.registry = registry
        self._forward = forward
        # Optional continuous-batching decode engine (serving/decode.py):
        # /generate admits into its slot array; its step loop runs on the
        # engine's own thread so prefill stalls never block /predict.
        self.decode_engine = decode_engine
        if decode_engine is not None:
            # A tp engine takes its weights through install_params on
            # every rank; one process's engine follows the registry.
            if decode_engine.registry is None \
                    and getattr(decode_engine, "tp", 1) == 1:
                decode_engine.registry = registry
            registry.add_swap_listener(
                lambda _cur: decode_engine._work.set())
            decode_engine.start()
        self._buckets = tuple(sorted(int(b) for b in (buckets
                                                      or SC.buckets())))
        self._window_s = SC.batch_window_s() if window_s is None \
            else float(window_s)
        self._request_timeout_s = float(request_timeout_s)
        self._rank = SC.serving_rank() if rank is None else int(rank)
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._closing = False
        self._draining = False
        # Admitted-but-unanswered requests (queued + in-flight): what
        # drain() waits on. Separate from qsize() — a request leaves the
        # queue when the batcher picks it up but is settled only when its
        # event fires.
        self._pending_lock = threading.Lock()
        self._pending_n = 0
        self._req_count = 0          # the replica fault schedule's axis
        self._drained_callbacks: List[Callable[[], None]] = []

        srv = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, obj, code=200, headers=None):
                body = json.dumps(obj).encode()
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    for k, v in (headers or {}).items():
                        self.send_header(k, v)
                    self.end_headers()
                    self.wfile.write(body)
                except (OSError, ValueError):
                    pass

            def _reply_text(self, text: str, code=200):
                body = text.encode()
                try:
                    self.send_response(code)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except (OSError, ValueError):
                    pass

            def do_GET(self):
                if self.path == "/metrics":
                    self._reply_text(srv.metrics_text())
                    return
                if self.path == "/livez":
                    # Liveness only: the process is up and serving HTTP.
                    # Restart decisions key off this; routing decisions
                    # key off /healthz.
                    self._reply({"ok": True})
                    return
                if self.path == "/healthz":
                    # Readiness: can this replica answer a request RIGHT
                    # NOW? Not while draining, not before a model landed,
                    # not when the served model went stale past the
                    # configured ceiling (a replica that lost its publish
                    # feed must fall out of the routing set, not serve
                    # ancient weights forever).
                    cur = srv.registry.current()
                    stale = srv.registry.staleness_s()
                    ceiling = SC.max_staleness_s()
                    ready = (cur is not None and not srv._draining
                             and not srv._closing
                             and not (ceiling > 0 and stale is not None
                                      and stale > ceiling))
                    self._reply(
                        {"ok": ready,
                         "draining": srv._draining,
                         "staleness_s": stale,
                         "model_seq": None if cur is None
                         else cur.manifest_seq},
                        200 if ready else 503)
                    return
                self._reply({"error": "not found"}, 404)

            def _deadline_s(self, body) -> Optional[float]:
                """Per-request deadline budget (seconds): JSON
                ``deadline_s`` (popped — the forward never sees it) wins
                over the ``X-HVD-Deadline-S`` header."""
                raw = None
                if isinstance(body, dict) and "deadline_s" in body:
                    raw = body.pop("deadline_s")
                else:
                    raw = self.headers.get("X-HVD-Deadline-S")
                if raw is None:
                    return None
                try:
                    return max(0.0, float(raw))
                except (TypeError, ValueError):
                    return None

            def _shed(self, reason: str):
                """One shed reply: 429 + Retry-After. Never a hang, never
                a 500 — the client's failover/backoff loop needs a crisp
                signal, immediately."""
                retry = SC.shed_retry_after_s()
                self._reply({"ok": False, "error": reason,
                             "retry_after_s": retry}, 429,
                            headers={"Retry-After": f"{retry:g}"})

            def do_POST(self):
                if self.path == "/generate":
                    self._do_generate()
                    return
                if self.path != "/predict":
                    self._reply({"error": "not found"}, 404)
                    return
                n = int(self.headers.get("Content-Length", "0"))
                try:
                    inputs = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:
                    _telemetry.inc("hvd_serving_request_failures_total")
                    self._reply({"ok": False, "error": "bad json"}, 400)
                    return
                deadline_s = self._deadline_s(inputs)
                pending, refusal = srv._admit(inputs, deadline_s)
                if pending is None:
                    if refusal == "draining":
                        _telemetry.inc("hvd_serving_request_failures_total")
                        self._reply({"ok": False, "error": "draining"}, 503)
                    else:
                        self._shed(refusal)
                    return
                if not pending.event.wait(srv._request_timeout_s):
                    _telemetry.inc("hvd_serving_request_failures_total")
                    self._reply({"ok": False, "error": "timeout"}, 504)
                    return
                if pending.error is not None:
                    _telemetry.inc("hvd_serving_request_failures_total")
                    self._reply({"ok": False, "error": pending.error},
                                pending.status)
                    return
                _telemetry.inc("hvd_serving_requests_total")
                _telemetry.observe("hvd_serving_request_seconds",
                                   time.perf_counter() - pending.t0)
                self._reply({"ok": True,
                             "result": jsonable(pending.result),
                             "model_seq": pending.model_seq})

            def _do_generate(self):
                if srv.decode_engine is None:
                    self._reply({"ok": False,
                                 "error": "no decode engine attached"}, 404)
                    return
                if srv._draining or srv._closing:
                    _telemetry.inc("hvd_serving_request_failures_total")
                    self._reply({"ok": False, "error": "draining"}, 503)
                    return
                srv._count_request()
                n = int(self.headers.get("Content-Length", "0"))
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                    prompt = [int(t) for t in body["tokens"]]
                    max_new = body.get("max_new")
                    if max_new is not None:
                        max_new = int(max_new)
                except (ValueError, KeyError, TypeError):
                    _telemetry.inc("hvd_serving_request_failures_total")
                    self._reply({"ok": False, "error": "bad json"}, 400)
                    return
                req = srv.decode_engine.submit(prompt, max_new)
                if not req.event.wait(srv._request_timeout_s):
                    _telemetry.inc("hvd_serving_request_failures_total")
                    self._reply({"ok": False, "error": "timeout"}, 504)
                    return
                if req.error is not None:
                    _telemetry.inc("hvd_serving_request_failures_total")
                    self._reply({"ok": False, "error": req.error}, 503)
                    return
                _telemetry.inc("hvd_serving_requests_total")
                self._reply({"ok": True, "tokens": req.tokens,
                             "truncated": req.truncated,
                             "ttft_s": req.ttft_s,
                             "model_seq": req.model_seq})

        self._server = ThreadingHTTPServer((bind_host, 0), Handler)
        self._http_thread = threading.Thread(
            target=self._server.serve_forever, name="hvd-serve-http",
            daemon=True)
        self._http_thread.start()
        self._batch_thread = threading.Thread(
            target=self._batch_loop, name="hvd-serve-batcher", daemon=True)
        self._batch_thread.start()

    # -- frontend helpers ----------------------------------------------------

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def addr(self) -> str:
        return f"{self._server.server_address[0]}:{self.port}"

    def metrics_text(self) -> str:
        snap = _telemetry.active().registry.export()
        return _telemetry.render_prometheus({self._rank: snap})

    def _count_request(self) -> None:
        """Bump the admitted-request counter (the axis the reference's
        replica fault schedule reads)."""
        with self._pending_lock:
            self._req_count += 1

    def _admit(self, inputs: Any,
               deadline_s: Optional[float] = None
               ) -> Tuple[Optional[_Pending], Optional[str]]:
        """Bounded admission. Returns ``(pending, None)`` on admit, or
        ``(None, reason)`` — "draining" (503) when the replica is being
        reclaimed, "overloaded" (429 + Retry-After) when the queue is at
        ``HOROVOD_SERVING_QUEUE_MAX``. Shedding at the door is the
        containment: past the bound, every queued request is latency
        nobody asked for and timeout-retry amplification downstream."""
        if self._draining or self._closing:
            return None, "draining"
        qmax = SC.queue_max()
        if qmax > 0 and self._queue.qsize() >= qmax:
            _telemetry.inc("hvd_serving_shed_total")
            return None, "overloaded"
        self._count_request()
        deadline = None if deadline_s is None \
            else time.monotonic() + deadline_s
        pending = _Pending(inputs, time.perf_counter(), deadline)
        with self._pending_lock:
            self._pending_n += 1
        self._queue.put(pending)
        _telemetry.set_gauge("hvd_serving_queue_depth",
                             float(self._queue.qsize()))
        return pending, None

    def _settle(self, pending: _Pending) -> None:
        """Fire the waiter and release the drain accounting — every
        admitted request passes through exactly once (result, error, or
        deadline drop)."""
        pending.event.set()
        with self._pending_lock:
            self._pending_n -= 1

    # -- the batcher ---------------------------------------------------------

    def _collect(self) -> Optional[List[_Pending]]:
        """Block for the first request, then coalesce arrivals within the
        batching window, capped at the largest bucket."""
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return None
        batch = [first]
        cap = self._buckets[-1]
        deadline = time.monotonic() + self._window_s
        while len(batch) < cap:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _batch_loop(self) -> None:
        while not self._closing:
            batch = self._collect()
            if batch is None:
                continue
            # Deadline propagation: drop expired requests BEFORE padding
            # and the device call — device time spent on an answer whose
            # waiter already gave up is pure overload amplification.
            now = time.monotonic()
            live = []
            for p in batch:
                if p.deadline is not None and now > p.deadline:
                    _telemetry.inc("hvd_serving_deadline_dropped_total")
                    p.error = "deadline exceeded"
                    p.status = 504
                    self._settle(p)
                else:
                    live.append(p)
            if not live:
                continue
            batch = live
            # One bucketed shape per batch: the forward only ever sees
            # len(buckets) shapes, whatever the traffic does.
            padded = pad_to_bucket(len(batch), self._buckets)
            cur = self.registry.current()
            try:
                if cur is None:
                    raise RuntimeError("no model published yet")
                outs = self._forward(cur.payload,
                                     [p.inputs for p in batch], padded)
                if len(outs) != len(batch):
                    raise RuntimeError(
                        f"forward returned {len(outs)} results for "
                        f"{len(batch)} requests")
            except Exception as err:    # noqa: BLE001 — per-batch containment
                get_logger().error("serving batch failed: %s", err)
                for p in batch:
                    p.error = str(err)
                    self._settle(p)
                continue
            _telemetry.inc("hvd_serving_batches_total")
            _telemetry.inc("hvd_serving_padded_examples_total",
                           float(padded - len(batch)))
            _telemetry.set_gauge("hvd_serving_queue_depth",
                                 float(self._queue.qsize()))
            stale = self.registry.staleness_s()
            if stale is not None:
                _telemetry.set_gauge("hvd_serving_staleness_seconds", stale)
            for p, out in zip(batch, outs):
                p.result = out
                p.model_seq = cur.manifest_seq
                self._settle(p)

    # -- graceful drain (the arbiter's reclaim primitive) --------------------

    def add_drained_callback(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` once :meth:`drain` finishes (serving/fleet.py hangs
        the coordinator deregistration here)."""
        self._drained_callbacks.append(fn)

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Stop admitting (new requests get 503 and /healthz goes
        not-ready immediately), finish every in-flight request, then fire
        the drained callbacks (deregistration). Returns True when the
        backlog fully settled inside ``timeout_s`` — False means
        stragglers remain (their waiters still get answers or their own
        timeouts; the callbacks fire either way, because a half-drained
        replica must still leave the routing set)."""
        self._draining = True
        _telemetry.set_gauge("hvd_serving_draining", 1.0)
        get_logger().info("serving: draining (pending=%d)", self._pending_n)
        deadline = time.monotonic() + max(0.0, timeout_s)
        settled = False
        while time.monotonic() < deadline:
            with self._pending_lock:
                n = self._pending_n
            if n <= 0 and self._queue.qsize() == 0:
                settled = True
                break
            time.sleep(0.005)
        for fn in self._drained_callbacks:
            try:
                fn()
            except Exception as err:    # noqa: BLE001 — best-effort
                get_logger().warning("drained callback failed: %s", err)
        _telemetry.inc("hvd_serving_drains_total")
        get_logger().info("serving: drain %s",
                          "complete" if settled else "timed out")
        return settled

    @property
    def draining(self) -> bool:
        return self._draining

    def close(self) -> None:
        self._closing = True
        if self.decode_engine is not None:
            self.decode_engine.close()
        self._server.shutdown()
        self._server.server_close()
        self._batch_thread.join(timeout=5)
