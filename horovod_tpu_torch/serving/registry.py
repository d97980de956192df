"""Serving-side model registry: the served model and its RCU swap surface.

Counterpart of ``ServedModel`` and the request-path surface of
``ModelRegistry`` in ``horovod_tpu/serving/registry.py``. The served model
is one attribute: :meth:`ModelRegistry.current` hands out a reference,
and a request keeps the exact generation it grabbed while a swap lands,
so no lock sits on the request path. ``clock`` is injectable for the
staleness math.

Adoption from a content-addressed store (``adopt``, ``poll_coordinator``,
``poll_store`` and the delta fetch behind them) is not ported: it rides on
the checkpoint store and the elastic coordinator, which the port does not
have yet (ROADMAP.md, section A). Until then a caller places a
:class:`ServedModel` itself, and a decode engine takes weights through
``DecodeEngine.install_params``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional


class ServedModel:
    """One immutable served generation (the RCU payload)."""

    __slots__ = ("payload", "record", "manifest_seq", "leaves_digest",
                 "adopted_at")

    def __init__(self, payload: Any, record: Dict, manifest_seq: int,
                 digest: str, adopted_at: float):
        self.payload = payload
        self.record = record
        self.manifest_seq = manifest_seq
        self.leaves_digest = digest
        self.adopted_at = adopted_at


class ModelRegistry:
    """Holds the served-model pointer for one serving process."""

    def __init__(self, clock: Callable[[], float] = time.time):
        self._clock = clock
        self._current: Optional[ServedModel] = None
        self._swap_listeners: list = []

    def current(self) -> Optional[ServedModel]:
        """The served model: one attribute read, never a lock. Callers hold
        the returned reference for the whole request so a concurrent swap
        cannot mix generations within it."""
        return self._current

    def add_swap_listener(self, fn: Callable[[ServedModel], None]) -> None:
        """Register a callback run after every swap (the decode engine's
        wake)."""
        self._swap_listeners.append(fn)

    def staleness_s(self) -> Optional[float]:
        """now - publish time of the served model (the
        ``hvd_serving_staleness_seconds`` gauge), or None before the first
        model."""
        cur = self._current
        if cur is None:
            return None
        return max(0.0, self._clock() - float(cur.record.get("time", 0.0)))
