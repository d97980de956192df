"""Numeric-integrity sentinel: the in-step health probe and the
containment ladder.

Counterpart of ``horovod_tpu/core/sentinel.py``. Upstream Horovod's
coordinator cross-checks each tensor's dtype, shape and op across ranks,
which catches structural divergence only; a rank whose gradient values are
NaN, or whose replica of the parameters took a flipped bit, all-reduces its
poison into every peer. The sentinel closes that gap:

- :func:`health_vector` — a per-rank ``[grads_finite, grad_sqnorm,
  param_digest]`` float32 triple, gathered to ``[n, 3]`` by one small
  all-gather. The digest is the folded XOR of the parameters' f32 bit
  patterns, bitcast into the f32 lane (a collective moves bytes and does no
  arithmetic on them), so a replica that diverged shows as a fingerprint
  minority. ``DistributedOptimizer`` builds the same vector from its
  gradient buckets before their all-reduces (``optimizer/distributed.py``),
  so the finite bit and the squared norm are this rank's own, as JAX's
  ``health_vector(grads, ...)`` sees the local gradients.
- :func:`decode_health` — the host's view of the gathered ``[n, 3]``.
- :class:`Sentinel` — the ladder, copied from the reference: **skip** (the
  update is not applied; bounded by ``HOROVOD_SENTINEL_MAX_SKIPS``) →
  **rollback** (``rollback_fn``, else ``HorovodInternalError``; bounded by
  ``HOROVOD_SENTINEL_MAX_ROLLBACKS``) → **evict** (the fingerprint-minority
  or non-finite-minority rank exits ``EVICT_EXIT_CODE`` under an elastic
  launcher).

On the card the digest is plain torch on ``int32`` views, an XOR fold by
halving, leaf by leaf and in chunks of :data:`DIGEST_CHUNK` elements, so
its temporaries stay small beside a model of billions of parameters; the
reference computes it in ``jnp`` outside any Pallas kernel. It is
bit-equal to JAX's on the same bytes: XOR is order-free and the zero
padding JAX adds to a power of 2 changes nothing.

Env knobs: ``HOROVOD_SENTINEL`` (off by default),
``HOROVOD_SENTINEL_MAX_SKIPS`` (3), ``HOROVOD_SENTINEL_MAX_ROLLBACKS`` (1).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, Optional

import numpy as np
import torch

from .exceptions import HorovodInternalError
from .logging import get_logger

SENTINEL_ENV = "HOROVOD_SENTINEL"
MAX_SKIPS_ENV = "HOROVOD_SENTINEL_MAX_SKIPS"
MAX_ROLLBACKS_ENV = "HOROVOD_SENTINEL_MAX_ROLLBACKS"

#: Exit codes of the elastic launcher's protocol (the port's copy of
#: ``horovod_tpu/elastic/constants.py``): a worker that must be relaunched
#: exits ``RESTART_EXIT_CODE``; a rank voted corrupt exits
#: ``EVICT_EXIT_CODE`` and the launcher bans its host.
RESTART_EXIT_CODE = 73
EVICT_EXIT_CODE = 75
#: The environment an elastic launcher gives its workers.
COORD_ADDR_ENV = "HOROVOD_ELASTIC_COORD_ADDR"
WORLD_VERSION_ENV = "HOROVOD_ELASTIC_WORLD_VERSION"

#: Health-vector lanes: [grads_finite, grad_sqnorm, param_digest].
HEALTH_WIDTH = 3

COUNTER_KEYS = ("steps_skipped", "rollbacks", "evictions",
                "last_fingerprint_mismatch_step")

#: Elements of a leaf folded at a time by :func:`param_digest`.
DIGEST_CHUNK = 1 << 26


# ---------------------------------------------------------------------------
# The probe (tensors stay on their device; nothing here waits for it)
# ---------------------------------------------------------------------------

def _float_leaves(tensors: Iterable[torch.Tensor]) -> List[torch.Tensor]:
    return [t for t in tensors if t is not None and t.is_floating_point()
            and not t.is_sparse]


def grads_finite(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """0-d bool: every float tensor of ``grads`` is fully finite. The max
    of ``|g|`` is NaN or inf exactly when some element is, and never
    overflows."""
    leaves = _float_leaves(grads)
    if not leaves:
        return torch.ones((), dtype=torch.bool)
    peaks = torch._foreach_norm(leaves, float("inf"))
    return torch.stack([p.float() for p in peaks]).isfinite().all()


def grad_sqnorm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """0-d f32: the sum of the squared f32 entries of ``grads``."""
    leaves = _float_leaves(grads)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    norms = torch._foreach_norm(leaves, 2, dtype=torch.float32)
    return torch.stack(norms).square().sum()


def _xor_fold(bits: torch.Tensor) -> torch.Tensor:
    """XOR-reduce a flat int32 tensor by halving (log2(n) vectorised
    XORs); a 0-d int32. The first halving reads ``bits`` and writes a
    half-size copy, the rest work in place on it."""
    acc = torch.zeros((), dtype=torch.int32, device=bits.device)
    n = bits.numel()
    if n == 0:
        return acc
    if n % 2:
        acc = acc ^ bits[-1]
        n -= 1
    if n == 0:
        return acc
    h = n // 2
    x = torch.bitwise_xor(bits[:h], bits[h:n])
    n = h
    while n > 1:
        if n % 2:
            acc = acc ^ x[n - 1]
            n -= 1
        h = n // 2
        x[:h].bitwise_xor_(x[h:n])
        n = h
    return acc ^ x[0]


def param_digest(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """Folded-XOR fingerprint (0-d int32; JAX's uint32 bits) of the float
    tensors' f32 bit patterns. Bit-exact replicas fold to the same word; a
    single flipped mantissa bit on one replica changes it. A bf16 or f16
    leaf is widened to f32 first, as JAX's ``astype(float32)``; XOR does
    no arithmetic, so NaN payload bits survive."""
    leaves = _float_leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")
    acc = torch.zeros((), dtype=torch.int32, device=device)
    with torch.no_grad():
        for leaf in leaves:
            flat = leaf.detach().reshape(-1)
            for chunk in flat.split(DIGEST_CHUNK):
                acc = acc ^ _xor_fold(chunk.float().view(torch.int32))
    return acc


def local_health(finite: torch.Tensor, sqnorm: torch.Tensor,
                 digest: torch.Tensor) -> torch.Tensor:
    """This rank's ``[3]`` f32 row; the digest's bits ride the f32 lane."""
    return torch.stack([finite.to(torch.float32).reshape(()),
                        sqnorm.to(torch.float32).reshape(()),
                        digest.reshape(()).view(torch.float32)])


def health_vector(grads, params, process_set=None, gather: bool = True
                  ) -> torch.Tensor:
    """The health probe over this rank's ``grads`` and ``params``: an
    ``[n, HEALTH_WIDTH]`` f32 tensor, one row per member of
    ``process_set`` (``[1, 3]`` with ``gather=False``: the mesh form, where
    each rank holds different blocks and fingerprints are not compared).
    One small all-gather."""
    grads, params = list(grads), list(params)
    row = local_health(grads_finite(grads), grad_sqnorm(grads),
                       param_digest(params))
    return gather_health(row, process_set if gather else False)


def gather_health(row: torch.Tensor, process_set=None) -> torch.Tensor:
    """All-gather each rank's ``[3]`` row into ``[n, 3]``; ``False``
    gathers nothing (``[1, 3]``)."""
    row = row.reshape(1, HEALTH_WIDTH)
    if process_set is False:
        return row
    from ..collectives import ops as _ops
    from . import context_api as _ctx
    if not _ctx.is_initialized() or _ops._set_size(process_set) == 1:
        return row
    return _ops.allgather(row, process_set=process_set)


class Health(NamedTuple):
    """Host-side decode of one step's gathered health vector."""
    finite: bool                 # all ranks' grads fully finite
    finite_by_rank: np.ndarray   # bool [n]
    grad_norm: float             # global L2 norm (NaN when non-finite)
    fingerprints: np.ndarray     # uint32 [n] param digests


def decode_health(raw) -> Health:
    """Decode the ``[n, HEALTH_WIDTH]`` vector on the host. Fingerprints
    are compared as BIT PATTERNS (uint32 view), never as floats — a digest
    whose bits happen to spell NaN must still compare equal to itself."""
    if isinstance(raw, torch.Tensor):
        raw = raw.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(raw, np.float32)
                             ).reshape(-1, HEALTH_WIDTH)
    finite_by_rank = a[:, 0] >= 1.0
    sq = float(a[:, 1].astype(np.float64).sum())
    return Health(
        finite=bool(finite_by_rank.all()),
        finite_by_rank=finite_by_rank,
        grad_norm=float(np.sqrt(sq)) if sq >= 0.0 else float("nan"),
        fingerprints=np.ascontiguousarray(a[:, 2]).view(np.uint32).copy(),
    )


# ---------------------------------------------------------------------------
# Policy engine (the reference's, line for line)
# ---------------------------------------------------------------------------

class SentinelAction(NamedTuple):
    kind: str                    # ok | skip | rollback | evict | abort
    rank: Optional[int] = None   # evict target (health-row == rank index)
    reason: str = ""


def _minority_ranks(values: np.ndarray) -> Optional[np.ndarray]:
    """Indices holding a STRICT minority value (fewer than half). None
    when no strict minority exists (ties — e.g. 1v1 — are unattributable
    and must not evict an innocent rank)."""
    vals, inverse, counts = np.unique(values, return_inverse=True,
                                      return_counts=True)
    if len(vals) < 2:
        return None
    minority = counts < (len(values) / 2.0)
    if not minority.any():
        return None
    return np.nonzero(minority[inverse])[0]


class Sentinel:
    """The skip → rollback → evict containment ladder.

    Pure host-side state machine: :meth:`observe` consumes one decoded
    :class:`Health` per step and returns the action the caller applies.
    ``clock`` is injectable; it only timestamps the history — every
    decision is step-counted, never wall-clocked.

    Hooks: ``rollback_fn(state) -> state`` restores the last verified state
    in process (when None, rollback raises ``HorovodInternalError``, the
    reference's escalation to the elastic restore); ``evict_fn(action)``
    carries out an eviction (default: :func:`default_evict`).
    """

    def __init__(self, max_skips: Optional[int] = None,
                 max_rollbacks: Optional[int] = None, *,
                 rank: Optional[int] = None,
                 rollback_fn: Optional[Callable[[Any], Any]] = None,
                 evict_fn: Optional[Callable[[SentinelAction], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        from .config import _env_int
        self.max_skips = (_env_int(MAX_SKIPS_ENV, 3)
                          if max_skips is None else int(max_skips))
        self.max_rollbacks = (_env_int(MAX_ROLLBACKS_ENV, 1)
                              if max_rollbacks is None
                              else int(max_rollbacks))
        self.rank = rank
        self.rollback_fn = rollback_fn
        self.evict_fn = evict_fn
        self.clock = clock
        self.steps_skipped = 0
        self.rollbacks = 0
        self.evictions = 0
        self.last_fingerprint_mismatch_step = -1
        #: True while the step dispatcher should run the no-update probe
        #: step (consecutive bad steps; cleared on the first healthy step).
        self.in_containment = False
        self._consecutive_bad = 0
        self.history: List[tuple] = []   # (t, kind, step, reason)

    @classmethod
    def from_env(cls, **kw) -> "Sentinel":
        return cls(**kw)

    def counters(self) -> Dict[str, int]:
        return {k: getattr(self, k) for k in COUNTER_KEYS}

    def _note(self, action: SentinelAction, step: int) -> SentinelAction:
        if action.kind != "ok":
            self.history.append((self.clock(), action.kind, step,
                                 action.reason))
            get_logger().warning("sentinel: %s at step %d (%s)",
                                 action.kind, step, action.reason)
            from . import telemetry as _telemetry
            _telemetry.inc("hvd_sentinel_verdicts_total", kind=action.kind)
            _telemetry.record_event("sentinel", verdict=action.kind,
                                    step=step, rank=action.rank,
                                    reason=action.reason,
                                    in_containment=self.in_containment)
        return action

    def observe(self, health: Health, step: int) -> SentinelAction:
        """One step's verdict. Every rank holds the SAME gathered health
        vector, so every rank computes the SAME action — the eviction vote
        needs no extra agreement round."""
        n = len(health.finite_by_rank)
        if n > 1 and len(np.unique(health.fingerprints)) > 1:
            # Desync cannot be skipped away: the corrupt replica stays
            # corrupt. Identify and evict the minority immediately.
            self.last_fingerprint_mismatch_step = step
            minority = _minority_ranks(health.fingerprints)
            if minority is None:
                return self._note(SentinelAction(
                    "abort", None,
                    "parameter fingerprints diverged with no strict "
                    "minority — unattributable desync"), step)
            self.evictions += 1
            return self._note(SentinelAction(
                "evict", int(minority[0]),
                f"parameter fingerprint minority (ranks {minority.tolist()}"
                f" of {n})"), step)

        if health.finite:
            self._consecutive_bad = 0
            self.in_containment = False
            return SentinelAction("ok")

        self._consecutive_bad += 1
        if self._consecutive_bad <= self.max_skips:
            self.steps_skipped += 1
            self.in_containment = True
            return self._note(SentinelAction(
                "skip", None,
                f"non-finite gradients ({self._consecutive_bad}/"
                f"{self.max_skips} consecutive skips)"), step)

        if self.rollbacks < self.max_rollbacks:
            self.rollbacks += 1
            self._consecutive_bad = 0
            self.in_containment = True
            return self._note(SentinelAction(
                "rollback", None,
                "skip budget exhausted — restoring last verified commit"),
                step)

        bad = np.nonzero(~health.finite_by_rank)[0]
        if n > 1 and 0 < len(bad) < n / 2.0:
            self.evictions += 1
            return self._note(SentinelAction(
                "evict", int(bad[0]),
                f"persistent non-finite gradients from minority ranks "
                f"{bad.tolist()} after rollback"), step)
        return self._note(SentinelAction(
            "abort", None,
            "persistent non-finite gradients with no attributable "
            "minority rank"), step)

    def observe_finite(self, finite: bool, step: int) -> SentinelAction:
        """Feed a bare local finiteness bit as a 1-rank health vector."""
        return self.observe(Health(
            finite=bool(finite),
            finite_by_rank=np.asarray([bool(finite)]),
            grad_norm=float("nan"),
            fingerprints=np.zeros(1, np.uint32)), step)

    def do_rollback(self, state):
        """Apply a rollback action: in-process restore through the hook.
        The port has no verified commit to restore yet (the elastic
        runtime is a later slice), so without a hook this raises
        ``HorovodInternalError``, the reference's behaviour when
        ``rollback_fn`` is None."""
        from . import telemetry as _telemetry
        _telemetry.record_event(
            "sentinel_rollback",
            manifest_seq=getattr(state, "_commit_seq", None))
        if self.rollback_fn is not None:
            return self.rollback_fn(state)
        raise HorovodInternalError(
            "sentinel rollback: no in-process rollback hook — escalating "
            "to the elastic restore path (last verified commit)")

    def do_evict(self, action: SentinelAction) -> None:
        if self.evict_fn is not None:
            self.evict_fn(action)
            return
        default_evict(action)


def _world_rank() -> Optional[int]:
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        return dist.get_rank()
    return None


def default_evict(action: SentinelAction) -> None:
    """Carry out an eviction vote. Under an elastic launcher the voted rank
    hard-exits ``EVICT_EXIT_CODE`` (the launcher bans its host and relaunches
    without it; the survivors' ``HorovodInternalError`` rides the restart
    path). Outside a launcher nobody can shrink the world, so every rank
    raises ``HorovodInternalError``. ``abort`` always raises."""
    under_launcher = bool(os.environ.get(COORD_ADDR_ENV)
                        or os.environ.get(WORLD_VERSION_ENV))
    my_rank = _world_rank()
    if (action.kind == "evict" and under_launcher and my_rank is not None
            and my_rank == action.rank):
        get_logger().error(
            "sentinel: this rank (%d) was voted corrupt — exiting with "
            "EVICT_EXIT_CODE=%d (%s)", my_rank, EVICT_EXIT_CODE,
            action.reason)
        # Hard exit (no atexit): a rank voted corrupt must not run teardown
        # collectives against its peers. Dump the flight ring first.
        from . import telemetry as _telemetry
        _telemetry.record_event("evict_exit", rank=my_rank,
                                reason=action.reason)
        _telemetry.dump_flight("sentinel_evict")
        os._exit(EVICT_EXIT_CODE)
    raise HorovodInternalError(
        f"sentinel {action.kind}: rank {action.rank} voted corrupt "
        f"({action.reason}) — recovering from last verified commit")


# ---------------------------------------------------------------------------
# Process-wide registry: metrics and heartbeats read the active sentinel.
# ---------------------------------------------------------------------------

_active: Optional[Sentinel] = None
_active_lock = threading.Lock()


def enabled() -> bool:
    """Is the sentinel requested by ``HOROVOD_SENTINEL``? (Step factories
    also accept an explicit instance, which wins.)"""
    from .config import _env_bool
    return _env_bool(SENTINEL_ENV, False)


def install(s: Optional[Sentinel]) -> Optional[Sentinel]:
    """Register ``s`` as the process-wide sentinel (latest wins; None
    uninstalls)."""
    global _active
    with _active_lock:
        _active = s
    return s


def active() -> Optional[Sentinel]:
    return _active


def resolve(spec) -> Optional[Sentinel]:
    """Normalize a step factory's ``sentinel=`` argument: None → the
    context's config (``HOROVOD_SENTINEL``); True → a fresh env-configured
    instance; an instance passes through. Any resulting instance is
    installed."""
    if isinstance(spec, Sentinel):
        return install(spec)
    if spec is None:
        from . import context_api as _ctx
        if _ctx.is_initialized():
            spec = _ctx.context().config.sentinel
        else:
            spec = enabled()
    if not spec:
        return None
    return install(Sentinel.from_env())


def counters() -> Dict[str, int]:
    """The active sentinel's counters (zeros / -1 when none is active)."""
    s = active()
    if s is not None:
        return s.counters()
    return {k: (-1 if k == "last_fingerprint_mismatch_step" else 0)
            for k in COUNTER_KEYS}
