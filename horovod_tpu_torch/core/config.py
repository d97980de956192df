"""Typed config mapping the reference's ``HOROVOD_*`` env surface.

The port's own copy of ``horovod_tpu/core/config.py``: the same fields, read
from the same environment variables with the same defaults, so that under one
environment both packages configure alike. On the GPU the knobs mean what
they meant in the original Horovod again:

- ``HOROVOD_FUSION_THRESHOLD`` (bytes) caps the gradient buckets that
  ``DistributedOptimizer`` and ``grouped_allreduce`` pack before one NCCL
  all-reduce each (``collectives/ops.py::plan_buckets``); ``0`` sends one
  collective per tensor.
- ``HOROVOD_AUTOTUNE`` and its sample counts drive ``train.make_train_step``'s
  live tuning of that threshold (``tools/autotune.py``);
  ``HOROVOD_SENTINEL`` and its skip and rollback bounds the numeric-integrity
  sentinel (``core/sentinel.py``); ``HOROVOD_CYCLE_TIME`` the idle wait of
  the frontend's negotiation thread (``frontend/mpi_ops.py``).
- The rest of the surface (elastic, timeline, stall checks) is parsed for
  script compatibility and read by the later slices of the port.

Precedence matches the reference: explicit argument > env > default.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return int(v)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return float(v)
    except ValueError:
        return default


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v.lower() in ("1", "true", "yes", "on")


def resolve_fusion_threshold_bytes() -> int:
    """The fusion threshold every gradient bucketer uses: the initialised
    context's config, else the environment. 0 disables fusion (reference
    semantics); an uncapped context value means one bucket per dtype,
    returned as a cap no bucket reaches."""
    from ..collectives.ops import _fusion_threshold
    from . import context_api as _ctx
    t = _fusion_threshold()
    if t is None:
        if _ctx.is_initialized():
            return 1 << 62  # context says uncapped: one bucket
        t = Config.from_env().fusion_threshold_bytes
    return int(t)


@dataclasses.dataclass
class Config:
    """Runtime configuration, populated from the ``HOROVOD_*`` env surface."""

    # Fusion. Reference: fusion_buffer_manager.cc.
    fusion_threshold_bytes: int = 64 * 1024 * 1024
    cycle_time_ms: float = 1.0
    cache_capacity: int = 1024
    cache_verify_every: int = 0
    hierarchical_allreduce: bool = False
    hierarchical_allgather: bool = False
    hierarchical_compression: str = "none"
    # Observability. Reference: timeline.cc, stall_inspector.cc.
    timeline_path: Optional[str] = None
    timeline_mark_cycles: bool = False
    stall_check_disable: bool = False
    stall_check_warning_sec: float = 60.0
    stall_check_shutdown_sec: float = 0.0  # 0 = never hard-shutdown
    # Autotune. Reference: parameter_manager.cc.
    autotune: bool = False
    autotune_log: Optional[str] = None
    autotune_warmup_samples: int = 3
    autotune_steps_per_sample: int = 10
    autotune_max_samples: int = 20
    # Adasum numerics. Reference: ops/adasum/adasum.h.
    adasum_accumulate_dtype: str = "float32"
    mismatch_check: bool = False
    # Numeric-integrity sentinel.
    sentinel: bool = False
    sentinel_max_skips: int = 3
    sentinel_max_rollbacks: int = 1
    # Elastic.
    elastic_timeout_sec: float = 600.0
    # Control plane.
    coordinator_rpc_retries: int = 3
    coordinator_rpc_timeout_sec: float = 5.0
    coordinator_lost_timeout_sec: float = 120.0

    @classmethod
    def from_env(cls) -> "Config":
        timeline = os.environ.get("HOROVOD_TIMELINE") or None
        autotune_log = os.environ.get("HOROVOD_AUTOTUNE_LOG") or None
        adasum_dtype = "float64" if _env_bool(
            "HOROVOD_ADASUM_ACCUMULATE_FP64", False) else "float32"
        return cls(
            fusion_threshold_bytes=_env_int(
                "HOROVOD_FUSION_THRESHOLD", 64 * 1024 * 1024),
            cycle_time_ms=_env_float("HOROVOD_CYCLE_TIME", 1.0),
            cache_capacity=_env_int("HOROVOD_CACHE_CAPACITY", 1024),
            cache_verify_every=_env_int("HOROVOD_CACHE_VERIFY_EVERY", 0),
            hierarchical_allreduce=_env_bool(
                "HOROVOD_HIERARCHICAL_ALLREDUCE", False),
            hierarchical_allgather=_env_bool(
                "HOROVOD_HIERARCHICAL_ALLGATHER", False),
            hierarchical_compression=os.environ.get(
                "HOROVOD_HIERARCHICAL_COMPRESSION", "none").lower() or "none",
            timeline_path=timeline,
            timeline_mark_cycles=_env_bool("HOROVOD_TIMELINE_MARK_CYCLES",
                                           False),
            stall_check_disable=_env_bool("HOROVOD_STALL_CHECK_DISABLE",
                                          False),
            stall_check_warning_sec=_env_float(
                "HOROVOD_STALL_CHECK_TIME_SECONDS", 60.0),
            stall_check_shutdown_sec=_env_float(
                "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", 0.0),
            autotune=_env_bool("HOROVOD_AUTOTUNE", False),
            autotune_log=autotune_log,
            autotune_warmup_samples=_env_int(
                "HOROVOD_AUTOTUNE_WARMUP_SAMPLES", 3),
            autotune_steps_per_sample=_env_int(
                "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", 10),
            autotune_max_samples=_env_int(
                "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", 20),
            adasum_accumulate_dtype=adasum_dtype,
            mismatch_check=_env_bool("HOROVOD_MISMATCH_CHECK", False),
            sentinel=_env_bool("HOROVOD_SENTINEL", False),
            sentinel_max_skips=_env_int("HOROVOD_SENTINEL_MAX_SKIPS", 3),
            sentinel_max_rollbacks=_env_int(
                "HOROVOD_SENTINEL_MAX_ROLLBACKS", 1),
            elastic_timeout_sec=_env_float("HOROVOD_ELASTIC_TIMEOUT", 600.0),
            coordinator_rpc_retries=_env_int(
                "HOROVOD_COORDINATOR_RPC_RETRIES", 3),
            coordinator_rpc_timeout_sec=_env_float(
                "HOROVOD_COORDINATOR_RPC_TIMEOUT_SECONDS", 5.0),
            coordinator_lost_timeout_sec=_env_float(
                "HOROVOD_COORDINATOR_LOST_TIMEOUT_SECONDS", 120.0),
        )
