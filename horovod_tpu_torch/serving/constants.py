"""Serving-plane configuration knobs.

The port's own copy of ``horovod_tpu/serving/constants.py``, every knob
and default unchanged: every knob is ``HOROVOD_*``, read lazily at use so
tests can flip them per case. The tp knob (``HOROVOD_DECODE_TP``) names
the width of a tp process group here (one process a card), not a count of
local devices.
"""

from __future__ import annotations

import os

#: Publish cadence: every Nth committed generation that passes the gate
#: is published (0 disables publishing entirely).
PUBLISH_EVERY_ENV = "HOROVOD_PUBLISH_EVERY"
DEFAULT_PUBLISH_EVERY = 1

#: How many published manifests stay pinned against GC. Must be >= 2 so
#: the previously-served manifest survives while a swap to the newest is
#: in flight (the registry may still delta-fetch against it).
PUBLISH_KEEP_ENV = "HOROVOD_PUBLISH_KEEP"
DEFAULT_PUBLISH_KEEP = 2

#: Serving-side discovery cadence (seconds) when NOT long-polling (the
#: store-watch mode's pin scan, and the floor between long-poll rounds).
SERVING_POLL_ENV = "HOROVOD_SERVING_POLL_SECONDS"
DEFAULT_SERVING_POLL_S = 1.0

#: Long-poll bound (seconds) the registry's coordinator watcher parks
#: for (clamped server-side to elastic LONG_POLL_CAP_S).
SERVING_LONG_POLL_ENV = "HOROVOD_SERVING_LONG_POLL_SECONDS"
DEFAULT_SERVING_LONG_POLL_S = 30.0

#: Dynamic-batching window (milliseconds): how long the batcher waits to
#: coalesce queued requests into one bucketed device call.
BATCH_WINDOW_ENV = "HOROVOD_SERVING_BATCH_WINDOW_MS"
DEFAULT_BATCH_WINDOW_MS = 2.0

#: Comma-separated ascending bucket sizes the batcher pads into — the
#: complete set of batch shapes the jitted forward will ever see, so
#: compiles are bounded by len(buckets), not by traffic.
BUCKETS_ENV = "HOROVOD_SERVING_BUCKETS"
DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)

#: Rank label serving metrics are pushed/rendered under — far above any
#: real training rank so fleet rollups keep serving separable.
SERVING_RANK_ENV = "HOROVOD_SERVING_RANK"
DEFAULT_SERVING_RANK = 900

#: Decode-path knobs (docs/serving.md "Decode path") — the continuous
#: batching engine's slot width: how many sequences one decode step
#: advances. Fixed for the serving lifetime (the decode program compiles
#: exactly once).
DECODE_SLOTS_ENV = "HOROVOD_DECODE_SLOTS"
DEFAULT_DECODE_SLOTS = 8

#: Tokens per KV block. Prefill buckets must be multiples of this.
DECODE_BLOCK_SIZE_ENV = "HOROVOD_DECODE_BLOCK_SIZE"
DEFAULT_DECODE_BLOCK_SIZE = 16

#: Total blocks in the preallocated device pool (block 0 is reserved).
DECODE_POOL_BLOCKS_ENV = "HOROVOD_DECODE_POOL_BLOCKS"
DEFAULT_DECODE_POOL_BLOCKS = 128

#: Block-table width per slot — caps a sequence's context at
#: ``max_blocks_per_slot * block_size`` positions.
DECODE_MAX_BLOCKS_ENV = "HOROVOD_DECODE_MAX_BLOCKS_PER_SLOT"
DEFAULT_DECODE_MAX_BLOCKS = 8

#: Comma-separated ascending PROMPT buckets (token positions, not batch
#: size) the prefill pads into — one compile each, same discipline as
#: BUCKETS_ENV for the /predict batcher.
DECODE_PREFILL_BUCKETS_ENV = "HOROVOD_DECODE_PREFILL_BUCKETS"
DEFAULT_DECODE_PREFILL_BUCKETS = (16, 32, 64)

#: Default generation budget when a request does not name one.
DECODE_MAX_NEW_ENV = "HOROVOD_DECODE_MAX_NEW"
DEFAULT_DECODE_MAX_NEW = 64

#: What the engine does with LIVE slots when the registry hot-swaps:
#: "refill" re-prefills them under the new weights (block tables
#: remapped), "drain" finishes them on the old weights first.
DECODE_SWAP_POLICY_ENV = "HOROVOD_DECODE_SWAP_POLICY"
DEFAULT_DECODE_SWAP_POLICY = "refill"

#: Tensor-parallel width of the decode plane (docs/serving.md "Sharded
#: decode"). 0/1 = single-device decode; N > 1 builds a ``tp`` mesh over
#: the first N local devices and runs the shard_map'd decode/prefill
#: programs (heads and expert hidden dims split, KV pools head-sharded).
DECODE_TP_ENV = "HOROVOD_DECODE_TP"
DEFAULT_DECODE_TP = 0

#: Admission-queue bound (docs/fleet.md "Overload containment"): a
#: ``/predict`` arriving while this many requests are already queued is
#: SHED — 429 + ``Retry-After`` — instead of admitted. Bounding the
#: queue is what keeps overload from cascading: an unbounded queue turns
#: a traffic spike into unbounded latency for EVERY request (each waits
#: behind the spike), then into timeout storms and retry amplification.
#: 0 = unbounded (the pre-fleet behavior; the
#: ``lint-unbounded-admission`` trap flags handler code written that
#: way).
QUEUE_MAX_ENV = "HOROVOD_SERVING_QUEUE_MAX"
DEFAULT_QUEUE_MAX = 256

#: ``Retry-After`` seconds advertised on shed (429) replies.
SHED_RETRY_AFTER_ENV = "HOROVOD_SERVING_RETRY_AFTER_SECONDS"
DEFAULT_SHED_RETRY_AFTER_S = 1.0

#: Readiness gate (GET /healthz): a replica whose served model is staler
#: than this is NOT ready (503) — the fleet's replica list must never
#: route traffic to a replica that lost its publish feed. 0 disables the
#: staleness gate (liveness stays on GET /livez either way).
MAX_STALENESS_ENV = "HOROVOD_SERVING_MAX_STALENESS_SECONDS"
DEFAULT_MAX_STALENESS_S = 0.0

#: Speculative-decode window width (docs/serving.md "Speculative
#: decode"): tokens scored per verify call = 1 pending token + K-1
#: host-drafted candidates. 0 (or 1) disables speculation — the engine
#: runs today's single-token decode program byte-identically. K >= 2
#: replaces the decode call with ONE verify call per tick; greedy
#: longest-matching-prefix acceptance keeps the stream lossless.
DECODE_SPEC_K_ENV = "HOROVOD_DECODE_SPEC_K"
DEFAULT_DECODE_SPEC_K = 0


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


def publish_every() -> int:
    return _env_int(PUBLISH_EVERY_ENV, DEFAULT_PUBLISH_EVERY)


def publish_keep() -> int:
    # >= 2 by contract: the previous publish must stay fetchable during
    # a swap to the newest one.
    return max(2, _env_int(PUBLISH_KEEP_ENV, DEFAULT_PUBLISH_KEEP))


def serving_poll_s() -> float:
    return max(0.01, _env_float(SERVING_POLL_ENV, DEFAULT_SERVING_POLL_S))


def serving_long_poll_s() -> float:
    return max(0.0, _env_float(SERVING_LONG_POLL_ENV,
                               DEFAULT_SERVING_LONG_POLL_S))


def batch_window_s() -> float:
    return max(0.0, _env_float(BATCH_WINDOW_ENV,
                               DEFAULT_BATCH_WINDOW_MS)) / 1e3


def buckets() -> tuple:
    raw = os.environ.get(BUCKETS_ENV, "")
    if not raw:
        return DEFAULT_BUCKETS
    try:
        sizes = sorted({int(x) for x in raw.split(",") if x.strip()})
    except ValueError:
        return DEFAULT_BUCKETS
    return tuple(s for s in sizes if s > 0) or DEFAULT_BUCKETS


def serving_rank() -> int:
    return _env_int(SERVING_RANK_ENV, DEFAULT_SERVING_RANK)


def decode_slots() -> int:
    return max(1, _env_int(DECODE_SLOTS_ENV, DEFAULT_DECODE_SLOTS))


def decode_block_size() -> int:
    return max(1, _env_int(DECODE_BLOCK_SIZE_ENV, DEFAULT_DECODE_BLOCK_SIZE))


def decode_pool_blocks() -> int:
    return max(2, _env_int(DECODE_POOL_BLOCKS_ENV,
                           DEFAULT_DECODE_POOL_BLOCKS))


def decode_max_blocks_per_slot() -> int:
    return max(1, _env_int(DECODE_MAX_BLOCKS_ENV, DEFAULT_DECODE_MAX_BLOCKS))


def decode_prefill_buckets() -> tuple:
    raw = os.environ.get(DECODE_PREFILL_BUCKETS_ENV, "")
    if not raw:
        return DEFAULT_DECODE_PREFILL_BUCKETS
    try:
        sizes = sorted({int(x) for x in raw.split(",") if x.strip()})
    except ValueError:
        return DEFAULT_DECODE_PREFILL_BUCKETS
    return tuple(s for s in sizes if s > 0) or DEFAULT_DECODE_PREFILL_BUCKETS


def decode_max_new() -> int:
    return max(1, _env_int(DECODE_MAX_NEW_ENV, DEFAULT_DECODE_MAX_NEW))


def decode_swap_policy() -> str:
    v = os.environ.get(DECODE_SWAP_POLICY_ENV, "").strip().lower()
    return v if v in ("refill", "drain") else DEFAULT_DECODE_SWAP_POLICY


def decode_tp() -> int:
    return max(0, _env_int(DECODE_TP_ENV, DEFAULT_DECODE_TP))


def decode_spec_k() -> int:
    return max(0, _env_int(DECODE_SPEC_K_ENV, DEFAULT_DECODE_SPEC_K))


def queue_max() -> int:
    return max(0, _env_int(QUEUE_MAX_ENV, DEFAULT_QUEUE_MAX))


def shed_retry_after_s() -> float:
    return max(0.0, _env_float(SHED_RETRY_AFTER_ENV,
                               DEFAULT_SHED_RETRY_AFTER_S))


def max_staleness_s() -> float:
    return max(0.0, _env_float(MAX_STALENESS_ENV, DEFAULT_MAX_STALENESS_S))
