"""Continuous-batching decode engine over the paged KV cache.

Counterpart of ``horovod_tpu/serving/decode.py`` (``BlockAllocator``,
``DecodeRequest``, ``DecodeEngine``), built on ``models/decode.py``:

- a :class:`BlockAllocator` hands out fixed-size KV blocks from the
  preallocated pool (block 0 is the null block masked slots point at);
  any free block serves any slot, so allocation fails only when the pool
  is exhausted;
- a fixed-width slot array: requests are admitted into free slots at
  prefill (one prompt shape a configured bucket) and retired per step;
  between admissions the decode step keeps stepping with an active mask,
  so the steps see one input shape whatever the traffic does
  (``compile_counts`` counts the distinct input shapes each function has
  seen: JAX counts compiles, and each compile is one shape);
- the sampled tokens stay on the card between ticks, fed back as a tensor;
  their values are read only at retire, at refill and in the speculative
  tick's one ``[S, K]`` fetch.

Weight hot-swap (``HOROVOD_DECODE_SWAP_POLICY``): each tick reads the
current weights once (the registry's RCU pointer or
:meth:`DecodeEngine.install_params`). On new weights the engine either
refills (re-prefills every live slot's sequence so far under the new
weights into fresh blocks; a sequence past the largest prefill bucket
retires early, ``truncated``) or drains (admits nothing, finishes the
in-flight slots on the old weights, adopts the new ones once idle).

Speculative decode (``spec_k`` / ``HOROVOD_DECODE_SPEC_K``): with K >= 2
each tick is one K-wide verify call; K - 1 candidates come from a host
n-gram drafter over the tokens the engine holds, and greedy
longest-matching-prefix acceptance emits 1..K tokens a slot, the plain
stream's tokens. K = 0 keeps the plain path, and no verify function is
built.

**Host arrays never reach a step by reference.** Every host array a step
reads (positions, tables, the masks, the drafts) is copied into a tensor
the step owns before the call (``torch.tensor`` copies), so the engine may
change its arrays right after the call. The JAX engine hands
``self._positions`` to its step through ``jnp.asarray`` and then changes
it in place; on the CPU jax may alias the buffer, and streams fork.

**Tensor parallelism** (``mesh=`` with a ``tp`` axis, or
``HOROVOD_DECODE_TP``): every rank of the tp group runs this engine on its
shard of the weights (``models.decode.decode_shard``) and its heads' slice
of the pools, and every rank takes the same decisions on the same tick.
Rank 0 of the group alone takes requests, weight installs and close; at
the start of each tick it broadcasts what is new to the others over a
gloo group of the same ranks (CPU tensors, no wait for the card), and
every rank then runs the same host logic on the same inputs. The tp
all-reduces give every rank the same logits, so the same greedy tokens.
Weights reach a tp engine through ``install_params`` on every rank (each
its own shard); rank 0's call decides the tick at which all ranks adopt
them.
"""

from __future__ import annotations

import collections
import datetime
import queue
import threading
import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core import telemetry as _telemetry
from ..core.logging import get_logger
from ..models import decode as MD
from ..models.llama import _default_device
from . import constants as SC
from .server import pad_to_bucket

FREE = "free"
ACTIVE = "active"

#: How long a tp follower waits for its own ``install_params`` after rank
#: 0's install reached it.
INSTALL_WAIT_S = 600.0


def _ngram_draft(ctx: Sequence[int], n: int, max_ngram: int = 3) -> List[int]:
    """Prompt-lookup drafting: the ``n`` tokens that followed the most
    recent earlier occurrence of the longest matching suffix n-gram
    (``max_ngram`` down to 1) in ``ctx`` (prompt + accepted tokens). Host
    Python over host ints, by design: the verify side is one call a tick.
    Falls back to repeating the last token when nothing matches."""
    L = len(ctx)
    for m in range(min(max_ngram, L - 1), 0, -1):
        suffix = list(ctx[L - m:])
        for start in range(L - m - 1, -1, -1):
            if list(ctx[start:start + m]) == suffix:
                cont = [int(t) for t in ctx[start + m:start + m + n]]
                if cont:
                    return (cont + [cont[-1]] * n)[:n]
    last = int(ctx[-1]) if L else 0
    return [last] * n


class BlockAllocator:
    """Free-list allocator over KV pool blocks ``1..n_blocks-1`` (block 0
    is the reserved null block)."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is reserved)")
        self.n_blocks = int(n_blocks)
        self._free = list(range(self.n_blocks - 1, 0, -1))
        self._held = set()

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def alloc(self) -> Optional[int]:
        """One block id, or None when the pool is exhausted."""
        if not self._free:
            return None
        b = self._free.pop()
        self._held.add(b)
        return b

    def alloc_many(self, n: int) -> Optional[List[int]]:
        """``n`` blocks all-or-nothing (admission must not half-allocate)."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self._held.update(out)
        return out

    def free(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            if b not in self._held:
                raise ValueError(f"double free / foreign block {b}")
            self._held.discard(b)
            self._free.append(int(b))


class DecodeRequest:
    """One generation request: submitted, admitted into a slot, completed
    at retire (``event`` fires; ``tokens`` = prompt + generated)."""

    __slots__ = ("prompt", "max_new", "event", "tokens", "error",
                 "truncated", "model_seq", "t0", "ttft_s",
                 "queue_wait_s", "prefill_wall_s")

    def __init__(self, prompt: Sequence[int], max_new: int):
        self.prompt = [int(t) for t in prompt]
        self.max_new = int(max_new)
        self.event = threading.Event()
        self.tokens: Optional[List[int]] = None
        self.error: Optional[str] = None
        self.truncated = False
        self.model_seq: Optional[int] = None
        self.t0 = time.perf_counter()
        self.ttft_s: Optional[float] = None
        #: the time to the first token, split: queued before the winning
        #: admission pass, and the prefill's wall (launch + first token).
        self.queue_wait_s: Optional[float] = None
        self.prefill_wall_s: Optional[float] = None


class _Slot:
    __slots__ = ("state", "req", "pos", "table", "gen", "gen_toks",
                 "stalled", "pending")

    def __init__(self):
        self.state = FREE
        self.req: Optional[DecodeRequest] = None
        self.pos = 0
        self.table: List[int] = []
        self.gen = 0
        #: generated tokens, in order. Plain mode: tensor refs, (tensor,
        #: idx) picks ``tensor[idx]`` (idx None: a 0-d tensor), read only at
        #: retire or refill. Spec mode: host ints.
        self.gen_toks: List[Any] = []
        self.stalled = False
        #: spec mode only: the pending token (sampled, K/V not yet
        #: written) as a host int, window position 0 of the next verify.
        self.pending: Optional[int] = None


class _ShapeCounted:
    """A step function that counts, in ``counts[name]``, the distinct
    input shapes it has been called with."""

    def __init__(self, fn, counts, name):
        self._fn, self._counts, self._name = fn, counts, name
        self._seen = set()

    def __call__(self, params, *args):
        key = tuple(tuple(a.shape) for a in args)
        if key not in self._seen:
            self._seen.add(key)
            self._counts[self._name] += 1
        return self._fn(params, *args)


class DecodeEngine:
    """Continuous batching over one model configuration. Weights come from
    a ``ModelRegistry`` (hot-swappable; one process only) or from
    ``params`` and :meth:`install_params` (each call after the first is a
    swap). ``params`` are the decode parameters
    (``export_decode_params``), under tp this rank's shard. ``device``
    defaults to the context's device, else ``"cuda"``: without a card
    the engine raises."""

    def __init__(self, cfg, registry=None, params=None, *,
                 slots: Optional[int] = None,
                 block_size: Optional[int] = None,
                 pool_blocks: Optional[int] = None,
                 max_blocks_per_slot: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 swap_policy: Optional[str] = None,
                 mesh=None, tp_axis: str = "tp",
                 spec_k: Optional[int] = None,
                 draft_fn: Optional[Callable[[Sequence[int], int],
                                             Sequence[int]]] = None,
                 device=None):
        self.cfg = cfg
        self.registry = registry
        self.device = _default_device(device)
        if mesh is None and SC.decode_tp() > 1:
            from ..parallel.mesh import create_mesh
            mesh = create_mesh({tp_axis: SC.decode_tp()})
        axis = mesh.axis(tp_axis) if mesh is not None else None
        self.mesh = mesh
        self.tp_axis = tp_axis
        self.tp = axis.size if axis is not None else 1
        MD.validate_tp(cfg, self.tp)
        self.n_slots = SC.decode_slots() if slots is None else int(slots)
        self.block_size = SC.decode_block_size() if block_size is None \
            else int(block_size)
        n_blocks = SC.decode_pool_blocks() if pool_blocks is None \
            else int(pool_blocks)
        self.max_blocks_per_slot = SC.decode_max_blocks_per_slot() \
            if max_blocks_per_slot is None else int(max_blocks_per_slot)
        self.prefill_buckets = tuple(sorted(
            int(b) for b in (prefill_buckets or SC.decode_prefill_buckets())))
        self.swap_policy = swap_policy or SC.decode_swap_policy()
        if self.swap_policy not in ("refill", "drain"):
            raise ValueError(f"swap policy {self.swap_policy!r}: use "
                             "'refill' or 'drain'")
        for b in self.prefill_buckets:
            if b % self.block_size:
                raise ValueError(f"prefill bucket {b} not a multiple of "
                                 f"block_size {self.block_size}")
        k = SC.decode_spec_k() if spec_k is None else int(spec_k)
        #: speculative window width; below 2 it is 0 (off)
        self.spec_k = k if k >= 2 else 0
        self._draft_fn = draft_fn
        #: host tokens emitted so far (both paths)
        self.tokens_emitted = 0
        self.max_context = self.max_blocks_per_slot * self.block_size
        if self.prefill_buckets[-1] > self.max_context:
            raise ValueError(
                f"largest prefill bucket {self.prefill_buckets[-1]} exceeds "
                f"per-slot context {self.max_context} "
                f"(max_blocks_per_slot * block_size)")

        self.allocator = BlockAllocator(n_blocks)
        self.slots = [_Slot() for _ in range(self.n_slots)]
        self._pending: "collections.deque[DecodeRequest]" = \
            collections.deque()
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._closing = False

        self._model_seq: Optional[int] = 0 if params is not None else None
        self._installed = None
        self._installed_seq = 0 if params is not None else None
        self._drain_target = None   # (params, seq) awaiting idle adoption

        # tp lockstep: rank 0 of the group posts events (requests,
        # installs, close) to its inbox; each tick starts by broadcasting
        # them over a gloo group of the same ranks (_sync). Every rank
        # queues the shards it is given in _staged until an install event
        # takes them.
        if self.tp > 1:
            if registry is not None:
                raise ValueError("a tp engine takes its weights through "
                                 "install_params on every rank, not a "
                                 "registry")
            self._root = axis.ranks[0]
            self.is_leader = dist.get_rank() == self._root
            self._ctrl = dist.new_group(
                list(axis.ranks), backend="gloo",
                timeout=datetime.timedelta(seconds=INSTALL_WAIT_S * 2))
        else:
            self.is_leader = True
        self._inbox: list = []
        self._staged: "queue.Queue" = queue.Queue()

        #: distinct input shapes each step function has seen; no
        #: ``verify`` key at K = 0 (the verify function is never built)
        self.compile_counts = {"decode": 0, "prefill": 0}
        if self.spec_k:
            self.compile_counts["verify"] = 0
        if mesh is not None:
            base = (MD.make_decode_step_tp(cfg, self.block_size, mesh,
                                           tp_axis),
                    MD.make_prefill_tp(cfg, self.block_size, mesh, tp_axis),
                    MD.make_verify_step_tp(cfg, self.block_size, mesh,
                                           tp_axis) if self.spec_k else None)
        else:
            base = (MD.make_decode_step(cfg, self.block_size),
                    MD.make_prefill(cfg, self.block_size),
                    MD.make_verify_step(cfg, self.block_size)
                    if self.spec_k else None)
        self._decode = _ShapeCounted(base[0], self.compile_counts, "decode")
        self._prefill = _ShapeCounted(base[1], self.compile_counts,
                                      "prefill")
        self._verify = (_ShapeCounted(base[2], self.compile_counts, "verify")
                        if self.spec_k else None)

        self._kp, self._vp = MD.init_kv_pools(cfg, n_blocks, self.block_size,
                                              tp=self.tp, device=self.device)
        self._dev_tokens = torch.zeros(self.n_slots, dtype=torch.long,
                                       device=self.device)
        self._params = self._place_params(params)
        self._positions = np.zeros(self.n_slots, np.int64)
        self._tables = np.zeros((self.n_slots, self.max_blocks_per_slot),
                                np.int64)
        self._active = np.zeros(self.n_slots, bool)
        # Device copies of the block tables and the runnable mask: both
        # change only on admit, retire, extend and refill, not every tick.
        self._tables_dev = None
        self._runnable_host: Optional[np.ndarray] = None
        self._runnable_dev = None

    # -- weights --------------------------------------------------------------

    def _place_params(self, params):
        """The decode parameters on the engine's device (a no-op for
        tensors already there)."""
        if params is None:
            return None
        return {k: v.to(self.device) for k, v in params.items()}

    def install_params(self, params) -> None:
        """Static-weights mode: (re)install decode parameters; each call
        after the first is observed as a hot swap by the step loop. Under
        tp every rank installs its own shard; rank 0's call decides the
        tick at which every rank adopts its shard."""
        if self.tp > 1:
            self._staged.put(params)
            if self.is_leader:
                self._post(("install",))
            return
        with self._lock:
            self._installed = params
            self._installed_seq = (self._installed_seq or 0) + 1
        self._work.set()

    def _current(self):
        """(params, seq) from the registry, install_params, or the
        constructor params: one RCU read, no lock on the step path."""
        if self.registry is not None:
            cur = self.registry.current()
            if cur is None:
                return None, None
            return cur.payload, cur.manifest_seq
        if self._installed is not None:
            return self._installed, self._installed_seq
        return self._params, self._model_seq

    # -- submission -----------------------------------------------------------

    def submit(self, prompt: Sequence[int],
               max_new: Optional[int] = None) -> DecodeRequest:
        if not self.is_leader:
            raise RuntimeError("rank 0 of the tp group alone takes requests")
        req = DecodeRequest(prompt, SC.decode_max_new() if max_new is None
                            else max_new)
        error = self._refusal(req)
        if error is not None:
            req.error = error
            req.event.set()
            return req
        if self.tp > 1:
            self._post(("submit", req))
            return req
        with self._lock:
            self._pending.append(req)
        _telemetry.set_gauge("hvd_serving_decode_queue_depth",
                             float(len(self._pending)))
        self._work.set()
        return req

    def _refusal(self, req: DecodeRequest) -> Optional[str]:
        """Why ``req`` can never be served here, or None. Spec mode
        reserves K - 1 extra positions: the last verify window may start at
        the final budgeted position and still index ``pos..pos+K-1`` into
        the block table (the window-fit rule; an index past the table
        would fail on the card, where JAX's gather clamps)."""
        if not req.prompt or req.max_new < 1:
            return "empty prompt or max_new < 1"
        window_slack = self.spec_k - 1 if self.spec_k else 0
        if len(req.prompt) > self.prefill_buckets[-1] \
                or len(req.prompt) + req.max_new + window_slack \
                > self.max_context:
            return (f"request needs {len(req.prompt)}+{req.max_new}"
                    + (f"+{window_slack} (speculative window)"
                       if window_slack else "")
                    + f" positions; max prompt bucket "
                    f"{self.prefill_buckets[-1]}, context "
                    f"{self.max_context}")
        bucket = pad_to_bucket(len(req.prompt), self.prefill_buckets)
        if bucket // self.block_size > self.allocator.n_blocks - 1:
            # admission could never succeed even on an idle pool
            return (f"prompt bucket {bucket} needs "
                    f"{bucket // self.block_size} blocks; pool has "
                    f"{self.allocator.n_blocks - 1}")
        return None

    def has_work(self) -> bool:
        return bool(self._pending) or bool(self._active.any())

    @property
    def active_slots(self) -> int:
        return int(self._active.sum())

    # -- tp lockstep ----------------------------------------------------------

    def _post(self, event) -> None:
        with self._lock:
            self._inbox.append(event)
        self._work.set()

    def _sync(self) -> None:
        """Start of a tick under tp: rank 0 broadcasts the events posted
        since the last tick, and every rank applies them in order. A no-op
        in one process."""
        if self.tp == 1:
            return
        events = []
        if self.is_leader:
            with self._lock:
                events, self._inbox = self._inbox, []
        wire = [("submit", e[1].prompt, e[1].max_new) if e[0] == "submit"
                else e for e in events]
        n = torch.tensor([len(wire)], dtype=torch.long)
        dist.broadcast(n, self._root, group=self._ctrl)
        if int(n) == 0:
            return
        box = [wire]
        dist.broadcast_object_list(box, self._root, group=self._ctrl)
        for i, ev in enumerate(box[0]):
            if ev[0] == "submit":
                req = events[i][1] if self.is_leader \
                    else DecodeRequest(ev[1], ev[2])
                self._pending.append(req)
            elif ev[0] == "install":
                try:
                    params = self._staged.get(timeout=INSTALL_WAIT_S)
                except queue.Empty:
                    raise RuntimeError(
                        "rank 0 installed weights, this rank did not within "
                        f"{INSTALL_WAIT_S:.0f} s") from None
                self._installed = params
                self._installed_seq = (self._installed_seq or 0) + 1
            elif ev[0] == "close":
                self._closing = True

    # -- the step loop --------------------------------------------------------

    def _runnable(self) -> np.ndarray:
        return self._active & ~np.asarray([s.stalled for s in self.slots])

    def _owned(self, arr: np.ndarray) -> torch.Tensor:
        """A copy of host array ``arr`` on the engine's device, owned by the
        step (``torch.tensor`` always copies): the engine may change
        ``arr`` as soon as the step is launched."""
        return torch.tensor(arr, device=self.device)

    def _tables_device(self):
        if self._tables_dev is None:
            self._tables_dev = self._owned(self._tables)
        return self._tables_dev

    def _runnable_device(self, runnable: np.ndarray):
        if self._runnable_host is None \
                or not np.array_equal(runnable, self._runnable_host):
            self._runnable_host = runnable.copy()
            self._runnable_dev = self._owned(runnable)
        return self._runnable_dev

    def decode_once(self) -> bool:
        """One engine tick: (under tp, take rank 0's events,) observe
        swaps, admit, step every runnable slot. Returns True when a step
        ran."""
        self._sync()
        return self._tick()

    def _tick(self) -> bool:
        self._observe_swap()
        self._admit_pending()
        if not self._active.any():
            return False
        self._extend_tables()
        runnable = self._runnable()
        if not runnable.any():
            # Every active slot is stalled on a block extension with the
            # free list empty: no step can run, so no retire can ever free
            # blocks, unless broken. Retire the longest stalled sequence
            # truncated; its blocks unstall the rest.
            if self.allocator.free_blocks == 0:
                self._break_stall()
                self._extend_tables()
                runnable = self._runnable()
            if not runnable.any():
                return False
        if self.spec_k:
            return self._spec_step(runnable)
        runnable_dev = self._runnable_device(runnable)
        _, nt, self._kp, self._vp = self._decode(
            self._params, self._kp, self._vp, self._dev_tokens,
            self._owned(self._positions), self._tables_device(),
            runnable_dev)
        # Masked slots (inactive or stalled) keep their pending token: a
        # stalled slot's row came from an un-extended table (its K/V went
        # to the null block), and consuming it would fork the stream.
        self._dev_tokens = torch.where(runnable_dev, nt, self._dev_tokens)
        stepped = 0
        for i, slot in enumerate(self.slots):
            if not runnable[i]:
                continue
            slot.gen_toks.append((nt, i))
            slot.gen += 1
            slot.pos += 1
            self._positions[i] = slot.pos
            stepped += 1
            if slot.gen >= slot.req.max_new:
                self._retire(i)
        self.tokens_emitted += stepped
        _telemetry.inc("hvd_serving_decode_tokens_total", float(stepped))
        _telemetry.set_gauge("hvd_serving_decode_active_slots",
                             float(self.active_slots))
        _telemetry.set_gauge("hvd_serving_decode_free_blocks",
                             float(self.allocator.free_blocks))
        return True

    # -- speculative tick -----------------------------------------------------

    def _draft(self, slot: _Slot, n: int) -> List[int]:
        """``n`` candidate tokens for ``slot`` from the injected
        ``draft_fn`` or the built-in n-gram lookup; host only."""
        ctx = slot.req.prompt + slot.gen_toks
        if self._draft_fn is not None:
            cand = [int(t) for t in self._draft_fn(ctx, n)]
            if len(cand) < n:
                pad = cand[-1] if cand else (int(ctx[-1]) if ctx else 0)
                cand += [pad] * (n - len(cand))
            return cand[:n]
        return _ngram_draft(ctx, n)

    def _spec_step(self, runnable: np.ndarray) -> bool:
        """One speculative tick over the runnable slots: draft on the host,
        verify all K window positions in one call, accept the longest
        matching prefix, rewind positions to the accepted length. Row i is
        ``[pending, d_1 .. d_{K-1}]`` at ``pos .. pos+K-1``; ``g[i, j]`` is
        the greedy token after window token j, so emitting ``g[i,
        :n_acc+1]`` is the plain loop's ``n_acc + 1`` tokens."""
        K = self.spec_k
        vmax = int(self.cfg.vocab_size) - 1
        toks = np.zeros((self.n_slots, K), np.int64)
        for i, slot in enumerate(self.slots):
            if not runnable[i]:
                continue
            toks[i, 0] = slot.pending
            # Clamp drafts into the vocabulary: an id past it would index
            # past the embedding, which fails on the card (JAX's gather
            # fills NaN instead). Acceptance compares the clamped value
            # actually verified, so the clamp stays lossless.
            toks[i, 1:] = np.clip(self._draft(slot, K - 1), 0, vmax)
        _, g, self._kp, self._vp = self._verify(
            self._params, self._kp, self._vp, self._owned(toks),
            self._owned(self._positions), self._tables_device(),
            self._runnable_device(runnable))
        g_h = g.cpu().numpy()   # the one [S, K] host fetch a tick
        # Longest-matching-prefix lengths for all slots at once: draft
        # d_{j+1} is accepted iff it equals g[:, j] with every earlier
        # draft accepted, a leading run of True per row.
        n_accs = np.cumprod(toks[:, 1:] == g_h[:, :-1], axis=1).sum(axis=1)
        stepped = hits = n_run = 0
        for i, slot in enumerate(self.slots):
            if not runnable[i]:
                continue
            n_run += 1
            n_acc = int(n_accs[i])
            # the budget can cap the emit below the accepted length
            n_emit = min(n_acc + 1, slot.req.max_new - slot.gen)
            new = [int(t) for t in g_h[i, :n_emit]]
            slot.gen_toks.extend(new)
            slot.pending = new[-1]
            slot.gen += n_emit
            # The rewind: positions advance by the emitted length only;
            # the next window (starting there) overwrites every stale
            # position before any mask can admit it.
            slot.pos += n_emit
            self._positions[i] = slot.pos
            stepped += n_emit
            hits += n_acc
            _telemetry.observe("hvd_serving_spec_accept_len", float(n_acc))
            if slot.gen >= slot.req.max_new:
                self._retire(i)
        self.tokens_emitted += stepped
        _telemetry.inc("hvd_serving_decode_tokens_total", float(stepped))
        _telemetry.inc("hvd_serving_spec_draft_hits_total", float(hits))
        _telemetry.inc("hvd_serving_spec_draft_tokens_total",
                       float(n_run * (K - 1)))
        _telemetry.set_gauge("hvd_serving_decode_active_slots",
                             float(self.active_slots))
        _telemetry.set_gauge("hvd_serving_decode_free_blocks",
                             float(self.allocator.free_blocks))
        return True

    # -- admission / retirement ----------------------------------------------

    def _admit_pending(self) -> None:
        if self._drain_target is not None:
            return                      # draining: no admissions
        while self._pending:
            idx = next((i for i, s in enumerate(self.slots)
                        if s.state == FREE), None)
            if idx is None:
                return
            params, seq = self._current()
            if params is None:
                return                  # nothing published yet
            if seq != self._model_seq:
                # A swap landed between this tick's _observe_swap and
                # admission: defer to the next tick, where _observe_swap
                # applies the policy to the live slots first.
                return
            with self._lock:
                if not self._pending:
                    return
                req = self._pending.popleft()
            bucket = pad_to_bucket(len(req.prompt), self.prefill_buckets)
            blocks = self.allocator.alloc_many(bucket // self.block_size)
            if blocks is None:
                with self._lock:
                    self._pending.appendleft(req)
                _telemetry.inc("hvd_serving_decode_admit_stalls_total")
                return                  # pool exhausted: retry next tick
            t_adm = time.perf_counter()
            req.queue_wait_s = t_adm - req.t0
            ft = self._run_prefill(req.prompt, blocks, bucket)
            slot = self.slots[idx]
            slot.state = ACTIVE
            slot.req = req
            slot.pos = len(req.prompt)
            slot.table = blocks
            slot.gen = 1
            slot.stalled = False
            self._positions[idx] = slot.pos
            self._tables[idx] = 0
            self._tables[idx, :len(blocks)] = blocks
            self._tables_dev = None
            self._active[idx] = True
            self._dev_tokens[idx] = ft
            if self.spec_k:
                # spec mode keeps host tokens: the prefill token is the
                # first emitted token and the pending window head
                tok0 = int(ft)
                slot.gen_toks = [tok0]
                slot.pending = tok0
            else:
                slot.gen_toks = [(ft, None)]
                if ft.is_cuda:  # the time to the first token includes it
                    torch.cuda.synchronize(ft.device)
            req.ttft_s = time.perf_counter() - req.t0
            req.prefill_wall_s = time.perf_counter() - t_adm
            _telemetry.inc("hvd_serving_decode_admitted_total")
            _telemetry.observe("hvd_serving_decode_ttft_seconds", req.ttft_s)
            if slot.gen >= req.max_new:
                self._retire(idx)

    def _run_prefill(self, prompt: Sequence[int], blocks: Sequence[int],
                     bucket: int):
        """Prefill ``prompt`` into ``blocks``; returns the first generated
        token as a 0-d tensor on the card."""
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :len(prompt)] = prompt
        logits, self._kp, self._vp = self._prefill(
            self._params, self._kp, self._vp, self._owned(padded),
            self._owned(np.asarray(blocks, np.int64)))
        return logits[0, len(prompt) - 1].argmax()

    def _extend_tables(self) -> None:
        """Grow any slot whose next write window crosses into unallocated
        blocks (one position plain, ``spec_k`` under speculation: every
        window row is written, accepted or not); a slot that cannot get
        every block it needs stalls (masked out) until a retire frees
        capacity. Partial extensions keep their blocks. If every active
        slot stalls with the free list empty, ``_tick`` breaks the
        deadlock (``_break_stall``)."""
        window = self.spec_k if self.spec_k else 1
        for i, slot in enumerate(self.slots):
            if slot.state != ACTIVE:
                continue
            need = (slot.pos + window - 1) // self.block_size
            while need >= len(slot.table):
                b = self.allocator.alloc()
                if b is None:
                    break
                slot.table.append(b)
                self._tables[i, len(slot.table) - 1] = b
                self._tables_dev = None
            if need < len(slot.table):
                slot.stalled = False
            elif not slot.stalled:
                slot.stalled = True
                _telemetry.inc("hvd_serving_decode_block_stalls_total")

    def _break_stall(self) -> None:
        """All active slots stalled with zero free blocks: retire the
        longest sequence truncated (it has the most tokens to deliver and
        frees the most blocks) so the others can extend."""
        idx = max((i for i, s in enumerate(self.slots) if s.state == ACTIVE),
                  key=lambda i: self.slots[i].pos, default=None)
        if idx is None:
            return
        get_logger().warning(
            "decode pool deadlocked (all %d active slots stalled, 0 free "
            "blocks): retiring slot %d truncated at pos %d",
            self.active_slots, idx, self.slots[idx].pos)
        _telemetry.inc("hvd_serving_decode_stall_breaks_total")
        self._retire(idx, truncated=True)

    def _slot_token_values(self, slot: _Slot) -> List[int]:
        """The slot's generated tokens as host ints (one wait for the card;
        retire and refill only, never the step loop)."""
        if not slot.gen_toks:
            return []
        if isinstance(slot.gen_toks[0], int):
            return list(slot.gen_toks)
        return torch.stack([a if i is None else a[i]
                            for a, i in slot.gen_toks]).tolist()

    def _retire(self, idx: int, truncated: bool = False) -> None:
        slot = self.slots[idx]
        req = slot.req
        req.tokens = req.prompt + self._slot_token_values(slot)
        req.truncated = truncated
        req.model_seq = self._model_seq
        req.event.set()
        self.allocator.free(slot.table)
        slot.state = FREE
        slot.req = None
        slot.table = []
        slot.gen_toks = []
        slot.stalled = False
        slot.pending = None
        slot.pos = 0
        slot.gen = 0
        self._active[idx] = False
        self._positions[idx] = 0
        self._tables[idx] = 0
        self._tables_dev = None
        _telemetry.inc("hvd_serving_decode_retired_total")
        if self._drain_target is not None and not self._active.any():
            tgt_params, tgt_seq = self._drain_target
            self._params, self._model_seq = \
                self._place_params(tgt_params), tgt_seq
            self._drain_target = None
            _telemetry.inc("hvd_serving_decode_drain_adoptions_total")

    # -- hot swap -------------------------------------------------------------

    def _observe_swap(self) -> None:
        params, seq = self._current()
        if params is None or seq == self._model_seq:
            return
        if self._model_seq is None or not self._active.any():
            self._params, self._model_seq = self._place_params(params), seq
            self._drain_target = None
            return
        if self.swap_policy == "drain":
            self._drain_target = (params, seq)
            return
        # refill: adopt now, remap every live slot's blocks under the new
        # weights
        self._params, self._model_seq = self._place_params(params), seq
        self._drain_target = None
        t0 = time.perf_counter()
        n = self._refill_live_slots()
        _telemetry.inc("hvd_serving_decode_refills_total", float(n))
        _telemetry.observe("hvd_serving_decode_refill_seconds",
                           time.perf_counter() - t0)

    def _refill_live_slots(self) -> int:
        refilled = 0
        for i, slot in enumerate(self.slots):
            if slot.state != ACTIVE:
                continue
            seq_toks = slot.req.prompt + self._slot_token_values(slot)
            if len(seq_toks) > self.prefill_buckets[-1]:
                # outgrown the prefill buckets: finish with what it has
                # rather than serve KV of mixed generations
                self._retire(i, truncated=True)
                continue
            bucket = pad_to_bucket(len(seq_toks), self.prefill_buckets)
            self.allocator.free(slot.table)
            slot.table = []
            blocks = self.allocator.alloc_many(bucket // self.block_size)
            if blocks is None:          # cannot re-place: finish early
                self._retire(i, truncated=True)
                continue
            ft = self._run_prefill(seq_toks, blocks, bucket)
            slot.table = blocks
            slot.pos = len(seq_toks)
            slot.gen += 1
            if self.spec_k:
                tok0 = int(ft)
                slot.gen_toks.append(tok0)
                slot.pending = tok0
            else:
                slot.gen_toks.append((ft, None))
            self._positions[i] = slot.pos
            self._tables[i] = 0
            self._tables[i, :len(blocks)] = blocks
            self._tables_dev = None
            self._dev_tokens[i] = ft
            refilled += 1
            if slot.gen >= slot.req.max_new:
                self._retire(i)
        return refilled

    # -- background serving --------------------------------------------------

    def start(self) -> None:
        """Run the step loop on a daemon thread (server integration). Under
        tp every rank starts it; rank 0's :meth:`close` ends them all."""
        if self._thread is not None:
            return

        def _loop():
            while not self._closing:
                try:
                    # Wait whenever no step ran, even with work pending
                    # (admission blocked on the pool or on a swap): nothing
                    # changes until a tick or an outside event. Under tp
                    # the other ranks wait in rank 0's next broadcast.
                    if not self.decode_once() and self.is_leader:
                        self._work.wait(timeout=0.05)
                        self._work.clear()
                except Exception as err:  # noqa: BLE001 — containment
                    get_logger().exception("decode engine tick failed")
                    self._fail_all(str(err))

        self._thread = threading.Thread(target=_loop, name="hvd-decode",
                                        daemon=True)
        self._thread.start()

    def _fail_all(self, msg: str) -> None:
        with self._lock:
            pending = list(self._pending)
            self._pending.clear()
        for i, slot in enumerate(self.slots):
            if slot.state == ACTIVE:
                slot.req.error = msg
                slot.req.event.set()
                self.allocator.free(slot.table)
                slot.state = FREE
                slot.req = None
                slot.table = []
                slot.gen_toks = []
                self._active[i] = False
        for req in pending:
            req.error = msg
            req.event.set()

    def close(self) -> None:
        """Stop the engine. Under tp rank 0 posts the close and every rank
        waits for it to arrive: through its loop thread, or without one by
        taking rank 0's broadcasts until it comes."""
        if self.tp > 1:
            if self.is_leader:
                self._post(("close",))
            if self._thread is None:
                while not self._closing:
                    self._sync()
        else:
            self._closing = True
            self._work.set()
        if self._thread is not None:
            self._thread.join(timeout=30)

    def run_until_idle(self, max_steps: int = 10_000) -> None:
        """Drive the loop inline until every request completes (tests, and
        under tp on every rank at once: after each tick's broadcast every
        rank sees the same work)."""
        for _ in range(max_steps):
            self._sync()
            if not self.has_work():
                return
            self._tick()
        raise RuntimeError(f"engine still busy after {max_steps} steps")
