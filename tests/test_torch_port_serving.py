"""The port's decode engine and inference server, on the CPU.

The engine (``horovod_tpu_torch/serving/decode.py``) is held against the
flax greedy loop (``model.apply`` over the sequence, one token at a time;
:func:`_flax_greedy`), the oracle of ``tests/test_decode_parity.py``, not
against the JAX
package's engine, whose streams fork (ROADMAP.md, section C). ``llama_tiny``
and ``mixtral_tiny`` (capacity factor 8.0, so the router drops nothing) in
f32, weights from the flax init through ``convert.decode_params_from_flax``.
Every stream is compared token for token:

- greedy for both models; a refill swap of the same weights mid-decode
  (stream unchanged, the original blocks freed); a drain swap (the
  in-flight request finishes on the old weights, the next on the new);
- a stall mid-generation (the stalled slot keeps its pending token) and
  the deadlock break (all slots stalled, none free: the longest retires
  truncated, a prefix of its greedy stream);
- speculative decode at K = 2, 3 and 4 equal to K = 0, with the n-gram
  drafter (accepts happen) and an always-wrong drafter; the rejected
  window rows overwritten across block boundaries (at every tick the
  accepted rows equal the plain engine's pool within 1e-5 (|ref| +
  RMS(ref)) per element: torch's CPU matmul sums a row's products in an
  order that depends on how many rows share the call, one a slot in the
  plain step and K in the verify step, which moves the last bits, while a
  stale row, written from another token, differs by the size of the
  values); the window slack of ``submit``; 500 ticks of allocator churn
  under K = 4;
- ``compile_counts``: one decode shape, one prefill shape a bucket, no
  ``verify`` key at K = 0;
- the positions hazard: no tensor a step receives shares memory with the
  engine's host arrays, and each still holds what it held at the call
  after the engine has moved on.

The server (``serving/server.py``): ``/generate`` through an attached
engine; ``/predict`` batching over buckets with one registry read a
batch; 400 on a bad ``max_new``; 503 before a model and while draining;
429 with ``Retry-After`` past ``queue_max``; expired deadlines never
batched; ``/healthz`` staleness with an injected clock. The registry's
adoption from a store is not ported, so each test places a
``ServedModel`` in the registry itself.
"""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from horovod_tpu.models import llama as jllama
from horovod_tpu.models import mixtral as jmixtral

from horovod_tpu_torch import convert
from horovod_tpu_torch.core import telemetry as _telemetry
from horovod_tpu_torch.models import llama as tllama
from horovod_tpu_torch.models import mixtral as tmixtral
from horovod_tpu_torch.serving import (DecodeEngine, InferenceServer,
                                       ModelRegistry, ServedModel,
                                       pad_to_bucket)
from horovod_tpu_torch.serving.decode import _ngram_draft

SPEC_PROMPT = [5, 6, 7, 5, 6, 7, 5, 6]


def _build(kind, seed=0):
    if kind == "llama":
        jcfg, tcfg = jllama.llama_tiny(), tllama.llama_tiny()
        model = jllama.Llama(jcfg)
    else:
        jcfg = dataclasses.replace(jmixtral.mixtral_tiny(),
                                   capacity_factor=8.0)
        tcfg = dataclasses.replace(tmixtral.mixtral_tiny(),
                                   capacity_factor=8.0)
        model = jmixtral.Mixtral(jcfg)
    params = nn.meta.unbox(jax.jit(model.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 16), jnp.int32)))["params"]
    return tcfg, model, params, convert.decode_params_from_flax(params, tcfg)


@pytest.fixture(scope="module")
def llama():
    return _build("llama")


@pytest.fixture(scope="module")
def mixtral():
    return _build("mixtral")


_GREEDY = {}
_APPLY = {}
ORACLE_T = 32


def _flax_greedy(model, params, prompt, n_new):
    """The flax greedy loop. Each token is the argmax of ``model.apply``
    at the last position of the sequence so far, padded to ``ORACLE_T``
    tokens so one jitted forward serves every length: the model is
    causal, so position t's logits see only tokens up to t, and at
    capacity factor 8.0 the router drops nothing, so the padding routes
    apart from the real tokens."""
    key = (id(params), tuple(prompt), n_new)
    if key not in _GREEDY:
        if id(model) not in _APPLY:
            _APPLY[id(model)] = jax.jit(
                lambda p, t: model.apply({"params": p}, t))
        apply = _APPLY[id(model)]
        seq = list(prompt)
        for _ in range(n_new):
            padded = np.zeros((1, ORACLE_T), np.int32)
            padded[0, :len(seq)] = seq
            logits = apply(params, jnp.asarray(padded))
            seq.append(int(np.argmax(np.asarray(logits[0, len(seq) - 1]))))
        _GREEDY[key] = seq
    return _GREEDY[key]


def _engine(cfg, params, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("block_size", 4)
    kw.setdefault("pool_blocks", 24)
    kw.setdefault("max_blocks_per_slot", 8)
    kw.setdefault("prefill_buckets", (8, 16))
    kw.setdefault("swap_policy", "refill")
    return DecodeEngine(cfg, params=params, device="cpu", **kw)


def _run(eng, prompt, n):
    req = eng.submit(prompt, n)
    eng.run_until_idle()
    assert req.error is None, req.error
    return req


# ------------------------------------------------------------ the engine

@pytest.mark.parametrize("kind", ["llama", "mixtral"])
def test_engine_greedy_matches_flax(kind, llama, mixtral):
    cfg, model, params, tparams = llama if kind == "llama" else mixtral
    eng = _engine(cfg, tparams)
    a = eng.submit([11, 3, 20, 5, 42, 7], 8)
    b = eng.submit([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 5)
    eng.run_until_idle()
    assert a.tokens == _flax_greedy(model, params, [11, 3, 20, 5, 42, 7], 8)
    assert b.tokens == _flax_greedy(model, params, list(range(1, 11)), 5)
    assert eng.allocator.free_blocks == 23
    assert not eng._kp[:, 0].any() and not eng._vp[:, 0].any()


@pytest.mark.parametrize("kind", ["llama", "mixtral"])
def test_refill_swap_mid_decode_is_transparent(kind, llama, mixtral):
    cfg, model, params, tparams = llama if kind == "llama" else mixtral
    eng = _engine(cfg, tparams)
    prompt = [2, 9, 33, 4, 17, 6]
    req = eng.submit(prompt, 10)
    for _ in range(4):
        eng.decode_once()
    eng.install_params(tparams)              # the same weights, a new seq
    eng.run_until_idle()
    assert req.error is None and not req.truncated
    assert req.tokens == _flax_greedy(model, params, prompt, 10)
    assert eng.allocator.free_blocks == 23   # the remap freed the originals
    assert req.model_seq == 1


def test_drain_swap_finishes_on_old_weights(llama):
    cfg, model, params_a, tparams_a = llama
    _, _, params_b, tparams_b = _build("llama", seed=7)
    eng = _engine(cfg, tparams_a, swap_policy="drain")
    prompt = [13, 8, 21, 34, 55, 3]
    req = eng.submit(prompt, 10)
    for _ in range(3):
        eng.decode_once()
    eng.install_params(tparams_b)
    eng.run_until_idle()
    assert req.tokens == _flax_greedy(model, params_a, prompt, 10)
    req2 = _run(eng, prompt, 6)              # drained: B serves now
    assert req2.tokens == _flax_greedy(model, params_b, prompt, 6)
    assert req2.tokens != req.tokens[:len(req2.tokens)]


def test_stall_mid_generation_preserves_greedy_stream(llama):
    cfg, model, params, tparams = llama
    eng = _engine(cfg, tparams, pool_blocks=4, max_blocks_per_slot=4,
                  prefill_buckets=(4, 8))
    a = eng.submit([1, 2], 10)        # bucket 4: 1 block, extends at pos 4
    b = eng.submit([3, 4, 5, 6], 4)   # bucket 8: 2 blocks, never extends
    stalled_seen = False
    for _ in range(100):
        if not eng.has_work():
            break
        eng.decode_once()
        stalled_seen = stalled_seen or eng.slots[0].stalled
    assert stalled_seen, "slot A never stalled: the scenario regressed"
    assert not a.truncated and not b.truncated
    assert a.tokens == _flax_greedy(model, params, [1, 2], 10)
    assert b.tokens == _flax_greedy(model, params, [3, 4, 5, 6], 4)


def test_deadlock_break_retires_the_longest_truncated(llama):
    """Three usable blocks, two slots of one block each: A takes the
    third at position 4 while B stalls there; A stalls at position 8 with
    the pool empty, so every active slot is stalled and the engine
    retires A (the longer) truncated; B then extends and finishes."""
    cfg, model, params, tparams = llama
    reg = _telemetry.active().registry
    before = reg.counter_value("hvd_serving_decode_stall_breaks_total")
    eng = _engine(cfg, tparams, pool_blocks=4, max_blocks_per_slot=4,
                  prefill_buckets=(4,))
    a = eng.submit([1, 2, 3], 10)
    b = eng.submit([4, 5, 6], 5)
    eng.run_until_idle()
    assert a.truncated and not b.truncated
    assert reg.counter_value("hvd_serving_decode_stall_breaks_total") \
        == before + 1
    full_a = _flax_greedy(model, params, [1, 2, 3], 10)
    assert len(a.tokens) == 9 and a.tokens == full_a[:9]
    assert b.tokens == _flax_greedy(model, params, [4, 5, 6], 5)
    assert eng.allocator.free_blocks == 3


@pytest.mark.parametrize("kind", ["llama", "mixtral"])
def test_spec_stream_equals_plain_across_k(kind, llama, mixtral):
    cfg, model, params, tparams = llama if kind == "llama" else mixtral
    want = _flax_greedy(model, params, SPEC_PROMPT, 12)
    reg = _telemetry.active().registry
    for k in (0, 2, 3, 4):
        hits = reg.counter_value("hvd_serving_spec_draft_hits_total")
        eng = _engine(cfg, tparams, spec_k=k)
        req = _run(eng, SPEC_PROMPT, 12)
        assert req.tokens == want, (k, req.tokens, want)
        if k:
            assert eng.compile_counts == {"decode": 0, "prefill": 1,
                                          "verify": 1}
            # the repeat-heavy prompt makes the n-gram drafter hit
            assert reg.counter_value(
                "hvd_serving_spec_draft_hits_total") > hits
        else:
            assert eng.compile_counts == {"decode": 1, "prefill": 1}


def _wrong_draft(cfg, tparams, prompt, max_new):
    """An always-wrong drafter: the true greedy stream (from a plain
    engine) plus one, modulo the vocabulary, at every position."""
    full = _run(_engine(cfg, tparams), prompt, max_new).tokens
    V = cfg.vocab_size

    def draft(ctx, n):
        return [(full[len(ctx) + j] + 1) % V
                if len(ctx) + j < len(full) else 1 for j in range(n)]
    return draft


def _pool_rows(eng, slot_idx, upto_pos):
    table, bs = eng.slots[slot_idx].table, eng.block_size
    rows = [(eng._kp[:, table[p // bs], p % bs],
             eng._vp[:, table[p // bs], p % bs]) for p in range(upto_pos)]
    return (torch.stack([k for k, _ in rows]),
            torch.stack([v for _, v in rows]))


def test_rejected_kv_rows_overwritten_across_block_boundaries(llama):
    """A plain engine and an all-rejecting K = 4 engine, tick for tick on
    one prompt: the accepted positions' K/V equal the plain pool's at
    every tick (within the module's stated tolerance), windows straddling
    block boundaries included."""
    cfg, _, _, tparams = llama
    prompt, K = [7, 1, 4, 12, 9, 30, 2], 4
    plain = _engine(cfg, tparams, pool_blocks=32)
    spec = _engine(cfg, tparams, pool_blocks=32, spec_k=K,
                   draft_fn=_wrong_draft(cfg, tparams, prompt, 12))
    rp, rs = plain.submit(prompt, 12), spec.submit(prompt, 12)
    plain._admit_pending()
    spec._admit_pending()
    straddles = 0
    for _ in range(10):
        pos_before = spec.slots[0].pos
        plain.decode_once()
        spec.decode_once()
        assert spec.slots[0].pos == pos_before + 1 == plain.slots[0].pos
        straddles += pos_before // 4 != (pos_before + K - 1) // 4
        upto = spec.slots[0].pos
        for got, ref in zip(_pool_rows(spec, 0, upto),
                            _pool_rows(plain, 0, upto)):
            tol = 1e-5 * (ref.abs() + ref.square().mean().sqrt())
            assert ((got - ref).abs() <= tol).all()
    assert straddles >= 2, "windows never straddled a boundary"
    assert not spec._kp[:, 0].any() and not spec._vp[:, 0].any()
    plain.run_until_idle()
    spec.run_until_idle()
    assert rp.tokens == rs.tokens


def test_spec_adversarial_draft_matches_plain_and_counts(llama):
    cfg, model, params, tparams = llama
    reg = _telemetry.active().registry
    before_hits = reg.counter_value("hvd_serving_spec_draft_hits_total")
    before_off = reg.counter_value("hvd_serving_spec_draft_tokens_total")
    eng = _engine(cfg, tparams, spec_k=4, pool_blocks=32,
                  draft_fn=_wrong_draft(cfg, tparams, SPEC_PROMPT, 9))
    req = eng.submit(SPEC_PROMPT, 9)
    ticks = 0
    while eng.has_work():
        ticks += eng.decode_once()
    assert req.tokens == _flax_greedy(model, params, SPEC_PROMPT, 9)
    assert ticks == 8
    assert reg.counter_value("hvd_serving_spec_draft_hits_total") \
        == before_hits
    assert reg.counter_value("hvd_serving_spec_draft_tokens_total") \
        - before_off == ticks * 3


def test_spec_drafts_out_of_the_vocabulary_are_clamped(llama):
    """A drafter that offers ids past the vocabulary (and negative ones)
    cannot index past the embedding: the engine clamps them, and the
    stream is still the greedy one."""
    cfg, model, params, tparams = llama
    eng = _engine(cfg, tparams, spec_k=3,
                  draft_fn=lambda ctx, n: [10 ** 6, -5][:n])
    req = _run(eng, [11, 3, 20, 5], 7)
    assert req.tokens == _flax_greedy(model, params, [11, 3, 20, 5], 7)


def test_spec_window_reserves_context_slack(llama):
    cfg, _, _, tparams = llama
    plain = _engine(cfg, tparams, max_blocks_per_slot=4,
                    prefill_buckets=(8,))
    ok = _run(plain, [1] * 8, 8)
    spec = _engine(cfg, tparams, spec_k=4, max_blocks_per_slot=4,
                   prefill_buckets=(8,))
    bad = spec.submit([1] * 8, 8)            # 8 + 8 + 3 > 16
    assert bad.error is not None and "speculative window" in bad.error
    ok2 = _run(spec, [1] * 8, 5)             # 8 + 5 + 3 = 16 fits
    assert ok2.tokens == ok.tokens[:13]


def test_allocator_churn_invariants_with_spec_enabled(llama):
    cfg, _, _, tparams = llama
    eng = _engine(cfg, tparams, spec_k=4, slots=3, pool_blocks=16,
                  max_blocks_per_slot=4, prefill_buckets=(4, 8))
    rng = np.random.RandomState(0)
    done = []
    for _ in range(500):
        if rng.rand() < 0.35 and len(done) < 60:
            plen = int(rng.randint(1, 8))
            budget = int(rng.randint(1, 16 - plen - 3))
            done.append(eng.submit(list(rng.randint(1, 50, plen)), budget))
        eng.decode_once()
        alloc = eng.allocator
        held = alloc._held
        assert 0 not in held and 0 not in alloc._free
        assert len(set(alloc._free)) == len(alloc._free)
        assert held.isdisjoint(alloc._free)
        assert len(held) + len(alloc._free) == alloc.n_blocks - 1
        assert sorted(b for s in eng.slots for b in s.table) == sorted(held)
    eng.run_until_idle()
    assert eng.allocator.free_blocks == eng.allocator.n_blocks - 1
    assert len(done) > 20
    for req in done:
        assert req.error is None and req.tokens is not None
        if not req.truncated:
            assert len(req.tokens) == len(req.prompt) + req.max_new
    assert eng.compile_counts == {"decode": 0, "prefill": 2, "verify": 1}


def test_compile_counts_bounded_by_the_buckets(llama):
    cfg, _, _, tparams = llama
    eng = _engine(cfg, tparams, slots=3)
    for n in (1, 3, 8, 9, 12, 16, 5):
        eng.submit(list(range(1, n + 1)), 3)
    eng.run_until_idle()
    assert eng.compile_counts == {"decode": 1, "prefill": 2}


def test_refill_outgrown_sequence_retires_truncated(llama):
    cfg, model, params, tparams = llama
    eng = _engine(cfg, tparams, slots=1, pool_blocks=16,
                  max_blocks_per_slot=6, prefill_buckets=(8,))
    req = eng.submit([1, 2, 3, 4, 5], 12)
    for _ in range(5):                       # the sequence grows past 8
        eng.decode_once()
    eng.install_params(tparams)
    eng.run_until_idle()
    assert req.truncated and req.error is None
    full = _flax_greedy(model, params, [1, 2, 3, 4, 5], 12)
    assert 5 < len(req.tokens) <= 17 and req.tokens == full[:len(req.tokens)]


@pytest.mark.parametrize("spec_k", [0, 3])
def test_steps_never_share_memory_with_host_arrays(llama, spec_k):
    """The positions hazard of the JAX engine: each tensor a step or a
    prefill receives is the engine's own copy. It shares no memory with
    the host arrays the engine changes after the call, and it still holds
    the values of the call once the engine has moved on."""
    cfg, model, params, tparams = llama
    eng = _engine(cfg, tparams, spec_k=spec_k)
    host = [eng._positions, eng._tables, eng._active]
    calls = []
    for name in ("_decode", "_verify", "_prefill"):
        real = getattr(eng, name)
        if real is None:
            continue

        def spy(params, *args, _real=real):
            tensors = args[2:]
            for t in tensors:
                for arr in host:
                    assert not np.shares_memory(t.numpy(), arr)
            calls.append([(t, t.clone()) for t in tensors])
            return _real(params, *args)
        setattr(eng, name, spy)
    a = eng.submit([2, 9, 33, 4, 17, 6], 9)
    b = eng.submit(SPEC_PROMPT, 7)
    eng.run_until_idle()
    assert len(calls) > 4
    for call in calls:
        for t, snapshot in call:
            assert torch.equal(t, snapshot)
    assert a.tokens == _flax_greedy(model, params, [2, 9, 33, 4, 17, 6], 9)
    assert b.tokens == _flax_greedy(model, params, SPEC_PROMPT, 7)


def test_ngram_draft():
    assert _ngram_draft([5, 6, 7, 5, 6, 7, 5, 6], 3) == [7, 5, 6]
    assert _ngram_draft([1, 2, 9, 1, 2], 3) == [9, 1, 2]
    assert _ngram_draft([1, 2, 9, 1, 2], 5) == [9, 1, 2, 2, 2]
    assert _ngram_draft([1, 2, 3, 4], 3) == [4, 4, 4]
    assert _ngram_draft([], 2) == [0, 0]
    assert all(type(t) is int for t in _ngram_draft([1, 2, 1, 2], 4))


# ------------------------------------------------------------ the server

def _http(url, body=None, headers=None):
    """GET or POST; returns (status, parsed JSON or text, headers)."""
    hdrs = {"Content-Type": "application/json"} if body else {}
    hdrs.update(headers or {})
    req = urllib.request.Request(url, data=body, headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=20) as r:
            raw = r.read()
            status, h = r.status, dict(r.headers)
    except urllib.error.HTTPError as e:
        raw, status, h = e.read(), e.code, dict(e.headers)
    try:
        return status, json.loads(raw or b"{}"), h
    except ValueError:
        return status, raw.decode(), h


def _post(srv, path, obj):
    return _http(f"http://{srv.addr()}{path}", json.dumps(obj).encode())


def _served(payload, t=0.0, seq=1):
    reg_time = {"time": t}
    return ServedModel(payload, reg_time, seq, "d", t)


def test_pad_to_bucket():
    assert [pad_to_bucket(n, (1, 2, 4, 8)) for n in (1, 2, 3, 5, 8, 9)] \
        == [1, 2, 4, 8, 8, 8]


def test_generate_through_the_engine_and_bad_max_new(llama):
    cfg, model, params, tparams = llama
    reg = ModelRegistry()
    eng = _engine(cfg, tparams)
    srv = InferenceServer(reg, lambda p, i, n: [], window_s=0.0,
                          request_timeout_s=60.0, decode_engine=eng)
    try:
        assert eng.registry is reg           # attached; no model yet
        reg._current = _served(tparams)
        prompt = [11, 3, 20, 5, 42, 7]
        code, body, _ = _post(srv, "/generate",
                              {"tokens": prompt, "max_new": 6})
        assert code == 200 and body["ok"], body
        assert body["tokens"] == _flax_greedy(model, params, prompt, 6)
        assert body["model_seq"] == 1 and body["ttft_s"] > 0
        code, body, _ = _post(srv, "/generate",
                              {"tokens": [1, 2], "max_new": "abc"})
        assert code == 400 and body["error"] == "bad json"
        code, text, _ = _http(f"http://{srv.addr()}/metrics")
        assert code == 200 and "hvd_serving_requests_total" in text
        assert srv._req_count == 2
    finally:
        srv.close()
    assert eng._closing and not eng._thread.is_alive()


def test_predict_batches_over_buckets_with_one_registry_read():
    """Requests coalesce within the window into one padded bucket; each
    batch calls the forward once with the payload it read, and a swap
    between batches reaches only the next batch."""
    reg = ModelRegistry()
    reg._current = _served({"w": 2.0})
    seen = []

    def forward(payload, inputs, padded_n):
        seen.append((len(inputs), padded_n, payload["w"]))
        return [q["x"] * payload["w"] for q in inputs]

    srv = InferenceServer(reg, forward, buckets=(1, 2, 4), window_s=0.3,
                          request_timeout_s=20.0)
    try:
        results = []
        threads = [threading.Thread(target=lambda x=x: results.append(
            _post(srv, "/predict", {"x": x}))) for x in (1.0, 2.0, 3.0)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=20)
        assert sorted(r[1]["result"] for r in results) == [2.0, 4.0, 6.0]
        assert all(r[0] == 200 and r[1]["model_seq"] == 1 for r in results)
        assert sum(n for n, _, _ in seen) == 3
        assert all(p == pad_to_bucket(n, (1, 2, 4)) for n, p, _ in seen)
        reg._current = _served({"w": 10.0}, seq=2)
        code, body, _ = _post(srv, "/predict", {"x": 1.0})
        assert (code, body["result"], body["model_seq"]) == (200, 10.0, 2)
    finally:
        srv.close()


def test_503_before_a_model_and_while_draining(llama):
    cfg, _, _, tparams = llama
    reg = ModelRegistry()
    release = threading.Event()

    def forward(payload, inputs, n):
        release.wait(20)
        return [0.0] * len(inputs)

    srv = InferenceServer(reg, forward, buckets=(1,), window_s=0.0,
                          request_timeout_s=20.0,
                          decode_engine=_engine(cfg, tparams))
    try:
        code, body, _ = _post(srv, "/predict", {"x": 1.0})
        assert code == 503 and body["ok"] is False
        code, body, _ = _http(f"http://{srv.addr()}/healthz")
        assert code == 503 and body["model_seq"] is None
        reg._current = _served({}, t=time.time())
        code, body, _ = _http(f"http://{srv.addr()}/healthz")
        assert code == 200 and body["ok"]
        drained = []
        srv.add_drained_callback(lambda: drained.append(True))
        t = threading.Thread(target=lambda: _post(srv, "/predict",
                                                  {"x": 1.0}))
        t.start()
        deadline = time.monotonic() + 10
        while srv._pending_n == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        done = []
        dt = threading.Thread(target=lambda: done.append(
            srv.drain(timeout_s=20)))
        dt.start()
        while not srv.draining and time.monotonic() < deadline:
            time.sleep(0.005)
        for path, obj in (("/predict", {"x": 2.0}),
                          ("/generate", {"tokens": [1, 2]})):
            code, body, _ = _post(srv, path, obj)
            assert code == 503 and body["error"] == "draining", path
        code, body, _ = _http(f"http://{srv.addr()}/healthz")
        assert code == 503 and body["draining"]
        code, _, _ = _http(f"http://{srv.addr()}/livez")
        assert code == 200
        release.set()
        t.join(timeout=20)
        dt.join(timeout=20)
        assert done == [True] and drained == [True]
    finally:
        release.set()
        srv.close()


def test_sheds_past_queue_max_with_retry_after(monkeypatch):
    monkeypatch.setenv("HOROVOD_SERVING_QUEUE_MAX", "1")
    monkeypatch.setenv("HOROVOD_SERVING_RETRY_AFTER_SECONDS", "1.5")
    reg = ModelRegistry()
    reg._current = _served({"w": 10.0})
    entered, release = threading.Event(), threading.Event()

    def forward(payload, inputs, padded_n):
        entered.set()
        release.wait(20)
        return [q["x"] * payload["w"] for q in inputs]

    srv = InferenceServer(reg, forward, buckets=(1,), window_s=0.0,
                          request_timeout_s=30.0)
    results = []
    try:
        shed = _telemetry.active().registry.counter_value(
            "hvd_serving_shed_total")
        t1 = threading.Thread(target=lambda: results.append(
            _post(srv, "/predict", {"x": 1.0})))
        t1.start()
        assert entered.wait(10)              # A in flight, off the queue
        t2 = threading.Thread(target=lambda: results.append(
            _post(srv, "/predict", {"x": 2.0})))
        t2.start()
        deadline = time.monotonic() + 10
        while srv._queue.qsize() < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert srv._queue.qsize() == 1       # B parked at the bound
        code, body, headers = _post(srv, "/predict", {"x": 3.0})
        assert code == 429 and body["error"] == "overloaded"
        assert body["retry_after_s"] == 1.5 and headers["Retry-After"] == \
            "1.5"
        assert _telemetry.active().registry.counter_value(
            "hvd_serving_shed_total") == shed + 1
        release.set()
        t1.join(timeout=20)
        t2.join(timeout=20)
        assert sorted(r[1]["result"] for r in results) == [10.0, 20.0]
    finally:
        release.set()
        srv.close()


def test_expired_deadlines_are_never_batched():
    reg = ModelRegistry()
    reg._current = _served({})
    calls = []
    srv = InferenceServer(reg, lambda p, i, n: calls.append(i) or
                          [0.0] * len(i), buckets=(1,), window_s=0.0,
                          request_timeout_s=10.0)
    try:
        dropped = _telemetry.active().registry.counter_value(
            "hvd_serving_deadline_dropped_total")
        code, body, _ = _post(srv, "/predict", {"x": 1.0, "deadline_s": 0})
        assert code == 504 and body["error"] == "deadline exceeded"
        code, _, _ = _http(f"http://{srv.addr()}/predict",
                           json.dumps({"x": 1.0}).encode(),
                           {"X-HVD-Deadline-S": "0"})
        assert code == 504
        assert _telemetry.active().registry.counter_value(
            "hvd_serving_deadline_dropped_total") == dropped + 2
        assert calls == []
        code, body, _ = _post(srv, "/predict", {"x": 1.0})
        assert code == 200 and body["ok"] and calls == [[{"x": 1.0}]]
    finally:
        srv.close()


def test_healthz_staleness_with_an_injected_clock(monkeypatch):
    monkeypatch.setenv("HOROVOD_SERVING_MAX_STALENESS_SECONDS", "10")
    now = [100.0]
    reg = ModelRegistry(clock=lambda: now[0])
    assert reg.staleness_s() is None
    reg._current = _served({}, t=95.0)
    srv = InferenceServer(reg, lambda p, i, n: [], window_s=0.0)
    try:
        code, body, _ = _http(f"http://{srv.addr()}/healthz")
        assert code == 200 and body["staleness_s"] == 5.0
        now[0] = 120.0
        code, body, _ = _http(f"http://{srv.addr()}/healthz")
        assert code == 503 and body["staleness_s"] == 25.0
        assert not body["ok"] and not body["draining"]
    finally:
        srv.close()
