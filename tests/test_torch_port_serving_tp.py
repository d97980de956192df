"""The port's decode engine over a tp process group, on the CPU (gloo).

One gloo world of 2 and one of 4, started side by side once for the module
(``torch_port_mp.start_worlds``). Every rank builds the same engine on its
shard of the decode parameters (``models.decode.decode_shard``) of
``llama_tiny`` and ``mixtral_tiny`` with 8 query and 4 KV heads (so tp 2
and 4 divide them; capacity factor 8.0), in f32, from one flax init carried
across by ``convert.decode_params_from_flax``. Rank 0 alone submits; the
others learn each request from rank 0's broadcast at the start of a tick.

- Streams: greedy for both models, a second request admitted mid-run,
  and speculative K = 2 and 4 (the n-gram drafter), each token for token
  equal to the flax greedy loop and to the port's engine in one process
  (tp 1), on every rank.
- A stall mid-generation under tp, and a refill swap of the same weights
  (each rank installs its own shard; rank 0's call decides the tick): the
  streams unchanged.
- Lockstep: after every tick each rank's slot state (state, position,
  table, generated count, stall) and free list equal rank 0's; a submit on
  another rank raises.
- The wire: a decode step and a verify step, called directly, hand exactly
  ``2 * n_layers`` all-reduces to ``torch.distributed`` and no other
  collective (every collective entry point of ``torch.distributed`` is
  counted), and ``sharding.counts["tp_all_reduce"]`` agrees; each tick adds
  only rank 0's control broadcasts (one, or two when something is new).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

import torch_port_mp as mp
from test_torch_port_serving import _flax_greedy
from horovod_tpu.models import llama as jllama
from horovod_tpu.models import mixtral as jmixtral

from horovod_tpu_torch import convert
from horovod_tpu_torch.models import llama as tllama
from horovod_tpu_torch.models import mixtral as tmixtral
from horovod_tpu_torch.serving import DecodeEngine

PROMPT = [11, 3, 20, 5, 42, 7]
LATE = [9, 8, 7, 6]
SPEC_PROMPT = [5, 6, 7, 5, 6, 7, 5, 6]
HEADS = dict(n_heads=8, n_kv_heads=4)

_WORKER = """
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import decode as MD
from horovod_tpu_torch.models.llama import llama_tiny
from horovod_tpu_torch.models.mixtral import mixtral_tiny
from horovod_tpu_torch.parallel import create_mesh, sharding
from horovod_tpu_torch.serving import DecodeEngine

torch.set_num_threads(1)
tmp = sys.argv[1]
hvd.init(device="cpu")
rank, n = hvd.rank(), hvd.size()
mesh = create_mesh({"tp": n})
heads = dict(n_heads=8, n_kv_heads=4)
cfgs = {"llama": dataclasses.replace(llama_tiny(), **heads),
        "mixtral": dataclasses.replace(mixtral_tiny(), capacity_factor=8.0,
                                       **heads)}
COLLECTIVES = ("all_reduce", "broadcast", "all_gather",
               "all_gather_into_tensor", "reduce_scatter_tensor",
               "reduce_scatter", "all_to_all", "all_to_all_single",
               "broadcast_object_list", "all_gather_object", "send", "recv",
               "isend", "irecv", "barrier", "gather", "scatter", "reduce")
calls = {}
for name in COLLECTIVES:
    real = getattr(dist, name)
    def counting(*a, _name=name, _real=real, **k):
        calls[_name] = calls.get(_name, 0) + 1
        return _real(*a, **k)
    setattr(dist, name, counting)


def shard(kind):
    whole = {k: torch.from_numpy(v) for k, v in
             np.load(f"{tmp}/params_{kind}.npz").items()}
    return MD.decode_shard(cfgs[kind], whole, n, rank)


def engine(kind, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("block_size", 4)
    kw.setdefault("pool_blocks", 24)
    kw.setdefault("max_blocks_per_slot", 8)
    kw.setdefault("prefill_buckets", (8, 16))
    eng = DecodeEngine(cfgs[kind], params=shard(kind), device="cpu",
                       mesh=mesh, **kw)
    # every rank's streams, in the order its slots retire them
    eng.retired = []
    real = eng._retire
    def retire(idx, truncated=False):
        req = eng.slots[idx].req
        real(idx, truncated)
        eng.retired.append(req.tokens)
    eng._retire = retire
    return eng


def state(eng):
    return [[s.state, s.pos, list(s.table), s.gen, bool(s.stalled)]
            for s in eng.slots] + [list(eng.allocator._free)]


def drive(eng, hook=None, limit=500):
    # run_until_idle, tick by tick, recording the slot state after each
    states = []
    for tick in range(limit):
        if hook is not None:
            hook(tick)
        eng._sync()
        if not eng.has_work():
            break
        eng._tick()
        states.append(state(eng))
    return states


def submit(eng, prompt, n_new, reqs):
    if rank == 0:
        reqs.append(eng.submit(prompt, n_new))


out = {}
for kind in ("llama", "mixtral"):
    # greedy, a request admitted mid-run, then spec K = 2 and 4
    eng = engine(kind)
    reqs = []
    submit(eng, %(PROMPT)r, 8, reqs)
    late = lambda tick: tick == 3 and submit(eng, %(LATE)r, 6, reqs)
    states = drive(eng, late)
    out[f"{kind}_greedy"] = [r.tokens for r in reqs]
    out[f"{kind}_greedy_retired"] = eng.retired
    out[f"{kind}_states"] = states
    for k in (2, 4):
        eng = engine(kind, spec_k=k)
        reqs = []
        submit(eng, %(SPEC)r, 12, reqs)
        out[f"{kind}_spec{k}_states"] = drive(eng)
        out[f"{kind}_spec{k}"] = [r.tokens for r in reqs]
        out[f"{kind}_spec{k}_retired"] = eng.retired
        out[f"{kind}_spec{k}_counts"] = eng.compile_counts
    # refill: every rank installs its shard after 4 ticks
    eng = engine(kind)
    reqs = []
    submit(eng, [2, 9, 33, 4, 17, 6], 10, reqs)
    p = shard(kind)
    refill = lambda tick: tick == 4 and eng.install_params(p)
    out[f"{kind}_refill_states"] = drive(eng, refill)
    out[f"{kind}_refill"] = [r.tokens for r in reqs]
    out[f"{kind}_refill_retired"] = eng.retired
    out[f"{kind}_refill_seq"] = eng._model_seq
    eng.close()

# a stall under tp (the one-process stall scenario)
eng = engine("llama", pool_blocks=4, max_blocks_per_slot=4,
             prefill_buckets=(4, 8))
reqs = []
submit(eng, [1, 2], 10, reqs)
submit(eng, [3, 4, 5, 6], 4, reqs)
states = drive(eng)
out["stall_states"] = states
out["stall_seen"] = any(s[0][4] for s in states)
out["stall"] = [r.tokens for r in reqs]
out["stall_retired"] = eng.retired

# only rank 0 takes requests
try:
    engine("llama").submit([1, 2], 3)
    out["submit_raised"] = False
except RuntimeError:
    out["submit_raised"] = True

# the wire of one step, called directly, and of one engine tick
wire = {}
for kind in ("llama", "mixtral"):
    for k in (0, 3):
        eng = engine(kind, spec_k=k)
        reqs = []
        submit(eng, %(PROMPT)r, 6, reqs)
        eng._sync()
        eng._tick()                        # admit and one step
        toks = (eng._owned(np.zeros((2, k), np.int64)) if k
                else eng._dev_tokens)
        fn = eng._verify if k else eng._decode
        calls.clear()
        sharding.reset_counts()
        fn(eng._params, eng._kp, eng._vp, toks,
           eng._owned(eng._positions), eng._tables_device(),
           eng._runnable_device(eng._runnable()))
        wire[f"{kind}_{k}_step"] = [dict(calls),
                                    sharding.counts["tp_all_reduce"]]
        calls.clear()
        eng._sync()
        eng._tick()
        wire[f"{kind}_{k}_tick"] = dict(calls)
        eng.run_until_idle()
out["wire"] = wire
with open(f"{tmp}/rank{rank}_{n}.json", "w") as f:
    json.dump(out, f)
hvd.shutdown()
""" % {"PROMPT": PROMPT, "LATE": LATE, "SPEC": SPEC_PROMPT}


def _build(kind):
    if kind == "llama":
        jcfg = dataclasses.replace(jllama.llama_tiny(), **HEADS)
        tcfg = dataclasses.replace(tllama.llama_tiny(), **HEADS)
        model = jllama.Llama(jcfg)
    else:
        jcfg = dataclasses.replace(jmixtral.mixtral_tiny(),
                                   capacity_factor=8.0, **HEADS)
        tcfg = dataclasses.replace(tmixtral.mixtral_tiny(),
                                   capacity_factor=8.0, **HEADS)
        model = jmixtral.Mixtral(jcfg)
    params = nn.meta.unbox(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32)))["params"]
    return tcfg, model, params, convert.decode_params_from_flax(params, tcfg)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serving_tp")
    built = {kind: _build(kind) for kind in ("llama", "mixtral")}
    for kind, (_, _, _, tparams) in built.items():
        np.savez(tmp / f"params_{kind}.npz",
                 **{k: v.numpy() for k, v in tparams.items()})
    wait = mp.start_worlds(tmp, _WORKER, (2, 4))
    # the oracles and the one-process engine while the worlds run
    want = {}
    for kind, (tcfg, model, params, tparams) in built.items():
        want[kind] = {
            "greedy": [_flax_greedy(model, params, PROMPT, 8),
                       _flax_greedy(model, params, LATE, 6)],
            "spec": [_flax_greedy(model, params, SPEC_PROMPT, 12)],
            "refill": [_flax_greedy(model, params, [2, 9, 33, 4, 17, 6], 10)]}
        if kind == "llama":
            want["stall"] = [_flax_greedy(model, params, [1, 2], 10),
                             _flax_greedy(model, params, [3, 4, 5, 6], 4)]
        eng = DecodeEngine(tcfg, params=tparams, device="cpu", slots=2,
                           block_size=4, pool_blocks=24,
                           max_blocks_per_slot=8, prefill_buckets=(8, 16))
        req = eng.submit(PROMPT, 8)
        eng.run_until_idle()
        want[kind]["tp1"] = req.tokens
        layers = tcfg.n_layers
    wait()
    got = {n: [json.load(open(tmp / f"rank{r}_{n}.json")) for r in range(n)]
           for n in (2, 4)}
    return got, want, layers


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["llama", "mixtral"])
def test_tp_streams_equal_flax_and_one_process(worlds, kind, n):
    got, want, _ = worlds
    rank0 = got[n][0]
    assert rank0[f"{kind}_greedy"] == want[kind]["greedy"]
    assert rank0[f"{kind}_greedy"][0] == want[kind]["tp1"]
    for k in (2, 4):
        assert rank0[f"{kind}_spec{k}"] == want[kind]["spec"], k
        for r in got[n]:
            assert r[f"{kind}_spec{k}_counts"] == {"decode": 0, "prefill": 1,
                                                   "verify": 1}


@pytest.mark.parametrize("n", [2, 4])
def test_tp_stall_and_refill_keep_the_streams(worlds, n):
    got, want, _ = worlds
    rank0 = got[n][0]
    assert rank0["stall_seen"], "no slot stalled: the scenario regressed"
    assert rank0["stall"] == want["stall"]
    for kind in ("llama", "mixtral"):
        assert rank0[f"{kind}_refill"] == want[kind]["refill"]
        for r in got[n]:
            assert r[f"{kind}_refill_seq"] == 1


@pytest.mark.parametrize("n", [2, 4])
def test_tp_ranks_take_the_same_decisions_every_tick(worlds, n):
    """Admission comes from rank 0 alone, yet after every tick each rank's
    slot state and free list equal rank 0's, and every rank retires the
    same tokens."""
    got, _, _ = worlds
    keys = [k for k in got[n][0] if k.endswith("_states")]
    assert len(keys) == 9
    for key in keys:
        ticks = got[n][0][key]
        assert len(ticks) > 5, key
        for r in got[n][1:]:
            assert r[key] == ticks, key
    keys = [k for k in got[n][0] if k.endswith("_retired")]
    assert len(keys) == 9
    for key in keys:
        assert got[n][0][key], key
        for r in got[n][1:]:
            assert r[key] == got[n][0][key], key
    for r in got[n]:
        assert r["submit_raised"] is (r is not got[n][0])


@pytest.mark.parametrize("n", [2, 4])
def test_tp_step_wire_is_two_all_reduces_a_layer(worlds, n):
    got, _, layers = worlds
    for r in got[n]:
        for kind in ("llama", "mixtral"):
            for k in (0, 3):
                calls, counted = r["wire"][f"{kind}_{k}_step"]
                assert calls == {"all_reduce": 2 * layers}, (kind, k, calls)
                assert counted == 2 * layers
                tick = r["wire"][f"{kind}_{k}_tick"]
                assert tick == {"all_reduce": 2 * layers, "broadcast": 1}, \
                    (kind, k, tick)
