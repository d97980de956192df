"""The port's paged-KV decode functions against the JAX package's, on the CPU.

``horovod_tpu_torch/models/decode.py`` against ``horovod_tpu.models.decode``
called directly (not through an engine): ``llama_tiny`` and ``mixtral_tiny``
in f32, weights from one flax init carried across by
``convert.decode_params_from_flax``, in the unrolled and the scanned
layouts, the same seeded tokens on both sides.

- prefill: the logits and both pools after the bulk write;
- decode: five steps of two slots, one inactive (pointing at the null
  block), across a block boundary: logits, next tokens and both pools at
  every step;
- verify: three windows of K = 3 over three slots, one inactive, across a
  block boundary, with drafts that are partly rejected: logits, next tokens
  and both pools;
- Mixtral at ``capacity_factor`` 8.0 (nothing dropped) and at its default
  (2.0): four slots with two inactive whose rows are routed too and
  compete for the capacity (asserted: some routing is dropped);
- the null block all zero after every prefill, decode and verify call;
- ``decode_leaf_shard_axis`` equal to JAX's on every parameter path and
  shape of both layouts and both models, at tp 2, 4 and 3 (indivisible);
- ``export_decode_params`` of a port model loaded from the flax tree equal
  to the JAX package's ``export_decode_params`` after conversion, bit for
  bit, and its dtypes in bf16.

Tolerance: logits and pools within 2e-5 (|ref| + RMS(ref)) per element.
Both sides compute the same f32 arithmetic, in different summation orders
(torch's matmuls against XLA's); those differences are near 1e-6 of the
summed magnitudes over at most 128 terms, so 2e-5 leaves a margin of more
than ten. Next tokens must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from horovod_tpu.models import decode as JMD
from horovod_tpu.models import llama as jllama
from horovod_tpu.models import mixtral as jmixtral
from horovod_tpu.train.step_builder import export_decode_params as j_export

from horovod_tpu_torch import convert
from horovod_tpu_torch.models import decode as TMD
from horovod_tpu_torch.models import llama as tllama
from horovod_tpu_torch.models import mixtral as tmixtral
from horovod_tpu_torch.parallel import moe as tmoe
from horovod_tpu_torch.train.step_builder import export_decode_params

R = 2e-5
BS = 4


def _close(got, ref, what):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    rms = np.sqrt(np.mean(ref ** 2)) if ref.size else 0.0
    err = np.abs(got - ref)
    tol = R * (np.abs(ref) + rms)
    assert (err <= tol).all(), (what, float(err.max()), float(tol.min()))


def _cfgs(kind, layout, cf=None):
    scan = layout == "scanned"
    if kind == "llama":
        j = dataclasses.replace(jllama.llama_tiny(), scan_layers=scan)
        t = tllama.llama_tiny()
        model = jllama.Llama(j)
    else:
        j = dataclasses.replace(jmixtral.mixtral_tiny(), scan_layers=scan)
        t = tmixtral.mixtral_tiny()
        if cf is not None:
            j = dataclasses.replace(j, capacity_factor=cf)
            t = dataclasses.replace(t, capacity_factor=cf)
        model = jmixtral.Mixtral(j)
    return j, t, model


_PARAMS = {}


def _setup(kind, layout, cf=None):
    """(jax cfg, port cfg, flax params, port decode params)."""
    key = (kind, layout)
    j, t, model = _cfgs(kind, layout, cf)
    if key not in _PARAMS:
        params = nn.meta.unbox(jax.jit(model.init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32)))["params"]
        params = jax.tree_util.tree_map(np.asarray, params)
        _PARAMS[key] = params
    params = _PARAMS[key]
    if layout == "scanned":
        assert "layers" in params
    return j, t, params, convert.decode_params_from_flax(params, t)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _null_block_zero(kp, vp):
    assert not _np(kp[:, 0]).any() and not _np(vp[:, 0]).any()


KINDS = [("llama", "unrolled"), ("llama", "scanned"),
         ("mixtral", "unrolled"), ("mixtral", "scanned")]


def _prefill_both(j, t, params, tparams, prompt, bucket, block_ids,
                  n_blocks=16):
    padded = np.zeros((1, bucket), np.int64)
    padded[0, :len(prompt)] = prompt
    jkp, jvp = JMD.init_kv_pools(j, n_blocks, BS)
    jl, jkp, jvp = jax.jit(JMD.make_prefill(j, BS))(
        params, jkp, jvp, jnp.asarray(padded, jnp.int32),
        jnp.asarray(block_ids, jnp.int32))
    tkp, tvp = TMD.init_kv_pools(t, n_blocks, BS, device="cpu")
    tl, tkp, tvp = TMD.make_prefill(t, BS)(
        tparams, tkp, tvp, torch.tensor(padded), torch.tensor(block_ids))
    return (jl, jkp, jvp), (tl, tkp, tvp)


@pytest.mark.parametrize("kind, layout", KINDS)
def test_prefill_matches_jax(kind, layout):
    j, t, params, tparams = _setup(kind, layout)
    prompt = [3, 14, 15, 9, 2, 6, 5, 35, 8, 97, 93, 2, 38]
    (jl, jkp, jvp), (tl, tkp, tvp) = _prefill_both(
        j, t, params, tparams, prompt, 16, [1, 2, 3, 4])
    _close(_np(tl), jl, "prefill logits")
    _close(_np(tkp), jkp, "k pool")
    _close(_np(tvp), jvp, "v pool")
    _null_block_zero(tkp, tvp)


@pytest.mark.parametrize("kind, layout", KINDS)
def test_decode_steps_match_jax(kind, layout):
    """Five decode steps, S = 2 with slot 1 inactive, through a block
    boundary: logits, next tokens and both pools equal JAX's at every
    step, and the inactive slot's writes leave the null block zero."""
    j, t, params, tparams = _setup(kind, layout)
    prompt = [7, 1, 4, 12, 9, 30, 2]
    (jl, jkp, jvp), (tl, tkp, tvp) = _prefill_both(
        j, t, params, tparams, prompt, 8, [1, 2])
    jdec = jax.jit(JMD.make_decode_step(j, BS))
    tdec = TMD.make_decode_step(t, BS)
    seq = prompt + [int(np.argmax(np.asarray(jl)[0, len(prompt) - 1]))]
    table, tables, next_free = [1, 2], np.zeros((2, 8), np.int64), 3
    for _ in range(5):
        pos = len(seq) - 1
        if pos // BS >= len(table):
            table.append(next_free)
            next_free += 1
        tables[0, :len(table)] = table
        toks, poss = np.array([seq[-1], 0]), np.array([pos, 0])
        active = np.array([True, False])
        jl, jnt, jkp, jvp = jdec(params, jkp, jvp, jnp.asarray(toks,
                                                               jnp.int32),
                                 jnp.asarray(poss, jnp.int32),
                                 jnp.asarray(tables, jnp.int32),
                                 jnp.asarray(active))
        tl, tnt, tkp, tvp = tdec(tparams, tkp, tvp, torch.tensor(toks),
                                 torch.tensor(poss), torch.tensor(tables),
                                 torch.tensor(active))
        _close(_np(tl)[0], np.asarray(jl)[0], "decode logits")
        assert int(tnt[0]) == int(jnt[0])
        _close(_np(tkp), jkp, "k pool")
        _close(_np(tvp), jvp, "v pool")
        _null_block_zero(tkp, tvp)
        seq.append(int(tnt[0]))


def _verify_windows(j, t, params, tparams, S, active, cf_label):
    """Three verify windows of K = 3 over S slots (one prefilled prompt a
    live slot), drafts that are right, wrong, right; both sides fed the
    same windows. Returns nothing: asserts as it goes."""
    K = 3
    prompts = {0: [5, 6, 7, 5, 6], 1: [9, 8, 7, 6, 5, 4, 3], 2: [1, 2, 3]}
    live = [s for s in range(S) if active[s]]
    n_blocks = 24
    jkp, jvp = JMD.init_kv_pools(j, n_blocks, BS)
    tkp, tvp = TMD.init_kv_pools(t, n_blocks, BS, device="cpu")
    jpre = jax.jit(JMD.make_prefill(j, BS))
    tpre = TMD.make_prefill(t, BS)
    tables = np.zeros((S, 8), np.int64)
    nxt = 1
    pending, pos = {}, {}
    for s in live:
        p = prompts[s]
        bucket = 8
        blocks = list(range(nxt, nxt + bucket // BS))
        nxt += len(blocks)
        tables[s, :len(blocks)] = blocks
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :len(p)] = p
        jl, jkp, jvp = jpre(params, jkp, jvp, jnp.asarray(padded, jnp.int32),
                            jnp.asarray(blocks, jnp.int32))
        tl, tkp, tvp = tpre(tparams, tkp, tvp, torch.tensor(padded),
                            torch.tensor(blocks))
        _close(_np(tl), jl, f"{cf_label} prefill logits")
        pending[s] = int(np.argmax(np.asarray(jl)[0, len(p) - 1]))
        pos[s] = len(p)
    jver = jax.jit(JMD.make_verify_step(j, BS))
    tver = TMD.make_verify_step(t, BS)
    for w in range(3):
        toks = np.zeros((S, K), np.int64)
        poss = np.zeros(S, np.int64)
        for s in live:
            while (pos[s] + K - 1) // BS >= int((tables[s] > 0).sum()):
                tables[s, int((tables[s] > 0).sum())] = nxt
                nxt += 1
            toks[s, 0] = pending[s]
            toks[s, 1:] = [(pending[s] + 1 + w) % 256, pending[s]]
            poss[s] = pos[s]
        args = (toks, poss, tables, np.asarray(active))
        jl, jg, jkp, jvp = jver(params, jkp, jvp,
                                *[jnp.asarray(a, jnp.int32 if a.dtype !=
                                              bool else bool) for a in args])
        tl, tg, tkp, tvp = tver(tparams, tkp, tvp,
                                *[torch.tensor(a) for a in args])
        for s in live:
            _close(_np(tl)[s], np.asarray(jl)[s], f"{cf_label} verify logits")
            assert _np(tg)[s].tolist() == np.asarray(jg)[s].tolist()
        _close(_np(tkp), jkp, f"{cf_label} k pool")
        _close(_np(tvp), jvp, f"{cf_label} v pool")
        _null_block_zero(tkp, tvp)
        g = _np(tg)
        for s in live:
            n_acc = int(np.cumprod(toks[s, 1:] == g[s, :-1]).sum())
            pending[s] = int(g[s, n_acc])
            pos[s] += n_acc + 1


@pytest.mark.parametrize("kind, layout", KINDS)
def test_verify_windows_match_jax(kind, layout):
    j, t, params, tparams = _setup(kind, layout)
    _verify_windows(j, t, params, tparams, 3, [True, False, True], kind)


@pytest.mark.parametrize("cf", [8.0, None])
def test_mixtral_inactive_rows_compete_for_capacity(cf, monkeypatch):
    """Four slots, two inactive: every row is routed, as in JAX, and at
    the default capacity factor (2.0: capacity 2 for 4 tokens over 8
    experts) some of the (token, choice) entries are dropped, the inactive
    rows' among those that compete. Decode and verify logits, tokens and
    pools still equal JAX's."""
    j, t, params, tparams = _setup("mixtral", "unrolled")
    if cf is not None:
        j = dataclasses.replace(j, capacity_factor=cf)
        t = dataclasses.replace(t, capacity_factor=cf)
    dropped = []
    real = tmoe.topk_router_sorted

    def counting(logits, E, capacity, k):
        r = real(logits, E, capacity, k)
        dropped.append(int((r.dest == E * capacity).sum()))
        return r
    monkeypatch.setattr(TMD, "topk_router_sorted", counting)
    _verify_windows(j, t, params, tparams, 4, [True, False, True, False],
                    f"cf {cf}")
    # and the plain decode step on the same four slots
    (jl, jkp, jvp), (tl, tkp, tvp) = _prefill_both(
        j, t, params, tparams, [4, 8, 15, 16, 23], 8, [1, 2])
    toks = np.array([int(np.argmax(np.asarray(jl)[0, 4])), 3, 0, 9])
    poss = np.array([5, 0, 0, 0])
    tables = np.zeros((4, 8), np.int64)
    tables[0, :2] = [1, 2]
    active = np.array([True, False, False, False])
    dropped.clear()
    jl, jnt, jkp, jvp = jax.jit(JMD.make_decode_step(j, BS))(
        params, jkp, jvp, jnp.asarray(toks, jnp.int32),
        jnp.asarray(poss, jnp.int32), jnp.asarray(tables, jnp.int32),
        jnp.asarray(active))
    tl, tnt, tkp, tvp = TMD.make_decode_step(t, BS)(
        tparams, tkp, tvp, torch.tensor(toks), torch.tensor(poss),
        torch.tensor(tables), torch.tensor(active))
    _close(_np(tl)[0], np.asarray(jl)[0], "decode logits")
    assert int(tnt[0]) == int(jnt[0])
    _close(_np(tkp), jkp, "k pool")
    _null_block_zero(tkp, tvp)
    if cf is None:
        assert sum(dropped) > 0, dropped


def _jax_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _jax_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), np.shape(v)


def _port_key(path, layer):
    """A flax path (unrolled ``block_i`` or scanned ``layers/block``) -> the
    port's state-dict key, and whether the leaf is a transposed dense
    kernel."""
    names = list(path)
    if names[0] == "layers":
        names = [f"block_{layer}"] + names[2:]
    top = names[0]
    if top == "embedding":
        return "embedding", False
    if top == "lm_head":
        return "lm_head.weight", True
    if top == "final_norm":
        return "final_norm.scale", False
    i = int(top.split("_")[1])
    rest = names[1:]
    if rest[-1] == "kernel":
        return f"blocks.{i}." + ".".join(rest[:-1]) + ".weight", True
    return f"blocks.{i}." + ".".join(rest), False


@pytest.mark.parametrize("tp", [2, 4, 3])
@pytest.mark.parametrize("kind, layout", KINDS)
def test_decode_leaf_shard_axis_matches_jax(kind, layout, tp):
    j, t, params, tparams = _setup(kind, layout)
    seen = 0
    for path, shape in _jax_paths(params):
        lead = 1 if path[0] == "layers" else 0
        jax_ax = JMD.decode_leaf_shard_axis(path, shape, tp)
        key, transposed = _port_key(path, 0)
        port_shape = tuple(tparams[key].shape)
        assert port_shape == (shape[lead:][::-1] if transposed
                              else shape[lead:]), (path, key)
        port_ax = TMD.decode_leaf_shard_axis(key, port_shape, tp)
        if jax_ax is None:
            assert port_ax is None, (path, key)
        else:
            want = jax_ax - lead
            if transposed:
                want = len(port_shape) - 1 - want
            assert port_ax == want, (path, key, jax_ax, port_ax)
        seen += 1
    assert seen >= 12
    specs = TMD.decode_param_specs(t, tparams, 2)
    assert set(specs) == set(tparams)


@pytest.mark.parametrize("kind, layout", KINDS)
def test_export_decode_params_matches_flax_export(kind, layout):
    """The port model loaded from the flax tree, exported, equals the JAX
    package's export of that tree carried across, bit for bit (f32); in a
    bf16 configuration the matrices are bf16 and the embedding, the norm
    scales and the router stay f32."""
    j, t, params, _ = _setup(kind, layout)
    cls = tllama.Llama if kind == "llama" else tmixtral.Mixtral
    model = cls(t, device="cpu")
    sd = (convert.llama_params_from_flax if kind == "llama"
          else convert.mixtral_params_from_flax)(params, t)
    model.load_state_dict(sd)
    got = export_decode_params(model)
    want = convert.decode_params_from_flax(j_export({"params": params}), t)
    assert set(got) == set(want) == set(sd)
    for k in got:
        assert torch.equal(got[k], want[k]), k
        assert got[k].data_ptr() != model.state_dict()[k].data_ptr()
    bf = export_decode_params(model.state_dict(),
                              dataclasses.replace(t, dtype=torch.bfloat16))
    for k, v in bf.items():
        f32 = k == "embedding" or k.endswith((".scale", "router.weight"))
        assert v.dtype == (torch.float32 if f32 else torch.bfloat16), k
        assert torch.equal(v, sd[k].to(v.dtype)), k
