"""The port's numeric-integrity sentinel against the JAX package's.

In process:

- ``param_digest`` bit-equal to JAX's on the same bytes: f32, bf16 and f16
  leaves, odd lengths, NaN payloads and infinities, empty and integer
  leaves, and leaves folded in several chunks;
- the health vector: the finite bit and the digest exact, the squared norm
  within f32 summation order (rtol 1e-6);
- the ladder's actions and counters equal to the reference ``Sentinel``'s
  over the same ``Health`` sequences (a hypothesis property), and
  ``decode_health``, ``resolve`` and ``default_evict`` as the reference's.

In a 2-process gloo world of the port, started once for the module, beside
the JAX package's ``make_train_step`` on the 8-device CPU mesh (the same
global batch and weights; JAX's shards 4-7 are the port's rank 1):

- ``llama_tiny`` with AdamW, the sentinel on: clean, NaN on rank 1, NaN on
  rank 1 again (``max_skips=1``: the rollback through ``rollback_fn`` to
  the state after the first step), clean (the containment's no-update
  step), clean. The NaN step leaves parameters and optimizer state bitwise
  unchanged on every rank; losses and the final parameters match JAX's
  within 1e-5; the counters match.
- The sentinel does not perturb a clean step (on and off bit-identical),
  and ``scan_steps=2`` equals two single steps bit for bit, and JAX's
  ``scan_steps=2`` within 1e-5.
- ``ResNetTiny`` with SyncBatchNorm and SGD momentum: a NaN step leaves
  parameters, momentum and the BatchNorm running statistics bitwise
  unchanged; the trajectory matches JAX's within 1e-5.
- A flipped bit on rank 1 of 2: the verdict is ``abort``; on the mesh step
  over ``{"fsdp": 2}`` the single health row's digest is the digest of the
  whole parameters, JAX's, a NaN step applies nothing, and
  ``scan_steps=2`` equals two single mesh steps bit for bit.

In a 3-process world: one bit of one parameter flipped on rank 2 gives
``evict`` naming rank 2, as the reference ``Sentinel`` decides on the same
gathered health, whose digests are JAX's of each rank's parameters.
"""

import pickle
import textwrap

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import horovod_tpu as hvd
import torch_port_mp as mp
from horovod_tpu.core import sentinel as jsentinel
from horovod_tpu.core.exceptions import HorovodInternalError as JError
from horovod_tpu.models import llama as jllama
from horovod_tpu.models import resnet as jresnet
from horovod_tpu.optimizer import distributed
from horovod_tpu.train import create_train_state, make_train_step
from horovod_tpu.train.gspmd import next_token_loss as j_next_token_loss

from horovod_tpu_torch import convert
from horovod_tpu_torch.core import sentinel as tsentinel
from horovod_tpu_torch.core.exceptions import HorovodInternalError
from horovod_tpu_torch.models import llama as tllama

# -- the digest and the health vector ----------------------------------------


def _bits(*words):
    return np.asarray(words, np.uint32).view(np.float32)


_DIGEST_CASES = {
    "f32-empty": [np.zeros(0, np.float32)],
    "f32-one": [np.float32([1.5])],
    "f32-odd": [np.random.RandomState(0).randn(1001).astype(np.float32)],
    "f32-pow2-plus-one": [np.random.RandomState(1).randn(4097)
                          .astype(np.float32)],
    "f32-nan-payloads-and-inf": [_bits(0x7FC00001, 0xFFFFFFFF, 0x7F800000,
                                       0xFF800000, 0x00000001, 0x80000000)],
    "bf16-odd": [np.random.RandomState(2).randn(3, 7)
                 .astype(ml_dtypes.bfloat16)],
    "f16-odd": [np.random.RandomState(3).randn(5, 3).astype(np.float16)],
    "mixed-with-int-leaf": [np.random.RandomState(4).randn(6, 5)
                            .astype(np.float32), np.arange(7),
                            np.random.RandomState(5).randn(3)
                            .astype(ml_dtypes.bfloat16)],
}


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _jax_digest(leaves):
    return int(np.asarray(jsentinel.param_digest(
        {str(i): jnp.asarray(a) for i, a in enumerate(leaves)})))


@pytest.mark.parametrize("chunk", [tsentinel.DIGEST_CHUNK, 7])
@pytest.mark.parametrize("case", sorted(_DIGEST_CASES))
def test_param_digest_is_bit_equal_to_jax(case, chunk, monkeypatch):
    monkeypatch.setattr(tsentinel, "DIGEST_CHUNK", chunk)
    leaves = _DIGEST_CASES[case]
    got = tsentinel.param_digest([_torch(a) for a in leaves])
    assert got.dtype == torch.int32 and got.dim() == 0
    assert (int(got) & 0xFFFFFFFF) == _jax_digest(leaves)


def test_one_flipped_bit_changes_the_digest():
    a = np.random.RandomState(6).randn(257).astype(np.float32)
    b = a.copy()
    b.view(np.uint32)[100] ^= 1 << 3
    assert int(tsentinel.param_digest([_torch(a)])) != \
        int(tsentinel.param_digest([_torch(b)]))


@pytest.mark.parametrize("poison", [None, "nan", "inf"])
def test_health_vector_matches_jax(poison):
    rng = np.random.RandomState(7)
    params = [rng.randn(9, 5).astype(np.float32),
              rng.randn(11).astype(np.float32)]
    grads = [rng.randn(9, 5).astype(np.float32) * 100,
             rng.randn(11).astype(np.float32)]
    if poison:
        grads[1][3] = np.nan if poison == "nan" else np.inf
    jtree = lambda leaves: {str(i): jnp.asarray(a)
                            for i, a in enumerate(leaves)}
    want = np.asarray(jsentinel.health_vector(jtree(grads), jtree(params)))
    got = tsentinel.health_vector([_torch(g) for g in grads],
                                  [_torch(p) for p in params],
                                  gather=False).numpy()
    assert got.shape == want.shape == (1, 3)
    assert got[0, 0] == want[0, 0]
    assert got[:, 2].view(np.uint32) == want[:, 2].view(np.uint32)
    if poison:
        assert not np.isfinite(got[0, 1]) and not np.isfinite(want[0, 1])
    else:
        np.testing.assert_allclose(got[0, 1], want[0, 1], rtol=1e-6)
    jh, th = jsentinel.decode_health(want), tsentinel.decode_health(got)
    assert th.finite == jh.finite and \
        list(th.fingerprints) == list(jh.fingerprints)


# -- the ladder ------------------------------------------------------------------

@st.composite
def _health_sequences(draw):
    n = draw(st.integers(1, 5))
    steps = draw(st.lists(st.tuples(
        st.lists(st.booleans(), min_size=n, max_size=n),
        st.lists(st.sampled_from([7, 7, 7, 9]), min_size=n, max_size=n)),
        min_size=1, max_size=12))
    return n, steps


@settings(max_examples=200, deadline=None)
@given(seq=_health_sequences(), max_skips=st.integers(0, 3),
       max_rollbacks=st.integers(0, 2))
def test_ladder_actions_equal_the_reference(seq, max_skips, max_rollbacks):
    n, steps = seq
    ref = jsentinel.Sentinel(max_skips, max_rollbacks, clock=lambda: 0.0)
    port = tsentinel.Sentinel(max_skips, max_rollbacks, clock=lambda: 0.0)
    for i, (finite, prints) in enumerate(steps):
        fbr = np.asarray(finite, bool)
        fps = np.asarray(prints, np.uint32)
        want = ref.observe(jsentinel.Health(bool(fbr.all()), fbr, 1.0, fps),
                           i)
        got = port.observe(tsentinel.Health(bool(fbr.all()), fbr, 1.0, fps),
                           i)
        assert tuple(got) == tuple(want)
        assert port.in_containment == ref.in_containment
    assert port.counters() == ref.counters()
    assert [h[1:] for h in port.history] == [h[1:] for h in ref.history]


def test_minority_and_observe_finite_match_the_reference():
    for values in ([1, 1, 2], [1, 2], [3, 3, 3, 4, 4], [5], [1, 2, 3]):
        a = np.asarray(values, np.uint32)
        got, want = tsentinel._minority_ranks(a), jsentinel._minority_ranks(a)
        assert (got is None) == (want is None)
        if got is not None:
            assert list(got) == list(want)
    ref, port = jsentinel.Sentinel(1, 0), tsentinel.Sentinel(1, 0)
    for i, ok in enumerate([True, False, False, True]):
        assert tuple(port.observe_finite(ok, i)) == \
            tuple(ref.observe_finite(ok, i))


def test_resolve_install_and_evict_like_the_reference(monkeypatch):
    for var in (tsentinel.COORD_ADDR_ENV, tsentinel.WORLD_VERSION_ENV):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HOROVOD_SENTINEL", "1")
    monkeypatch.setenv("HOROVOD_SENTINEL_MAX_SKIPS", "5")
    s = tsentinel.resolve(None)
    assert s is tsentinel.active() and s.max_skips == 5
    assert tsentinel.resolve(False) is None
    mine = tsentinel.Sentinel()
    assert tsentinel.resolve(mine) is mine is tsentinel.active()
    assert tsentinel.counters() == mine.counters()
    tsentinel.install(None)
    assert tsentinel.counters() == {"steps_skipped": 0, "rollbacks": 0,
                                    "evictions": 0,
                                    "last_fingerprint_mismatch_step": -1}
    assert (tsentinel.RESTART_EXIT_CODE, tsentinel.EVICT_EXIT_CODE) == (73, 75)
    for kind in ("evict", "abort"):
        with pytest.raises(HorovodInternalError, match=f"sentinel {kind}"):
            tsentinel.default_evict(tsentinel.SentinelAction(kind, 1, "x"))
        with pytest.raises(JError, match=f"sentinel {kind}"):
            jsentinel.default_evict(jsentinel.SentinelAction(kind, 1, "x"))
    with pytest.raises(HorovodInternalError, match="rollback"):
        tsentinel.Sentinel().do_rollback(None)


# -- the train steps with the guards on, in gloo worlds ------------------------

#: The steps' flags: 1 keeps a row's loss, NaN poisons it (rank 1's rows).
_TRAJECTORY = ["clean", "nan", "nan", "clean", "clean"]
_RESNET = ["clean", "nan", "clean", "clean"]

_WORKER = textwrap.dedent("""
    import copy
    import pickle
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.core import sentinel as S
    from horovod_tpu_torch.models.llama import Llama, llama_tiny
    from horovod_tpu_torch.models.resnet import ResNetTiny
    from horovod_tpu_torch.parallel import create_mesh, sharding
    from horovod_tpu_torch.train import (create_gspmd_train_state,
                                         create_train_state,
                                         make_gspmd_train_step,
                                         make_train_step, mesh_param_groups,
                                         next_token_loss, shard_tokens)

    data_dir, mode = sys.argv[1], sys.argv[2]
    hvd.init(device="cpu")
    rank, size = hvd.rank(), hvd.size()
    out = {}

    def snap(model, opt):
        return ({k: v.detach().clone() for k, v in model.state_dict().items()},
                copy.deepcopy(opt.state_dict()))

    def same(a, b):
        return all(torch.equal(a[k], b[k]) for k in a)

    def same_state(a, b):
        for k in a["state"]:
            for n, v in a["state"][k].items():
                if torch.is_tensor(v) and not torch.equal(v, b["state"][k][n]):
                    return False
        return True

    def flags(kind, n):
        f = torch.ones(n)
        if kind == "nan" and rank == 1:
            f[:] = float("nan")
        return f

    if mode == "evict":
        model = torch.nn.Sequential(torch.nn.Linear(6, 5),
                                    torch.nn.Linear(5, 1))
        with torch.no_grad():
            for i, p in enumerate(model.parameters()):
                p.copy_(torch.linspace(-1, 1, p.numel()).reshape(p.shape)
                        + i)
            if rank == size - 1:
                p0 = next(model.parameters())
                p0.view(-1).view(torch.int32)[3] ^= 1 << 3
        params = [p.detach().numpy().copy() for p in model.parameters()]
        seen = []
        s = S.Sentinel(evict_fn=lambda a: seen.append(tuple(a)))
        opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                       lr=0.1))
        step = make_train_step(model, opt, lambda y, t: (y - t).square().mean(),
                               sentinel=s)
        rows = []
        real = opt.health
        opt.health = lambda *a, **k: rows.append(real(*a, **k)) or rows[-1]
        state = create_train_state(model, opt, broadcast=False)
        state, _ = step(state, torch.ones(2, 6) * (rank + 1), torch.zeros(2, 1))
        out = {"seen": seen, "health": rows[0].numpy(), "params": params}
    else:
        data = np.load(f"{data_dir}/llama_init.npz")
        init = {k: torch.from_numpy(data[k]) for k in data.files
                if k not in ("tokens", "flags")}
        tokens = torch.from_numpy(data["tokens"])
        per = tokens.shape[0] // size
        shard = tokens[rank * per:(rank + 1) * per]

        def loss_fn(logits, labels):
            toks, f = labels
            return next_token_loss(logits, toks) * f.mean()

        def llama(sentinel, scan=None):
            model = Llama(llama_tiny(), device="cpu", seed=rank)
            model.load_state_dict(init)
            opt = hvd.DistributedOptimizer(
                torch.optim.AdamW(model.parameters(), lr=1e-3,
                                  weight_decay=1e-4),
                named_parameters=model.named_parameters())
            step = make_train_step(model, opt, loss_fn, sentinel=sentinel,
                                   scan_steps=scan)
            return model, opt, step, create_train_state(model, opt)

        # on and off: bit-identical over two clean steps; scan_steps=2 too
        runs = {}
        for name, sentinel, scan, calls in (("on", S.Sentinel(), None, 2),
                                            ("off", False, None, 2),
                                            ("scan", S.Sentinel(), 2, 1)):
            model, opt, step, state = llama(sentinel, scan)
            losses = []
            for _ in range(calls):
                state, loss = step(state, shard,
                                   (shard, flags("clean", per)))
                losses.append(loss.item())
            runs[name] = (snap(model, opt)[0], losses, state.step)
        out["on_off_equal"] = same(runs["on"][0], runs["off"][0]) and \\
            runs["on"][1] == runs["off"][1]
        out["scan_equal"] = same(runs["on"][0], runs["scan"][0]) and \\
            runs["scan"][1][-1] == runs["on"][1][-1]
        out["scan_step"] = runs["scan"][2]
        out["scan_params"] = {k: v.numpy() for k, v in runs["scan"][0].items()}

        # the guarded trajectory, with the rollback
        saved = {}

        def rollback(state):
            model.load_state_dict(saved["model"])
            opt.load_state_dict(saved["opt"])
            return state._replace(step=saved["step"])

        s = S.Sentinel(max_skips=1, max_rollbacks=1, rollback_fn=rollback)
        model, opt, step, state = llama(s)
        losses, unchanged = [], []
        for i, kind in enumerate(%(trajectory)r):
            before = snap(model, opt)
            state, loss = step(state, shard, (shard, flags(kind, per)))
            losses.append(loss.item())
            after = snap(model, opt)
            unchanged.append(same(before[0], after[0])
                             and same_state(before[1], after[1]))
            if i == 0:
                saved.update(model=after[0], opt=after[1], step=state.step)
        out["trajectory"] = {
            "losses": losses, "unchanged": unchanged, "step": state.step,
            "counters": s.counters(),
            "params": {k: v.detach().numpy()
                       for k, v in model.state_dict().items()}}

        # ResNetTiny with SyncBatchNorm: the BatchNorm buffers are guarded
        data = np.load(f"{data_dir}/resnet_init.npz")
        model = ResNetTiny(num_classes=10, dtype=torch.float32,
                           sync_batch_norm=True, device="cpu", seed=rank)
        model.load_state_dict({k: torch.from_numpy(data[k])
                               for k in data.files
                               if k not in ("images", "labels")})
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters())
        step = make_train_step(
            model, opt, lambda lg, y: torch.nn.functional.cross_entropy(
                lg, y[0]) * y[1].mean(), sentinel=S.Sentinel())
        state = create_train_state(model, opt)
        per = data["images"].shape[0] // size
        own = slice(rank * per, (rank + 1) * per)
        images = torch.from_numpy(data["images"][own])
        labels = torch.from_numpy(data["labels"][own])
        losses, unchanged = [], []
        for kind in %(resnet)r:
            before = snap(model, opt)
            state, loss = step(state, images, (labels, flags(kind, per)))
            losses.append(loss.item())
            after = snap(model, opt)
            unchanged.append(same(before[0], after[0])
                             and same_state(before[1], after[1]))
        out["resnet"] = {"losses": losses, "unchanged": unchanged,
                         "state": {k: v.detach().numpy() for k, v
                                   in model.state_dict().items()}}

        # a flipped bit on the last of 2 ranks: no strict minority, abort
        model = torch.nn.Linear(4, 2)
        with torch.no_grad():
            model.weight.fill_(0.5)
            model.bias.zero_()
            if rank == 1:
                model.weight.view(-1).view(torch.int32)[0] ^= 1
        seen = []
        opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                       lr=0.1))
        step = make_train_step(model, opt, lambda y, t: y.sum(),
                               sentinel=S.Sentinel(
                                   evict_fn=lambda a: seen.append(a.kind)))
        step(create_train_state(model, opt, broadcast=False),
             torch.ones(1, 4), None)
        out["abort"] = seen

        # the mesh step on {"fsdp": 2}: the whole model's digest, a NaN step
        # applies nothing
        with open(f"{data_dir}/flax_params.pkl", "rb") as f:
            flax_params = pickle.load(f)
        mesh = create_mesh({"fsdp": 2})
        cfg = llama_tiny()
        model = Llama(cfg, device="cpu", seed=rank, mesh=mesh)
        model.load_state_dict(convert.llama_params_from_flax(
            flax_params, cfg, mesh=mesh))
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(mesh_param_groups(model, mesh), lr=1e-3),
            named_parameters=model.named_parameters())
        state = create_gspmd_train_state(model, opt, mesh)
        s = S.Sentinel()
        rows = []
        import horovod_tpu_torch.train.gspmd as G
        real = G._mesh_health
        G._mesh_health = lambda *a: rows.append(real(*a)) or rows[-1]
        step = make_gspmd_train_step(model, opt, mesh, sentinel=s)
        toks = shard_tokens(tokens, mesh)
        before = snap(model, opt)[0]
        for p in model.parameters():
            p.register_hook(lambda g: g * float("nan") if poison else g)
        poison = True
        state, loss = step(state, toks)
        out["mesh"] = {"rows": [r.numpy() for r in rows],
                       "unchanged": same(before, snap(model, opt)[0]),
                       "skipped": s.steps_skipped}
        G._mesh_health = real
        # scan_steps=2 on the mesh against two single mesh steps
        poison = False
        blocks = []
        for scan, calls in ((None, 2), (2, 1)):
            model = Llama(cfg, device="cpu", seed=rank, mesh=mesh)
            model.load_state_dict(convert.llama_params_from_flax(
                flax_params, cfg, mesh=mesh))
            opt = hvd.DistributedOptimizer(
                torch.optim.AdamW(mesh_param_groups(model, mesh), lr=1e-3),
                named_parameters=model.named_parameters())
            state = create_gspmd_train_state(model, opt, mesh)
            step = make_gspmd_train_step(model, opt, mesh,
                                         sentinel=S.Sentinel(),
                                         scan_steps=scan)
            for _ in range(calls):
                state, loss = step(state, toks)
            blocks.append((snap(model, opt)[0], loss.item(), state.step))
        out["mesh"]["scan_equal"] = same(blocks[0][0], blocks[1][0]) and \
            blocks[0][1:] == blocks[1][1:] == (blocks[0][1], 2)
    with open(f"{data_dir}/{mode}{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    hvd.shutdown()
""") % {"trajectory": _TRAJECTORY, "resnet": _RESNET}


def _flags(kinds, rows):
    """The per-step [B] flags of the global batch: NaN on the rows of the
    port's rank 1 (the second half) on a "nan" step."""
    out = []
    for kind in kinds:
        f = np.ones(rows, np.float32)
        if kind == "nan":
            f[rows // 2:] = np.nan
        out.append(f)
    return out


def _jax_llama(tmp):
    """The JAX side of the Llama cases; writes the weights and the batch
    for the port's world."""
    cfg = jllama.llama_tiny()
    model = jllama.Llama(cfg)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (8, 16))
    dopt = distributed(optax.adamw(1e-3, weight_decay=1e-4))
    state0 = create_train_state(model, jax.random.PRNGKey(0),
                                jnp.asarray(tokens[:1]), dopt)
    tcfg = tllama.llama_tiny()
    init = convert.llama_params_from_flax(state0.params, tcfg)
    np.savez(tmp / "llama_init.npz", tokens=tokens,
             **{k: v.numpy() for k, v in init.items()})
    with open(tmp / "flax_params.pkl", "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, state0.params), f)

    def loss_fn(logits, labels):
        toks, f = labels
        return j_next_token_loss(logits, toks) * jnp.mean(f)

    toks = jnp.asarray(tokens)
    scan = make_train_step(model, dopt, loss_fn, donate=False, scan_steps=2,
                           sentinel=jsentinel.Sentinel())
    s_scan, _ = scan(state0, toks, (toks, jnp.ones(8, jnp.float32)))
    saved = {}
    s = jsentinel.Sentinel(max_skips=1, max_rollbacks=1,
                           rollback_fn=lambda st: saved["state"])
    step = make_train_step(model, dopt, loss_fn, donate=False, sentinel=s)
    state, losses = state0, []
    for i, f in enumerate(_flags(_TRAJECTORY, 8)):
        state, loss = step(state, toks, (toks, jnp.asarray(f)))
        losses.append(float(loss))
        if i == 0:
            saved["state"] = state
    return {"scan": convert.llama_params_from_flax(s_scan.params, tcfg),
            "params": convert.llama_params_from_flax(state.params, tcfg),
            "losses": losses, "step": int(state.step),
            "counters": s.counters(),
            "digest": int(np.asarray(jsentinel.param_digest(state0.params)))}


def _jax_resnet(tmp):
    model = jresnet.ResNetTiny(num_classes=10, dtype=jnp.float32,
                               axis_name=hvd.RANK_AXIS)
    rng = np.random.RandomState(5)
    images = rng.randn(16, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 10, 16)
    dopt = distributed(optax.sgd(0.1, momentum=0.9))
    state = create_train_state(model, jax.random.PRNGKey(0),
                               jnp.asarray(images[:1]), dopt)
    init = convert.resnet_params_from_flax(
        {"params": state.params, "batch_stats": state.batch_stats})
    np.savez(tmp / "resnet_init.npz", images=images, labels=labels,
             **{k: v.numpy() for k, v in init.items()})

    def xent(logits, y):
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y[0]).mean() * jnp.mean(y[1])

    step = make_train_step(model, dopt, xent, donate=False,
                           sentinel=jsentinel.Sentinel())
    losses = []
    for f in _flags(_RESNET, 16):
        state, loss = step(state, jnp.asarray(images),
                           (jnp.asarray(labels), jnp.asarray(f)))
        losses.append(float(loss))
    return {"state": convert.resnet_params_from_flax(
        {"params": state.params, "batch_stats": state.batch_stats}),
        "losses": losses}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sentinel")
    hvd.shutdown()
    hvd.init()
    want_resnet = _jax_resnet(tmp)
    evict = tmp / "evict"
    evict.mkdir()
    wait3 = mp.start_worlds(evict, _WORKER, (3,), ("evict",))
    # The port's 2-rank world reads the weights the JAX side writes.
    want_llama = _jax_llama(tmp)
    wait2 = mp.start_worlds(tmp, _WORKER, (2,), ("main",))
    wait3()
    wait2()
    out = {}
    for mode, n, d in (("main", 2, tmp), ("evict", 3, evict)):
        out[mode] = []
        for r in range(n):
            with open(d / f"{mode}{r}.pkl", "rb") as f:
                out[mode].append(pickle.load(f))
    return out, want_llama, want_resnet


def _close(got, want, what):
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w.numpy() if torch.is_tensor(w)
                                   else w, rtol=1e-5, atol=1e-5,
                                   err_msg=f"{what} {k}")


def test_sentinel_does_not_perturb_a_clean_step(worlds):
    out, *_ = worlds
    for r in out["main"]:
        assert r["on_off_equal"]


def test_scan_steps_equal_single_steps_and_jax(worlds):
    out, want, _ = worlds
    for r in out["main"]:
        assert r["scan_equal"] and r["scan_step"] == 2
        _close(r["scan_params"], want["scan"], "scan_steps=2")


def test_nan_step_skips_then_rolls_back_like_jax(worlds):
    out, want, _ = worlds
    for r in out["main"]:
        t = r["trajectory"]
        # the NaN steps change nothing; the rollback restores the state
        # after step 0, which is the state before it; the containment step
        # changes nothing
        assert t["unchanged"] == [False, True, True, True, False]
        assert t["counters"] == want["counters"]
        assert t["counters"]["steps_skipped"] == 1 and \
            t["counters"]["rollbacks"] == 1
        assert t["step"] == want["step"]
        np.testing.assert_allclose(t["losses"], want["losses"], rtol=1e-5)
        _close(t["params"], want["params"], "trajectory")


def test_resnet_nan_step_keeps_batch_norm_buffers(worlds):
    out, _, want = worlds
    for r in out["main"]:
        res = r["resnet"]
        assert res["unchanged"] == [False, True, True, False]
        np.testing.assert_allclose(res["losses"], want["losses"], rtol=1e-5)
        _close(res["state"], {k: v for k, v in want["state"].items()},
               "resnet")


def test_flipped_bit_on_one_of_two_ranks_aborts(worlds):
    out, *_ = worlds
    for r in out["main"]:
        assert r["abort"] == ["abort"]


def test_mesh_health_row_is_the_whole_models(worlds):
    out, want, _ = worlds
    for r in out["main"]:
        m = r["mesh"]
        assert len(m["rows"]) == 1 and m["rows"][0].shape == (1, 3)
        assert m["rows"][0][0, 0] == 0.0
        assert int(m["rows"][0][:, 2].view(np.uint32)[0]) == want["digest"]
        assert m["unchanged"] and m["skipped"] == 1
        # and scan_steps=2 on the mesh equals two single mesh steps
        assert m["scan_equal"]


def test_one_bit_minority_of_three_is_evicted(worlds):
    out, *_ = worlds
    ranks = out["evict"]
    health = ranks[0]["health"]
    assert health.shape == (3, 3)
    digests = [_jax_digest(r["params"]) for r in ranks]
    assert list(health[:, 2].view(np.uint32)) == digests
    assert digests[0] == digests[1] != digests[2]
    want = jsentinel.Sentinel().observe(jsentinel.decode_health(health), 1)
    assert (want.kind, want.rank) == ("evict", 2)
    for r in ranks:
        assert np.array_equal(r["health"].view(np.uint32),
                              health.view(np.uint32))
        assert r["seen"] == [tuple(want)]
