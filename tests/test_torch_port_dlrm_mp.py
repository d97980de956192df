"""DLRM over ep and dp in the port against the JAX package, on the CPU.

One gloo world of 4 processes, started once for the module, trains a
tiny DLRM (f32; ``dlrm_tiny()``, 8 tables of 64 x 8, and the same with 6
tables) for three steps on a seeded global batch of 16 examples (ids in
[0, 8), so rows repeat within and across the data shards), lr 1e-2, eps
1e-7, acc0 0.1, each rank on its data shard (dp-major) and its tables cut
from the flax init by ``convert.dlrm_params_from_flax(..., mesh=mesh)``:

- ``{"ep": 4}``, ``{"dp": 2, "ep": 2}`` and ``{"ep": 4}`` with 6 tables
  (split 2, 2, 1, 1) through ``build_sparse_training``: the rows cross
  the ep axis in three all-to-alls a step, and on dp 2 each block's
  replicas all-gather their (ids, row gradients);
- ``{"dp": 4}`` through Horovod's recipe: ``DLRM(sparse_grad=True)``,
  ``DistributedOptimizer(Adagrad)``, whose ``sparse_allreduce`` carries
  the replicated table's sparse gradient, and ``train.make_train_step``.

Each is held against the reference's ``make_sparse_dlrm_step`` over the
global batch on one device, and ``{"dp": 2, "ep": 2}`` also against dense
``optax.adagrad`` through JAX's GSPMD on that mesh of
``jax.devices()[:4]`` (``tests/test_models.py::test_dlrm_trains_dp_ep``).
Losses within 1e-6 relative (the mean of the shards' means against one
mean); every parameter after the steps within 1e-5 relative and 1e-7
absolute (the gradients summed in another order, through Adagrad's
``g / sqrt(acc)``). Every table block and MLP is bit-identical on the
ranks that hold it, and the collectives of each step are those the code
implies (:func:`expected_counts`).
"""

import dataclasses
import json
import pickle
import textwrap

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from flax.linen import partitioning as nn_partitioning

import torch_port_mp as mp
from horovod_tpu.models import dlrm as jdlrm
from horovod_tpu.models.llama import LOGICAL_RULES
from horovod_tpu.parallel import create_mesh as jcreate_mesh
from horovod_tpu.train import rules_for_mesh

from horovod_tpu_torch import convert
from horovod_tpu_torch.models import dlrm as tdlrm

N, B, STEPS = 4, 16, 3
LR, EPS, ACC0 = 1e-2, 1e-7, 0.1

#: name -> (axes, num_tables, route)
CASES = {
    "ep4": ({"ep": 4}, 8, "sparse_step"),
    "dp2ep2": ({"dp": 2, "ep": 2}, 8, "sparse_step"),
    "ep4-tables6": ({"ep": 4}, 6, "sparse_step"),
    "dp4": ({"dp": 4}, 8, "horovod"),
}

_WORKER = textwrap.dedent("""
    import dataclasses
    import json
    import pickle
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.collectives import ops
    from horovod_tpu_torch.models import dlrm
    from horovod_tpu_torch.optimizer import Adagrad
    from horovod_tpu_torch.parallel import create_mesh, embedding, sharding
    from horovod_tpu_torch.train import create_train_state, make_train_step
    from horovod_tpu_torch.train.gspmd import _data_shards

    data_dir = sys.argv[1]
    hvd.init(device="cpu")
    rank = hvd.rank()
    with open(f"{data_dir}/cases.json") as f:
        cases = json.load(f)
    lr, eps, acc0 = 1e-2, 1e-7, 0.1
    out = {}
    for name, (axes, tables, route) in cases.items():
        cfg = dataclasses.replace(dlrm.dlrm_tiny(), num_tables=tables)
        with open(f"{data_dir}/init_{tables}.pkl", "rb") as f:
            params = pickle.load(f)
        batch = np.load(f"{data_dir}/batch_{tables}.npz")
        mesh = create_mesh(axes)
        shards, i = _data_shards(mesh)
        b = len(batch["labels"]) // shards
        d, s, y = (torch.from_numpy(batch[k][i * b:(i + 1) * b])
                   for k in ("dense", "sparse", "labels"))
        model = dlrm.DLRM(cfg, device="cpu", mesh=mesh,
                          sparse_grad=route == "horovod")
        model.load_state_dict(convert.dlrm_params_from_flax(params, cfg,
                                                            mesh=mesh))
        if route == "horovod":
            opt = hvd.DistributedOptimizer(
                Adagrad(model.parameters(), lr=lr,
                        initial_accumulator_value=acc0, eps=eps),
                named_parameters=model.named_parameters())
            state = create_train_state(model, opt)
            step = make_train_step(model, opt, dlrm.bce_loss)
            run = lambda: step(state, (d, s), y)[1]
        else:
            step, tab, acc = dlrm.build_sparse_training(model, lr=lr,
                                                        eps=eps, acc0=acc0)
            run = lambda: step(tab, acc, d, s, y)
        losses, counts = [], []
        for _ in range(3):
            embedding.reset_counts()
            ops.allreduce_async_.launches = 0
            ops.sparse_allreduce.launches = 0
            hvd.DistributedOptimizer.agreements = 0
            losses.append(run().item())
            counts.append(dict(
                embedding.counts, all_reduce=ops.allreduce_async_.launches,
                sparse_all_gather=ops.sparse_allreduce.launches,
                agreement=hvd.DistributedOptimizer.agreements))
        differ = 0
        for k, p in model.named_parameters():
            rs = (sharding.replica_set(mesh, ("ep",))
                  if k == "embedding_tables" else None)
            ranks = rs.ranks if rs is not None else tuple(range(hvd.size()))
            buf = p.detach().clone()
            hvd.broadcast_(buf, ranks[0], process_set=rs)
            differ += int(not torch.equal(buf, p.detach()))
        out[name] = {"losses": losses, "counts": counts, "differ": differ,
                     "first": model.exchange.first,
                     "local": model.exchange.local}
        np.savez(f"{data_dir}/{name}_r{rank}.npz",
                 **{k: v.numpy() for k, v in model.state_dict().items()})
    with open(f"{data_dir}/rank{rank}.json", "w") as f:
        json.dump(out, f)
    hvd.shutdown()
""")


def expected_counts(axes, route, step):
    """The collectives step ``step`` (from 0) hands to
    ``torch.distributed``: over ep three all-to-alls (ids, rows, and the
    row gradients in backward); over dp the sparse step's two all-gathers
    of ids and row gradients; Horovod's route three all-gathers of its
    ``sparse_allreduce`` (the entry counts, indices, values); the
    all-reduces of the MLPs' one fusion bucket (they take 9 KB of a 64 MB
    bucket) and of the loss; and on the first step
    ``DistributedOptimizer``'s all-gather of the kinds of gradient."""
    ep, dp = axes.get("ep", 1), axes.get("dp", 1)
    sparse_step = route == "sparse_step"
    return {"all_to_all": 3 * (ep > 1),
            "all_gather": 2 * (dp > 1) * sparse_step,
            "sparse_all_gather": 3 * (not sparse_step),
            "all_reduce": 2, "agreement": int(step == 0)}


def _cfg(tables):
    return dataclasses.replace(jdlrm.dlrm_tiny(), num_tables=tables)


def _batch(cfg):
    rng = np.random.RandomState(7)
    return {"dense": rng.randn(B, cfg.dense_features).astype(np.float32),
            "sparse": rng.randint(0, 8, (B, cfg.num_tables)),
            "labels": (rng.rand(B) < 0.3).astype(np.float32)}


def _jax_sparse(cfg, params, batch):
    """The reference's sparse step over the global batch on one device:
    losses and the final parameters (tables ``[T, R, D]``)."""
    model = jdlrm.DLRM(cfg)
    dp = {k: v for k, v in params.items() if k != "embedding_tables"}
    tables = jnp.asarray(params["embedding_tables"]).reshape(
        -1, cfg.embed_dim)
    accum = jnp.full_like(tables, ACC0)
    opt = optax.adagrad(LR, initial_accumulator_value=ACC0, eps=EPS)
    st = opt.init(dp)
    step = jax.jit(jdlrm.make_sparse_dlrm_step(model, cfg, opt, lr=LR,
                                               eps=EPS))
    args = [jnp.asarray(batch[k]) for k in ("dense", "sparse", "labels")]
    losses = []
    for _ in range(STEPS):
        dp, tables, accum, st, loss = step(dp, tables, accum, st, *args)
        losses.append(float(loss))
    return losses, {**dp, "embedding_tables": np.asarray(tables).reshape(
        cfg.num_tables, cfg.rows_per_table, -1)}


def _jax_gspmd_dense(cfg, params, batch, axes):
    """Dense ``optax.adagrad`` through GSPMD on ``axes`` of
    ``jax.devices()[:4]``, the tables split over ep by the model's own
    logical axes (``tests/test_models.py::test_dlrm_trains_dp_ep``)."""
    model = jdlrm.DLRM(cfg)
    mesh = jcreate_mesh(axes, devices=jax.devices()[:N])
    rules = rules_for_mesh(mesh, LOGICAL_RULES)
    dense, sparse, labels = (jnp.asarray(batch[k])
                             for k in ("dense", "sparse", "labels"))
    with nn_partitioning.axis_rules(rules):
        abstract = jax.eval_shape(model.init, jax.random.PRNGKey(0), dense,
                                  sparse)
    shardings = nn.logical_to_mesh_sharding(
        nn.get_partition_spec(abstract["params"]), mesh, rules)
    p = jax.tree_util.tree_map(jax.device_put, params,
                               nn.meta.unbox(shardings))
    opt = optax.adagrad(LR, initial_accumulator_value=ACC0, eps=EPS)
    with jax.sharding.set_mesh(mesh):
        st = opt.init(p)

        @jax.jit
        def step(p, st):
            def loss_of(pp):
                with nn_partitioning.axis_rules(rules):
                    return jdlrm.bce_loss(model.apply({"params": pp}, dense,
                                                      sparse), labels)
            loss, g = jax.value_and_grad(loss_of)(p)
            up, st2 = opt.update(g, st, p)
            return optax.apply_updates(p, up), st2, loss  # hvd-analyze: ok

        losses = []
        for _ in range(STEPS):
            p, st, loss = step(p, st)
            losses.append(float(loss))
    assert "ep" in str(p["embedding_tables"].sharding.spec)
    return losses, jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dlrm_mp")
    inits, batches = {}, {}
    for tables in sorted({t for _, t, _ in CASES.values()}):
        cfg = _cfg(tables)
        batches[tables] = _batch(cfg)
        np.savez(tmp / f"batch_{tables}.npz", **batches[tables])
        inits[tables] = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(
            jdlrm.DLRM(cfg).init(jax.random.PRNGKey(0),
                                 jnp.asarray(batches[tables]["dense"]),
                                 jnp.asarray(batches[tables]["sparse"]))[
                "params"]))
        with open(tmp / f"init_{tables}.pkl", "wb") as f:
            pickle.dump(inits[tables], f)
    (tmp / "cases.json").write_text(json.dumps(CASES))
    wait = mp.start_worlds(tmp, _WORKER, (N,))
    # JAX's steps while the world runs
    want = {t: _jax_sparse(_cfg(t), inits[t], batches[t]) for t in inits}
    gspmd = _jax_gspmd_dense(_cfg(8), inits[8], batches[8],
                             {"dp": 2, "ep": 2})
    wait()
    ranks = []
    for r in range(N):
        with open(tmp / f"rank{r}.json") as f:
            ranks.append(json.load(f))
    return tmp, ranks, want, gspmd


def _whole(tmp, ranks, name):
    """The whole parameters after the steps: each table block from the
    first rank that holds it, the MLPs from rank 0."""
    parts = [dict(np.load(tmp / f"{name}_r{r}.npz")) for r in range(N)]
    blocks = {}
    for r in range(N):
        blocks.setdefault(ranks[r][name]["first"],
                          parts[r]["embedding_tables"])
    return {**parts[0], "embedding_tables": np.concatenate(
        [blocks[k] for k in sorted(blocks)])}


def _flat(cfg, params):
    """A flax tree in the port's names, the tables ``[T R, D]``."""
    tcfg = dataclasses.replace(tdlrm.dlrm_tiny(), num_tables=cfg.num_tables)
    return {k: v.numpy() for k, v in
            convert.dlrm_params_from_flax(params, tcfg).items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_losses_and_parameters_match_the_reference_sparse_step(world, name):
    tmp, ranks, want, _ = world
    axes, tables, _ = CASES[name]
    losses, params = want[tables]
    for r in ranks:
        np.testing.assert_allclose(r[name]["losses"], losses, rtol=1e-6)
    got = _whole(tmp, ranks, name)
    for k, v in _flat(_cfg(tables), params).items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_dp2ep2_matches_gspmd_dense_adagrad(world):
    """Sparse Adagrad over split, replicated tables equals JAX's dense
    Adagrad over the GSPMD-sharded model (the untouched rows' gradients
    are exactly zero)."""
    tmp, ranks, _, (losses, params) = world
    for r in ranks:
        np.testing.assert_allclose(r["dp2ep2"]["losses"], losses,
                                   rtol=1e-6)
    got = _whole(tmp, ranks, "dp2ep2")
    for k, v in _flat(_cfg(8), params).items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_blocks_bit_identical_on_their_holders(world, name):
    _, ranks, _, _ = world
    assert [r[name]["differ"] for r in ranks] == [0] * N


@pytest.mark.parametrize("name", sorted(CASES))
def test_collectives_per_step(world, name):
    _, ranks, _, _ = world
    axes, tables, route = CASES[name]
    want = [expected_counts(axes, route, i) for i in range(STEPS)]
    for r in ranks:
        assert r[name]["counts"] == want, (r[name]["counts"], want)


def test_ep_split_of_six_tables_is_uneven(world):
    _, ranks, _, _ = world
    assert [(r["ep4-tables6"]["first"], r["ep4-tables6"]["local"])
            for r in ranks] == [(0, 2), (2, 2), (4, 1), (5, 1)]
