"""The port's DLRM (``horovod_tpu_torch/models/dlrm.py``), its Adagrad and
its table exchange, in one process, against ``horovod_tpu/models/dlrm.py``.

Inputs are seeded numpy; weights come from flax through
``convert.dlrm_params_from_flax``. Configurations: ``dlrm_tiny()`` (8
tables) and a tiny one with 6 tables, which 4 ep ranks split 2, 2, 1, 1.
Every comparison is f32 against f32; tolerances are in each test. The
multi-process meshes are in ``test_torch_port_dlrm_mp.py``.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models import dlrm as jdlrm

from horovod_tpu_torch import convert
from horovod_tpu_torch.models import dlrm as tdlrm
from horovod_tpu_torch.optimizer.adagrad import Adagrad
from horovod_tpu_torch.parallel import embedding
from horovod_tpu_torch.parallel.mesh import Axis, Mesh

LR, EPS, ACC0 = 1e-2, 1e-7, 0.1
CFGS = {"tiny": {}, "tables6": {"num_tables": 6}}


def _cfgs(name):
    over = CFGS[name]
    return (dataclasses.replace(jdlrm.dlrm_tiny(), **over),
            dataclasses.replace(tdlrm.dlrm_tiny(), **over))


def _batch(cfg, seed, B=16, ids=None):
    rng = np.random.RandomState(seed)
    dense = rng.randn(B, cfg.dense_features).astype(np.float32)
    sparse = rng.randint(0, ids or cfg.rows_per_table, (B, cfg.num_tables))
    labels = (rng.rand(B) < 0.3).astype(np.float32)
    return dense, sparse, labels


def _flax(jcfg, batch):
    return nn.meta.unbox(jdlrm.DLRM(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(batch[0]),
        jnp.asarray(batch[1]))["params"])


def _port(tcfg, params, mesh=None, **kw):
    model = tdlrm.DLRM(tcfg, device="cpu", mesh=mesh, **kw)
    model.load_state_dict(convert.dlrm_params_from_flax(params, tcfg,
                                                        mesh=mesh))
    return model


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got)
                                          else got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _mesh_view(n, index):
    """This rank's view of ``{"ep": n}`` without a world: the model and
    the converter read only the axis's size and index."""
    axis = Axis("ep", n, index, tuple(range(n)), None)
    return Mesh(("ep",), {"ep": n}, {"ep": axis}, tuple(range(n)))


def test_interaction_pairs_keep_jax_order():
    """The top MLP's first kernel is laid out in ``jnp.triu_indices(n,
    k=1)``'s order; the port's flat pair index follows it (n = 27 at
    Criteo width, 351 pairs)."""
    for n in (9, 27):
        iu, ju = jnp.triu_indices(n, k=1)
        model = tdlrm.DLRM(dataclasses.replace(tdlrm.dlrm_tiny(),
                                               num_tables=n - 1),
                           device="cpu")
        np.testing.assert_array_equal(model._pairs.numpy(),
                                      np.asarray(iu * n + ju))
    assert tdlrm.dlrm_criteo().embed_dim + 351 == 415


@pytest.mark.parametrize("name", sorted(CFGS))
def test_forward_and_gradients_match_flax(name):
    """Logits and loss within 1e-5 relative (f32, the same products in
    another order), and the gradients of every MLP parameter and of the
    looked-up rows (``looked=``, as the sparse step passes them) within
    1e-5 relative and 1e-6 absolute; the lookup through the table gives
    the same logits."""
    jcfg, tcfg = _cfgs(name)
    dense, sparse, labels = _batch(jcfg, 1)
    params = _flax(jcfg, (dense, sparse))
    model = jdlrm.DLRM(jcfg)
    tables = params["embedding_tables"]
    looked = jax.vmap(lambda t, i: t[i], in_axes=(0, 1), out_axes=1)(
        tables, jnp.asarray(sparse))

    def loss_of(p, rows):
        out = model.apply({"params": {**p, "embedding_tables": tables}},
                          jnp.asarray(dense), jnp.asarray(sparse),
                          looked=rows)
        return jdlrm.bce_loss(out, jnp.asarray(labels)), out

    mlps = {k: v for k, v in params.items() if k != "embedding_tables"}
    (jloss, jout), (gp, grows) = jax.value_and_grad(
        loss_of, argnums=(0, 1), has_aux=True)(mlps, looked)

    tmodel = _port(tcfg, params)
    rows = _t(looked).requires_grad_(True)
    out = tmodel(_t(dense), _t(sparse), looked=rows)
    loss = tdlrm.bce_loss(out, _t(labels))
    loss.backward()
    _close(out, jout)
    _close(loss, jloss)
    _close(rows.grad, grows)
    want = convert.dlrm_params_from_flax({**gp, "embedding_tables": tables},
                                         tcfg)
    for k, p in tmodel.named_parameters():
        if k != "embedding_tables":
            _close(p.grad, want[k].numpy())
    _close(tmodel(_t(dense), _t(sparse)), jout)


def test_bottom_mlp_must_end_at_embed_dim():
    cfg = dataclasses.replace(tdlrm.dlrm_tiny(), bottom_mlp=(16, 4))
    with pytest.raises(ValueError, match="bottom_mlp must end at embed_dim"):
        tdlrm.DLRM(cfg, device="cpu")


def test_sparse_adagrad_update_matches_jax_with_duplicates():
    """The row update against the reference's on ids that repeat within
    the batch (24 ids over 10 rows of 40), from an accumulator that is not
    flat: tables and accumulator within 1e-6 relative and 1e-7 absolute
    (``rsqrt`` may round apart by one ulp); untouched rows bit-unchanged;
    two calls on the same inputs bit-identical."""
    rng = np.random.RandomState(3)
    N, D, K = 40, 8, 24
    tables = rng.randn(N, D).astype(np.float32) * 0.01
    accum = (0.1 + rng.rand(N, D)).astype(np.float32)
    ids = rng.choice(10, K) * 4
    grads = rng.randn(K, D).astype(np.float32)
    jt, ja = jdlrm.sparse_adagrad_update(jnp.asarray(tables),
                                         jnp.asarray(accum),
                                         jnp.asarray(ids), jnp.asarray(grads),
                                         LR, EPS)
    outs = []
    for _ in range(2):
        tt, ta = _t(tables.copy()), _t(accum.copy())
        tdlrm.sparse_adagrad_update(tt, ta, _t(ids), _t(grads), LR, EPS)
        outs.append((tt, ta))
    _close(outs[0][0], jt, 1e-6, 1e-7)
    _close(outs[0][1], ja, 1e-6, 1e-7)
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    untouched = np.setdiff1d(np.arange(N), ids)
    assert torch.equal(outs[0][0][untouched], _t(tables)[untouched])
    assert torch.equal(outs[0][1][untouched], _t(accum)[untouched])


def test_adagrad_matches_optax_dense_and_row_sparse():
    """``optimizer.adagrad.Adagrad`` against ``optax.adagrad(1e-2,
    initial_accumulator_value=0.1, eps=1e-7)`` for three steps: a dense
    parameter, and a 2-D one whose gradient is row-sparse with repeated
    rows (its dense equivalent fed to optax). Within 1e-6 relative and
    1e-7 absolute."""
    rng = np.random.RandomState(4)
    w = rng.randn(5, 3).astype(np.float32)
    table = rng.randn(12, 4).astype(np.float32)
    opt = optax.adagrad(LR, initial_accumulator_value=ACC0, eps=EPS)
    jp = {"w": jnp.asarray(w), "table": jnp.asarray(table)}
    st = opt.init(jp)
    tw = torch.nn.Parameter(_t(w.copy()))
    tt = torch.nn.Parameter(_t(table.copy()))
    topt = Adagrad([tw, tt], lr=LR, initial_accumulator_value=ACC0, eps=EPS)
    for _ in range(3):
        gw = rng.randn(5, 3).astype(np.float32)
        rows = rng.choice(12, 7)
        vals = rng.randn(7, 4).astype(np.float32)
        gt = np.zeros_like(table)
        np.add.at(gt, rows, vals)
        up, st = opt.update({"w": jnp.asarray(gw), "table": jnp.asarray(gt)},
                            st, jp)
        jp = optax.apply_updates(jp, up)
        tw.grad = _t(gw)
        tt.grad = torch.sparse_coo_tensor(_t(rows)[None], _t(vals), (12, 4))
        topt.step()
    _close(tw, jp["w"], 1e-6, 1e-7)
    _close(tt, jp["table"], 1e-6, 1e-7)


def _dense_adagrad_step(model, opt, batch):
    opt.zero_grad(set_to_none=True)
    loss = tdlrm.bce_loss(model(*batch[:2]), batch[2])
    loss.backward()
    opt.step()
    return loss.detach()


@pytest.mark.parametrize("name", sorted(CFGS))
def test_sparse_steps_match_jax_and_dense_adagrad(name):
    """Three steps (``tests/test_models.py``'s settings: B = 16, ids in
    [0, 4), so rows repeat, lr 1e-2, eps 1e-7, acc0 0.1) of the port's
    sparse step (``build_sparse_training``, no mesh) against the
    reference's ``make_sparse_dlrm_step``, and the port's dense path (the
    table's dense gradient through ``Adagrad``) against dense
    ``optax.adagrad`` over the flax model: losses within 1e-6 relative,
    tables and MLPs within 1e-5 relative and 1e-7 absolute. Rows no step
    touched stay bit-unchanged."""
    jcfg, tcfg = _cfgs(name)
    dense, sparse, labels = _batch(jcfg, 5, ids=4)
    params = _flax(jcfg, (dense, sparse))
    jmodel = jdlrm.DLRM(jcfg)
    dp = {k: v for k, v in params.items() if k != "embedding_tables"}
    jt = params["embedding_tables"].reshape(-1, jcfg.embed_dim)
    ja = jnp.full_like(jt, ACC0)
    opt_d = optax.adagrad(LR, initial_accumulator_value=ACC0, eps=EPS)
    st = opt_d.init(dp)
    jstep = jax.jit(jdlrm.make_sparse_dlrm_step(jmodel, jcfg, opt_d, lr=LR,
                                                eps=EPS))
    jargs = [jnp.asarray(x) for x in (dense, sparse, labels)]

    @jax.jit
    def jdense_step(p, st):  # tests/test_models.py's dense path
        def loss_of(pp):
            return jdlrm.bce_loss(jmodel.apply({"params": pp}, *jargs[:2]),
                                  jargs[2])
        loss, g = jax.value_and_grad(loss_of)(p)
        up, st = opt_d.update(g, st, p)
        return optax.apply_updates(p, up), st, loss  # hvd-analyze: ok

    jp, jst = params, opt_d.init(params)
    batch = (_t(dense), _t(sparse), _t(labels))
    model = _port(tcfg, params)
    step, tables, accum = tdlrm.build_sparse_training(model, lr=LR, eps=EPS,
                                                      acc0=ACC0)
    before = tables.detach().clone()
    dense_model = _port(tcfg, params)
    dense_opt = Adagrad(dense_model.parameters(), lr=LR,
                        initial_accumulator_value=ACC0, eps=EPS)
    for _ in range(3):
        dp, jt, ja, st, jloss = jstep(dp, jt, ja, st, *jargs)
        jp, jst, jdloss = jdense_step(jp, jst)
        loss = step(tables, accum, *batch)
        dloss = _dense_adagrad_step(dense_model, dense_opt, batch)
        _close(loss, jloss, 1e-6, 0)
        _close(dloss, jdloss, 1e-6, 0)
    got = convert.dlrm_params_from_flax({**dp, "embedding_tables": np.asarray(
        jt).reshape(jcfg.num_tables, jcfg.rows_per_table, -1)}, tcfg)
    got_dense = convert.dlrm_params_from_flax(jp, tcfg)
    for m, want in ((model, got), (dense_model, got_dense)):
        for k, v in m.state_dict().items():
            _close(v, want[k].numpy(), 1e-5, 1e-7)
    _close(accum, ja, 1e-5, 1e-7)
    touched = (np.unique((sparse + np.arange(tcfg.num_tables)
                          * tcfg.rows_per_table).reshape(-1)))
    untouched = np.setdiff1d(np.arange(tables.shape[0]), touched)
    assert torch.equal(tables[untouched], before[untouched])
    assert torch.equal(dense_model.embedding_tables[untouched],
                       before[untouched])


@pytest.mark.parametrize("name", sorted(CFGS))
def test_table_exchange_layout_matches_the_plain_gather(name):
    """The ep exchange's layouts with the all-to-alls done by hand: four
    ranks' ids sent to the owners (``by_owner``), each owner's rows
    gathered from its block (``DLRM.owner_ids``' arithmetic) and sent back
    (``from_owners``) give every rank exactly the rows of the whole table
    at its ids, in table order; the gradients take the reverse path to
    the same rows. 6 tables split 2, 2, 1, 1."""
    jcfg, tcfg = _cfgs(name)
    n, b = 4, 3
    whole = torch.randn(tcfg.num_tables * tcfg.rows_per_table,
                        tcfg.embed_dim)
    ids = [_t(_batch(jcfg, 10 + r, B=b)[1]) for r in range(n)]
    R, T = tcfg.rows_per_table, tcfg.num_tables
    sizes = embedding.table_split(T, n)
    starts = np.cumsum((0,) + sizes)
    sent = [embedding.by_owner(x, sizes).split([b * s for s in sizes])
            for x in ids]
    rows_back = []
    for j in range(n):  # owner j: its tables' ids from every rank
        mine = torch.cat([sent[i][j] for i in range(n)]).reshape(-1,
                                                                 sizes[j])
        block = whole[starts[j] * R:starts[j + 1] * R]
        fid = (mine + torch.arange(sizes[j]) * R).reshape(-1)
        rows_back.append(block[fid].split(b * sizes[j]))
    for i in range(n):
        looked = embedding.from_owners(
            torch.cat([rows_back[j][i] for j in range(n)]), sizes, b)
        plain = whole[(ids[i] + torch.arange(T) * R).reshape(-1)]
        assert torch.equal(looked, plain.reshape(b, T, -1))
        g = torch.randn(b, T, tcfg.embed_dim)
        back = embedding.by_owner(g, sizes).split([b * s for s in sizes])
        for j in range(n):
            want = g[:, starts[j]:starts[j + 1]].reshape(-1, tcfg.embed_dim)
            assert torch.equal(back[j], want)
    assert embedding.table_split(26, 4) == (7, 7, 6, 6)
    with pytest.raises(ValueError, match="each owns at least one"):
        embedding.table_split(3, 4)


def test_convert_round_trip_and_ep_blocks():
    """``dlrm_params_from_flax`` then ``dlrm_params_to_flax`` gives the
    flax tree back exactly; under a ``{"ep": 4}`` mesh each rank's table
    block is its run of whole tables (6 tables: 2, 2, 1, 1), which a model
    built under that mesh holds."""
    jcfg, tcfg = _cfgs("tables6")
    params = _flax(jcfg, _batch(jcfg, 0)[:2])
    back = convert.dlrm_params_to_flax(
        convert.dlrm_params_from_flax(params, tcfg), tcfg)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(back)
    tables = np.asarray(params["embedding_tables"])
    for index, (first, local) in enumerate([(0, 2), (2, 2), (4, 1),
                                            (5, 1)]):
        mesh = _mesh_view(4, index)
        model = _port(tcfg, params, mesh=mesh)
        np.testing.assert_array_equal(
            model.embedding_tables.detach().numpy(),
            tables[first:first + local].reshape(-1, tcfg.embed_dim))
        assert model._row_base.tolist() == [i * tcfg.rows_per_table
                                            for i in range(local)]


def test_model_built_under_a_mesh_holds_the_whole_models_values():
    """From one seed, the block a rank of ``{"ep": 4}`` holds is the whole
    model's tables at its run, and its MLPs are the whole model's."""
    tcfg = dataclasses.replace(tdlrm.dlrm_tiny(), num_tables=6)
    whole = tdlrm.DLRM(tcfg, device="cpu", seed=3)
    part = tdlrm.DLRM(tcfg, device="cpu", seed=3, mesh=_mesh_view(4, 1))
    R = tcfg.rows_per_table
    assert torch.equal(part.embedding_tables,
                       whole.embedding_tables[2 * R:4 * R])
    for (k, a), (_, b) in zip(whole.named_parameters(),
                              part.named_parameters()):
        if k != "embedding_tables":
            assert torch.equal(a, b), k
