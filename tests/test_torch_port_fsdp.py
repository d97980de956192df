"""ZeRO-3 (fsdp) Llama training in the port against the JAX package's GSPMD
step, on the CPU.

One 4-process gloo world for the module (``tests/torch_port_mp.py``) runs
``llama_tiny`` (f32) three AdamW steps on each case below, each rank
holding its fsdp shard of every weight and norm scale (the table stays
whole: ``embed_table`` has no fsdp rule), beside the JAX package's
``make_gspmd_train_step`` on the same mesh of ``jax.devices()[:4]``:

- ``{"fsdp": 4}``, untied and with ``tie_embeddings``;
- ``{"dp": 2, "fsdp": 2}``;
- ``{"fsdp": 2, "tp": 2}``, and again with ``accum_steps=2`` (two
  microbatches of 1 x 32 a rank) against JAX's full-batch step: the mean
  of the microbatches' mean losses is the batch's mean loss.

Gates, those of ``tests/test_torch_port_context.py``: losses at rtol
3e-4; every parameter after the three steps, gathered whole, within 1e-4
absolute plus relative of JAX's; each block bit-identical on every rank
that holds it. The fsdp collectives a step are counted: one all-gather on
use and one reduce-scatter of the gradient for each of the 20 sharded
parameters, per microbatch.
"""

import numpy as np
import pytest

import torch_port_mp as mp

CASES = {
    "fsdp4": ({"fsdp": 4}, {}),
    "fsdp4-tied": ({"fsdp": 4}, {"tie_embeddings": True}),
    "dp2fsdp2": ({"dp": 2, "fsdp": 2}, {}),
    "fsdp2tp2": ({"fsdp": 2, "tp": 2}, {}),
}
#: Each case and the JAX run it is held to.
RUNS = dict({n: n for n in CASES}, **{"fsdp2tp2-accum2": "fsdp2tp2"})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp_world")
    toks = mp.tokens()
    np.save(tmp / "tokens.npy", toks)
    want = {name: mp.jax_train(axes, cfg, toks, tmp, name)
            for name, (axes, cfg) in CASES.items()}
    cases = [{"name": n, "axes": a, "cfg": c, "init": n}
             for n, (a, c) in CASES.items()]
    cases.append({"name": "fsdp2tp2-accum2", "axes": {"fsdp": 2, "tp": 2},
                  "cfg": {}, "init": "fsdp2tp2", "accum": 2})
    return tmp, mp.run_world(tmp, cases), want


@pytest.mark.parametrize("name", sorted(RUNS))
def test_losses_match_jax_gspmd(world, name):
    _, ranks, want = world
    jlosses, _ = want[RUNS[name]]
    for r in ranks:
        np.testing.assert_allclose(r[name]["losses"], jlosses, rtol=3e-4)
    assert jlosses[-1] < jlosses[0]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_parameters_after_three_steps_match_jax(world, name):
    tmp, _, want = world
    _, params = want[RUNS[name]]
    got = mp.full_params(tmp, name)
    assert sorted(got) == sorted(params)
    for k, w in params.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_blocks_bit_identical_on_their_holders(world, name):
    _, ranks, _ = world
    assert [r[name]["differ"] for r in ranks] == [0] * mp.N


@pytest.mark.parametrize("name", sorted(RUNS))
def test_optimizer_state_follows_its_block(world, name):
    """``gspmd_shardings``: each AdamW moment has its parameter's block
    and placement; the step counter is whole (JAX's ``_fit_rank``)."""
    _, ranks, _ = world
    assert [r[name]["opt_follows"] for r in ranks] == [True] * mp.N


@pytest.mark.parametrize("name,passes,tp", [
    ("fsdp4", 1, 0), ("fsdp4-tied", 1, 0), ("fsdp2tp2-accum2", 2, 12)])
def test_fsdp_collectives_per_step(world, name, passes, tp):
    """Per layer seven weights and two norm scales, then the final norm
    and (untied) the head: 2 x 9 + 2 = 20 sharded parameters, 19 tied.
    Remat is off in ``llama_tiny``, so each is gathered once a forward.
    Under tp 2, 12 tp all-reduces a pass (``test_torch_port_tp.py``)."""
    _, ranks, _ = world
    n = 20 - ("tied" in name)
    want = {"all_gather": n * passes, "reduce_scatter": n * passes,
            "tp_all_reduce": tp * passes}
    for r in ranks:
        assert r[name]["counts"] == [want] * mp.STEPS


@pytest.mark.parametrize("axes", [{"fsdp": 4}, {"fsdp": 2, "tp": 2}])
def test_convert_blocks_from_both_flax_layouts(monkeypatch, axes):
    """``llama_params_from_flax(..., mesh=mesh)`` gives rank 0's blocks
    from the scanned flax layout (``layers/block``, as 32-layer configs
    scan under ``scan_layers="auto"``) and the unrolled one alike, each the
    block ``sharding.placement`` assigns (the embed dim of a flax ``[in,
    out]`` kernel is dim 1 of the port's weight). A world of one stands in
    for four, its size patched and ``new_group`` recording the rows."""
    import dataclasses

    import jax
    import torch
    import torch.distributed as dist
    from horovod_tpu.models import llama as jllama

    import horovod_tpu_torch as thvd
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.core import context_api
    from horovod_tpu_torch.models import llama as tllama
    from horovod_tpu_torch.parallel import create_mesh, sharding

    cfg = dataclasses.replace(jllama.llama_tiny(), scan_layers=False)
    unrolled_tree = jllama.Llama(cfg).init(
        jax.random.PRNGKey(0), jax.numpy.asarray(mp.tokens()))["params"]
    blocks = [unrolled_tree[f"block_{i}"] for i in range(cfg.n_layers)]
    scanned_tree = {k: v for k, v in unrolled_tree.items()
                    if not k.startswith("block_")}
    scanned_tree["layers"] = {"block": jax.tree_util.tree_map(
        lambda *x: np.stack([np.asarray(a) for a in x]), *blocks)}
    trees = {True: scanned_tree, False: unrolled_tree}
    tcfg = tllama.llama_tiny()
    whole = convert.llama_params_from_flax(trees[False], tcfg)
    thvd.init(device="cpu")
    try:
        monkeypatch.setattr(context_api, "size", lambda: 4)
        monkeypatch.setattr(dist, "new_group", lambda ranks: tuple(ranks))
        mesh = create_mesh(axes)
        scanned = convert.llama_params_from_flax(trees[True], tcfg, mesh)
        unrolled = convert.llama_params_from_flax(trees[False], tcfg, mesh)
        for k, w in whole.items():
            place = sharding.placement(mesh, tllama.logical_names(k),
                                       w.shape)
            torch.testing.assert_close(unrolled[k], place.block(w),
                                       rtol=0, atol=0)
            torch.testing.assert_close(scanned[k], unrolled[k], rtol=0,
                                       atol=0)
        w1 = whole["blocks.0.mlp.w1.weight"]  # [mlp, embed], embed on fsdp
        n = axes["fsdp"]
        assert unrolled["blocks.0.mlp.w1.weight"].shape[1] == w1.shape[1] // n
    finally:
        monkeypatch.undo()
        thvd.shutdown()
