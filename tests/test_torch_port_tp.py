"""Tensor-parallel Llama training in the port against the JAX package's
GSPMD step, on the CPU.

One 4-process gloo world for the module, declared 2 x 2 by
``HOROVOD_LOCAL_SIZE=2`` (``tests/torch_port_mp.py``), runs ``llama_tiny``
(f32) three AdamW steps on each mesh below, each rank holding its blocks
of every parameter (``parallel/sharding.py``), beside the JAX package's
``make_gspmd_train_step`` on the same mesh of ``jax.devices()[:4]``:

- ``{"dp": 2, "tp": 2}``, untied and with ``tie_embeddings``;
- ``{"fsdp": 2, "tp": 2}``;
- ``{"sp": 2, "tp": 2}`` with ``attention_impl="ring"``: the ring on the
  local heads, as JAX's ``P(batch, "sp", "tp", None)``.

Gates, those of ``tests/test_torch_port_context.py``: losses at rtol
3e-4; every parameter after the three steps, gathered whole, within 1e-4
absolute plus relative of JAX's; each block bit-identical on every rank
that holds it. ``{"dp": 2, "tp": 2}`` is run again with each gradient
divided by the world size (4), the divisor this slice replaced, and must
then miss JAX's parameters: the data shards are 2.

The world also builds ``create_hybrid_mesh``'s cases of
``tests/test_parallel.py``: ``tp`` within a node and ``dp`` across, a
``dp`` of both extents, a user DCN axis outermost, and an ICI product
that is not the local size (``ValueError``).
"""

import numpy as np
import pytest

import torch_port_mp as mp

CASES = {
    "dp2tp2": ({"dp": 2, "tp": 2}, {}),
    "dp2tp2-tied": ({"dp": 2, "tp": 2}, {"tie_embeddings": True}),
    "fsdp2tp2": ({"fsdp": 2, "tp": 2}, {}),
    "sp2tp2-ring": ({"sp": 2, "tp": 2}, {"attention_impl": "ring"}),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_world")
    toks = mp.tokens()
    np.save(tmp / "tokens.npy", toks)
    want = {name: mp.jax_train(axes, cfg, toks, tmp, name)
            for name, (axes, cfg) in CASES.items()}
    cases = [{"name": n, "axes": a, "cfg": c, "init": n}
             for n, (a, c) in CASES.items()]
    cases.append({"name": "dp2tp2-world-divisor", "axes": {"dp": 2, "tp": 2},
                  "cfg": {}, "init": "dp2tp2", "world_divisor": True})
    ranks = mp.run_world(tmp, cases, extra=("hybrid",))
    return tmp, ranks, want


@pytest.mark.parametrize("name", sorted(CASES))
def test_losses_match_jax_gspmd(world, name):
    _, ranks, want = world
    jlosses, _ = want[name]
    for r in ranks:
        np.testing.assert_allclose(r[name]["losses"], jlosses, rtol=3e-4)
    assert jlosses[-1] < jlosses[0]


@pytest.mark.parametrize("name", sorted(CASES))
def test_parameters_after_three_steps_match_jax(world, name):
    tmp, _, want = world
    _, params = want[name]
    got = mp.full_params(tmp, name)
    assert sorted(got) == sorted(params)
    for k, w in params.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_blocks_bit_identical_on_their_holders(world, name):
    _, ranks, _ = world
    assert [r[name]["differ"] for r in ranks] == [0] * mp.N


def test_world_size_divisor_misses_jax(world):
    """Under tp the world (4) is larger than the data shards (2): dividing
    by it halves every gradient, which AdamW's first steps hide only in
    part (its update is scale-free but for eps and weight decay), so the
    parameters miss JAX's where the correct divisor meets them."""
    tmp, ranks, want = world
    _, params = want["dp2tp2"]
    got = mp.full_params(tmp, "dp2tp2-world-divisor")
    worst = max(np.max(np.abs(got[k] - w) / (1e-4 + 1e-4 * np.abs(w)))
                for k, w in params.items())
    assert worst > 1.0


def test_tp_collectives_per_step(world):
    """Per step on ``{"dp": 2, "tp": 2}``: one tp all-reduce for the
    embedding, two a layer forward (after ``wo`` and ``w2``) and two
    backward (before ``wq``/``wk``/``wv`` and ``w1``/``w3``), one backward
    before the head, two for the loss; no fsdp gather."""
    _, ranks, _ = world
    want = {"all_gather": 0, "reduce_scatter": 0,
            "tp_all_reduce": 1 + 2 * 2 + 2 * 2 + 1 + 2}
    for r in ranks:
        assert r["dp2tp2"]["counts"] == [want] * mp.STEPS


def test_hybrid_mesh_tp_within_a_node(world):
    _, ranks, _ = world
    for rank, r in enumerate(ranks):
        names, tp, dp = r["hybrid"]["dp_tp"]
        assert names == ["dp", "tp"]
        node = rank // 2
        assert tp == [2 * node, 2 * node + 1]  # tp stays within a node
        assert dp == [rank % 2, rank % 2 + 2]
        names, dp4 = r["hybrid"]["dp4"]
        assert names == ["dp"] and dp4 == [0, 1, 2, 3]


def test_hybrid_mesh_user_dcn_axis_is_outermost(world):
    _, ranks, _ = world
    for rank, r in enumerate(ranks):
        names, cross, tp = r["hybrid"]["cross_tp"]
        assert names == ["cross", "tp"]
        assert cross == [rank % 2, rank % 2 + 2]
        assert tp == [2 * (rank // 2), 2 * (rank // 2) + 1]


def test_hybrid_mesh_ici_product_must_be_the_local_size(world):
    _, ranks, _ = world
    for r in ranks:
        assert "needs 2 nodes of 4 ranks" in r["hybrid"]["error"]
