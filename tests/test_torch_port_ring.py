"""The port's ring attention and Ulysses against the JAX package's, on the
CPU.

One 4-process gloo world for the module, a mesh of ``{"sp": 4}``, against
``shard_map`` over ``create_mesh({"sp": 4}, devices=jax.devices()[:4])``.
The same seeded numpy q, k, v (B=2, T=32, H=4, D=8, each rank holding 8
positions) go through both sides:

- ``ring_attention`` by both routes, causal and not: the port's B1 route
  (``impl="kernel"``, B1 through its plain version on the CPU) against
  JAX's Pallas route (interpret mode, as ``tests/test_ops.py`` runs it), the
  port's blockwise route against JAX's ``jnp`` one, and both against
  ``local_attention`` on the whole sequence: rtol 2e-4, atol 2e-5, the JAX
  tests' tolerance for the same comparison;
- the gradients of ``sum(out ** 2)`` with respect to q, k and v, each rank's
  shard gathered, against JAX's at rtol and atol 2e-4 (the regression of
  ``tests/test_ops.py``: the K/V cotangents from other ranks' queries must
  come back through the rotation);
- ``ulysses_attention``, causal and not, output and gradients, against
  JAX's at the same tolerances, and its head-count error;
- the mesh: row-major layout with ``sp`` innermost, and its errors.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from horovod_tpu.parallel import create_mesh as jcreate_mesh
from horovod_tpu.parallel import local_attention as jlocal
from horovod_tpu.parallel import ring_attention as jring
from horovod_tpu.parallel import ulysses_attention as julysses

import horovod_tpu_torch as thvd
from horovod_tpu_torch.parallel import create_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
B, T, H, D = 2, 32, 4, 8
FWD = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)
#: (name, port function and impl, JAX impl): the ring's two routes, then
#: Ulysses.
CASES = [("ring-kernel", "kernel", "pallas"),
         ("ring-blockwise", "blockwise", "jnp"),
         ("ulysses", None, None)]

_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import (create_mesh, ring_attention,
                                            ulysses_attention)

    data_dir = sys.argv[1]
    hvd.init(device="cpu")
    rank = hvd.rank()
    mesh = create_mesh({"sp": 4})
    axis = mesh.axis("sp")
    data = np.load(f"{data_dir}/qkv.npz")
    t = data["q"].shape[1] // 4
    own = slice(axis.index * t, (axis.index + 1) * t)
    out = {}
    for name, impl in (("ring-kernel", "kernel"),
                       ("ring-blockwise", "blockwise"), ("ulysses", None)):
        for causal in (True, False):
            q, k, v = (torch.from_numpy(data[x][:, own]).requires_grad_()
                       for x in "qkv")
            if impl is None:
                o = ulysses_attention(q, k, v, axis, causal=causal)
            else:
                o = ring_attention(q, k, v, axis, causal=causal, impl=impl)
            o.square().sum().backward()
            key = f"{name}-{causal}"
            out[key] = o.detach().numpy()
            for x, g in zip("qkv", (q.grad, k.grad, v.grad)):
                out[f"{key}-d{x}"] = g.numpy()
    six = torch.zeros((2, t, 6, 8))
    try:
        ulysses_attention(six, six, six, axis)
        out["head_error"] = np.asarray("")
    except ValueError as e:
        out["head_error"] = np.asarray(str(e))
    dp_sp = create_mesh({"dp": 2, "sp": 2})
    out["layout"] = np.asarray(
        [dp_sp.axis("dp").index, dp_sp.axis("sp").index,
         *dp_sp.axis("sp").ranks, *dp_sp.axis("dp").ranks])
    np.savez(f"{data_dir}/rank{rank}.npz", **out)
    hvd.shutdown()
""")


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_side(q, k, v):
    """Outputs and gradients of every case on the JAX mesh of 4 devices."""
    mesh = jcreate_mesh({"sp": N}, devices=jax.devices()[:N])
    spec = P(None, "sp")
    want = {}
    for name, _, jimpl in CASES:
        for causal in (True, False):
            if jimpl is None:
                def body(qb, kb, vb, causal=causal):
                    return julysses(qb, kb, vb, "sp", causal=causal)
            else:
                def body(qb, kb, vb, causal=causal, jimpl=jimpl):
                    return jring(qb, kb, vb, "sp", causal=causal,
                                 impl=jimpl)
            f = shard_map(body, mesh=mesh, in_specs=(spec,) * 3,
                          out_specs=spec, check_vma=False)
            key = f"{name}-{causal}"
            want[key] = np.asarray(jax.jit(f)(q, k, v))
            grads = jax.grad(lambda *a: jnp.sum(f(*a) ** 2),
                             argnums=(0, 1, 2))(q, k, v)
            for x, g in zip("qkv", grads):
                want[f"{key}-d{x}"] = np.asarray(g)
    for causal in (True, False):
        want[f"local-{causal}"] = np.asarray(jlocal(q, k, v, causal=causal))
    return want


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 4-rank world's per-rank results, and JAX's on the same inputs."""
    tmp = tmp_path_factory.mktemp("ring_world")
    rng = np.random.RandomState(5)
    q = (rng.randn(B, T, H, D) * 0.5).astype(np.float32)
    k = (rng.randn(B, T, H, D) * 0.5).astype(np.float32)
    v = rng.randn(B, T, H, D).astype(np.float32)
    np.savez(tmp / "qkv.npz", q=q, k=k, v=v)
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=REPO, HOROVOD_NUM_PROCESSES=str(N),
               HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(tmp)],
        env=dict(env, HOROVOD_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(N)]
    want = _jax_side(*(jnp.asarray(x) for x in (q, k, v)))
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, _) in zip(procs, outs):
        assert p.returncode == 0, out
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N)]
    return ranks, want


def _gathered(ranks, key):
    """The ranks' sequence shards of ``key``, in order along T."""
    return np.concatenate([r[key] for r in ranks], axis=1)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_forward_matches_jax_and_local_attention(world, name, causal):
    ranks, want = world
    key = f"{name}-{causal}"
    got = _gathered(ranks, key)
    np.testing.assert_allclose(got, want[key], **FWD)
    np.testing.assert_allclose(got, want[f"local-{causal}"], **FWD)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_gradients_of_sum_of_squares_match_jax(world, name, causal):
    ranks, want = world
    for x in "qkv":
        key = f"{name}-{causal}-d{x}"
        np.testing.assert_allclose(_gathered(ranks, key), want[key], **GRAD,
                                   err_msg=key)


def test_ulysses_head_count_error(world):
    ranks, _ = world
    for r in ranks:
        assert str(r["head_error"]) == ("head count 6 not divisible by sp "
                                        "axis size 4")


def test_mesh_is_row_major_with_sp_innermost(world):
    """``{"dp": 2, "sp": 2}`` on 4 ranks: rank r has dp index r // 2 and sp
    index r % 2; its sp row is the contiguous pair, its dp row the ranks two
    apart."""
    ranks, _ = world
    for r, got in enumerate(ranks):
        pair = 2 * (r // 2)
        assert list(got["layout"]) == [r // 2, r % 2, pair, pair + 1,
                                       r % 2, r % 2 + 2]


def test_mesh_errors():
    """Axes that do not cover the world raise as JAX's ``create_mesh`` does,
    whichever axis it is."""
    thvd.init(device="cpu")
    try:
        with pytest.raises(ValueError, match="require 2 devices, have 1"):
            create_mesh({"dp": 2})
        for axis in ("tp", "fsdp", "ep", "pp"):
            with pytest.raises(ValueError):
                create_mesh({axis: 2})
        mesh = create_mesh({"dp": 1, "tp": 1, "sp": 1})
        assert mesh.axis_names == ("dp", "sp", "tp")
        assert mesh.axis("sp").group is None
    finally:
        thvd.shutdown()


def test_later_axes_raise_not_implemented(monkeypatch):
    """``tp`` and ``fsdp`` build (the model-parallel slice), and since
    slice 10 Mixtral builds on them too, holding its ``[E/ep, D/fsdp,
    M/tp]`` block of each expert bank; what the port still refuses on an
    axis is a deliberate disagreement that names ROADMAP.md, section C:
    BERT on sp. A world of one shows it: the size is patched and
    ``new_group`` records the rows instead of making them."""
    import torch.distributed as dist
    from horovod_tpu_torch.core import context_api
    from horovod_tpu_torch.models.bert import Bert, bert_tiny
    from horovod_tpu_torch.models.mixtral import Mixtral, mixtral_tiny
    thvd.init(device="cpu")
    try:
        monkeypatch.setattr(context_api, "size", lambda: 4)
        monkeypatch.setattr(dist, "new_group", lambda ranks: tuple(ranks))
        assert create_mesh({"dp": 2, "tp": 2}).axis("tp").ranks == (0, 1)
        assert create_mesh({"fsdp": 4}).axis("fsdp").ranks == (0, 1, 2, 3)
        for axes, bank in (({"dp": 2, "tp": 2}, (8, 64, 64)),
                           ({"fsdp": 4}, (8, 16, 128))):
            model = Mixtral(mixtral_tiny(), device="cpu",
                            mesh=create_mesh(axes))
            assert tuple(model.blocks[0].moe.w1.shape) == bank
        with pytest.raises(ValueError, match="ROADMAP.md, section C"):
            Bert(bert_tiny(), device="cpu",
                 mesh=create_mesh({"dp": 2, "sp": 2}))
    finally:
        monkeypatch.undo()
        thvd.shutdown()


@pytest.mark.parametrize("causal", [True, False])
def test_local_attention_matches_jax(causal):
    from horovod_tpu_torch.parallel import local_attention
    rng = np.random.RandomState(6)
    q, k, v = (rng.randn(B, T, H, D).astype(np.float32) for _ in range(3))
    want = jlocal(*(jnp.asarray(x) for x in (q, k, v)), causal=causal)
    got = local_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                          causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
