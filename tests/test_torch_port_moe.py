"""The port's MoE routing, dispatch, combine and expert exchange against the
JAX package's ``parallel/moe.py``, on the CPU.

- Routing plans: ``topk_router_sorted``'s ``token_idx``, ``dest``,
  ``slot_entry`` and ``slot_valid`` equal JAX's exactly; ``weight`` and
  ``aux_loss`` within 1e-6. The one-hot ``topk_router`` matches too. Ample,
  tight and heavy-drop capacities, and logits with ties (``lax.top_k``
  breaks them by the lower index).
- ``sorted_dispatch`` and ``sorted_combine``: values and VJPs against
  ``jax.vjp`` within 1e-6, with cases that drop tokens (asserted). Both
  backward passes are gathers: two runs are bit-identical.
- ``expert_alltoall`` and ``expert_alltoall_back`` on gloo worlds of 2 and
  4 processes against JAX's under ``shard_map`` on as many devices,
  element for element, forward and backward; and ``routed_experts`` over
  those worlds against ``tests/test_parallel.py``'s construction (per-rank
  single-device MoE, and JAX's ``shard_map`` form).
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
from horovod_tpu.parallel import moe as jmoe

from horovod_tpu_torch.parallel import moe as tmoe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, E, D, K = 64, 8, 16, 2
CAP_FACTORS = (2.0, 0.5, 0.15)


def _logits(seed, ties=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(T, E).astype(np.float32)
    if ties:
        # every other token: experts 5 and 2 tie for first, 0 and 7 for
        # third place
        x[::2] = 0.0
        x[::2, 5] = x[::2, 2] = 1.0
        x[::2, 0] = x[::2, 7] = 0.5
    return x


def _cap(f):
    return max(1, int(f * K * T / E))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("cap_factor", CAP_FACTORS)
def test_sorted_plan_matches_jax(cap_factor, ties):
    logits = _logits(0, ties)
    cap = _cap(cap_factor)
    j = jmoe.topk_router_sorted(jnp.asarray(logits), E, cap, K)
    t = tmoe.topk_router_sorted(torch.from_numpy(logits), E, cap, K)
    for name in ("token_idx", "dest", "slot_entry", "slot_valid"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    np.testing.assert_allclose(t.weight.numpy(), np.asarray(j.weight),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t.aux_loss.item(), float(j.aux_loss),
                               rtol=1e-6)


@pytest.mark.parametrize("cap_factor", CAP_FACTORS)
def test_one_hot_router_matches_jax(cap_factor):
    logits = _logits(1)
    cap = _cap(cap_factor)
    j = jmoe.topk_router(jnp.asarray(logits), E, cap, K)
    t = tmoe.topk_router(torch.from_numpy(logits), E, cap, K)
    np.testing.assert_array_equal(t.dispatch.numpy(), np.asarray(j.dispatch))
    np.testing.assert_allclose(t.combine.numpy(), np.asarray(j.combine),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t.aux_loss.item(), float(j.aux_loss),
                               rtol=1e-6)


def _dispatch_combine_case(cap_factor, seed=2):
    rng = np.random.RandomState(seed)
    cap = _cap(cap_factor)
    logits = rng.randn(T, E).astype(np.float32)
    x = rng.randn(T, D).astype(np.float32)
    out = rng.randn(E, cap, D).astype(np.float32)
    dbuf = rng.randn(E, cap, D).astype(np.float32)
    dy = rng.randn(T, D).astype(np.float32)
    return cap, logits, x, out, dbuf, dy


@pytest.mark.parametrize("cap_factor", CAP_FACTORS)
def test_dispatch_and_combine_values_and_vjps_match_jax(cap_factor):
    cap, logits, x, out, dbuf, dy = _dispatch_combine_case(cap_factor)
    jr = jmoe.topk_router_sorted(jnp.asarray(logits), E, cap, K)
    dropped = int((np.asarray(jr.dest) == E * cap).sum())
    if cap_factor < 1:
        assert dropped > 0, "this case must drop tokens"

    jbuf, jvjp = jax.vjp(lambda v: jmoe.sorted_dispatch(v, jr, E, cap),
                         jnp.asarray(x))
    (jdx,) = jvjp(jnp.asarray(dbuf))

    def jcomb(o, lg):
        r = jmoe.topk_router_sorted(lg, E, cap, K)
        return jmoe.sorted_combine(o, r, T)
    jy, cvjp = jax.vjp(jcomb, jnp.asarray(out), jnp.asarray(logits))
    jdout, jdlogits = cvjp(jnp.asarray(dy))

    tx = torch.from_numpy(x).requires_grad_()
    tout = torch.from_numpy(out).requires_grad_()
    tlogits = torch.from_numpy(logits).requires_grad_()
    tr = tmoe.topk_router_sorted(tlogits, E, cap, K)
    tbuf = tmoe.sorted_dispatch(tx, tr, E, cap)
    tbuf.backward(torch.from_numpy(dbuf))
    ty = tmoe.sorted_combine(tout, tr, T)
    ty.backward(torch.from_numpy(dy))
    for got, want in ((tbuf, jbuf), (tx.grad, jdx), (ty, jy),
                      (tout.grad, jdout), (tlogits.grad, jdlogits)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def test_dispatch_and_combine_backward_is_deterministic():
    """Gathers only: two backward passes give the same bits."""
    cap, logits, x, out, dbuf, dy = _dispatch_combine_case(0.5, seed=3)
    grads = []
    for _ in range(2):
        tx = torch.from_numpy(x).requires_grad_()
        tout = torch.from_numpy(out).requires_grad_()
        r = tmoe.topk_router_sorted(torch.from_numpy(logits), E, cap, K)
        (tmoe.sorted_dispatch(tx, r, E, cap) * torch.from_numpy(dbuf)).sum() \
            .backward()
        (tmoe.sorted_combine(tout, r, T) * torch.from_numpy(dy)).sum() \
            .backward()
        grads.append((tx.grad, tout.grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_routed_experts_single_device_identity_expert():
    """With identity experts and top-1 routing (no drops) the output is the
    input, as JAX's test of the same name."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(8, 4).astype(np.float32))
    logits = torch.from_numpy(rng.randn(8, 2).astype(np.float32))
    y, _ = tmoe.routed_experts(x, logits, lambda e: e, axis=None,
                               num_experts=2, capacity_factor=8.0, top_k=1)
    np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=1e-5, atol=1e-6)


# ------------------------------------------------ the exchange, gloo worlds

TL, DX, C = 8, 6, 3  # routed_experts tokens a rank, width; exchange slots

_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import create_mesh, moe

    data_dir = sys.argv[1]
    hvd.init(device="cpu")
    rank, n = hvd.rank(), hvd.size()
    d = np.load(f"{data_dir}/data{n}.npz")
    axis = create_mesh({"ep": n}).axis("ep")
    out = {}
    moe.expert_alltoall.launches = 0
    x = torch.from_numpy(d["x"][rank]).requires_grad_()
    y = moe.expert_alltoall(x, axis)
    (y * torch.from_numpy(d["w"][rank])).sum().backward()
    out["fwd"], out["dx"] = y.detach().numpy(), x.grad.numpy()
    yb = torch.from_numpy(d["yb"][rank]).requires_grad_()
    back = moe.expert_alltoall_back(yb, axis)
    (back * torch.from_numpy(d["wb"][rank])).sum().backward()
    out["back"], out["dyb"] = back.detach().numpy(), yb.grad.numpy()
    out["launches"] = np.asarray(moe.expert_alltoall.launches)
    el = 8 // n
    scales = torch.arange(1, 9, dtype=torch.float32)[rank * el:(rank + 1) * el]
    xr = torch.from_numpy(d["xr"][rank])
    lr = torch.from_numpy(d["lr"][rank])
    routed, aux = moe.routed_experts(
        xr, lr, lambda e: e * scales[:, None, None], axis=axis,
        num_experts=8, capacity_factor=8.0, top_k=2)
    out["routed"], out["aux"] = routed.numpy(), aux.numpy()
    np.savez(f"{data_dir}/rank{rank}_{n}.npz", **out)
    hvd.shutdown()
""")


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_exchange(n, x, w, yb, wb):
    """JAX's exchanges under shard_map on n devices: values and the VJPs of
    sum(out * w)."""
    mesh = jcreate_mesh({"ep": n}, devices=jax.devices()[:n])

    def fwd(xs, ws):
        def loss(v):
            return (jmoe.expert_alltoall(v, "ep") * ws[0]).sum()
        y = jmoe.expert_alltoall(xs[0], "ep")
        return y[None], jax.grad(loss)(xs[0])[None]

    def back(ys, ws):
        def loss(v):
            return (jmoe.expert_alltoall_back(v, "ep") * ws[0]).sum()
        y = jmoe.expert_alltoall_back(ys[0], "ep")
        return y[None], jax.grad(loss)(ys[0])[None]

    spec = (P("ep"), P("ep"))
    f = jax.jit(shard_map(fwd, mesh=mesh, in_specs=spec,
                          out_specs=(P("ep"), P("ep")), check_vma=False))
    b = jax.jit(shard_map(back, mesh=mesh, in_specs=spec,
                          out_specs=(P("ep"), P("ep")), check_vma=False))
    y, dx = f(jnp.asarray(x), jnp.asarray(w))
    yback, dyb = b(jnp.asarray(yb), jnp.asarray(wb))
    return [np.asarray(a) for a in (y, dx, yback, dyb)]


def _jax_routed(n, xr, lr):
    """tests/test_parallel.py:164's construction: expert e scales by e + 1;
    the per-rank single-device MoE, and the shard_map form."""
    scales = np.arange(1, E + 1, dtype=np.float32)

    def single(xl, ll):
        return jmoe.routed_experts(
            jnp.asarray(xl), jnp.asarray(ll),
            lambda einp: einp * scales[:, None, None], axis_name=None,
            num_experts=E, capacity_factor=8.0, top_k=2)[0]
    ref = np.stack([np.asarray(single(xr[r], lr[r])) for r in range(n)])
    mesh = jcreate_mesh({"ep": n}, devices=jax.devices()[:n])

    def body(xb, lb):
        local = jnp.asarray(scales).reshape(n, E // n)[
            jax.lax.axis_index("ep")]
        y, _ = jmoe.routed_experts(
            xb[0], lb[0], lambda einp: einp * local[:, None, None],
            axis_name="ep", num_experts=E, capacity_factor=8.0, top_k=2)
        return y[None]
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("ep"), P("ep")),
                          out_specs=P("ep"), check_vma=False))
    return ref, np.asarray(f(jnp.asarray(xr), jnp.asarray(lr)))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_worlds")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    rng = np.random.RandomState(11)
    want, procs = {}, []
    for n in (2, 4):
        d = {"x": rng.randn(n, E, C, D).astype(np.float32),
             "w": rng.randn(n, E // n, n * C, D).astype(np.float32),
             "yb": rng.randn(n, E // n, n * C, D).astype(np.float32),
             "wb": rng.randn(n, E, C, D).astype(np.float32),
             "xr": rng.randn(n, TL, DX).astype(np.float32),
             "lr": rng.randn(n, TL, E).astype(np.float32)}
        np.savez(tmp / f"data{n}.npz", **d)
        want[n] = (_jax_exchange(n, d["x"], d["w"], d["yb"], d["wb"]),
                   _jax_routed(n, d["xr"], d["lr"]))
        env = dict(os.environ, PYTHONPATH=REPO,
                   HOROVOD_NUM_PROCESSES=str(n),
                   HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}")
        procs += [(n, subprocess.Popen(
            [sys.executable, str(script), str(tmp)],
            env=dict(env, HOROVOD_PROCESS_ID=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for r in range(n)]
    for _, p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out
    got = {n: [dict(np.load(tmp / f"rank{r}_{n}.npz")) for r in range(n)]
           for n in (2, 4)}
    return got, want


@pytest.mark.parametrize("n", [2, 4])
def test_expert_alltoall_matches_jax_shard_map(worlds, n):
    got, want = worlds
    y, dx, yback, dyb = want[n][0]
    for r, res in enumerate(got[n]):
        np.testing.assert_array_equal(res["fwd"], y[r])
        np.testing.assert_array_equal(res["dx"], dx[r])
        np.testing.assert_array_equal(res["back"], yback[r])
        np.testing.assert_array_equal(res["dyb"], dyb[r])
        # one exchange each way, forward and backward
        assert int(res["launches"]) == 4


@pytest.mark.parametrize("n", [2, 4])
def test_routed_experts_over_ep_matches_single_device(worlds, n):
    got, want = worlds
    ref, shard_mapped = want[n][1]
    for r, res in enumerate(got[n]):
        np.testing.assert_allclose(res["routed"], ref[r], rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(res["routed"], shard_mapped[r],
                                   rtol=1e-6, atol=1e-6)
