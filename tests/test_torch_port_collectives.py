"""The port's collective surface against the JAX package's, on the CPU.

Two gloo worlds are started once per module, side by side: 2 processes and
4. Each rank runs every case on its own row of seeded numpy inputs and saves
what it got. The tests then hold the ranks against the JAX functions on a
JAX world of the same size (``hvd.init(devices=jax.devices()[:n])``, so the
member counts match): ``eager.allgather``, ``eager.broadcast``,
``eager.alltoall`` and ``eager.reducescatter`` for the ops, ``shard_map``
over the ops for ``allgather_v``, ``alltoall_v``, the join functions and
the optimizer's ``join_allreduce``.

- Process sets: a set of 2 in the world of 4 (``[1, 3]``) and a ragged set
  of 3 of 4 (``[0, 1, 2]``). Members are held to the JAX members; a rank
  outside a set takes no part and gets its input back (the JAX package
  leaves non-member output unspecified for allgather and reducescatter).
- Errors (dim 0 not divisible by the member count, a root outside the set
  or the world, an op reducescatter does not take) are raised on every
  rank, with the JAX package's message.
- Tolerances: gathers, broadcasts, all-to-alls and the object helpers move
  values and are held exactly; reductions of f32 over at most 4 ranks are
  held within rtol = atol = 1e-6 (two summation orders of at most 4 terms
  differ by a few f32 roundings).
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd
from horovod_tpu.collectives import eager
from horovod_tpu.collectives.join import (iterate_with_join, join,
                                          join_allreduce, join_count)
from horovod_tpu.collectives.dynamic import allgather_v, alltoall_v
from horovod_tpu.collectives.dynamic import compact_gathered as j_compact
from horovod_tpu.optimizer import functions as jfunctions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
#: Per-rank data lengths of the uneven loop, the first n of them.
LENGTHS = (2, 3, 4, 5)
MAX_ROWS = 3

_WORKER = textwrap.dedent("""
    import json
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.optimizer import functions

    data_dir = sys.argv[1]
    hvd.init(device="cpu")
    rank, n = hvd.rank(), hvd.size()
    data = np.load(f"{data_dir}/inputs{n}.npz")
    row = lambda k: torch.from_numpy(data[k][rank].copy())
    out, errors = {}, {}

    def error(key, fn):
        try:
            fn()
        except ValueError as e:
            errors[key] = str(e)

    out["allgather"] = hvd.allgather(row("g"))
    out["grouped_allgather/0"], out["grouped_allgather/1"] = \\
        hvd.grouped_allgather([row("g"), row("g2")])
    b = row("b")
    out["broadcast"] = hvd.broadcast(b, 1)
    assert torch.equal(b, row("b")), "the input is left untouched"
    out["grouped_broadcast/0"], out["grouped_broadcast/1"] = \\
        hvd.grouped_broadcast([row("b"), row("g")], n - 1)
    out["alltoall"] = hvd.alltoall(row("a"))
    for op in (hvd.Sum, hvd.Average):
        out[f"reducescatter/{op}"] = hvd.reducescatter(row("r"), op)
        out[f"grouped_reducescatter/{op}/0"], \\
            out[f"grouped_reducescatter/{op}/1"] = \\
            hvd.grouped_reducescatter([row("r"), row("ri")], op)
    out["reducescatter_int_average"] = hvd.reducescatter(row("ri"),
                                                         hvd.Average)
    splits = data["s"][rank].tolist()
    out["alltoall_splits"], out["alltoall_splits_sizes"] = hvd.alltoall(
        row("sd"), splits=splits)
    out["alltoall_v_cut"], out["alltoall_v_cut_sizes"] = hvd.alltoall_v(
        row("td"), data["ts"][rank].tolist(), max_split=4)
    out["allgather_v"], out["allgather_v_sizes"] = hvd.allgather_v(
        row("v"), int(data["vs"][rank]))
    out["compact"] = hvd.compact_gathered(out["allgather_v"],
                                          out["allgather_v_sizes"])

    error("alltoall_dim0", lambda: hvd.alltoall(torch.zeros(3, 2)))
    error("reducescatter_dim0",
          lambda: hvd.reducescatter(torch.zeros(3, 2)))
    error("reducescatter_op",
          lambda: hvd.reducescatter(torch.zeros(n, 2), hvd.Min))
    error("broadcast_root", lambda: hvd.broadcast(torch.zeros(2), n))

    if n == 4:
        pair = hvd.add_process_set([1, 3])
        three = hvd.add_process_set([0, 1, 2])
        for name, ps in (("pair", pair), ("three", three)):
            x = row("p")
            out[f"{name}/allgather"] = hvd.allgather(x, process_set=ps)
            out[f"{name}/alltoall"] = hvd.alltoall(x, process_set=ps)
            out[f"{name}/reducescatter"] = hvd.reducescatter(
                x, hvd.Sum, process_set=ps)
            out[f"{name}/broadcast"] = hvd.broadcast(
                x, ps.ranks[-1], process_set=ps)
        error("three/broadcast_root",
              lambda: hvd.broadcast(torch.zeros(2), 3, process_set=three))
        error("three/alltoall_dim0",
              lambda: hvd.alltoall(torch.zeros(4, 2), process_set=three))
        out["join_functions_pair"] = functions.join_allreduce(
            row("j"), rank != 1, process_set=pair)

    # hvd.join: masked inactive ranks, everyone joined, the poll, the count.
    x = row("j")
    out["join_average"] = hvd.join_allreduce(x, rank < n - 1)
    out["join_sum_all_joined"] = hvd.join_allreduce(x, False, hvd.Sum)
    any_active, last = hvd.join(rank % 2 == 0)
    out["join_poll"] = np.asarray([int(any_active), int(last)])
    any_active, last = hvd.join(False)
    out["join_poll_nobody"] = np.asarray([int(any_active), int(last)])
    out["join_count"] = hvd.join_count(rank < n // 2)
    mine = [torch.tensor(float(v)) for v in data["loop"][:, rank]]
    mine = mine[:[2, 3, 4, 5][rank]]
    out["join_loop"] = torch.stack([hvd.join_allreduce(batch, active)
                                    for batch, active in
                                    hvd.iterate_with_join(mine)])
    # The last rank has no data at all: it is fed None and still joins in.
    out["join_loop_empty"] = torch.stack([
        hvd.join_allreduce(torch.zeros(()) if batch is None else batch,
                           active)
        for batch, active in hvd.iterate_with_join(
            mine if rank < n - 1 else [])])
    out["join_functions"] = functions.join_allreduce(
        [row("j"), row("b")], rank != 0)[1]
    assert functions.join() == n - 1

    obj = {"rank": rank, "nested": {"list": [rank, "x" * rank],
                                    "tuple": (1.5, None)}}
    objects = {"broadcast": functions.broadcast_object(obj, n - 1),
               "allgather": functions.allgather_object(obj)}
    with open(f"{data_dir}/objects{n}_rank{rank}.json", "w") as f:
        json.dump(objects, f)
    np.savez(f"{data_dir}/out{n}_rank{rank}.npz",
             errors=np.asarray(json.dumps(errors)),
             **{k: np.asarray(v) for k, v in out.items()})
    hvd.shutdown()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inputs(n):
    rng = np.random.RandomState(10 + n)
    splits = rng.randint(0, 3, size=(n, n)).astype(np.int32)
    sd = np.zeros((n, int(splits.sum(1).max()), 2), np.float32)
    for r in range(n):
        sd[r, :splits[r].sum()] = rng.randn(splits[r].sum(), 2)
    ts = np.zeros((n, n), np.int32)  # every rank sends 5 rows to member 0
    ts[:, 0], ts[:, 1] = 5, 3        # and 3 to member 1: a cut at 4
    td = (np.arange(8, dtype=np.float32)[None, :, None]
          + 100 * np.arange(n, dtype=np.float32)[:, None, None])
    return {
        "g": rng.randn(n, 3, 2).astype(np.float32),
        "g2": rng.randn(n, 2, 5).astype(np.float32),
        "b": rng.randn(n, 4).astype(np.float32),
        "a": rng.randn(n, 2 * n, 3).astype(np.float32),
        "r": rng.randn(n, 2 * n, 3).astype(np.float32),
        "ri": rng.randint(-50, 50, size=(n, 2 * n)).astype(np.int32),
        "p": rng.randn(n, 6, 2).astype(np.float32),
        "s": splits, "sd": sd, "ts": ts, "td": td,
        "v": rng.randn(n, MAX_ROWS, 2).astype(np.float32),
        "vs": rng.randint(0, MAX_ROWS + 1, size=n).astype(np.int32),
        "j": rng.randn(n, 3).astype(np.float32),
        "loop": rng.randn(max(LENGTHS[:n]), n).astype(np.float32),
    }


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Run the worker in a 2- and a 4-process gloo world at once; return
    ``{n: (inputs, [rank outputs], [rank objects])}``."""
    d = tmp_path_factory.mktemp("collectives")
    inputs = {n: _inputs(n) for n in WORLDS}
    for n in WORLDS:
        np.savez(d / f"inputs{n}.npz", **inputs[n])
    script = d / "worker.py"
    script.write_text(_WORKER)
    procs = []
    for n in WORLDS:
        env = dict(os.environ, PYTHONPATH=REPO,
                   HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
                   HOROVOD_NUM_PROCESSES=str(n))
        procs += [subprocess.Popen(
            [sys.executable, str(script), str(d)],
            env=dict(env, HOROVOD_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(n)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            assert p.returncode == 0, out
    finally:
        for p in procs:
            p.kill()
    result = {}
    for n in WORLDS:
        ranks = [dict(np.load(d / f"out{n}_rank{r}.npz")) for r in range(n)]
        objects = [json.loads((d / f"objects{n}_rank{r}.json").read_text())
                   for r in range(n)]
        result[n] = (inputs[n], ranks, objects)
    return result


def _jax_world(n):
    """A JAX world of n devices, the port's member count."""
    hvd.shutdown()
    hvd.init(devices=jax.devices()[:n])


def _flat(x):
    """Per-rank ``[n, k, ...]`` rows as the eager ops' ``[n * k, ...]``."""
    return jnp.asarray(x.reshape((-1,) + x.shape[2:]))


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=key)


def _shmap(fn, n_in, out_specs):
    f = shard_map(fn, mesh=hvd.mesh(),
                  in_specs=tuple(P(hvd.RANK_AXIS) for _ in range(n_in)),
                  out_specs=out_specs, check_vma=False)
    return jax.jit(f)


@pytest.mark.parametrize("n", WORLDS)
def test_allgather_matches_jax(worlds, n):
    inputs, ranks, _ = worlds[n]
    _jax_world(n)
    want = np.asarray(eager.allgather(_flat(inputs["g"])))
    for r in ranks:
        np.testing.assert_array_equal(r["allgather"], want)


@pytest.mark.parametrize("n", WORLDS)
def test_grouped_allgather_matches_jax(worlds, n):
    inputs, ranks, _ = worlds[n]
    _jax_world(n)
    want = eager.allgather([_flat(inputs["g"]), _flat(inputs["g2"])])
    for r in ranks:
        for i, w in enumerate(want):
            np.testing.assert_array_equal(r[f"grouped_allgather/{i}"],
                                          np.asarray(w))


@pytest.mark.parametrize("n", WORLDS)
def test_broadcast_and_grouped_broadcast_match_jax(worlds, n):
    inputs, ranks, _ = worlds[n]
    _jax_world(n)
    want = np.asarray(eager.broadcast(jnp.asarray(inputs["b"]), 1))
    want_grouped = eager.broadcast([jnp.asarray(inputs["b"]),
                                    jnp.asarray(inputs["g"])], n - 1)
    for r in ranks:
        np.testing.assert_array_equal(r["broadcast"], want)
        for i, w in enumerate(want_grouped):
            np.testing.assert_array_equal(r[f"grouped_broadcast/{i}"],
                                          np.asarray(w))


@pytest.mark.parametrize("n", WORLDS)
def test_alltoall_matches_jax(worlds, n):
    inputs, ranks, _ = worlds[n]
    _jax_world(n)
    want = np.asarray(eager.alltoall(jnp.asarray(inputs["a"])))
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["alltoall"], want[r])


@pytest.mark.parametrize("op", [hvd.Sum, hvd.Average])
@pytest.mark.parametrize("n", WORLDS)
def test_reducescatter_and_grouped_match_jax(worlds, n, op):
    inputs, ranks, _ = worlds[n]
    _jax_world(n)
    want = np.asarray(eager.reducescatter(jnp.asarray(inputs["r"]), op=op))
    want_int = np.asarray(eager.reducescatter(jnp.asarray(inputs["ri"]),
                                              op=op))
    for r, got in enumerate(ranks):
        for key in (f"reducescatter/{op}", f"grouped_reducescatter/{op}/0"):
            np.testing.assert_allclose(got[key], want[r], rtol=1e-6,
                                       atol=1e-6, err_msg=key)
        key = f"grouped_reducescatter/{op}/1"
        assert got[key].dtype == want_int.dtype, (key, got[key].dtype)
        np.testing.assert_allclose(got[key], want_int[r], rtol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("n", WORLDS)
def test_reducescatter_average_promotes_ints_like_jax(worlds, n):
    inputs, ranks, _ = worlds[n]
    _jax_world(n)
    want = np.asarray(eager.reducescatter(jnp.asarray(inputs["ri"]),
                                          op=hvd.Average))
    assert want.dtype == np.float32
    for r, got in enumerate(ranks):
        assert got["reducescatter_int_average"].dtype == np.float32
        np.testing.assert_allclose(got["reducescatter_int_average"], want[r],
                                   rtol=1e-6)


def _set_result(eager_op, x, members, **kw):
    """The JAX eager op over the process set ``members`` of the 4-device
    world: the per-rank stacked result."""
    _jax_world(4)
    return np.asarray(eager_op(x, process_set=hvd.add_process_set(members),
                               **kw))


@pytest.mark.parametrize("name, members", [("pair", [1, 3]),
                                           ("three", [0, 1, 2])])
def test_process_set_allgather(worlds, name, members):
    inputs, ranks, _ = worlds[4]
    want = _set_result(eager.allgather, _flat(inputs["p"]), members)
    for r, got in enumerate(ranks):
        if r in members:
            np.testing.assert_array_equal(got[f"{name}/allgather"], want[r])
        else:
            np.testing.assert_array_equal(got[f"{name}/allgather"],
                                          inputs["p"][r])


@pytest.mark.parametrize("name, members", [("pair", [1, 3]),
                                           ("three", [0, 1, 2])])
def test_process_set_alltoall(worlds, name, members):
    """Members exchange among themselves in member order; the JAX package
    also leaves the ragged set's non-member its input."""
    inputs, ranks, _ = worlds[4]
    want = _set_result(eager.alltoall, jnp.asarray(inputs["p"]), members)
    for r, got in enumerate(ranks):
        if r in members or name == "three":
            np.testing.assert_array_equal(got[f"{name}/alltoall"], want[r])
        else:
            np.testing.assert_array_equal(got[f"{name}/alltoall"],
                                          inputs["p"][r])


@pytest.mark.parametrize("name, members", [("pair", [1, 3]),
                                           ("three", [0, 1, 2])])
def test_process_set_reducescatter(worlds, name, members):
    inputs, ranks, _ = worlds[4]
    want = _set_result(eager.reducescatter, jnp.asarray(inputs["p"]),
                       members, op=hvd.Sum)
    for r, got in enumerate(ranks):
        if r in members:
            np.testing.assert_allclose(got[f"{name}/reducescatter"], want[r],
                                       rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[f"{name}/reducescatter"],
                                          inputs["p"][r])


@pytest.mark.parametrize("name, members", [("pair", [1, 3]),
                                           ("three", [0, 1, 2])])
def test_process_set_broadcast(worlds, name, members):
    """From the set's last member; non-members keep their value, in the
    JAX package as here."""
    inputs, ranks, _ = worlds[4]
    want = _set_result(eager.broadcast, jnp.asarray(inputs["p"]), members,
                       root_rank=members[-1])
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[f"{name}/broadcast"], want[r])


def _jax_error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("n", WORLDS)
def test_errors_are_raised_on_every_rank_as_jax_raises_them(worlds, n):
    _, ranks, _ = worlds[n]
    _jax_world(n)
    want = {
        "alltoall_dim0": _jax_error(
            lambda: eager.alltoall(jnp.zeros((n, 3, 2)))),
        "reducescatter_dim0": _jax_error(
            lambda: eager.reducescatter(jnp.zeros((n, 3, 2)))),
        "reducescatter_op": _jax_error(
            lambda: eager.reducescatter(jnp.zeros((n, n, 2)), op=hvd.Min)),
    }
    if n == 4:
        three = hvd.add_process_set([0, 1, 2])
        want["three/broadcast_root"] = _jax_error(
            lambda: eager.broadcast(jnp.zeros((4, 2)), 3, process_set=three))
        want["three/alltoall_dim0"] = _jax_error(
            lambda: eager.alltoall(jnp.zeros((4, 4, 2)), process_set=three))
    root = _jax_error(lambda: eager.broadcast(jnp.zeros((n, 2)), n))
    assert root.startswith(f"root rank {n} out of range")
    for r in ranks:
        errors = json.loads(str(r["errors"]))
        assert errors.pop("broadcast_root").startswith(
            f"root rank {n} out of range")
        assert errors == want


@pytest.mark.parametrize("n", WORLDS)
def test_allgather_v_and_compact_match_jax(worlds, n):
    inputs, ranks, _ = worlds[n]
    _jax_world(n)

    def body(x, s):
        g, sz = allgather_v(x[0], s[0, 0])
        return g, sz

    gathered, sizes = _shmap(body, 2, (P(None), P(None)))(
        jnp.asarray(inputs["v"]), jnp.asarray(inputs["vs"])[:, None])
    dense = j_compact(np.asarray(gathered), np.asarray(sizes))
    for r in ranks:
        np.testing.assert_array_equal(r["allgather_v"], np.asarray(gathered))
        np.testing.assert_array_equal(r["allgather_v_sizes"],
                                      np.asarray(sizes))
        assert r["allgather_v_sizes"].dtype == np.int32
        np.testing.assert_array_equal(r["compact"], dense)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", ["splits", "cut"])
def test_alltoall_v_matches_jax(worlds, n, case):
    """``alltoall(t, splits)`` routes to ``alltoall_v``; with ``max_split``
    below a split the tail is cut from the rows and the sizes alike, and
    later chunks keep the caller's offsets
    (``tests/test_dynamic.py::test_alltoall_v_small_max_split_truncates_
    consistently``)."""
    inputs, ranks, _ = worlds[n]
    _jax_world(n)
    data, splits, kw = ((inputs["sd"], inputs["s"], {}) if case == "splits"
                        else (inputs["td"], inputs["ts"], {"max_split": 4}))

    def body(x, s):
        recv, rs = alltoall_v(x[0], s[0], **kw)
        return recv[None], rs[None]

    recv, rsplits = _shmap(body, 2, (P(hvd.RANK_AXIS), P(hvd.RANK_AXIS)))(
        jnp.asarray(data), jnp.asarray(splits))
    key = "alltoall_splits" if case == "splits" else "alltoall_v_cut"
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[key], np.asarray(recv)[r])
        np.testing.assert_array_equal(got[key + "_sizes"],
                                      np.asarray(rsplits)[r])
    if case == "cut":
        np.testing.assert_array_equal(ranks[1]["alltoall_v_cut"][:3, 0],
                                      [5, 6, 7])


def _join_run(n, fn, *arrays):
    _jax_world(n)
    body = lambda *xs: fn(*[x[0] for x in xs])[None]
    return np.asarray(_shmap(body, len(arrays), P(hvd.RANK_AXIS))(
        *[jnp.asarray(a) for a in arrays]))


@pytest.mark.parametrize("n", WORLDS)
def test_join_allreduce_masks_inactive_ranks(worlds, n):
    inputs, ranks, _ = worlds[n]
    active = np.arange(n) < n - 1
    want = _join_run(n, lambda a, v: join_allreduce(v, a, hvd.Average),
                     active, inputs["j"])
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["join_average"], want[r], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("n", WORLDS)
def test_join_allreduce_sum_with_everyone_joined(worlds, n):
    inputs, ranks, _ = worlds[n]
    want = _join_run(n, lambda a, v: join_allreduce(v, a, hvd.Sum),
                     np.zeros(n, bool), inputs["j"])
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["join_sum_all_joined"], want[r])
        assert not got["join_sum_all_joined"].any()


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", ["last_rank", "nobody_active"])
def test_join_poll(worlds, n, case):
    _, ranks, _ = worlds[n]
    active = (np.arange(n) % 2 == 0) if case == "last_rank" \
        else np.zeros(n, bool)

    def poll(a):
        any_active, last = join(a)
        return jnp.stack([any_active.astype(jnp.int32), last])

    want = _join_run(n, poll, active)
    key = "join_poll" if case == "last_rank" else "join_poll_nobody"
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[key], want[r])
    if case == "nobody_active":
        assert list(ranks[0][key]) == [0, -1]


@pytest.mark.parametrize("n", WORLDS)
def test_join_count(worlds, n):
    _, ranks, _ = worlds[n]
    want = _join_run(n, join_count, np.arange(n) < n // 2)
    for r, got in enumerate(ranks):
        assert got["join_count"].dtype == np.int32
        assert int(got["join_count"]) == int(want[r]) == n // 2


def _jax_join_loop(inputs, n, lengths):
    """The JAX loop's masked averages over the loop rows, the lengths
    declared."""
    class Batches(list):
        pass

    batches = Batches(jnp.asarray(row) for row in inputs["loop"])
    batches.per_rank_lengths = lengths
    _jax_world(n)
    f = _shmap(lambda a, v: join_allreduce(v[0], a[0],
                                                 hvd.Average)[None], 2,
               P(hvd.RANK_AXIS))
    want = []
    for batch, active in iterate_with_join(batches):
        want.append(np.asarray(f(active, batch))[0])
    assert len(want) == max(lengths)
    return want


@pytest.mark.parametrize("n", WORLDS)
def test_uneven_loop_through_iterate_with_join(worlds, n):
    """Each rank iterates over its own data, of length 2, 3, 4 or 5; the
    lengths are gathered, and each step's masked average is held to the
    JAX loop over the same rows with the lengths declared
    (``tests/test_join.py::test_uneven_training_loop``)."""
    inputs, ranks, _ = worlds[n]
    want = _jax_join_loop(inputs, n, list(LENGTHS[:n]))
    for got in ranks:
        np.testing.assert_allclose(got["join_loop"], want, rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("n", WORLDS)
def test_iterate_with_join_when_a_rank_has_no_data(worlds, n):
    """The last rank's list is empty: it still takes part in the gather of
    the lengths and in every step (fed None, inactive), so no rank blocks;
    the others' averages match the JAX loop with its length declared 0."""
    inputs, ranks, _ = worlds[n]
    want = _jax_join_loop(inputs, n, list(LENGTHS[:n - 1]) + [0])
    for got in ranks:
        np.testing.assert_allclose(got["join_loop_empty"], want, rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("n", WORLDS)
def test_functions_join_allreduce_matches_jax(worlds, n):
    inputs, ranks, _ = worlds[n]
    have = np.arange(n) != 0
    want = _join_run(n, lambda h, g: jfunctions.join_allreduce(g, h),
                     have, inputs["b"])
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["join_functions"], want[r], rtol=1e-6,
                                   atol=1e-6)


def test_functions_join_allreduce_over_a_process_set(worlds):
    """Members 1 and 3 average over the member with data; ranks outside
    the set reduce alone, as in the JAX package's singleton groups."""
    inputs, ranks, _ = worlds[4]
    _jax_world(4)
    pair = hvd.add_process_set([1, 3])
    body = lambda h, g: jfunctions.join_allreduce(g[0], h[0],
                                                  process_set=pair)[None]
    want = np.asarray(_shmap(body, 2, P(hvd.RANK_AXIS))(
        jnp.asarray(np.arange(4) != 1), jnp.asarray(inputs["j"])))
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["join_functions_pair"], want[r],
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ranks[1]["join_functions_pair"],
                               inputs["j"][3], rtol=1e-6)


@pytest.mark.parametrize("n", WORLDS)
def test_broadcast_object_and_allgather_object(worlds, n):
    """A nested dict from the last rank, and every rank's, in rank order
    (JSON round trip: tuples come back as lists)."""
    _, _, objects = worlds[n]

    def obj(rank):
        return {"rank": rank, "nested": {"list": [rank, "x" * rank],
                                         "tuple": [1.5, None]}}

    for got in objects:
        assert got["broadcast"] == obj(n - 1)
        assert got["allgather"] == [obj(r) for r in range(n)]
    assert jfunctions.broadcast_object(obj(0)) == obj(0)
    assert jfunctions.allgather_object(obj(0)) == [obj(0)]
