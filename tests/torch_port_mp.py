"""Shared harness of the port's model-parallel CPU tests
(``test_torch_port_tp.py``, ``test_torch_port_fsdp.py``): the JAX
package's GSPMD step on ``jax.devices()[:4]`` beside one 4-process gloo
world of the port that runs every case of a module in turn.
:func:`start_worlds` starts gloo worlds of any sizes side by side for the
other model-parallel files (``test_torch_port_mixtral_mp.py``,
``test_torch_port_bert_mp.py``, the sharded Adafactor of
``test_torch_port_moe_opt.py``).

Each case is ``llama_tiny`` (f32) with its config overrides, trained three
AdamW steps (lr 1e-3, weight decay 1e-4, as ``optax.adamw(1e-3)``) on a 4
x 32 seeded batch, ``tests/test_models.py``'s settings. JAX initialises
the weights; each rank loads its blocks through
``convert.llama_params_from_flax(..., mesh=mesh)``. A rank writes its
losses, the whole parameters gathered by ``sharding.full_state_dict``,
how many of its blocks differ from the first rank that holds them,
whether its AdamW moments follow their parameters' blocks
(``train.gspmd_shardings``), and the collectives it handed to
``torch.distributed`` in each step.
"""

import dataclasses
import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax

from horovod_tpu.models import llama as jllama
from horovod_tpu.parallel import create_mesh as jcreate_mesh
from horovod_tpu.train import (create_gspmd_train_state,
                               make_gspmd_train_step)

from horovod_tpu_torch import convert
from horovod_tpu_torch.models import llama as tllama

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
STEPS = 3

_WORKER = textwrap.dedent("""
    import dataclasses
    import json
    import pickle
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.models.llama import Llama, llama_tiny
    from horovod_tpu_torch.parallel import (create_hybrid_mesh, create_mesh,
                                            sharding)
    from horovod_tpu_torch.train import gspmd
    from horovod_tpu_torch.train import (create_gspmd_train_state,
                                         gspmd_shardings,
                                         make_gspmd_train_step,
                                         mesh_param_groups, shard_tokens)

    data_dir = sys.argv[1]
    hvd.init(device="cpu")
    rank = hvd.rank()
    with open(f"{data_dir}/cases.json") as f:
        cases = json.load(f)
    tokens = torch.from_numpy(np.load(f"{data_dir}/tokens.npy"))
    out = {}
    for case in cases:
        name = case["name"]
        mesh = create_mesh(case["axes"])
        cfg = dataclasses.replace(llama_tiny(), **case["cfg"])
        with open(f"{data_dir}/init_{case['init']}.pkl", "rb") as f:
            flax_params = pickle.load(f)
        model = Llama(cfg, device="cpu", seed=rank, mesh=mesh)
        model.load_state_dict(convert.llama_params_from_flax(
            flax_params, cfg, mesh=mesh))
        a = case.get("accum", 1)
        groups = mesh_param_groups(model, mesh)
        if case.get("world_divisor"):  # the divisor this slice replaced
            for g in groups:
                if "data_shards" in g:
                    g["data_shards"] = hvd.size()
            gspmd._check_optimizer = lambda *args: None
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(groups, lr=1e-3, weight_decay=1e-4),
            named_parameters=model.named_parameters(),
            backward_passes_per_step=a)
        state = create_gspmd_train_state(model, opt, mesh)
        step = make_gspmd_train_step(model, opt, mesh,
                                     accum_steps=a if a > 1 else None)
        shard = shard_tokens(tokens, mesh)
        losses, counts = [], []
        for _ in range(3):
            sharding.reset_counts()
            state, loss = step(state, shard)
            losses.append(loss.item())
            counts.append(dict(sharding.counts))
        differ = 0
        for p in model.parameters():
            rs = sharding.replica_set(mesh, sharding.holder_axes(p))
            ranks = rs.ranks if rs is not None else tuple(range(hvd.size()))
            buf = p.detach().clone()
            hvd.broadcast_(buf, ranks[0], process_set=rs)
            differ += int(not torch.equal(buf, p.detach()))
        params, opt_places = gspmd_shardings(model, opt)
        follows = all(
            v is (params[n] if k in ("exp_avg", "exp_avg_sq") else None)
            for (n, k), v in opt_places.items())
        full = sharding.full_state_dict(model)
        out[name] = {"losses": losses, "counts": counts, "differ": differ,
                     "opt_follows": follows and len(opt_places) > 0}
        if rank == 0:
            np.savez(f"{data_dir}/{name}.npz",
                     **{k: v.numpy() for k, v in full.items()})
    if "hybrid" in sys.argv[2:]:
        hyb = {}
        mesh = create_hybrid_mesh({"tp": 2}, {"dp": 2})
        hyb["dp_tp"] = [mesh.axis_names, mesh.axis("tp").ranks,
                        mesh.axis("dp").ranks]
        mesh = create_hybrid_mesh({"dp": 2}, {"dp": 2})
        hyb["dp4"] = [mesh.axis_names, mesh.axis("dp").ranks]
        mesh = create_hybrid_mesh({"tp": 2}, {"cross": 2})
        hyb["cross_tp"] = [mesh.axis_names, mesh.axis("cross").ranks,
                           mesh.axis("tp").ranks]
        try:
            create_hybrid_mesh({"dp": 4}, {"dp": 2})
            hyb["error"] = ""
        except ValueError as e:
            hyb["error"] = str(e)
        out["hybrid"] = hyb
    with open(f"{data_dir}/rank{rank}.json", "w") as f:
        json.dump(out, f)
    hvd.shutdown()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tokens():
    return np.random.RandomState(0).randint(0, 255, (4, 32))


def jax_train(axes, cfg_overrides, toks, tmp, name):
    """Three GSPMD AdamW steps of ``llama_tiny`` with ``cfg_overrides`` on
    the JAX mesh ``axes`` of ``jax.devices()[:4]``; pickles the initial
    flax parameters as ``init_<name>.pkl`` for the port's world and returns
    the losses and the final parameters in the port's names."""
    jcfg = dataclasses.replace(jllama.llama_tiny(), **cfg_overrides)
    tcfg = dataclasses.replace(tllama.llama_tiny(), **cfg_overrides)
    model = jllama.Llama(jcfg)
    mesh = jcreate_mesh(axes, devices=jax.devices()[:N])
    opt = optax.adamw(1e-3)
    toks = jnp.asarray(toks)
    state = create_gspmd_train_state(model, opt, jax.random.PRNGKey(0),
                                     toks, mesh, jllama.LOGICAL_RULES)
    flax_params = jax.tree_util.tree_map(np.asarray, state.params)
    with open(tmp / f"init_{name}.pkl", "wb") as f:
        pickle.dump(flax_params, f)
    step = make_gspmd_train_step(model, opt, mesh, jllama.LOGICAL_RULES)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, toks)
        losses.append(float(loss))
    final = convert.llama_params_from_flax(state.params, tcfg)
    return losses, {k: v.numpy() for k, v in final.items()}


def start_worlds(tmp, worker, sizes, extra=(), env=None):
    """Start a gloo world of each size in ``sizes`` side by side, every
    rank running the source ``worker`` with ``tmp`` and ``extra`` as its
    arguments. Returns a function that waits for every rank and asserts
    that each exited 0."""
    script = tmp / "worker.py"
    script.write_text(worker)
    procs = []
    for n in sizes:
        base = dict(os.environ, PYTHONPATH=REPO,
                    HOROVOD_NUM_PROCESSES=str(n),
                    HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
                    **(env or {}))
        procs += [subprocess.Popen(
            [sys.executable, str(script), str(tmp), *extra],
            env=dict(base, HOROVOD_PROCESS_ID=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n)]

    def wait():
        outs = [p.communicate(timeout=300) for p in procs]
        for p, (out, _) in zip(procs, outs):
            assert p.returncode == 0, out

    return wait


def run_world(tmp, cases, extra=()):
    """Run ``cases`` in one 4-process gloo world; each rank's results."""
    with open(tmp / "cases.json", "w") as f:
        json.dump(cases, f)
    start_worlds(tmp, _WORKER, [N], extra, {"HOROVOD_LOCAL_SIZE": "2"})()
    ranks = []
    for r in range(N):
        with open(tmp / f"rank{r}.json") as f:
            ranks.append(json.load(f))
    return ranks


def full_params(tmp, name):
    return dict(np.load(tmp / f"{name}.npz"))
