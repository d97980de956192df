"""The port's package rules.

``horovod_tpu_torch`` and ``chip_smoke.py`` import ``torch`` and never
``jax``, ``flax``, ``optax`` or anything of ``horovod_tpu``; its entry points
run on the card unless the caller asks for the CPU.
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

import horovod_tpu_torch as thvd

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "horovod_tpu"}


def _port_files():
    files = sorted((REPO / "horovod_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_nothing_of_jax_or_the_reference():
    files = _port_files()
    assert len(files) > 10
    pkg = REPO / "horovod_tpu_torch"
    for module in ("collectives/adasum.py", "ops/fused.py",
                   "ops/flash_attention.py", "models/resnet.py",
                   "models/bert.py", "optimizer/sync_batch_norm.py",
                   "train/step_builder.py", "train/gspmd.py",
                   "parallel/mesh.py", "parallel/ring.py",
                   "parallel/ulysses.py", "parallel/moe.py",
                   "models/mixtral.py", "optimizer/moe_opt.py",
                   "parallel/sharding.py", "parallel/pipeline.py",
                   "convert.py", "train/losses.py"):
        assert pkg / module in files
    bad = {str(f.relative_to(REPO)): sorted(set(_imported_roots(f))
                                            & FORBIDDEN)
           for f in files}
    assert {f: r for f, r in bad.items() if r} == {}


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        "horovod_tpu_torch." + ".".join(
            f.relative_to(REPO / "horovod_tpu_torch").with_suffix("").parts)
        for f in (REPO / "horovod_tpu_torch").rglob("*.py")
        if f.name != "__init__.py")
    code = ("import sys, importlib\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r})\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_build_takes_each_kernel_source_and_entry_point_once():
    """``ops/_build.py`` compiles every ``csrc/*.cu`` in one ``nvcc`` call:
    the flash-attention kernels and the Adasum kernels, and nothing else.
    Each C entry point it binds is defined in exactly one source (one
    shared library cannot hold two definitions of one symbol)."""
    from horovod_tpu_torch.ops import _build
    assert [f.name for f in _build._sources()] == ["flash_attention.cu",
                                                   "fused.cu"]
    text = {f.name: f.read_text() for f in _build._sources()}
    for name in _build._SIGNATURES:
        defined = [f for f, src in text.items()
                   if re.search(rf"^\S.*\b{name}\(", src, re.M)]
        assert len(defined) == 1, (name, defined)
    assert re.search(r"^int hvd_adasum_norms_dot\(", text["fused.cu"], re.M)
    assert re.search(r"^int hvd_adasum_combine\(", text["fused.cu"], re.M)


def test_init_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        thvd.init()
    assert not thvd.is_initialized()


def test_cpu_world_of_one_answers_like_the_reference():
    thvd.init(device="cpu")
    try:
        assert (thvd.rank(), thvd.size(), thvd.local_rank(),
                thvd.local_size(), thvd.cross_rank(),
                thvd.cross_size()) == (0, 1, 0, 1, 0, 1)
        assert thvd.device() == torch.device("cpu")
        assert thvd.cuda_built() == (torch.version.cuda is not None)
        assert thvd.nccl_built() == torch.distributed.is_nccl_available()
        x = torch.arange(6.0)
        for op, want in ((thvd.Sum, x), (thvd.Average, x), (thvd.Min, x),
                         (thvd.Max, x), (thvd.Product, x), (thvd.Adasum, x)):
            assert torch.equal(thvd.allreduce(x, op), want)
        # Adasum of one contribution is that contribution, scaled.
        assert torch.equal(thvd.allreduce(x, thvd.Adasum, prescale_factor=2.0,
                                          postscale_factor=3.0), 6 * x)
        y = thvd.allreduce(x, thvd.Average, prescale_factor=2.0,
                           postscale_factor=0.5)
        assert torch.equal(y, x)
        half = thvd.allreduce(x, compression=thvd.Compression.bf16)
        assert half.dtype == torch.float32 and torch.equal(half, x)
        assert torch.equal(thvd.broadcast(x, 0), x)
        thvd.barrier()
        with pytest.raises(ValueError, match="root rank"):
            thvd.broadcast(x, 1)
    finally:
        thvd.shutdown()


def test_bf16_attention_kernels_are_tensor_core_kernels_of_their_own():
    """The bf16 B1, B2 and B3 (``csrc/flash_attention_sm90.cuh``, included
    by ``flash_attention.cu``) issue wgmma on tiles that TMA loads, with
    mbarrier completion, and no kernel source calls a library's kernel."""
    csrc = REPO / "horovod_tpu_torch" / "ops" / "csrc"
    sm90 = (csrc / "flash_attention_sm90.cuh").read_text()
    for needed in ("wgmma.mma_async", "cp.async.bulk.tensor",
                   "mbarrier.try_wait", "setmaxnreg", "fa_fwd_kernel_sm90",
                   "fa_bwd_dq_kernel_sm90", "fa_bwd_dkv_kernel_sm90"):
        assert needed in sm90, needed
    assert '#include "flash_attention_sm90.cuh"' in (
        csrc / "flash_attention.cu").read_text()
    text = "".join(f.read_text().lower() for f in sorted(csrc.iterdir()))
    for banned in ("cublas", "cudnn", "cutlass", "cute/",
                   "scaled_dot_product"):
        assert banned not in text, banned


@pytest.mark.parametrize("entry, launch", [("hvd_fa_fwd", "launch_fwd"),
                                           ("hvd_fa_bwd_dq", "launch_dq"),
                                           ("hvd_fa_bwd_dkv", "launch_dkv")])
def test_bf16_attention_entry_point_dispatches_to_tensor_cores(entry, launch):
    """Each flash-attention entry point sends bf16 to the tensor-core
    kernel (``sm90::launch_*``) through ``HVD_DISPATCH_SM90``, and f32 to
    the CUDA-core one; no entry point keeps bf16 on the CUDA cores."""
    src = (REPO / "horovod_tpu_torch" / "ops" / "csrc" /
           "flash_attention.cu").read_text()
    body = re.search(rf"^int {entry}\(.*?^}}", src, re.M | re.S)
    assert body is not None, entry
    assert re.search(rf"HVD_DISPATCH_SM90\({launch},", body.group(0))
    macro = re.search(r"^#define HVD_DISPATCH_SM90\(.*?\n\n", src,
                      re.M | re.S).group(0)
    assert "HVD_BF16 && D == 64) return sm90::LAUNCH<64>" in macro
    assert "HVD_BF16 && D == 128) return sm90::LAUNCH<128>" in macro
    assert not re.search(r"^#define HVD_DISPATCH\(", src, re.M)


def test_build_digest_covers_the_included_header(tmp_path, monkeypatch):
    """An edit to the header rebuilds the library: the digest in its name
    hashes every ``csrc/*.cu*`` file, not only the compiled sources."""
    import shutil
    from horovod_tpu_torch.ops import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build._digest()
    header = csrc / "flash_attention_sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build._digest() != before
    assert [f.name for f in _build._sources()] == ["flash_attention.cu",
                                                   "fused.cu"]


def test_sync_batch_norm_in_a_world_of_one_issues_no_collective(monkeypatch):
    """Where the JAX model drops the BatchNorm axis (a world of one, and
    eval mode), SyncBatchNorm calls no collective, forward or backward; a
    ResNet step in a world of one all-reduces only its gradient buckets."""
    from horovod_tpu_torch.collectives import ops
    from horovod_tpu_torch.models.resnet import ResNetTiny
    from horovod_tpu_torch.train import create_train_state, make_train_step
    issued = []
    real = ops.dist.all_reduce
    monkeypatch.setattr(ops.dist, "all_reduce",
                        lambda *a, **k: issued.append(a[0].shape)
                        or real(*a, **k))
    thvd.init(device="cpu")
    try:
        bn = thvd.SyncBatchNorm(3, device="cpu")
        x = torch.randn(4, 3, 5, 5, requires_grad=True)
        bn(x).square().sum().backward()
        bn.eval()
        bn(x).sum().backward()
        assert issued == []
        model = ResNetTiny(num_classes=10, dtype=torch.float32,
                           sync_batch_norm=True, device="cpu")
        opt = thvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                        lr=0.1))
        step = make_train_step(model, opt, torch.nn.functional.cross_entropy)
        step(create_train_state(model, opt), torch.randn(2, 8, 8, 3),
             torch.tensor([1, 2]))
        assert len(issued) == len(opt.buckets)
    finally:
        thvd.shutdown()


@pytest.mark.parametrize("make", ["resnet", "bert"])
def test_models_default_to_the_card(make):
    """Without a device and without an initialised context the models are
    made on "cuda": here, with no card, that raises instead of falling back
    to the CPU."""
    from horovod_tpu_torch.models.bert import Bert, bert_tiny
    from horovod_tpu_torch.models.resnet import ResNetTiny
    build = {"resnet": lambda: ResNetTiny(num_classes=10),
             "bert": lambda: Bert(bert_tiny())}[make]
    assert not thvd.is_initialized()
    if torch.cuda.is_available():
        assert next(build().parameters()).is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            build()


#: Names of the JAX package's collective surface with no counterpart in the
#: port, each with the ROADMAP.md text that accounts for it.
UNPORTED = {"eager": "`collectives/eager.py` has its counterpart in "
                     "`ops.py`"}


def _reference_collective_names():
    """``horovod_tpu.collectives.__all__`` and the names the top level
    imports from ``.collectives``, read from the sources (no jax import)."""
    ref = REPO / "horovod_tpu"
    tree = ast.parse((ref / "collectives" / "__init__.py").read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "__all__":
            names |= {e.value for e in node.value.elts}
    top = set()
    for node in ast.parse((ref / "__init__.py").read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.module == "collectives":
            top |= {a.name for a in node.names}
    return names, top


def test_every_reference_collective_has_a_counterpart_or_a_roadmap_entry():
    """Each name exported by ``horovod_tpu.collectives``, and each name the
    JAX package's top level takes from it, is exported by the port at the
    same place, or accounted for in ROADMAP.md: a later slice cannot drop
    one silently."""
    import horovod_tpu_torch.collectives as tcol
    names, top = _reference_collective_names()
    assert len(names) > 25 and top <= names | {"eager"}
    roadmap = (REPO / "ROADMAP.md").read_text()
    missing = []
    for name in sorted(names):
        if name in UNPORTED:
            assert UNPORTED[name] in roadmap, name
            continue
        if not hasattr(tcol, name) or name not in tcol.__all__:
            missing.append(f"collectives.{name}")
    for name in sorted(top - set(UNPORTED)):
        if getattr(thvd, name, None) is not getattr(tcol, name, None):
            missing.append(name)
    assert missing == []


def test_hierarchical_flag_in_a_world_of_one_issues_no_collective(
        monkeypatch):
    """As the JAX package drops the collectives of a 1-member axis, the
    flag adds nothing in a world of one: no reduce-scatter, all-gather or
    group, and a ``DistributedOptimizer`` step still all-reduces its
    buckets once each, flat."""
    from horovod_tpu_torch.collectives import ops
    from horovod_tpu_torch.core.config import Config
    issued = {"all_reduce": 0, "reduce_scatter_tensor": 0,
              "all_gather_into_tensor": 0, "new_group": 0}
    thvd.init(device="cpu", config=Config(hierarchical_allreduce=True,
                                          hierarchical_allgather=True))
    try:
        for name in issued:
            real = getattr(torch.distributed, name)

            def counting(*a, _name=name, _real=real, **k):
                issued[_name] += 1
                return _real(*a, **k)
            monkeypatch.setattr(torch.distributed, name, counting)
        before = dict(ops.hierarchical_allreduce_async_.launches)
        model = torch.nn.Sequential(torch.nn.Linear(8, 16),
                                    torch.nn.Linear(16, 4))
        opt = thvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                        lr=0.1))
        model(torch.randn(4, 8)).square().sum().backward()
        opt.step()
        x = torch.arange(6.0)
        assert torch.equal(thvd.allreduce(x, thvd.Sum), x)
        assert torch.equal(thvd.allgather(x), x)
        assert issued == {"all_reduce": len(opt.buckets) + 1,
                          "reduce_scatter_tensor": 0,
                          "all_gather_into_tensor": 0, "new_group": 0}
        assert ops.hierarchical_allreduce_async_.launches == before
    finally:
        thvd.shutdown()


def test_declared_layout_must_cover_the_world(monkeypatch):
    monkeypatch.setenv("HOROVOD_LOCAL_SIZE", "3")
    with pytest.raises(ValueError, match="HOROVOD_LOCAL_SIZE=3"):
        thvd.init(device="cpu")
    assert not thvd.is_initialized()
    assert not dist.is_initialized()  # the rejection leaves no world behind
    monkeypatch.delenv("HOROVOD_LOCAL_SIZE")
    with pytest.raises(ValueError, match=r"mesh \(2, 1\)"):
        thvd.init(device="cpu", mesh=(2, 1))
    assert not dist.is_initialized()
    thvd.init(device="cpu", mesh=(1, 1))
    try:
        assert (thvd.local_size(), thvd.cross_size()) == (1, 1)
    finally:
        thvd.shutdown()


def test_mesh_builds_ep_and_later_axes_still_raise(monkeypatch):
    """``ep`` is built like dp and sp, in ``AXIS_ORDER``, and so now are
    fsdp, tp and pp, which no longer raise: each axis of size > 1 gets its
    rows, made on every rank in one order. ``create_hybrid_mesh`` lays the
    DCN factors across nodes, outermost. A world of one stands in for
    four: the size (and for the hybrid mesh the two-level layout) is
    patched and ``new_group`` records the rows each rank must make."""
    from horovod_tpu_torch.core import context_api
    from horovod_tpu_torch.parallel import create_hybrid_mesh, create_mesh
    thvd.init(device="cpu")
    made = []
    try:
        monkeypatch.setattr(context_api, "size", lambda: 4)
        monkeypatch.setattr(dist, "new_group",
                            lambda ranks: made.append(tuple(ranks)) or
                            tuple(ranks))
        mesh = create_mesh({"ep": 2, "dp": 2})
        assert mesh.axis_names == ("dp", "ep")
        assert mesh.axis("ep").ranks == (0, 1)
        assert mesh.axis("dp").ranks == (0, 2)
        assert mesh.axis("ep").group == (0, 1)
        assert made == [(0, 2), (1, 3), (0, 1), (2, 3)]
        for axis in ("fsdp", "tp", "pp"):
            made.clear()
            mesh = create_mesh({"dp": 2, axis: 2})
            inner = axis != "pp"  # pp is outermost, tp and fsdp inside dp
            assert mesh.axis(axis).ranks == ((0, 1) if inner else (0, 2))
            assert mesh.axis(axis).group == mesh.axis(axis).ranks
            assert len(made) == 4
        monkeypatch.setattr(context_api, "cross_size", lambda: 2)
        monkeypatch.setattr(context_api, "local_size", lambda: 2)
        made.clear()
        mesh = create_hybrid_mesh({"tp": 2}, {"dp": 2})
        assert mesh.axis_names == ("dp", "tp")
        assert mesh.axis("tp").ranks == (0, 1)  # within node 0
        assert mesh.axis("dp").ranks == (0, 2)
        with pytest.raises(ValueError, match="needs 2 nodes of 4 ranks"):
            create_hybrid_mesh({"tp": 4}, {"dp": 2})
    finally:
        monkeypatch.undo()
        thvd.shutdown()
