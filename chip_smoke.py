#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``horovod_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits nonzero:

1. device  — requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them.
2. build   — builds ``horovod_tpu_torch/ops/csrc/*.cu`` with nvcc for sm_90a
   into ``horovod_tpu_torch/_build/``.
3. kernels — each flash-attention kernel (B1 forward, B2 dQ, B3 dK/dV)
   against its plain PyTorch version on the same inputs: at the training
   shape (B=2, T=2048, H=32, D=128, causal) in bf16 and again in f32, and at
   a small f32 non-causal case with a key-padding bias and a ragged T=1000
   (D=64). Times each kernel at the bf16 training shape beside its bound,
   its plain version and ``F.scaled_dot_product_attention`` (the yardstick;
   the port never calls it).
4. model   — a small f32 Llama (head dim 64) on the card: logits and
   gradients with flash on (the kernels) agree with flash off.
5. train   — the main path: ``init()`` (an NCCL world of one), the
   Llama-3-8B-width model cut to 2 layers, ``create_train_state`` (parameter
   broadcast), ``DistributedOptimizer(AdamW)`` for 4 steps at batch 2 x 2048
   tokens, the last under ``torch.profiler``. Requires finite, falling
   losses, each kernel launched at least twice (once per layer) per step,
   and one all-reduce launched per fusion bucket per step (counted where
   ``allreduce_async_`` hands it to ``torch.distributed``). Prints the step
   time and tokens/s, and the profiled step's device time by kernel group.

Then one ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` line again, and
last ``{"ok": true, "device": {...}}``.

Tolerances are per element: ``|kernel - plain| <= r * (|plain| + RMS)``,
with RMS that of the compared plain tensor. Both sides sum in f32, in
different orders, and round once to the output type.

- bf16 outputs, r = 2^-7: two roundings of nearly equal f32 values land at
  most one bf16 ulp apart, and one ulp is at most 2^-7 of the element's
  magnitude. The RMS term covers elements near zero, where the f32
  summation-order difference (about 1e-6 of the summed magnitudes) can
  exceed the rounding step.
- f32 outputs and the f32 statistics m and l, r = 5e-5: f32 summation-order
  differences over at most 2048 terms are near 1e-6 of the summed
  magnitudes; 5e-5 leaves a margin of more than ten.
"""

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time

H100_BF16_FLOPS = 989e12   # dense bf16 tensor-core peak, SXM, 700 W
H100_F32_FLOPS = 67e12     # f32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12
SOURCE = "horovod_tpu_torch/ops/csrc/flash_attention.cu"
REPLACES = {"fa_fwd": "horovod_tpu/ops/flash_attention.py:57",
            "fa_bwd_dq": "horovod_tpu/ops/flash_attention.py:323",
            "fa_bwd_dkv": "horovod_tpu/ops/flash_attention.py:357"}
#: Products each kernel does per visible (q, k) pair and head dim, 2 FLOP each.
PRODUCTS = {"fa_fwd": 2, "fa_bwd_dq": 3, "fa_bwd_dkv": 4}


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters=5):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(name, B, H, Tq, Tk, D, causal, itemsize):
    """Least time (ms) the card needs for the kernel's work on these shapes:
    the larger of its operations over the peak rate of the input type and
    its bytes (each input read once, each output written once) over the
    memory rate."""
    pairs = (sum(min(Tk, t + 1) for t in range(Tq)) if causal
             else Tq * Tk)
    flops = 2 * PRODUCTS[name] * pairs * D * B * H
    rows = B * H * D * itemsize
    stats = B * H * Tq * 4
    if name == "fa_fwd":
        nbytes = (2 * Tq + 2 * Tk) * rows + 2 * stats
    elif name == "fa_bwd_dq":
        nbytes = (3 * Tq + 2 * Tk) * rows + 3 * stats
    else:
        nbytes = (2 * Tq + 4 * Tk) * rows + 3 * stats
    peak = H100_BF16_FLOPS if itemsize == 2 else H100_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check(what, a, ref, dtype):
    """Hold ``a`` to ``ref`` element by element at the tolerance stated in
    the module doc; return ``(max |a - ref|, largest error / tolerance)``."""
    ref = ref.float()
    rms = ref.square().mean().sqrt().item()
    if not rms > 0.0:
        raise AssertionError(f"{what}: the plain version is all zero")
    r = 2 ** -7 if dtype == "bf16" else 5e-5
    err = (a.float() - ref).abs()
    ratio = err / (r * (ref.abs() + rms))
    worst = int(ratio.argmax())
    if not ratio.max().item() <= 1.0:
        raise AssertionError(
            f"{what}: |kernel - plain| = {err.view(-1)[worst].item():.3e} at "
            f"plain = {ref.view(-1)[worst].item():.3e} exceeds "
            f"{r:.3g} * (|plain| + RMS {rms:.3e})")
    return err.max().item(), ratio.max().item()


def kernel_case(fa, torch, *, B, Tq, Tk, H, D, dtype, causal, lengths,
                seed):
    """Run B1, B2 and B3 and their plain versions on one case; return the
    worst error of each kernel and the inputs for timing."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda T: torch.randn((B, T, H, D), generator=gen, device="cuda",
                               dtype=dtype)
    q, k, v, do = mk(Tq), mk(Tk), mk(Tk), mk(Tq)
    bias = None
    if lengths is not None:
        keep = (torch.arange(Tk, device="cuda")[None, :]
                < torch.tensor(lengths, device="cuda")[:, None])
        bias = torch.where(keep, 0.0, fa.NEG_INF).float().contiguous()
    kw = dict(causal=causal, scale=D ** -0.5)
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    o, m, l = fa.fa_fwd(q, k, v, bias, **kw)
    ro, rm, rl = fa._reference_partial(q, k, v, bias, **kw)
    # Per kernel, the (max error, error / tolerance) of its output with the
    # largest error relative to its tolerance.
    worst = lambda *pairs: max(pairs, key=lambda p: p[1])
    errs = {"fa_fwd": worst(check("B1 o", o, ro, tag),
                            check("B1 m", m, rm, "f32"),
                            check("B1 l", l, rl, "f32"))}
    dsum = fa._row_dsum(do, o)
    args = (q, k, v, do, m, l, dsum, bias)
    dq = fa.fa_bwd_dq(*args, **kw)
    errs["fa_bwd_dq"] = check("B2 dq", dq, fa._plain_bwd_dq(*args, **kw), tag)
    dk, dv = fa.fa_bwd_dkv(*args, **kw)
    rdk, rdv = fa._plain_bwd_dkv(*args, **kw)
    errs["fa_bwd_dkv"] = worst(check("B3 dk", dk, rdk, tag),
                               check("B3 dv", dv, rdv, tag))
    torch.cuda.synchronize()
    return errs, args, kw


def time_kernels(fa, torch, args, kw):
    """ms of each kernel, its plain version, and the nearest PyTorch call
    (SDPA forward for B1; SDPA backward, which yields dQ, dK and dV
    together, for B2 and B3)."""
    import torch.nn.functional as F
    q, k, v, do, m, l, dsum, bias = args
    ms = {
        "fa_fwd": (time_ms(lambda: fa.fa_fwd(q, k, v, bias, **kw)),
                   time_ms(lambda: fa._reference_partial(q, k, v, bias,
                                                         **kw), 2)),
        "fa_bwd_dq": (time_ms(lambda: fa.fa_bwd_dq(*args, **kw)),
                      time_ms(lambda: fa._plain_bwd_dq(*args, **kw), 2)),
        "fa_bwd_dkv": (time_ms(lambda: fa.fa_bwd_dkv(*args, **kw)),
                       time_ms(lambda: fa._plain_bwd_dkv(*args, **kw), 2)),
    }
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=kw["causal"], scale=kw["scale"])
    with torch.no_grad():
        lib_fwd = time_ms(sdpa)
    out = sdpa()
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))
    library = {"fa_fwd": lib_fwd, "fa_bwd_dq": lib_bwd,
               "fa_bwd_dkv": lib_bwd}
    return ms, library


def small_model_check(torch, hvd_llama):
    """Flash on (the f32, D=64 kernels) against flash off on a small Llama:
    logits and every parameter's gradient, element by element, within
    ``1e-4 * (|plain| + RMS)``. Whole models: the kernels' f32 differences
    pass through every later layer and its gradient, so the bound is twice
    the kernels' own. Returns the largest error / tolerance."""
    def close(what, a, ref):
        err = (a - ref).abs()
        tol = 1e-4 * (ref.abs() + ref.square().mean().sqrt())
        ratio = (err / tol.clamp_min(1e-30)).max().item()
        if not bool((err <= tol).all()):
            raise AssertionError(f"{what}: |flash - plain| reaches "
                                 f"{ratio:.3f} of its bound")
        return ratio

    from horovod_tpu_torch.train import next_token_loss
    base = hvd_llama.LlamaConfig(vocab_size=512, dim=256, n_layers=2,
                                 n_heads=4, n_kv_heads=2, hidden_dim=512,
                                 max_seq_len=256, dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, 512, (2, 200), generator=gen, device="cuda")
    out = {}
    for flash in (False, True):
        model = hvd_llama.Llama(dataclasses.replace(base, use_flash=flash),
                                device="cuda", seed=1)
        logits = model(tokens)
        next_token_loss(logits, tokens).backward()
        out[flash] = (logits.detach(),
                      {n: p.grad for n, p in model.named_parameters()})
    err = close("small-model logits", out[True][0], out[False][0])
    for name, g in out[False][1].items():
        err = max(err, close(f"small-model grad {name}", out[True][1][name],
                             g))
    return err


def expected_buckets(model, threshold):
    """Bucket count for the model's f32 parameters, packed in reverse order
    up to ``threshold`` bytes (0: one per tensor), computed here apart from
    the port's planner."""
    sizes = [p.numel() * 4 for p in model.parameters()]
    if threshold == 0:
        return len(sizes)
    count, fill = 0, None
    for nbytes in reversed(sizes):
        if fill is not None and fill + nbytes <= threshold:
            fill += nbytes
        else:
            count, fill = count + 1, nbytes
    return count


#: Kernel-name fragments of each group in the profiled step's device time.
GROUPS = (("B1 fa_fwd", ("fa_fwd_kernel",)),
          ("B2 fa_bwd_dq", ("fa_bwd_dq_kernel",)),
          ("B3 fa_bwd_dkv", ("fa_bwd_dkv_kernel",)),
          ("matmul", ("nvjet", "gemm", "xmma", "cutlass", "sm90_")),
          ("foreach (AdamW)", ("multi_tensor_apply",)),
          ("nccl", ("nccl",)))


def device_breakdown(prof, wall_s):
    """The profiled step's device time: each kernel group's ms and share of
    the summed kernel time, the rest with its largest kernels, and the
    device's idle share of the step's host-clock wall time (1 - union of
    kernel intervals / wall)."""
    from torch.autograd import DeviceType
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        return "the profiler saw no device time: not measured"
    ms = dict.fromkeys([g for g, _ in GROUPS] + ["other"], 0.0)
    other, spans = {}, []
    for e in kernels:
        t = e.time_range.elapsed_us() / 1e3
        group = next((g for g, frags in GROUPS
                      if any(f in e.name.lower() for f in frags)), "other")
        ms[group] += t
        if group == "other":
            other[e.name[:100]] = other.get(e.name[:100], 0.0) + t
        spans.append((e.time_range.start, e.time_range.end))
    busy_us, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    total = sum(ms.values())
    parts = "; ".join(f"{g} {t:.1f} ms ({t / total:.1%})"
                      for g, t in ms.items())
    top = "\n".join(f"    other: {t:.2f} ms  {name}" for name, t in
                    sorted(other.items(), key=lambda x: -x[1])[:8])
    return (f"kernels {total:.1f} ms summed over {len(kernels)} launches: "
            f"{parts}; device busy {busy_us / 1e3:.1f} ms, idle "
            f"{1 - busy_us / 1e3 / (wall_s * 1e3):.1%} of the step\n{top}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.collectives.ops import allreduce_async_
    from horovod_tpu_torch.core.config import Config
    from horovod_tpu_torch.models import llama as hvd_llama
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.train import (create_train_state, make_train_step,
                                         next_token_loss)

    # Plain references in full f32 (no TF32), hopper-kernels guide §6.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi_line()
    kind = torch.cuda.get_device_name(0)
    log("device", f"{card} | torch {torch.__version__} cuda "
                  f"{torch.version.cuda} | count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.build()
    log("build", f"{time.perf_counter() - t0:.1f} s "
                 f"(nvcc {_build.build_seconds:.1f} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  " + line.strip())

    big = dict(B=2, Tq=2048, Tk=2048, H=32, D=128, causal=True,
               lengths=None, seed=0)
    errs, args, kw = kernel_case(fa, torch, dtype=torch.bfloat16, **big)
    f32_errs, _, _ = kernel_case(fa, torch, dtype=torch.float32, **big)
    torch.cuda.empty_cache()
    small_errs, _, _ = kernel_case(
        fa, torch, B=2, Tq=1000, Tk=1000, H=4, D=64, dtype=torch.float32,
        causal=False, lengths=[1000, 613], seed=1)
    fmt = lambda e: {n: f"max err {err:.2e}, err/tol {ratio:.3f}"
                     for n, (err, ratio) in e.items()}
    log("kernels", f"agree with plain: training shape bf16 {fmt(errs)}; "
                   f"training shape f32 {fmt(f32_errs)}; small "
                   f"f32/bias/ragged {fmt(small_errs)}")
    ms, library = time_kernels(fa, torch, args, kw)
    bounds = {name: bound(name, 2, 32, 2048, 2048, 128, True, 2)
              for name in fa.KERNELS}
    for name in fa.KERNELS:
        log("kernels", f"{name}: {ms[name][0]:.3f} ms (bound "
                       f"{bounds[name][0]:.4f} ms by {bounds[name][1]}; "
                       f"plain {ms[name][1]:.3f} ms; library "
                       f"{library[name]:.3f} ms) on {card}")
    del args
    torch.cuda.empty_cache()

    log("model", f"small f32 Llama, flash on vs off: worst err/tol "
                 f"{small_model_check(torch, hvd_llama):.3f}")

    hvd.init()
    cfg = dataclasses.replace(hvd_llama.llama3_8b(), n_layers=2,
                              use_flash=True)
    model = hvd_llama.Llama(cfg, seed=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters())
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, next_token_loss)
    batch, seq = 2, 2048
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device="cuda")
    torch.cuda.reset_peak_memory_stats()
    n_steps = 4  # the last one under the profiler
    fa.reset_launch_counts()
    allreduce_async_.launches = 0
    losses, times = [], []
    for i in range(n_steps):
        torch.cuda.synchronize()
        with (torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
              if i == n_steps - 1 else contextlib.nullcontext()) as prof:
            t = time.perf_counter()
            state, loss = step(state, tokens, tokens)
            losses.append(loss.item())
            times.append(time.perf_counter() - t)
    launches = {name: fn.launches for name, fn in fa.KERNELS.items()}
    allreduces = allreduce_async_.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    for name, n in launches.items():
        if n < cfg.n_layers * n_steps:
            raise AssertionError(f"{name} launched {n} times in {n_steps} "
                                 f"steps of a {cfg.n_layers}-layer model")
    threshold = Config.from_env().fusion_threshold_bytes
    want = expected_buckets(model, threshold)
    # A world of one: the gradient buckets are the steps' only all-reduces
    # (the loss is averaged only across more than one rank).
    if allreduces != want * n_steps:
        raise AssertionError(
            f"{allreduces} all-reduces launched in {n_steps} steps, expected "
            f"{want} a step for HOROVOD_FUSION_THRESHOLD={threshold}")
    timed = times[1:-1]
    step_s = sorted(timed)[len(timed) // 2]
    log("train", f"llama3_8b width, 2 layers, {hvd.size()} rank(s) over "
                 f"NCCL: losses {losses}; step {step_s * 1e3:.1f} ms "
                 f"(first {times[0] * 1e3:.1f} ms); "
                 f"{batch * seq / step_s:.0f} tokens/s/GPU; "
                 f"{want} buckets at threshold {threshold}, {allreduces} "
                 f"all-reduces launched; kernel launches {launches}; "
                 f"peak {peak_gb:.1f} GB; on {card}")
    log("profile", f"step {n_steps} under torch.profiler, "
                   f"{times[-1] * 1e3:.1f} ms on the host clock: "
                   f"{device_breakdown(prof, times[-1])}")
    hvd.shutdown()

    kernels = [{
        "name": name, "route": "cuda", "source": SOURCE,
        "replaces": REPLACES[name], "launches": launches[name],
        "max_abs_err": errs[name][0], "err_over_tol": errs[name][1],
        "ms": ms[name][0],
        "plain_ms": ms[name][1], "bound_ms": bounds[name][0],
        "bound_by": bounds[name][1], "library_ms": library[name],
    } for name in fa.KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
