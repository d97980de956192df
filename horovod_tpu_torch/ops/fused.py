"""The Adasum pairwise combine as two fused passes, on Hopper.

Counterpart of ``horovod_tpu/ops/fused.py``. Its two Pallas TPU kernels are
CUDA C++ kernels here (``csrc/fused.cu``), each behind a wrapper that checks
its inputs, allocates its outputs, launches on the current stream and counts
its launches:

- :func:`fused_norms_dot` (B4) replaces ``_norms_dot_kernel``: ``(a·b,
  ‖a‖², ‖b‖²)`` in one read of each operand. A deterministic two-stage
  reduction in f64, rounded once to f32; the kernel also leaves the
  coefficients ``(ca, cb)`` in device memory for B5.
- :func:`fused_combine` (B4, then B5) replaces ``fused_combine`` and its
  ``_combine_kernel``: ``ca·a + cb·b`` elementwise in f32, each product and
  the sum rounded once, so that butterfly partners computing ``combine(x,
  y)`` and ``combine(y, x)`` get bit-identical results.

Beside each kernel is its plain PyTorch version (:func:`_plain_norms_dot`,
:func:`_plain_combine`, and :func:`_plain_scale_add` for B5 alone). A wrapper
takes the plain version only for tensors on the CPU, which is how the CPU
tests run this module; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

#: Elements the plain f64 sums convert at a time (bounds their scratch).
_PLAIN_CHUNK = 1 << 26


def adasum_coefficients(dot, na, nb, eps: float = 0.0):
    """The Adasum pairwise coefficients ``(ca, cb)`` for ``ca·a + cb·b``,
    with zero-norm operands degrading to plain sum (a coefficient of 1).
    Shared by the plain combine (``collectives/adasum.py``) and the plain
    version of the fused kernels, as in the JAX package."""
    dot, na, nb = (torch.as_tensor(t) for t in (dot, na, nb))
    ca = torch.where(na > eps,
                     1.0 - dot / (2.0 * torch.where(na > eps, na, 1.0)), 1.0)
    cb = torch.where(nb > eps,
                     1.0 - dot / (2.0 * torch.where(nb > eps, nb, 1.0)), 1.0)
    return ca, cb


# ------------------------------------------------------------ plain versions

def _plain_norms_dot(a: torch.Tensor, b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of B4: ``(a·b, ‖a‖², ‖b‖²)`` summed in f64 (chunk by
    chunk, so the scratch stays small) and rounded once to f32."""
    a, b = a.reshape(-1), b.reshape(-1)
    if a.shape != b.shape:
        raise ValueError(f"operands differ in size: {a.numel()} and "
                         f"{b.numel()}")
    acc = torch.zeros(3, dtype=torch.float64, device=a.device)
    for i in range(0, a.numel(), _PLAIN_CHUNK):
        x = a[i:i + _PLAIN_CHUNK].double()
        y = b[i:i + _PLAIN_CHUNK].double()
        acc += torch.stack([x @ y, x @ x, y @ y])
    dot, na, nb = acc.float()
    return dot, na, nb


def _plain_scale_add(a: torch.Tensor, b: torch.Tensor, ca, cb
                     ) -> torch.Tensor:
    """Plain version of B5: ``ca·a + cb·b`` in f32, each product and the sum
    rounded once (separate eager ops, never fused), cast to ``a``'s dtype."""
    return (ca * a.float() + cb * b.float()).to(a.dtype)


def _plain_combine(a: torch.Tensor, b: torch.Tensor, eps: float = 0.0
                   ) -> torch.Tensor:
    """Plain version of :func:`fused_combine` (B4, then B5)."""
    ca, cb = adasum_coefficients(*_plain_norms_dot(a, b), eps)
    return _plain_scale_add(a, b, ca, cb)


# ------------------------------------------------------------ kernel wrappers

def _check(*tensors: torch.Tensor) -> None:
    """Validate what the CUDA kernels accept; raise on anything else."""
    first = tensors[0]
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the Adasum kernels take float32, not {t.dtype}")
        if not t.is_cuda or t.device != first.device:
            raise ValueError("Adasum kernel operands must share one CUDA "
                             "device")
        if not t.is_contiguous():
            raise ValueError("Adasum kernel operands must be contiguous")
        if t.numel() != first.numel():
            raise ValueError(f"operands differ in size: {first.numel()} and "
                             f"{t.numel()}")


def _max_blocks(device: torch.device, per_sm: int) -> int:
    return per_sm * torch.cuda.get_device_properties(device) \
        .multi_processor_count


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        from . import _build
        msg = _build.library().hvd_error_string(rc).decode()
        raise RuntimeError(f"{what} CUDA kernel failed to launch: {msg} "
                           f"(cudaError {rc})")


def _norms_dot_kernel(a: torch.Tensor, b: torch.Tensor, eps: float = 0.0
                      ) -> torch.Tensor:
    """Launch B4 on CUDA tensors; returns the device buffer ``[a·b, ‖a‖²,
    ‖b‖², ca, cb]`` (f32). Counted on :func:`fused_norms_dot`."""
    _check(a, b)
    from . import _build
    blocks = _max_blocks(a.device, 4)
    partials = torch.empty(3 * blocks, dtype=torch.float64, device=a.device)
    stats = torch.empty(5, dtype=torch.float32, device=a.device)
    rc = _build.library().hvd_adasum_norms_dot(
        a.data_ptr(), b.data_ptr(), a.numel(), float(eps),
        partials.data_ptr(), blocks, stats.data_ptr(),
        torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(rc, "adasum norms_dot")
    fused_norms_dot.launches += 1
    return stats


def _combine_kernel(a: torch.Tensor, b: torch.Tensor, stats: torch.Tensor,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch B5 on CUDA tensors with the coefficients ``stats[3:5]`` that
    B4 left on the device; ``out`` may be ``a``. Counted on
    :func:`fused_combine`."""
    if out is None:
        out = torch.empty_like(a)
    _check(a, b, out)
    if stats.dtype != torch.float32 or stats.numel() != 5 \
            or stats.device != a.device:
        raise ValueError("stats must be the float32[5] buffer of B4 on the "
                         "operands' device")
    from . import _build
    rc = _build.library().hvd_adasum_combine(
        a.data_ptr(), b.data_ptr(), stats.data_ptr(), out.data_ptr(),
        a.numel(), _max_blocks(a.device, 8),
        torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(rc, "adasum combine")
    fused_combine.launches += 1
    return out


def fused_norms_dot(a: torch.Tensor, b: torch.Tensor):
    """B4: one-pass ``(a·b, ‖a‖², ‖b‖²)`` of two same-size f32 tensors, as
    0-d f32 tensors.

    Replaces ``horovod_tpu/ops/fused.py::_norms_dot_kernel``. Bound on the
    H100 by reading both operands once (2 · 4 · n bytes, 3.55 ms at the
    2-layer Llama-3-8B-width gradient); a grid-stride ``float4`` pass whose
    per-block f64 sums a second one-block pass adds in a fixed order."""
    if a.device.type == "cpu":
        return _plain_norms_dot(a, b)
    stats = _norms_dot_kernel(a.reshape(-1), b.reshape(-1))
    return stats[0], stats[1], stats[2]


fused_norms_dot.launches = 0


def fused_combine(a: torch.Tensor, b: torch.Tensor, eps: float = 0.0, *,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The Adasum pairwise operator ``ca·a + cb·b`` with ``ca = 1 -
    a·b/(2‖a‖²)`` and ``cb = 1 - a·b/(2‖b‖²)`` (zero-norm operands degrade
    to plain sum): B4, then B5, with no host round trip between them.

    Replaces ``horovod_tpu/ops/fused.py::fused_combine`` and its
    ``_combine_kernel``. B5 is bound on the H100 by moving 3 · 4 · n bytes
    (5.33 ms at the 2-layer Llama-3-8B-width gradient). ``out`` (default: a
    new tensor) may be ``a`` itself, for an in-place update of a working
    vector."""
    if a.device.type == "cpu":
        res = _plain_combine(a, b, eps)
        return res if out is None else out.copy_(res)
    a, b = a.contiguous(), b.contiguous()
    stats = _norms_dot_kernel(a.reshape(-1), b.reshape(-1), eps)
    flat_out = None if out is None else out.view(-1)
    res = _combine_kernel(a.view(-1), b.view(-1), stats, flat_out)
    return res.view(a.shape) if out is None else out


fused_combine.launches = 0

#: The kernel wrappers by name, for launch accounting: B4 counts on
#: ``fused_norms_dot``, B5 on ``fused_combine``.
KERNELS = {"norms_dot": fused_norms_dot, "combine": fused_combine}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
