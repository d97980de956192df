"""Build the hand-written CUDA kernels and load them with ``ctypes``.

``ops/csrc/*.cu`` is compiled with one ``nvcc`` call for ``sm_90a`` straight
into a shared library with a plain C interface under
``horovod_tpu_torch/_build/``, and loaded with ``ctypes``. The library's name
carries a digest of the sources and flags, so an edited source rebuilds and
an unchanged one is reused. A file lock serialises builds between processes
of one host (every rank of a data-parallel job calls :func:`library` at its
first kernel launch).

Nothing here runs at import time: the CPU tests import every module, and a
machine without the CUDA toolkit has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler=-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_int64
#: C signature, ``(restype, argtypes)``, of each entry point in
#: ``csrc/flash_attention.cu`` and ``csrc/fused.cu``.
_SIGNATURES = {
    # dtype, D, q, k, v, bias, o, m, l, B, H, Tq, Tk, scale, causal, stream
    "hvd_fa_fwd": (_I, [_I, _I, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _F, _I, _P]),
    # dtype, D, q, k, v, do, m, l, dsum, bias, dq, B, H, Tq, Tk, scale,
    # causal, stream
    "hvd_fa_bwd_dq": (_I, [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _F, _I, _P]),
    # dtype, D, q, k, v, do, m, l, dsum, bias, dk, dv, B, H, Tq, Tk, scale,
    # causal, stream
    "hvd_fa_bwd_dkv": (_I, [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P, _I, _I, _I, _I, _F, _I, _P]),
    "hvd_error_string": (ctypes.c_char_p, [_I]),
    # a, b, n, eps, partials, max_blocks, stats, stream
    "hvd_adasum_norms_dot": (_I, [_P, _P, _L, _F, _P, _I, _P, _P]),
    # a, b, stats, out, n, max_blocks, stream
    "hvd_adasum_combine": (_I, [_P, _P, _P, _P, _L, _I, _P]),
}

_lib = None
_lib_lock = threading.Lock()
#: What the last build printed (``-Xptxas=-v``: registers, shared memory and
#: spills of every kernel), or "" when the library was already built.
build_log = ""
#: Seconds the last build took in this process (0.0 when it was cached).
build_seconds = 0.0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        path = Path(CUDA_HOME) / "bin" / "nvcc"
        if path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless this digest is already built; return the
    shared library's path."""
    global build_log, build_seconds
    out = BUILD_DIR / f"libhvd_kernels_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while we waited
            return out
        t0 = time.perf_counter()
        tmp = out.with_suffix(".tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *map(str, _sources())]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"kernel build failed ({' '.join(cmd)}):\n"
                               f"{proc.stdout}")
        os.replace(tmp, out)
        build_log = proc.stdout
        build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib
