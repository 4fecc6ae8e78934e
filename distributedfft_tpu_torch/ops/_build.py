"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, and loaded with
``ctypes``. No PyTorch header is included, so a build takes seconds.

* A library is built at first use, under ``build/kernels/`` at the root of
  the checkout, named by a hash of its source, the shared headers
  (``csrc/*.cuh``) and the flags: a changed source builds anew, an
  unchanged one is reused.
* ``build()`` starts one ``nvcc`` per missing library, all at once.
* A missing ``nvcc`` or a failed build raises ``KernelError``. There is
  no fallback.
* Every C entry point returns ``cudaGetLastError()`` after its launch;
  ``check`` raises ``KernelError`` when that is not ``cudaSuccess``.

``KernelError`` is what the fallback ladder (``resilience/fallback.py``)
never steps around: a kernel that does not build or launch is a fault to
report, and a failed launch may leave the CUDA context unusable for any
other rendering.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Mapping, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A hand-written kernel could not be built or its launch failed."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise KernelError("nvcc not found (not on PATH, no CUDA_HOME): the "
                       "port's CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: named by a hash of the source,
    every shared header (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Build every named library that is not built yet, one ``nvcc`` per
    source, all running at once. Returns the wall seconds per library
    built (0.0 for one already there). Raises on any failure."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        secs = {n: 0.0 for n in names}
        todo = [n for n in names if not library_path(n).exists()]
        if not todo:
            return secs
        nvcc = _nvcc()
        procs = {}
        t0 = time.perf_counter()
        for n in todo:
            out = library_path(n)
            tmp = out.with_suffix(f".tmp{os.getpid()}")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, out)
        failed = []
        for n, (p, tmp, out) in procs.items():
            log, _ = p.communicate()
            secs[n] = time.perf_counter() - t0
            if p.returncode != 0:
                failed.append(f"{n}.cu (nvcc exit {p.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if failed:
            raise KernelError("CUDA kernel build failed: " + "\n".join(failed))
        return secs


def load(name: str, signatures: Mapping[str, Tuple[int, ...]]) -> ctypes.CDLL:
    """The loaded library ``csrc/<name>.cu``, built if needed.
    ``signatures`` maps each entry point to (pointer count, int count[,
    long long count]): its arguments are that many pointers, then that many
    ints, then that many 64-bit ints, then the stream, and it returns an
    int CUDA error code."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (n_ptr, n_int, *n_ll) in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                          + [ctypes.c_longlong] * sum(n_ll)
                          + [ctypes.c_void_p])
            f.restype = ctypes.c_int
        lib.dfft_error_string.argtypes = [ctypes.c_int]
        lib.dfft_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, fn: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = lib.dfft_error_string(rc).decode()
        raise KernelError(f"{fn}: CUDA error {rc} ({msg})")
