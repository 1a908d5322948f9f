"""Build the package's CUDA kernels with ``nvcc`` at first use; load with ctypes.

No counterpart in ``fiude_tpu`` (Pallas kernels compile inside ``jax.jit``).

Every ``fiude_tpu_torch/csrc/*.cu`` goes into one shared library with a plain
``extern "C"`` interface (no PyTorch headers, so a build takes seconds).  The
sources compile in parallel, one nvcc each, then link::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -Xptxas -v -c -o <name>.o csrc/<name>.cu          # all at once
    nvcc -shared -o libfiude_kernels-<hash>.so *.o

The library is named by a hash of the sources and the flags, built into
``fiude_tpu_torch/_build/`` and published by writing a temporary file and
renaming it into place, so processes that build at the same time never load
a half-written library.  A failed build raises with nvcc's stderr; ptxas's
register and shared-memory report is kept beside the library as ``.log``.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared",)


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfiude_kernels-{h.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; "
                       "the CUDA kernels are built on a machine with the CUDA toolkit")


def _run_all(commands) -> str:
    """Run the commands at once; raise with the stderr of any that failed,
    else return all their stderr."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                              text=True) for cmd in commands]
    errs = [proc.communicate()[1] for proc in procs]
    for proc, err in zip(procs, errs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{err}")
    return "".join(errs)


def build() -> Path:
    """Compile the library unless a build of these sources exists."""
    so = library_path()
    if so.exists():
        return so
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(dir=BUILD_DIR, suffix=".tmp")
    try:
        objs = [os.path.join(work, src.stem + ".o") for src in sources()]
        log = _run_all([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                       for obj, src in zip(objs, sources()))
        log += _run_all([[nvcc, *LINK_FLAGS, "-o", os.path.join(work, "lib.so"), *objs]])
        Path(work, "lib.log").write_text(log)
        os.replace(os.path.join(work, "lib.log"), str(so) + ".log")
        os.replace(os.path.join(work, "lib.so"), so)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return so


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    lib.fiude_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fiude_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise for a nonzero ``cudaError_t`` returned by a launcher."""
    if code != 0:
        msg = library().fiude_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def check_weights(tensors, device, dtype: torch.dtype = torch.float32) -> None:
    for t in tensors:
        if t.device != device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"kernel weights must be contiguous {dtype} tensors on "
                             f"{device}; got {t.dtype} on {t.device}")


def ptr(tensor):
    """A tensor's device address, or a null pointer for an absent (None) one."""
    return None if tensor is None else tensor.data_ptr()


def c_ptrs(tensors):
    """A C array of the tensors' device pointers."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def c_ints(values):
    return (ctypes.c_int * len(values))(*values)
