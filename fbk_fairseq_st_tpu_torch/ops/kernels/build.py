"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library under the package's
``_build/`` directory (listed in ``.gitignore``) at first use, and loaded
with ``ctypes``. The library's file name carries a hash of the source and
the flags, so an edited source is rebuilt and a stale one never loaded.

Nothing here runs at import time: this module imports on a host without
``nvcc`` or CUDA, and only ``build``/``load`` need them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in the .log
)
SMEM_LIMIT = 232448  # bytes of shared memory an H100 block can opt into

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a host with the CUDA toolkit")


def library_path(name: str) -> Path:
    """The library's path: named by a hash of the source, the shared
    headers it may include (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.
    Returns the library's path; the compiler's output is kept beside it
    as ``.log``."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _LOADED[name] = lib
        return lib


def bind(name: str, signatures: Dict[str, List]) -> ctypes.CDLL:
    """``load(name)`` with the ctypes ``argtypes`` of each function in
    ``signatures`` set, each returning its ``cudaError_t`` as an int, and
    ``lib.error_string`` bound to the source's ``<name>_error_string``."""
    lib = load(name)
    if not hasattr(lib, "error_string"):
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.error_string = getattr(lib, f"{name}_error_string")
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
    return lib


def raise_on(lib: ctypes.CDLL, fn: str, err: int) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize does not report it)."""
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{fn} launch failed: {msg} (cudaError {err})")
