"""Build and load the package's CUDA kernels.

Every ``srhmm_tpu_torch/csrc/*.cu`` source is compiled by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes``.  The library goes into ``build/srhmm_tpu_torch/<hash>/`` under
the repository root, keyed by a hash of the sources and flags, and is built
at first use.  There is no fallback: without ``nvcc`` the build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "srhmm_tpu_torch"
CUDA_ROOT = Path("/usr/local/cuda")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
LIB_NAME = "libsrhmm_tpu_torch.so"


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_ROOT; RuntimeError if absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = CUDA_ROOT / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in "
        f"{CUDA_ROOT / 'bin'}): the CUDA kernels of srhmm_tpu_torch are built "
        "with nvcc at first use"
    )


def _sources() -> list[Path]:
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources in {CSRC_DIR}")
    return srcs


def _source_hash(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(srcs + sorted(CSRC_DIR.glob("*.cuh"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> tuple[Path, float]:
    """Compile the kernels if no library for the current sources exists.
    Returns (library path, seconds spent compiling; 0.0 when cached)."""
    srcs = _sources()
    out_dir = BUILD_ROOT / _source_hash(srcs)
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib, 0.0
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never sees
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, srcs)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, lib)
    return lib, seconds


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library once per process."""
    lib_path, _ = build_library()
    lib = ctypes.CDLL(str(lib_path))
    lib.srhmm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.srhmm_cuda_error_string.restype = ctypes.c_char_p
    return lib
