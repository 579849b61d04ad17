"""Build and load the package's CUDA kernels.

Every ``srhmm_tpu_torch/csrc/*.cu`` source is compiled by its own ``nvcc``
process for ``sm_90a`` (all started together), and the objects are linked
into one shared library with a plain C interface, loaded with ``ctypes``.
The library goes into ``build/srhmm_tpu_torch/<hash>/`` under the repository
root, keyed by a hash of the sources and flags, and is built at first use.
There is no fallback: without ``nvcc`` the build raises.
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
    """Compile the kernels if no library for the current sources exists:
    one nvcc per source, in parallel, then one link.  Returns (library
    path, seconds spent compiling and linking; 0.0 when cached)."""
    srcs = _sources()
    out_dir = BUILD_ROOT / _source_hash(srcs)
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib, 0.0
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    # objects and the library go to private names first, then the library is
    # renamed: a concurrent build never sees a half-written library
    work = Path(tempfile.mkdtemp(dir=out_dir))
    t0 = time.perf_counter()
    try:
        jobs = []
        for src in srcs:
            obj = work / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.PIPE, text=True)))
        failed = []
        for (obj, proc), src in zip(jobs, srcs):
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{out}\n{err}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        tmp = work / LIB_NAME
        res = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *(str(obj) for obj, _ in jobs)],
            capture_output=True, text=True,
        )
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib, time.perf_counter() - t0


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library once per process."""
    lib_path, _ = build_library()
    lib = ctypes.CDLL(str(lib_path))
    lib.srhmm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.srhmm_cuda_error_string.restype = ctypes.c_char_p
    return lib
