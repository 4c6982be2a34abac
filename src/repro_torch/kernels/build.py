"""Build and load the port's CUDA kernels: ``nvcc`` → shared library → ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use into ``build/lib<name>-<digest>.so`` beside this package (the digest
covers the source, the shared ``csrc/*.cuh`` headers and the flags, so an
edited source or header rebuilds).  ``build``
starts one ``nvcc`` per source, all at once, and waits for them; the
``-Xptxas -v`` report (registers, shared memory, spills) is kept in a
``.log`` next to each library.  Nothing is built when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "SOURCES", "build", "load"]

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
SOURCES = ("superstep_csr", "tile_kernels", "d2_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels are "
            "built with the CUDA toolkit at first use")
    return path


def _library(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library in ``names`` that is missing, in parallel.

    Returns each library's ``-Xptxas -v`` report.  Raises if a compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        lib = _library(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        jobs[name] = (lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (lib, tmp, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{name}:\n{out}")
            continue
        lib.with_suffix(".log").write_text(out)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: _library(name).with_suffix(".log").read_text()
            for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed.

    Every library has ``repro_cuda_error_string`` (``csrc/common.cuh``);
    its signature is declared here, the kernels' by their wrappers.
    """
    if name not in _LIBS:
        path = _library(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]
