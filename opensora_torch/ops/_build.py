"""Build and load the port's hand-written CUDA kernels.

Kernel source ``name`` is ``csrc/<name>.cu`` (it may hold several kernels
and include the shared ``csrc/*.cuh``), compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface and loaded
with ``ctypes``. Libraries go to ``opensora_torch/_build/`` (git-ignored),
named by the hash of their source and headers, so a changed source is
rebuilt and an unchanged one is reused. Building happens at first use,
never at import: the CPU test environment has no ``nvcc``.

Every kernel wrapper adds one to ``LAUNCHES[kernel name]`` where it
launches its kernel, so a run can show which kernels its path went
through.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

LAUNCHES: collections.Counter = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return path


def _source(name: str) -> str:
    return os.path.join(_PKG, "csrc", f"{name}.cu")


def library_path(name: str) -> str:
    """The library of kernel ``name``, named by the hash of its source, the
    shared headers (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cuh")))
    for path in [_source(name), *headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(name: str) -> Tuple[float, str]:
    """Compile kernel ``name`` unless the library of its current source
    exists. Returns (seconds, nvcc's ptxas register / shared-memory
    report), or (0.0, "") when the library was reused."""
    out = library_path(name)
    if os.path.exists(out):
        return 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, _source(name)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return time.perf_counter() - t0, proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build(name)
        lib = _libs[name] = ctypes.CDLL(library_path(name))
    return lib
