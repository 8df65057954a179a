"""Build and load the port's hand-written CUDA kernels.

Each kernel library is one ``svs_torch/csrc/<name>.cu`` with a plain C
interface (it may include the ``.cuh`` headers beside it), compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library at first use and
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds, not
minutes).  Libraries land in ``svs_torch/_build/`` (git-ignored) under a
name that hashes the source, every header in ``csrc/`` and the flags, so an
edited source or header rebuilds and concurrent builders never read a
half-written file.  :func:`load_all` starts one ``nvcc`` per library at
once, so a cold start costs the slowest build rather than their sum.

Nothing here runs at import time: the CPU tests import every module, and this
machine-independent code only shells out to ``nvcc`` when a kernel is first
launched on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and under CUDA_HOME or "
            "/usr/local/cuda): the CUDA kernels are built on the machine "
            "with the card")
    return path


def _lib_path(name: str) -> str:
    digest = hashlib.sha1(repr(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(SRC_DIR) if f.endswith(".cuh"))
    for file in [f"{name}.cu", *headers]:
        with open(os.path.join(SRC_DIR, file), "rb") as f:
            digest.update(file.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _compile(names: Sequence[str]) -> None:
    """Build every library of ``names`` that is not built yet, one ``nvcc``
    each, all started together."""
    jobs = []
    try:
        for name in names:
            out = _lib_path(name)
            if os.path.exists(out):
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                 os.path.join(SRC_DIR, f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            jobs.append((name, out, tmp, proc))
        for name, out, tmp, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu "
                                   f"(exit {proc.returncode}):\n{err}")
            os.replace(tmp, out)
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)


def load_all(names: Sequence[str]) -> List[ctypes.CDLL]:
    """The loaded libraries of kernels ``names``, building the missing ones
    on first use (in parallel).  Safe to call from several threads."""
    with _lock:
        _compile([n for n in names if n not in _libs])
        for name in names:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(_lib_path(name))
        return [_libs[name] for name in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it on first use."""
    return load_all([name])[0]
