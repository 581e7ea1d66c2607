"""Build the CUDA sources in ``lqg_tpu_torch/csrc`` and load them with ctypes.

Each source is compiled on first use by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  Libraries are named by a hash of their source and flags,
so an edited source is rebuilt, and land in ``lqg_tpu_torch/_build``.  The
``-Xptxas -v`` report (registers, spills) is kept beside each library.
A build that fails raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Dict, Iterable, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the lqg_tpu_torch kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _target(name: str) -> Tuple[str, str]:
    """Source path and library path; the name hashes the source, the
    shared headers and the flags."""
    src = os.path.join(CSRC, f"{name}.cu")
    digest = hashlib.sha1(" ".join(FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that is not built yet, all ``nvcc``
    processes at once; returns each library's ``-Xptxas -v`` report."""
    names = list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        src, lib = _target(name)
        if not os.path.exists(lib):
            tmp = f"{lib}.{os.getpid()}.tmp"
            procs[name] = (subprocess.Popen(
                [_nvcc(), *FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), tmp, lib)
    # wait for every compiler before reporting any failure
    logs = {name: proc.communicate()[0]
            for name, (proc, _, _) in procs.items()}
    for name, (proc, tmp, lib) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{logs[name]}")
        with open(lib + ".log", "w") as f:
            f.write(logs[name])
        os.replace(tmp, lib)  # atomic: a concurrent build sees whole files
    reports = {}
    for name in names:
        with open(_target(name)[1] + ".log") as f:
            reports[name] = f.read()
    return reports


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    if name not in _loaded:
        build_all([name])
        _loaded[name] = ctypes.CDLL(_target(name)[1])
    return _loaded[name]


def check(status: int, what: str) -> None:
    """Raise on a non-zero status returned by a launch function."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {status}")
