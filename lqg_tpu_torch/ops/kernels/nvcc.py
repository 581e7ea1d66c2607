"""Build the CUDA sources in ``lqg_tpu_torch/csrc`` and load them with ctypes.

Each source is compiled on first use by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  A source with several parts (:data:`PARTS`) is compiled
once per part with ``-DLQG_PART=k``, each part a library of its own that
holds some of the source's template instances, so that a source with many
instances builds in the time of its slowest part.  Libraries are named by a
hash of their source and flags, so an edited source is rebuilt, and land in
``lqg_tpu_torch/_build``.  The ``-Xptxas -v`` report (registers, spills) is
kept beside each library.  A build that fails raises; nothing falls back.
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

# Parts of each source built in parts; the instances of each part are
# listed in the source's dispatch and in its module's PART table
# (ops/kernels/gains.py, ops/kernels/likelihood.py, ops/kernels/joint.py).
# Other sources have one.
PARTS = {"gains": 5, "likelihood": 3, "joint": 2}

_loaded: Dict[Tuple[str, int], ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the lqg_tpu_torch kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _flags(name: str, part: int) -> Tuple[str, ...]:
    return FLAGS + ((f"-DLQG_PART={part}",) if name in PARTS else ())


def _target(name: str, part: int = 0) -> Tuple[str, str]:
    """Source path and library path of one part; the name hashes the
    source, the shared headers and the flags."""
    src = os.path.join(CSRC, f"{name}.cu")
    digest = hashlib.sha1(" ".join(_flags(name, part)).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    tag = f"{name}.{part}" if name in PARTS else name
    return src, os.path.join(BUILD_DIR, f"lib{tag}-{digest.hexdigest()[:12]}.so")


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every part of every named source that is not built yet, all
    ``nvcc`` processes at once; returns each source's ``-Xptxas -v`` report
    (its parts' reports in part order)."""
    names = list(names)
    units = [(name, part) for name in names
             for part in range(PARTS.get(name, 1))]
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name, part in units:
        src, lib = _target(name, part)
        if not os.path.exists(lib):
            tmp = f"{lib}.{os.getpid()}.tmp"
            procs[(name, part)] = (subprocess.Popen(
                [_nvcc(), *_flags(name, part), "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, lib)
    # wait for every compiler before reporting any failure
    logs = {unit: proc.communicate()[0]
            for unit, (proc, _, _) in procs.items()}
    for (name, part), (proc, tmp, lib) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu part {part}:\n"
                               f"{logs[(name, part)]}")
        with open(lib + ".log", "w") as f:
            f.write(logs[(name, part)])
        os.replace(tmp, lib)  # atomic: a concurrent build sees whole files
    reports = dict.fromkeys(names, "")
    for name, part in units:
        with open(_target(name, part)[1] + ".log") as f:
            reports[name] += f.read()
    return reports


def load(name: str, part: int = 0) -> ctypes.CDLL:
    """The built library of part ``part`` of ``csrc/<name>.cu``, building
    the source's parts if needed."""
    if (name, part) not in _loaded:
        build_all([name])
        _loaded[(name, part)] = ctypes.CDLL(_target(name, part)[1])
    return _loaded[(name, part)]


def check(status: int, what: str) -> None:
    """Raise on a non-zero status returned by a launch function."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {status}")
