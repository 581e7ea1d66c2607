"""Device and precision policy of the port.

Counterpart of :mod:`lqg_tpu.config`, which pins matmul precision to
``"highest"`` inside every recursion.  Here the same policy means no TF32:
a float32 product on the card must run in full float32, or the T=1000
Riccati and covariance recursions drift at the percent level.

Every entry point that makes tensors resolves its device through
:func:`resolve_device`: the card unless the caller names another device.
With no card present and none named, it raises - the port never moves to
the CPU on its own.

The debugging helpers are the JAX package's: :func:`assert_finite`,
:func:`condition_number`, :func:`check_spec_conditioning` (host-side
diagnostics) and :func:`debug_nans` (a context that raises on the first
NaN).  ``lqg_tpu.config.enable_x64`` has no counterpart: JAX needs a global
switch before it makes any float64 array, while PyTorch makes float64
wherever asked, so the port picks the precision per call - a constructor's
``dtype=torch.float64``, or float64 data, whose dtype the inference models
keep.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode


def pin_precision() -> None:
    """Turn TF32 off for float32 products and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point works on: ``cuda`` unless named.  A CUDA
    device, named or not, raises where there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "lqg_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        pin_precision()
    return device


def as_tensors(values, device=None, dtype=torch.float32):
    """``values`` as tensors of ``dtype`` on one device, and that device.

    Without a named device, tensor values keep theirs; plain numbers go to
    the card (:func:`resolve_device`)."""
    if device is None:
        device = next((v.device for v in values if torch.is_tensor(v)), None)
    device = resolve_device(device)
    return [_as_tensor(v, dtype, device) for v in values], device


def _as_tensor(value, dtype, device) -> torch.Tensor:
    """A number goes to the device through a fill kernel: a copy from host
    memory would wait for the card, and a CUDA graph cannot capture it."""
    if isinstance(value, (int, float)):
        return torch.full((), value, dtype=dtype, device=device)
    return torch.as_tensor(value, dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def constant(rows: tuple, dtype, device) -> torch.Tensor:
    """The constant ``rows`` (nested tuples: a matrix's rows, or an index
    vector), copied to the device once per ``(rows, dtype, device)`` and
    shared: callers only read it, so that building a model makes no copy
    from host memory after the first."""
    return torch.tensor(rows, dtype=dtype, device=device)


# --- debugging and conditioning diagnostics ---------------------------------

def _leaves_with_path(tree, path=""):
    """``(path, leaf)`` pairs of a nest of dicts (keys sorted), lists,
    tuples and named tuples, the path in ``jax.tree_util.keystr``'s form:
    ``['key']``, ``[0]``, ``.field``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _leaves_with_path(getattr(tree, k), f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def assert_finite(tree, name: str = "value"):
    """Host-side finiteness check over a nest of tensors or arrays (for
    tests and debugging): raises ``FloatingPointError`` naming the first
    leaf with a non-finite entry, in ``lqg_tpu.config.assert_finite``'s
    words."""
    import numpy as np

    for path, leaf in _leaves_with_path(tree):
        if torch.is_tensor(leaf):
            leaf = leaf.detach().cpu().numpy()
        arr = np.asarray(leaf)
        if not np.isfinite(arr).all():
            bad = int((~np.isfinite(arr)).sum())
            raise FloatingPointError(
                f"{name}{path}: {bad} non-finite entries (shape {arr.shape})")


def condition_number(M: torch.Tensor) -> torch.Tensor:
    """Spectral condition number of (batched) symmetric matrices (a host
    diagnostic: ``torch.linalg.eigvalsh`` waits for the card)."""
    evals = torch.linalg.eigvalsh(M)
    tiny = torch.finfo(M.dtype).tiny
    return evals[..., -1].abs() / torch.clamp(evals[..., 0].abs(), min=tiny)


def check_spec_conditioning(spec, warn_threshold: float = 1e6) -> dict:
    """Condition numbers of a spec's noise and cost matrices (``VV^T``,
    ``WW^T``, ``R``; the largest over any batch), with a printed warning
    above ``warn_threshold``: the reference's eigenvalue clamps made
    visible instead of silent."""
    out = {}
    for name, mat in (("VV^T", spec.V @ spec.V.mT),
                      ("WW^T", spec.W @ spec.W.mT), ("R", spec.R)):
        if mat.shape[-1] == 0:
            continue
        c = float(condition_number(mat).max())
        out[name] = c
        if c > warn_threshold:
            print(f"lqg_tpu_torch: warning: {name} condition number {c:.2e} "
                  f"exceeds {warn_threshold:.0e}; expect unstable "
                  f"recursions in float32")
    return out


# factories whose output is uninitialized memory, which may hold NaN bits
_UNINITIALIZED = ("empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided")


class _RaiseOnNaN(TorchDispatchMode):
    """Checks every floating output of every operation for NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _UNINITIALIZED:
            return out
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for t in outs:
            if (torch.is_tensor(t) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(
                    f"invalid value (nan) encountered in {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Raise ``FloatingPointError`` on the first operation inside the
    context whose output holds a NaN, as ``lqg_tpu.config.debug_nans`` makes
    JAX do.  The forward goes through a ``TorchDispatchMode``; the backward
    is also watched by ``torch.autograd.set_detect_anomaly(True,
    check_nan=True)``, which names the autograd node at fault.  Debugging
    only: every operation waits for the card."""
    if not enable:
        yield
        return
    with torch.autograd.set_detect_anomaly(True, check_nan=True), \
            _RaiseOnNaN():
        yield
