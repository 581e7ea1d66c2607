"""Device and precision policy of the port.

Counterpart of :mod:`lqg_tpu.config`, which pins matmul precision to
``"highest"`` inside every recursion.  Here the same policy means no TF32:
a float32 product on the card must run in full float32, or the T=1000
Riccati and covariance recursions drift at the percent level.

Every entry point that makes tensors resolves its device through
:func:`resolve_device`: the card unless the caller names another device.
With no card present and none named, it raises - the port never moves to
the CPU on its own.
"""

from __future__ import annotations

import functools

import torch


def pin_precision() -> None:
    """Turn TF32 off for float32 products and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point works on: ``cuda`` unless named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "lqg_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
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
