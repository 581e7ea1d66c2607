"""Compensated (Neumaier) summation (port of :mod:`lqg_tpu.utils.numerics`).

The marginalized likelihood sums ~1e5 per-observation terms to totals of
O(1e5) nats; plain float32 accumulation leaves ~0.1 nats of noise, which is
what pinned NUTS step sizes in the JAX package's flagship fit.  Chunked
partial sums followed by a Neumaier fold keep the error near per-element
rounding.
"""

from __future__ import annotations

import torch


def kahan_sum(x: torch.Tensor, axis: int = 0, chunk: int = 16) -> torch.Tensor:
    """Sum ``x`` along ``axis``: chunks of ``chunk`` first, then a
    sequential Neumaier fold of the chunk partials."""
    x = torch.movedim(x, axis, 0)
    n = x.shape[0]
    pad = (-n) % chunk
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])], dim=0)
    parts = x.reshape((-1, chunk) + x.shape[1:]).sum(dim=1)

    s = torch.zeros_like(parts[0])
    c = torch.zeros_like(parts[0])
    for p in parts:
        t = s + p
        # Neumaier: recover the bits lost by whichever operand was smaller
        c = c + torch.where(s.abs() >= p.abs(), (s - t) + p, (p - t) + s)
        s = t
    return s + c
