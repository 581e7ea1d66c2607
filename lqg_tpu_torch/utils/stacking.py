"""Time-stacking helpers (port of :mod:`lqg_tpu.utils.stacking`).

Static matrices broadcast to per-timestep stacks; ``q, r, P`` and ``qf`` are
zero and the spec says so through its ``zero_affine`` flag; the terminal
cost is the running cost ``Q``.
"""

from __future__ import annotations

import torch

from lqg_tpu_torch.spec import LQGSpec


def _batch_shape(*mats: torch.Tensor) -> torch.Size:
    return torch.broadcast_shapes(*(M.shape[:-2] for M in mats))


def _zeros(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=like.dtype, device=like.device)


def time_stack(A: torch.Tensor, T: int) -> torch.Tensor:
    """Broadcast a static matrix to a length-``T`` time stack."""
    return A[..., None, :, :].expand(A.shape[:-2] + (T,) + A.shape[-2:])


def time_stack_spec(A, B, F, V, W, Q, R, T: int) -> LQGSpec:
    """Stacked spec from static matrices: ``q, r, P`` zero, ``Qf = Q``,
    ``qf = 0``."""
    batch = _batch_shape(A, B, F, V, W, Q, R)
    n, m = Q.shape[-1], R.shape[-1]
    return LQGSpec(
        A=time_stack(A, T), B=time_stack(B, T), F=time_stack(F, T),
        V=time_stack(V, T), W=time_stack(W, T), Q=time_stack(Q, T),
        R=time_stack(R, T),
        q=_zeros(batch + (T, n), Q),
        Qf=Q.expand(batch + Q.shape[-2:]),
        qf=_zeros(batch + (n,), Q),
        P=_zeros(batch + (T, m, n), R),
        r=_zeros(batch + (T, m), R),
        zero_affine=True,
    )


def stationary_spec(A, B, F, V, W, Q, R) -> LQGSpec:
    """Stationary spec (no time axis); the horizon is given at solve time."""
    batch = _batch_shape(A, B, F, V, W, Q, R)
    n, m = Q.shape[-1], R.shape[-1]
    return LQGSpec(
        A=A, B=B, F=F, V=V, W=W, Q=Q, R=R,
        q=_zeros(batch + (n,), Q),
        Qf=Q.expand(batch + Q.shape[-2:]),
        qf=_zeros(batch + (n,), Q),
        P=_zeros(batch + (m, n), R),
        r=_zeros(batch + (m,), R),
        zero_affine=True,
    )
