"""Generalized LQG problem specification (port of :mod:`lqg_tpu.spec`).

    x_{t+1} = A_t x_t + B_t u_t + V_t eps_t,      eps ~ N(0, I)
    y_t     = F_t x_t + W_t eta_t,                eta ~ N(0, I)
    J       = x_T' Qf x_T + qf' x_T
              + sum_t [ x' Q x + q' x + u' R u + r' u + 2 u' P x ]

``V`` and ``W`` are noise scale matrices: the covariances are ``V V^T`` and
``W W^T``.  Matrices may be stationary (no time axis, horizon supplied by
the caller) or stacked (time axis at ``-3``); leading batch axes are allowed
in both layouts.

``zero_affine`` is the port's explicit mark that ``q, qf, P, r`` are
structurally zero.  The JAX package infers it from NumPy leaves that survive
a trace (``lqg_tpu/utils/stacking.py:_zeros``); PyTorch has no trace, so the
spec constructors set the flag and the fused gains kernel, which ignores
those terms, is only chosen when it is set.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_AFFINE = ("q", "qf", "P", "r")


class _Fields(NamedTuple):
    Q: torch.Tensor  # (T, n, n) state cost
    q: torch.Tensor  # (T, n)   linear state cost
    Qf: torch.Tensor  # (n, n)  terminal state cost
    qf: torch.Tensor  # (n,)    linear terminal state cost
    P: torch.Tensor  # (T, m, n) control-state cross cost
    R: torch.Tensor  # (T, m, m) control cost
    r: torch.Tensor  # (T, m)   linear control cost
    A: torch.Tensor  # (T, n, n) state transition
    B: torch.Tensor  # (T, n, m) control input
    V: torch.Tensor  # (T, n, k) process noise scale (cov = V V^T)
    F: torch.Tensor  # (T, p, n) observation
    W: torch.Tensor  # (T, p, l) observation noise scale (cov = W W^T)
    zero_affine: bool = False  # q, qf, P, r are structurally zero


class LQGSpec(_Fields):
    """(generalized) LQG specification: 12 tensors and the zero flag."""

    __slots__ = ()

    def _replace(self, **kwargs) -> "LQGSpec":
        # replacing an affine term voids the promise unless restated
        if "zero_affine" not in kwargs and any(k in kwargs for k in _AFFINE):
            kwargs["zero_affine"] = False
        return super()._replace(**kwargs)

    def tensors(self):
        """The 12 tensor fields, in field order."""
        return tuple(self)[:12]

    @property
    def horizon(self) -> int:
        """Number of time steps T (stacked layout)."""
        return self.A.shape[-3]

    @property
    def state_dim(self) -> int:
        return self.A.shape[-1]

    @property
    def action_dim(self) -> int:
        return self.B.shape[-1]

    @property
    def obs_dim(self) -> int:
        return self.F.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.A.device

    @property
    def dtype(self) -> torch.dtype:
        return self.A.dtype

    def to(self, device=None, dtype=None) -> "LQGSpec":
        return LQGSpec(*(x.to(device=device, dtype=dtype)
                         for x in self.tensors()),
                       zero_affine=self.zero_affine)

    def astype(self, dtype) -> "LQGSpec":
        return self.to(dtype=dtype)
