"""Finite-horizon generalized LQR: Riccati backward recursion
(port of :mod:`lqg_tpu.ops.riccati`).

Batch-first over leading axes, Cholesky solves on the control Hessian, and
the three guards of :func:`lqg_tpu_torch.ops.linalg.regularize_spd`.  The
time loop is a Python loop of batched tensor ops; on the card the fused
gains kernel (:mod:`lqg_tpu_torch.ops.kernels.gains`) replaces it where the
spec fits.  :func:`backward_multiplicative` is the pass with
control-multiplicative (signal-dependent) noise, which no kernel takes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from lqg_tpu_torch.spec import LQGSpec
from lqg_tpu_torch.ops.linalg import (mT, cho_solve, cholesky, regularize_spd,
                                     symmetrize)


class Gains(NamedTuple):
    """Time-stacked LQR feedback gains: ``u_t = L_t x_t + l_t``."""

    L: torch.Tensor  # (T, m, n) feedback gain
    l: torch.Tensor  # (T, m)    feedforward term
    H: Optional[torch.Tensor] = None  # (T, m, m) control Hessian


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``M^T v`` over the trailing axes: ``(..., a, b), (..., a) -> (..., b)``."""
    return (mT(M) @ v[..., None])[..., 0]


def _step(S, s, Q, q, P, R, r, A, B, *, eps: float, regularize: str):
    SA = S @ A
    H = symmetrize(R + mT(B) @ (S @ B))
    G = P + mT(B) @ SA
    g = r + _mv(B, s)

    Ht = regularize_spd(H, eps, regularize)
    chol = cholesky(Ht)
    L = -cho_solve(chol, G)
    l = -cho_solve(chol, g)

    # value-function update with the unregularized H (reference lqr.py:33-34)
    HL = H @ L
    S_new = Q + mT(A) @ SA + mT(L) @ HL + mT(L) @ G + mT(G) @ L
    s_new = q + _mv(A, s) + _mv(G, l) + _mv(HL, l) + _mv(L, g)
    return symmetrize(S_new), s_new, (L, l, Ht)


def backward(spec: LQGSpec, horizon: Optional[int] = None, eps: float = 1e-8,
             regularize: str = "jitter") -> Gains:
    """Run the Riccati backward pass; returns time-leading :class:`Gains`.

    ``spec`` is stacked (time axis at ``-3``) or stationary (``horizon``
    required).  Outputs have shape ``(T, batch..., m, n)``.
    """
    stationary = spec.A.dim() == spec.Qf.dim()
    if stationary:
        if horizon is None:
            raise ValueError("stationary spec requires explicit horizon")
        T = horizon
        at = lambda x, t: x
    else:
        T = spec.A.shape[-3]
        at = lambda x, t: x[..., t, :, :]
    atv = (lambda x, t: x) if stationary else (lambda x, t: x[..., t, :])

    S, s = spec.Qf, spec.qf
    outs = [None] * T
    for t in range(T - 1, -1, -1):
        S, s, outs[t] = _step(
            S, s, at(spec.Q, t), atv(spec.q, t), at(spec.P, t), at(spec.R, t),
            atv(spec.r, t), at(spec.A, t), at(spec.B, t),
            eps=eps, regularize=regularize)
    L, l, H = (torch.stack(x) for x in zip(*outs))
    return Gains(L=L, l=l, H=H)


def backward_multiplicative(spec: LQGSpec, C: torch.Tensor,
                            horizon: Optional[int] = None, eps: float = 1e-8,
                            regularize: str = "jitter") -> Gains:
    """Riccati backward pass with control-multiplicative (signal-dependent)
    noise, after Todorov (2005) (port of
    ``lqg_tpu.ops.riccati.backward_multiplicative``).

    The dynamics carry the extra noise ``sum_i eps_i C_i u``, ``eps_i ~
    N(0, 1)``, so the control Hessian gains a penalty:

        H = R + B^T S B + sum_i C_i^T S C_i

    Args:
        spec: stationary spec (no time axis) with zero affine terms; leading
            parameter-set axes allowed.
        C: control-noise scales ``(..., k, n, m)``: ``k`` noise channels,
            broadcasting against the spec's parameter-set axes.
        horizon: number of steps.

    Returns time-stacked :class:`Gains` with ``H`` the regularized Hessian.
    """
    if spec.A.dim() != spec.Qf.dim():
        raise ValueError("backward_multiplicative expects a stationary spec")
    if horizon is None:
        raise ValueError("stationary spec requires explicit horizon")
    A, B, Q, R, P = spec.A, spec.B, spec.Q, spec.R, spec.P
    S = spec.Qf
    outs = []
    for _ in range(horizon):
        SB = S @ B
        # the control-dependent noise's penalty: sum_i C_i^T S C_i
        CtSC = torch.einsum("...kni,...nm,...kmj->...ij", C, S, C)
        H = symmetrize(R + mT(B) @ SB + CtSC)
        G = P + mT(B) @ (S @ A)
        Ht = regularize_spd(H, eps, regularize)
        L = -cho_solve(cholesky(Ht), G)
        S = symmetrize(Q + mT(A) @ (S @ A) + mT(G) @ L)
        outs.append((L, Ht))
    L, H = (torch.stack(x) for x in zip(*outs[::-1]))
    return Gains(L=L, l=L.new_zeros(L.shape[:-1]), H=H)
