"""Steady-state (infinite-horizon) LQG gains by doubling iterations (port
of :mod:`lqg_tpu.ops.dare`).

For time-invariant problems the Riccati recursions converge geometrically,
so for long horizons the gain schedules are constant except for boundary
transients.  The structure-preserving doubling algorithm (SDA) squares the
recursion: iterate k gives the value function after 2^k steps, so fixed
points arrive in ~10-20 iterations independent of T.

SDA for the DARE ``S = Q + A^T S (I + G S)^{-1} A`` with ``G = B R^{-1} B^T``:

    A_{k+1} = A_k (I + G_k H_k)^{-1} A_k
    G_{k+1} = G_k + A_k (I + G_k H_k)^{-1} G_k A_k^T
    H_{k+1} = H_k + A_k^T H_k (I + G_k H_k)^{-1} A_k

with ``A_0 = A, G_0 = G, H_0 = Q``; ``H_k -> S`` quadratically (Anderson &
Moore 1979; Chu, Fan & Lin 2005).  The filter ARE is the dual problem under
``A -> A^T, G -> F^T (W W^T)^{-1} F, Q -> V V^T``.

**Marginally stable caveat.** The tracking models drive penalized error with
random-walk (unit-eigenvalue) target states, so the infinite-horizon *cost*
diverges even though the *gains* converge.  The gain-level solvers monitor
the gain between doubling steps and freeze each batch element once
converged, before the diverging value iterate poisons the solve;
:func:`solve_dare` (raw fixed-iteration SDA) is only for problems whose ARE
solution is finite.

Batch-first and differentiable.  The iteration count is fixed and a
converged element is frozen by ``torch.where``, so nothing is read on the
host; the solves are ``torch.linalg.solve_ex`` and the NaN-not-raise
Cholesky.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from lqg_tpu_torch.spec import LQGSpec
from lqg_tpu_torch.ops.linalg import mT, psd_solve, symmetrize


class SteadyState(NamedTuple):
    """Converged stationary LQG gains."""

    L: torch.Tensor  # (..., m, n) steady-state feedback gain
    K: torch.Tensor  # (..., n, p) steady-state Kalman gain


def _sda_step(Ak, Gk, Hk):
    n = Ak.shape[-1]
    eye = torch.eye(n, dtype=Ak.dtype, device=Ak.device)
    M = torch.linalg.solve_ex(eye + Gk @ Hk,
                              eye.expand(Gk.shape[:-2] + (n, n)))[0]
    AM = Ak @ M
    A_next = AM @ Ak
    G_next = symmetrize(Gk + AM @ (Gk @ mT(Ak)))
    H_next = symmetrize(Hk + mT(Ak) @ (Hk @ (M @ Ak)))
    return A_next, G_next, H_next


def _start(A, G, Q):
    shape = torch.broadcast_shapes(A.shape, G.shape, Q.shape)
    return (A.expand(shape), symmetrize(G).expand(shape),
            symmetrize(Q).expand(shape))


def solve_dare(A: torch.Tensor, G: torch.Tensor, Q: torch.Tensor,
               iters: int = 32) -> torch.Tensor:
    """Solve ``S = Q + A^T S (I + G S)^{-1} A`` by fixed-iteration doubling.

    Args:
        A: open-loop matrix ``(..., n, n)``.
        G: PSD "gain" term (``B R^{-1} B^T`` for control), ``(..., n, n)``.
        Q: PSD constant term, ``(..., n, n)``.
        iters: doubling steps; iterate k covers a ``2^k``-step horizon.

    Requires a finite ARE solution (stabilizable + detectable); for the
    marginally stable tracking models use :func:`steady_control` /
    :func:`steady_filter`, which converge at the gain level.
    """
    Ak, Gk, Hk = _start(A, G, Q)
    for _ in range(iters):
        Ak, Gk, Hk = _sda_step(Ak, Gk, Hk)
    return Hk


def _doubling_gains(A: torch.Tensor, G: torch.Tensor, Q: torch.Tensor,
                    gain_fn: Callable[[torch.Tensor], torch.Tensor],
                    iters: int, tol: float) -> torch.Tensor:
    """Run SDA, computing ``gain_fn(H_k)`` each doubling step, and freeze
    each batch element once its gain stops moving (relative tolerance
    ``tol``; defaulted per dtype by the callers): a fixed number of steps,
    the freeze a ``torch.where`` on a per-element flag."""
    Ak, Gk, Hk = _start(A, G, Q)
    gain = gain_fn(Hk)
    done = torch.zeros(Ak.shape[:-2], dtype=torch.bool, device=Ak.device)
    for _ in range(iters):
        A_new, G_new, H_new = _sda_step(Ak, Gk, Hk)
        gain_new = gain_fn(H_new)
        delta = torch.linalg.matrix_norm(gain_new - gain)
        scale = 1.0 + torch.linalg.matrix_norm(gain_new)
        keep = done[..., None, None]
        done = done | (delta <= tol * scale)
        Ak, Gk, Hk, gain = (torch.where(keep, old, new) for old, new in
                            ((Ak, A_new), (Gk, G_new), (Hk, H_new),
                             (gain, gain_new)))
    return gain


def _default_tol(dtype) -> float:
    # a few doubling steps past quadratic convergence: ~eps^(3/4)
    return float(torch.finfo(dtype).eps) ** 0.75


def steady_control(spec: LQGSpec, iters: int = 32, tol: float = None,
                   jitter: float = 0.0) -> torch.Tensor:
    """Steady-state LQR feedback gain ``L`` (``u = L x``).

    Requires a stationary spec with zero affine/cross cost terms.  Matches
    the early-time rows of the finite-horizon backward pass for large ``T``.
    """
    A, B, Q, R = spec.A, spec.B, spec.Q, spec.R
    tol = _default_tol(A.dtype) if tol is None else tol
    G = B @ psd_solve(R, mT(B), jitter=jitter)

    def gain_fn(S):
        SB = S @ B
        H = R + mT(B) @ SB
        return -psd_solve(H, mT(SB) @ A, jitter=jitter)

    return _doubling_gains(A, G, Q, gain_fn, iters, tol)


def steady_filter(spec: LQGSpec, iters: int = 32, tol: float = None,
                  jitter: float = 0.0) -> torch.Tensor:
    """Steady-state Kalman gain ``K``.

    Solves the filter ARE (predicted-state covariance ``P``) as the dual
    DARE and returns ``K = P F^T (F P F^T + W W^T)^{-1}``.  Matches the
    late-time rows of the finite-horizon forward pass for large ``T``.
    """
    A, F, V, W = spec.A, spec.F, spec.V, spec.W
    tol = _default_tol(A.dtype) if tol is None else tol
    VVt = V @ mT(V)
    WWt = W @ mT(W)
    G = mT(F) @ psd_solve(WWt, F, jitter=jitter)

    def gain_fn(P):
        PFt = P @ mT(F)
        return mT(psd_solve(F @ PFt + WWt, mT(PFt), jitter=jitter))

    return _doubling_gains(mT(A), G, VVt, gain_fn, iters, tol)


def steady_state(spec: LQGSpec, iters: int = 32, tol: float = None,
                 jitter: float = 0.0) -> SteadyState:
    """Steady-state gains of a stationary LQG spec; see :class:`SteadyState`."""
    L = steady_control(spec, iters=iters, tol=tol, jitter=jitter)
    K = steady_filter(spec, iters=iters, tol=tol, jitter=jitter)
    return SteadyState(L=L, K=K)
