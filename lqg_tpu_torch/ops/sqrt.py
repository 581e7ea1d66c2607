"""Square-root (QR array-form) Riccati and Kalman recursions (port of
:mod:`lqg_tpu.ops.sqrt`).

The array form propagates Cholesky-like factors instead of covariances:
every intermediate is a product of factors, so covariances stay PSD by
construction and the effective precision is roughly doubled (Verhaegen &
Van Dooren 1986), where the ``P <- (I - KF) P`` style updates of the plain
scans lose symmetry over long float32 horizons.

Both recursions are batch-first over leading axes, take stationary (no time
axis) or stacked specs, put the time axis first on their outputs and return
the scans' types, so that :meth:`lqg_tpu_torch.system.System.gains` swaps
them in with ``method="sqrt"``.  The time loop is a Python loop of batched
tensor ops; each step takes two QR factorizations
(``torch.linalg.qr``).  The setup factors (:func:`psd_sqrt`) take their
spectrum from :func:`~lqg_tpu_torch.ops.linalg.eigh_jacobi`, since
``torch.linalg.eigh`` reads its error code on the host.

Restrictions: zero affine cost terms ``q, r`` and zero control-state cross
term ``P`` (every model of the zoo satisfies them).
"""

from __future__ import annotations

from typing import Optional

import torch

from lqg_tpu_torch.spec import LQGSpec
from lqg_tpu_torch.ops.linalg import _Eigh, cholesky, mT, symmetrize
from lqg_tpu_torch.ops.riccati import Gains


def psd_sqrt(M: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Symmetric square root of a PSD matrix from its eigendecomposition.

    Handles singular inputs (negative eigenvalues are clipped to ``eps``),
    unlike a Cholesky factorization.  Used at recursion setup (cost
    matrices, initial covariance), never inside the loops; differentiable
    through the eigendecomposition's adjoint (``linalg._Eigh``)."""
    w, V = _Eigh.apply(symmetrize(M))
    w = torch.clamp(w, min=eps)
    return (V * torch.sqrt(w)[..., None, :]) @ mT(V)


def _vcat(*blocks: torch.Tensor) -> torch.Tensor:
    """Stack matrix blocks along rows (axis ``-2``), broadcasting only the
    leading batch axes (row counts may differ)."""
    batch = torch.broadcast_shapes(*(b.shape[:-2] for b in blocks))
    return torch.cat([b.expand(batch + b.shape[-2:]) for b in blocks], -2)


def _tri_factor(M: torch.Tensor) -> torch.Tensor:
    """Lower-triangular factor ``S`` with ``S S^T = M^T M`` via QR.

    ``M`` is a tall pre-array ``(..., k, n)`` with ``k >= n``; returns the
    transposed R factor with a positive diagonal (the canonical
    Cholesky-like orientation, which keeps the factors comparable across
    steps).  ``mode="reduced"``: autograd needs ``Q``, which
    ``mode="r"`` does not form.
    """
    r = torch.linalg.qr(M, mode="reduced")[1]
    d = torch.diagonal(r, dim1=-2, dim2=-1)
    sign = torch.where(d < 0, -1.0, 1.0).to(r.dtype)
    return mT(r * sign[..., None])


def _kf_sqrt_step(S, A, F, V, W):
    """One array-form Kalman step on the Cholesky-like factor ``S``.

    Predict via QR of ``[S^T A^T; V^T]``; measurement update via QR of the
    block pre-array

        [[W^T,          0 ]            [[Y^T,  Z^T   ]
         [S_pred^T F^T, S_pred^T]]  ->  [0,    S_new^T]]

    whose post-array blocks give the innovation factor ``Y`` (``Y Y^T = G``),
    the updated factor ``S_new``, and the gain ``K = Z Y^{-1}``.
    """
    n = A.shape[-1]
    p = F.shape[-2]

    # predict: S_pred S_pred^T = A S S^T A^T + V V^T
    S_pred = _tri_factor(_vcat(mT(A @ S), mT(V)))

    # measurement update pre-array, shape (..., pw + n, p + n)
    SF = mT(F @ S_pred)  # (..., n, p) = S_pred^T F^T
    top = torch.cat([mT(W), W.new_zeros(W.shape[:-2] + (W.shape[-1], n))],
                    -1)
    bot = torch.cat([SF, mT(S_pred)], -1)
    top = top.expand(bot.shape[:-2] + top.shape[-2:])
    post = _tri_factor(_vcat(top, bot))

    Y = post[..., :p, :p]  # chol(F P F^T + W W^T)
    Z = post[..., p:, :p]  # P F^T Y^{-T}
    S_new = post[..., p:, p:]

    # K = Z Y^{-1}: solve Y^T K^T = Z^T (Y lower-triangular)
    Kt = torch.linalg.solve_triangular(mT(Y), mT(Z), upper=True)
    return S_new, mT(Kt)


def _time_fields(spec: LQGSpec, names, horizon):
    """The number of steps and a function ``t -> fields at step t``."""
    fields = [getattr(spec, k) for k in names]
    if spec.A.dim() == spec.Qf.dim():  # stationary
        if horizon is None:
            raise ValueError("stationary spec requires explicit horizon")
        return horizon, lambda t: fields
    return spec.A.shape[-3], lambda t: [x[..., t, :, :] for x in fields]


def _batch(spec: LQGSpec, factor: torch.Tensor) -> torch.Size:
    stationary = spec.A.dim() == spec.Qf.dim()
    batch = spec.A.shape[:-2] if stationary else spec.A.shape[:-3]
    return torch.broadcast_shapes(batch, factor.shape[:-2])


def kalman_forward_sqrt(spec: LQGSpec, Sigma0: torch.Tensor,
                        horizon: Optional[int] = None) -> torch.Tensor:
    """Square-root Kalman gain schedule; a drop-in for
    :func:`lqg_tpu_torch.ops.kalman.forward` with better float32
    conditioning.

    Args:
        spec: stacked (time axis at ``-3``) or stationary layout.
        Sigma0: initial state covariance (may be singular; factored by
            :func:`psd_sqrt`).
        horizon: required for stationary specs.

    Returns Kalman gains ``K (T, batch..., n, p)``.
    """
    S = psd_sqrt(Sigma0)
    T, at = _time_fields(spec, ("A", "F", "V", "W"), horizon)
    S = S.expand(_batch(spec, S) + S.shape[-2:])
    Ks = []
    for t in range(T):
        S, K = _kf_sqrt_step(S, *at(t))
        Ks.append(K)
    return torch.stack(Ks)


def _riccati_sqrt_step(U, A, B, Qs, R, Rs, jitter: float):
    """One square-root Riccati step on the cost-to-go factor ``U``
    (``S = U U^T``).

    Gains from the factored Hessian ``H = R + (U^T B)^T (U^T B)``; the value
    update uses the Joseph-form identity

        S_prev = Q + (A + B L)^T S (A + B L) + L^T R L

    (valid at the optimal ``L`` with zero cross term), realized as a QR of
    the stacked factor ``[U^T (A + B L); Rs^T L; Qs^T]``.
    """
    UtB = mT(U) @ B  # (..., n, m)
    H = R + mT(UtB) @ UtB
    if jitter:
        scale = torch.diagonal(H, dim1=-2, dim2=-1).mean(-1)
        H = H + (jitter * scale)[..., None, None] * torch.eye(
            H.shape[-1], dtype=H.dtype, device=H.device)
    cholH = cholesky(H)
    G = mT(UtB) @ (mT(U) @ A)  # B^T S A
    y = torch.linalg.solve_triangular(cholH, G, upper=False)
    L = -torch.linalg.solve_triangular(mT(cholH), y, upper=True)

    Acl = A + B @ L
    U_new = _tri_factor(_vcat(mT(U) @ Acl, mT(Rs) @ L, mT(Qs)))
    return U_new, L, H


def riccati_backward_sqrt(spec: LQGSpec, horizon: Optional[int] = None,
                          jitter: float = 0.0) -> Gains:
    """Square-root Riccati backward pass; a drop-in for
    :func:`lqg_tpu_torch.ops.riccati.backward` on specs with zero
    affine/cross cost terms (``q = r = 0``, ``P = 0``).

    The cost matrices are factored once at setup (``Qs Qs^T = Q``,
    ``Rs Rs^T = R`` by :func:`psd_sqrt`, so a singular ``Q`` - the tracking
    error cost ``[[1, -1], [-1, 1]]`` - is fine); the recursion then
    touches only factors.

    Returns time-stacked :class:`~lqg_tpu_torch.ops.riccati.Gains` (with
    ``l = 0``).
    """
    U = psd_sqrt(spec.Qf)
    T, at = _time_fields(spec, ("A", "B", "Q", "R"), horizon)
    U = U.expand(_batch(spec, U) + U.shape[-2:])
    if spec.A.dim() == spec.Qf.dim():
        factors = (psd_sqrt(spec.Q), psd_sqrt(spec.R))
        factors_at = lambda t: factors
    else:
        Qs, Rs = psd_sqrt(spec.Q), psd_sqrt(spec.R)
        factors_at = lambda t: (Qs[..., t, :, :], Rs[..., t, :, :])
    Ls, Hs = [None] * T, [None] * T
    for t in reversed(range(T)):
        A, B, _, R = at(t)
        Qs_t, Rs_t = factors_at(t)
        U, Ls[t], Hs[t] = _riccati_sqrt_step(U, A, B, Qs_t, R, Rs_t, jitter)
    L, H = torch.stack(Ls), torch.stack(Hs)
    return Gains(L=L, l=L.new_zeros(L.shape[:-1]), H=H)
