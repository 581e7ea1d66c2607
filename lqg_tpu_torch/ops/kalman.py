"""Kalman filter covariance forward pass (port of :mod:`lqg_tpu.ops.kalman`).

    P <- A P A^T + V V^T            (predict)
    G  = F P F^T + W W^T            (innovation covariance)
    K  = P F^T G^{-1}               (gain)
    P <- P - K (P F^T)^T            (update)
"""

from __future__ import annotations

from typing import Optional

import torch

from lqg_tpu_torch.spec import LQGSpec
from lqg_tpu_torch.ops.linalg import mT, cho_solve, cholesky, symmetrize


def _step(P, A, F, V, W, jitter: float):
    P = A @ P @ mT(A) + V @ mT(V)
    PFt = P @ mT(F)
    G = symmetrize(F @ PFt + W @ mT(W))
    if jitter:
        G = G + jitter * torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
    chol = cholesky(G)
    # K = P F^T G^{-1} == (G^{-1} (P F^T)^T)^T since G is symmetric
    K = mT(cho_solve(chol, mT(PFt)))
    P = symmetrize(P - K @ mT(PFt))
    return P, K


def forward(spec: LQGSpec, Sigma0: torch.Tensor,
            horizon: Optional[int] = None, jitter: float = 0.0) -> torch.Tensor:
    """Run the covariance recursion; returns Kalman gains ``(T, batch..., n, p)``.

    ``spec`` is stacked (time axis at ``-3``) or stationary (``horizon``
    required); ``Sigma0`` is the initial state covariance.
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

    P, Ks = Sigma0, []
    for t in range(T):
        P, K = _step(P, at(spec.A, t), at(spec.F, t), at(spec.V, t),
                     at(spec.W, t), jitter)
        Ks.append(K)
    return torch.stack(Ks)
