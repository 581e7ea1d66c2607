"""Small-matrix linear algebra, batch-first (port of :mod:`lqg_tpu.ops.linalg`).

State dims are tiny (2-40); every function broadcasts over leading batch axes
and solves through Cholesky factors.
"""

from __future__ import annotations

import torch


def mT(x: torch.Tensor) -> torch.Tensor:
    """Transpose the trailing two axes."""
    return x.transpose(-1, -2)


def symmetrize(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (x + mT(x))


def cholesky(x: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN for a matrix that is not positive-definite,
    as ``jnp.linalg.cholesky`` returns.  ``torch.linalg.cholesky_ex`` skips
    the error check, so the host does not wait for the card."""
    chol, info = torch.linalg.cholesky_ex(x)
    return torch.where((info != 0)[..., None, None], torch.nan, chol)


def cho_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``L L^T x = b`` given lower-triangular ``L`` (batched)."""
    vec = b.dim() == chol.dim() - 1
    if vec:
        b = b[..., None]
    y = torch.linalg.solve_triangular(chol, b, upper=False)
    x = torch.linalg.solve_triangular(mT(chol), y, upper=True)
    return x[..., 0] if vec else x


def tri_logdet(chol: torch.Tensor) -> torch.Tensor:
    """``log det(L L^T)`` from the Cholesky factor ``L``."""
    return 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)


def _eye_like(H: torch.Tensor) -> torch.Tensor:
    return torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)


def regularize_spd(H: torch.Tensor, eps: float, mode: str) -> torch.Tensor:
    """Guard a nominally-PD matrix before solving.

    ``"none"`` trusts PD-ness; ``"jitter"`` adds ``eps * mean(diag(H)) * I``
    (scale-invariant); ``"eigh"`` lifts the smallest eigenvalue to ``eps``
    (reference parity, non-smooth at degenerate spectra).
    """
    if mode == "none":
        return H
    if mode == "jitter":
        scale = torch.diagonal(H, dim1=-2, dim2=-1).mean(-1)
        lift = eps * (scale + 1e-30)
        return H + lift[..., None, None] * _eye_like(H)
    if mode == "eigh":
        # eigvalsh checks convergence on the host: a sync on the card
        evals = torch.linalg.eigvalsh(H)
        lift = torch.clamp(eps - evals[..., 0], min=0.0)
        return H + lift[..., None, None] * _eye_like(H)
    raise ValueError(f"unknown regularization mode: {mode!r}")
