"""Small-matrix linear algebra, batch-first (port of :mod:`lqg_tpu.ops.linalg`).

State dims are tiny (2-40); every function broadcasts over leading batch axes
and solves through Cholesky factors.  Nothing here waits for the card: the
factorizations skip their host-side error checks (``cholesky_ex``,
``solve_ex``), and :func:`expm` and :func:`make_psd` replace
``torch.linalg.matrix_exp`` and ``torch.linalg.eigh``, which read their
input's norms or their error codes on the host.
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


def psd_solve(M: torch.Tensor, b: torch.Tensor,
              jitter: float = 0.0) -> torch.Tensor:
    """Solve ``M x = b`` for symmetric positive-definite ``M`` via Cholesky;
    NaN where ``M`` is not positive-definite, as ``lqg_tpu`` gives.

    ``b`` may be a matrix or (batched) vector; leading batch axes broadcast.
    """
    M = symmetrize(M)
    if jitter:
        M = M + jitter * _eye_like(M)
    return cho_solve(cholesky(M), b)


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
        lift = torch.clamp(eps - smallest_eigenvalue(H), min=0.0)
        return H + lift[..., None, None] * _eye_like(H)
    raise ValueError(f"unknown regularization mode: {mode!r}")


def smallest_eigenvalue(H: torch.Tensor) -> torch.Tensor:
    """The smallest eigenvalue of symmetric ``H (..., m, m)``, computed on
    the device with nothing read on the host (``torch.linalg.eigvalsh``
    checks its error code there, so a CUDA graph cannot capture it).

    ``m = 1``: the entry.  ``m = 2``: closed form on ``(H + H^T) / 2``, as
    ``jnp.linalg.eigvalsh`` symmetrizes, written as ``min(a, d) - b^2 /
    (|a - d| / 2 + r)`` so that a diagonal ``H`` gives its smaller entry
    exactly.  ``m > 2``: :func:`eigh_jacobi`.  At ``m >= 2`` a non-finite
    entry anywhere gives NaN, as LAPACK's symmetric eigensolver gives for
    ``jnp.linalg.eigvalsh`` (``[[nan, 0], [0, 1]]`` -> ``[nan, 1]``,
    ``[[inf, 0], [0, 1]]`` -> ``[nan, nan]``)."""
    m = H.shape[-1]
    if m == 1:
        return H[..., 0, 0]
    if m == 2:
        a, d = H[..., 0, 0], H[..., 1, 1]
        b = 0.5 * (H[..., 0, 1] + H[..., 1, 0])
        h = 0.5 * (a - d).abs()
        den = h + torch.sqrt(h * h + b * b)
        lam = torch.minimum(a, d) - b * b / torch.where(den == 0, 1.0, den)
    else:
        lam = eigh_jacobi(symmetrize(H))[0].amin(-1)
    finite = torch.isfinite(H).all(-1).all(-1)
    return torch.where(finite, lam, torch.nan)


# jax.scipy.linalg.expm's Pade numerator coefficients b_0..b_m by degree m
_PADE = {
    3: (120., 60., 12., 1.),
    5: (30240., 15120., 3360., 420., 30., 1.),
    7: (17297280., 8648640., 1995840., 277200., 25200., 1512., 56., 1.),
    9: (17643225600., 8821612800., 2075673600., 302702400., 30270240.,
        2162160., 110880., 3960., 90., 1.),
    13: (64764752532480000., 32382376266240000., 7771770303897600.,
         1187353796428800., 129060195264000., 10559470521600., 670442572800.,
         33522128640., 1323241920., 40840800., 960960., 16380., 182., 1.),
}
# per dtype: the 1-norm a Pade approximant covers unscaled, the 1-norms at
# which the degree steps up, and the degrees
_EXPM_RULE = {
    torch.float64: (5.371920351148152,
                    (1.495585217958292e-002, 2.539398330063230e-001,
                     9.504178996162932e-001, 2.097847961257068e+000),
                    (3, 5, 7, 9, 13)),
    torch.float32: (3.925724783138660,
                    (4.258730016922831e-001, 1.880152677804762e+000),
                    (3, 5, 7)),
}


def _pade(m: int, A, A2, A4, A6, eye):
    """Odd and even parts ``(U, V)`` of the degree-``m`` Pade approximant,
    in ``jax.scipy.linalg``'s order of operations."""
    b = _PADE[m]
    if m == 3:
        return A @ (b[3] * A2 + b[1] * eye), b[2] * A2 + b[0] * eye
    if m == 5:
        return (A @ (b[5] * A4 + b[3] * A2 + b[1] * eye),
                b[4] * A4 + b[2] * A2 + b[0] * eye)
    if m == 7:
        return (A @ (b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * eye),
                b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * eye)
    if m == 9:
        A8 = A6 @ A2
        return (A @ (b[9] * A8 + b[7] * A6 + b[5] * A4 + b[3] * A2
                     + b[1] * eye),
                b[8] * A8 + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * eye)
    U = A @ (A6 @ (b[13] * A6 + b[11] * A4 + b[9] * A2) + b[7] * A6
             + b[5] * A4 + b[3] * A2 + b[1] * eye)
    V = (A6 @ (b[12] * A6 + b[10] * A4 + b[8] * A2) + b[6] * A6 + b[4] * A4
         + b[2] * A2 + b[0] * eye)
    return U, V


def expm(A: torch.Tensor, max_squarings: int = 16) -> torch.Tensor:
    """Matrix exponential of ``A (..., N, N)`` by the algorithm of
    ``jax.scipy.linalg.expm``: scaling by ``2^-s``, a Pade approximant whose
    degree the unscaled 1-norm picks, ``s`` squarings, NaN where ``s``
    exceeds ``max_squarings``.

    The degree and ``s`` are chosen per matrix on the device
    (``torch.where`` over the candidates, ``max_squarings`` squarings each
    kept or not), a fixed sequence of operations: no value is read on the
    host, so the card is never waited for and a CUDA graph can capture it.
    Gradients flow through the chosen approximant and squarings, as JAX's
    do through the branch ``lax.switch`` and ``lax.cond`` take.
    """
    if A.dtype not in _EXPM_RULE:
        raise TypeError(f"expm takes float32 or float64, got {A.dtype}")
    maxnorm, conds, degrees = _EXPM_RULE[A.dtype]
    norm = A.abs().sum(-2).amax(-1)  # the 1-norm
    s = torch.clamp(torch.floor(torch.log2(norm / maxnorm)), min=0).detach()
    As = A / torch.exp2(s)[..., None, None]
    step = sum((norm >= c).to(torch.int64) for c in conds)  # jnp.digitize
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    A2 = As @ As
    A4 = A2 @ A2
    A6 = A4 @ A2
    U = V = None
    for k, m in enumerate(degrees):
        u, v = _pade(m, As, A2, A4, A6, eye)
        pick = (step == k)[..., None, None]
        U = u if U is None else torch.where(pick, u, U)
        V = v if V is None else torch.where(pick, v, V)
    R = torch.linalg.solve_ex(V - U, U + V)[0]
    for k in range(max_squarings):
        R = torch.where((s > k)[..., None, None], R @ R, R)
    return torch.where((s > max_squarings)[..., None, None], torch.nan, R)


JACOBI_SWEEPS = 6  # cyclic sweeps of eigh_jacobi: converged at n <= 4


def eigh_jacobi(S: torch.Tensor):
    """Eigenvalues and eigenvectors ``(w, Vec)`` of symmetric ``S (..., n,
    n)``, ``S = Vec diag(w) Vec^T``, by cyclic Jacobi rotations: a fixed
    number of sweeps of tensor operations, nothing read on the host.  For the
    small matrices of the model constructors (n <= 4), where
    ``torch.linalg.eigh`` checks its error code on the host.  Eigenvalues
    are not sorted; differentiate through :class:`_Eigh`."""
    n = S.shape[-1]
    like = dict(dtype=S.dtype, device=S.device)
    eye = torch.eye(n, **like)
    Vec = eye.expand(S.shape).clone()
    for _ in range(JACOBI_SWEEPS):
        for p in range(n - 1):
            for q in range(p + 1, n):
                # the rotation zeroing S[p, q] (Golub and Van Loan 8.5.2),
                # t = tan(theta) in a form without division by S[p, q]
                d = S[..., q, q] - S[..., p, p]
                a = S[..., p, q]
                r2 = d * d + 4.0 * a * a
                flat = r2 == 0  # already diagonal in (p, q)
                r = torch.sqrt(torch.where(flat, 1.0, r2))
                sign = torch.where(d >= 0, 1.0, -1.0)
                t = torch.where(flat, 0.0,
                                2.0 * sign * a / torch.where(flat, 1.0,
                                                             d.abs() + r))
                c = torch.rsqrt(1.0 + t * t)
                sn = t * c
                J = eye.expand(S.shape).clone()
                J[..., p, p] = c
                J[..., q, q] = c
                J[..., p, q] = sn
                J[..., q, p] = -sn
                S = mT(J) @ S @ J
                Vec = Vec @ J
    return torch.diagonal(S, dim1=-2, dim2=-1), Vec


class _Eigh(torch.autograd.Function):
    """``(w, Vec)`` of a symmetric matrix by :func:`eigh_jacobi`, with the
    eigendecomposition's adjoint ``S-bar = Vec (diag(w-bar) + E o (Vec^T
    Vec-bar)) Vec^T``, symmetrized, ``E[i, j] = 1 / (w[j] - w[i])`` off the
    diagonal (0 where two eigenvalues coincide), as ``jnp.linalg.eigh``'s
    derivative.  The backward is itself made of differentiable operations
    on the saved outputs, so autograd differentiates it again."""

    @staticmethod
    def forward(ctx, S):
        w, Vec = eigh_jacobi(S)
        ctx.save_for_backward(w, Vec)
        return w, Vec

    @staticmethod
    def backward(ctx, wbar, Vbar):
        w, Vec = ctx.saved_tensors
        inner = torch.zeros_like(Vec)
        if Vbar is not None:
            dw = w[..., None, :] - w[..., :, None]
            same = dw == 0
            E = torch.where(same, 0.0, 1.0 / torch.where(same, 1.0, dw))
            inner = E * (mT(Vec) @ Vbar)
        if wbar is not None:
            inner = inner + torch.diag_embed(wbar)
        return symmetrize(Vec @ inner @ mT(Vec))


class _ClipSpectrum(torch.autograd.Function):
    """``Vec diag(max(w, eps)) Vec^T`` for the spectrum ``(w, Vec)`` of the
    symmetric ``S``, with the spectral-function adjoint: ``S-bar = Vec (G o
    (Vec^T F-bar Vec)) Vec^T``, ``G`` the divided differences of ``max(.,
    eps)`` over the eigenvalues (its derivative where two coincide), the
    quantity ``jax.grad`` forms through ``jnp.linalg.eigh``.

    The gradient goes to ``S`` alone.  The backward is made of
    differentiable operations on ``w`` and ``Vec``, which reach ``S``
    through :class:`_Eigh`: a second derivative (a Hessian through
    :func:`make_psd`) takes the eigenvector terms from there."""

    @staticmethod
    def forward(ctx, S, w, Vec, eps):
        ctx.eps = eps
        ctx.save_for_backward(w, Vec)
        return (Vec * torch.clamp(w, min=eps)[..., None, :]) @ mT(Vec)

    @staticmethod
    def backward(ctx, Fbar):
        w, Vec = ctx.saved_tensors
        g = torch.clamp(w, min=ctx.eps)
        dw = w[..., :, None] - w[..., None, :]
        same = dw == 0
        # the derivative of max(w, eps): 1 above eps, 1/2 at it (as
        # jnp.maximum splits a tie), 0 below
        slope = (w > ctx.eps).to(w.dtype) + 0.5 * (w == ctx.eps).to(w.dtype)
        G = torch.where(same, 0.5 * (slope[..., :, None] + slope[..., None, :]),
                        (g[..., :, None] - g[..., None, :])
                        / torch.where(same, 1.0, dw))
        return Vec @ (G * (mT(Vec) @ Fbar @ Vec)) @ mT(Vec), None, None, None


def make_psd(M: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Clip the eigenvalues of a symmetric matrix to ``>= eps`` (port of
    ``lqg_tpu.ops.linalg.make_psd``, reference
    ``lqg/tracking/point_mass.py:130-144``), for the small matrices of the
    model constructors: the spectrum comes from :func:`eigh_jacobi`, so
    nothing waits for the card.  Differentiable twice (:class:`_Eigh`)."""
    S = symmetrize(M)
    w, Vec = _Eigh.apply(S)
    return _ClipSpectrum.apply(S, w, Vec, eps)
