"""Associative (parallel-in-time) scans for the Riccati recursions and the
conditioned likelihood (port of :mod:`lqg_tpu.parallel.pscan`).

Both Riccati-type recursions, and the data-conditioned filter of the
likelihood, are rewritten as associative compositions of per-step elements,
so that :func:`associative_scan` evaluates them in O(log T) rounds of
batched tensor ops instead of T dependent steps, and a horizon split over
ranks can be stitched back together
(:func:`lqg_tpu_torch.parallel.sharding.sequence_parallel_log_likelihood`).

Every covariance/value Riccati step is a linear-fractional map

    Phi(X) = C + A_e (I + X J)^{-1} X A_e^T

and these maps are closed under composition:

    (Phi_j o Phi_i):  A = A_j (I + C_i J_j)^{-1} A_i
                      C = A_j (I + C_i J_j)^{-1} C_i A_j^T + C_j
                      J = A_i^T (I + J_j C_i)^{-1} J_j A_i + J_i

Requirements as in the JAX package: ``W W^T`` and ``R`` invertible, affine
cost terms zero.  Layouts are the JAX package's, time leading ``(T, ...,
j, j)``; leading batch axes (``P`` parameter sets) broadcast.

Nothing here waits for the card: the solves are ``torch.linalg.solve_ex``
and the triangular solves and Cholesky factors of
:mod:`lqg_tpu_torch.ops.linalg`, which give NaN where ``lqg_tpu`` gives NaN
instead of raising.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from lqg_tpu_torch.spec import LQGSpec
from lqg_tpu_torch.ops.gaussian import _LOG_2PI, _trials_last
from lqg_tpu_torch.ops.linalg import (_eye_like as _eye, mT, cho_solve,
                                     cholesky, psd_solve, symmetrize)
from lqg_tpu_torch.ops.riccati import Gains


def _flatten(elems):
    """The leaves of ``elems`` (a tensor or a tuple of tensors) and the
    function that rebuilds its structure from leaves."""
    if torch.is_tensor(elems):
        return [elems], lambda leaves: leaves[0]
    kind = type(elems)
    if kind is tuple:
        return list(elems), tuple
    return list(elems), lambda leaves: kind(*leaves)


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """``even[0], odd[0], even[1], odd[1], ...`` along dim 0, where
    ``even`` has as many entries as ``odd`` or one more."""
    n = odd.shape[0]
    out = torch.stack([even[:n], odd], 1).flatten(0, 1)
    return torch.cat([out, even[n:]]) if even.shape[0] > n else out


def associative_scan(fn: Callable, elems, reverse: bool = False):
    """Inclusive scan of ``elems`` (a tensor or a NamedTuple of tensors that
    share dim 0) under the associative ``fn(a, b)``: entry ``k`` is
    ``fn(...fn(fn(e_0, e_1), e_2)..., e_k)``; with ``reverse``, entry ``k``
    combines ``e_k`` with everything after it, the later element first
    (``[..., fn(fn(z, y), x), fn(z, y), z]``).

    The odd/even recursion of ``jax.lax.associative_scan``: pairs are
    combined, the half-length scan recurses, and the even entries are
    formed from the odd ones, so that every combination takes the same
    operands in the same order as under JAX."""
    leaves, build = _flatten(elems)
    if reverse:
        leaves = [torch.flip(x, (0,)) for x in leaves]

    def combine(a, b):
        return _flatten(fn(build(a), build(b)))[0]

    def scan(xs):
        n = xs[0].shape[0]
        if n < 2:
            return xs
        odd = scan(combine([x[0:-1:2] for x in xs], [x[1::2] for x in xs]))
        rest = [x[2::2] for x in xs]
        if rest[0].shape[0] == 0:  # n == 2: nothing to combine
            even = rest
        else:
            even = combine([o[:-1] for o in odd] if n % 2 == 0 else odd, rest)
        even = [torch.cat([x[:1], e]) for x, e in zip(xs, even)]
        return [_interleave(e, o) for e, o in zip(even, odd)]

    out = scan(leaves)
    if reverse:
        out = [torch.flip(x, (0,)) for x in out]
    return build(out)


def _solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A^{-1} B`` without the host check of ``torch.linalg.solve``."""
    return torch.linalg.solve_ex(A, B)[0]


def _common_batch(elems):
    """``elems`` with every leaf expanded to the broadcast of the leaves'
    batch axes (those between dim 0 and the trailing two)."""
    leaves, build = _flatten(elems)
    batch = torch.broadcast_shapes(*(x.shape[1:-2] for x in leaves))
    return build([x.expand(x.shape[:1] + batch + x.shape[-2:])
                  for x in leaves])


class RicattiElement(NamedTuple):
    A: torch.Tensor
    C: torch.Tensor
    J: torch.Tensor


def _compose(first: RicattiElement, second: RicattiElement) -> RicattiElement:
    """Composition ``second o first`` (apply ``first``, then ``second``)."""
    Ai, Ci, Ji = first
    Aj, Cj, Jj = second
    n = Ai.shape[-1]
    eye = _eye(Ai)
    M = _solve(eye + Ci @ Jj, torch.cat(
        torch.broadcast_tensors(Ai, Ci), dim=-1))
    MAi, MCi = M[..., :, :n], M[..., :, n:]
    A = Aj @ MAi
    C = Aj @ MCi @ mT(Aj) + Cj
    Jn = _solve(eye + Jj @ Ci, Jj @ Ai)
    J = mT(Ai) @ Jn + Ji
    return RicattiElement(A=A, C=symmetrize(C), J=symmetrize(J))


def _apply(e: RicattiElement, X: torch.Tensor) -> torch.Tensor:
    Y = _solve(_eye(X) + X @ e.J, X.expand(e.J.shape[:-2] + X.shape[-2:]))
    return symmetrize(e.C + e.A @ Y @ mT(e.A))


def _tl(x: torch.Tensor, spec: LQGSpec, horizon: int) -> torch.Tensor:
    """Time-leading ``(T, ..., ., .)`` stack of a spec field."""
    if spec.A.dim() > spec.Qf.dim():  # stacked: time at -3
        return torch.movedim(x, -3, 0)
    return x[None].expand((horizon,) + x.shape)


def _horizon(spec: LQGSpec, horizon: Optional[int]) -> int:
    if horizon is not None:
        return horizon
    if spec.A.dim() > spec.Qf.dim():
        return spec.A.shape[-3]
    raise ValueError("stationary spec requires explicit horizon")


def kalman_forward_assoc(spec: LQGSpec, Sigma0: torch.Tensor,
                         horizon: Optional[int] = None) -> torch.Tensor:
    """Kalman gain schedule ``(T, ..., n, p)`` by associative scan; the
    same as :func:`lqg_tpu_torch.ops.kalman.forward`."""
    horizon = _horizon(spec, horizon)
    A, F, V, W = (_tl(x, spec, horizon) for x in (spec.A, spec.F, spec.V,
                                                   spec.W))
    Q = V @ mT(V)
    R = W @ mT(W)
    S = mT(F) @ psd_solve(R, F)

    n = A.shape[-1]
    eye = _eye(A)
    AC = _solve(eye + Q @ S, torch.cat(torch.broadcast_tensors(A, Q), -1))
    Ae = AC[..., :, :n]
    Ce = symmetrize(AC[..., :, n:])
    Je = symmetrize(mT(A) @ _solve(eye + S @ Q, S @ A))
    elems = _common_batch(RicattiElement(A=Ae, C=Ce, J=Je))

    # prefix_t = step_t o ... o step_0
    prefix = associative_scan(lambda a, b: _compose(first=a, second=b), elems)

    # P_{t|t} = prefix_t(Sigma0) for t = 0..T-1; filtered covs shifted by one
    Pf = _apply(prefix, Sigma0)
    Pf_prev = torch.cat([Sigma0.expand((1,) + Pf.shape[1:]), Pf[:-1]])

    # predicted covariance and gain at step t (pointwise, fully parallel)
    Pp = A @ Pf_prev @ mT(A) + Q
    G = symmetrize(F @ Pp @ mT(F) + R)
    return mT(psd_solve(G, F @ mT(Pp)))


def lqr_backward_assoc(spec: LQGSpec, horizon: Optional[int] = None) -> Gains:
    """LQR gains by associative scan; the same as
    :func:`lqg_tpu_torch.ops.riccati.backward` with ``regularize="none"``
    for zero affine and cross terms."""
    horizon = _horizon(spec, horizon)
    A, B, Q, R = (_tl(x, spec, horizon) for x in (spec.A, spec.B, spec.Q,
                                                   spec.R))
    SB = B @ psd_solve(R, mT(B))
    elems = _common_batch(RicattiElement(A=mT(A), C=Q, J=SB))

    # backward composition: value_t = step_t o step_{t+1} o ... o step_{T-1}
    prefix = associative_scan(lambda a, b: _compose(first=b, second=a), elems,
                              reverse=True)

    Qf = spec.Qf
    S = _apply(prefix, Qf)  # S_t for t = 0..T-1
    # gains at step t need S_{t+1}
    S_next = torch.cat([S[1:], Qf.expand((1,) + S.shape[1:])])

    H = symmetrize(R + mT(B) @ S_next @ B)
    G = mT(B) @ S_next @ A
    L = -psd_solve(H, G)
    return Gains(L=L, l=L.new_zeros(L.shape[:-1]), H=H)


class FilterElement(NamedTuple):
    """Associative element of the parallel (in-time) conditioned filter:
    the Gaussian transition potential ``p(z' | z, data) = N(z'; A z + b,
    C)`` over consecutive post-conditioning joint states and the local
    evidence ``exp(-z^T J z / 2 + z^T eta)`` on ``z``.

    ``A, C, J (..., j, j)`` are data-independent and shared by the trials;
    ``b, eta (..., j, n)`` carry the trials in their trailing columns, so
    a composition is one shared ``(j, j)`` solve plus products with ``n``
    columns."""

    A: torch.Tensor
    b: torch.Tensor
    C: torch.Tensor
    eta: torch.Tensor
    J: torch.Tensor


def _compose_filter(first: FilterElement,
                    second: FilterElement) -> FilterElement:
    """Composition ``second o first`` (``first`` covers earlier time)."""
    Ai, bi, Ci, etai, Ji = first
    Aj, bj, Cj, etaj, Jj = second
    j = Ai.shape[-1]
    eye = _eye(Ai)

    # one shared solve with stacked right-hand sides
    rhs = torch.cat([Ai, Ci, bi + Ci @ etaj], dim=-1)
    M = _solve(eye + Ci @ Jj, rhs)
    MAi, MCi, Mb = M[..., :j], M[..., j:2 * j], M[..., 2 * j:]
    A = Aj @ MAi
    b = Aj @ Mb + bj
    C = symmetrize(Aj @ MCi @ mT(Aj) + Cj)

    rhs2 = torch.cat([Jj @ Ai, etaj - Jj @ bi], dim=-1)
    N = _solve(eye + Jj @ Ci, rhs2)
    J = symmetrize(mT(Ai) @ N[..., :j] + Ji)
    eta = mT(Ai) @ N[..., j:] + etai
    return FilterElement(A=A, b=b, C=C, eta=eta, J=J)


def identity_filter(like: FilterElement) -> FilterElement:
    """The neutral element of :func:`_compose_filter` (``A = I``, the rest
    zero), one entry shaped like an entry of ``like``."""
    zeros = [torch.zeros_like(x[:1]) for x in like]
    A = _eye(like.A).expand(zeros[0].shape)
    return FilterElement(A, *zeros[1:])


def _gauss_terms(chol: torch.Tensor, e: torch.Tensor):
    """``(quad per column, logdet + d log 2pi)`` of ``N(e; 0, L L^T)``;
    ``chol (..., d, d)``, ``e (..., d, n)``."""
    w = torch.linalg.solve_triangular(chol, e, upper=False)
    quad = (w * w).sum(-2)  # (..., n)
    diag = torch.diagonal(chol, dim1=-2, dim2=-1)
    logdet = 2.0 * torch.log(diag).sum(-1) + chol.shape[-1] * _LOG_2PI
    return quad, logdet


class FilterPieces(NamedTuple):
    """What :func:`trial_log_likelihood_assoc` builds before its scan:
    ``ll1`` the score of ``x_1 | x_0``, ``(..., n)``; ``elems`` the
    elements of steps ``0..T-1`` (step 0 the filtered moments at time 1);
    ``F, EF, S`` and ``x_next``, each step ``t = 1..T-1``'s transition, its
    observed rows, the observed block of its noise covariance and the data
    ``x_{t+1}``, which the scores need."""

    ll1: torch.Tensor
    elems: Optional[FilterElement]
    F: torch.Tensor
    EF: torch.Tensor
    S: torch.Tensor
    x_next: torch.Tensor


def filter_pieces(joint, x: torch.Tensor, jitter: float = 0.0,
                  steps: Optional[slice] = None) -> FilterPieces:
    """The score of ``x_1`` and the filter elements of the conditioned
    likelihood; with ``steps``, the elements of those steps only (a slice
    of ``0..T-1``; element 0 is built only when the slice holds it)."""
    Fj, Gj = joint.F, joint.G
    d = x.shape[-1]
    T, j = Fj.shape[0], Fj.shape[-1]
    X = _trials_last(x)  # (T+1, ..., d, n)
    n = X.shape[-1]
    eye_d = (jitter * torch.eye(d, dtype=X.dtype, device=X.device)
             if jitter else 0.0)

    # init: z_0 ~ N([x_0; 0], Q_0) conditioned on x_0, propagated through
    # step 0 (reference init simplifications, system.py:210-212)
    Q0 = Gj[0] @ mT(Gj[0])
    chol_S0 = cholesky(symmetrize(Q0[..., :d, :d]) + eye_d)
    G0 = mT(cho_solve(chol_S0, Q0[..., :d, :]))  # (..., j, d)
    Sigma0c = Q0 - G0 @ Q0[..., :d, :]
    mu0 = torch.cat([X[0], X.new_zeros(X.shape[1:-2] + (j - d, n))], -2)
    m1p = Fj[0] @ mu0
    P1p = symmetrize(Fj[0] @ Sigma0c @ mT(Fj[0]) + Q0)

    # score x_1 | x_0
    chol1 = cholesky(symmetrize(P1p[..., :d, :d]) + eye_d)
    quad1, logdet1 = _gauss_terms(chol1, X[1] - m1p[..., :d, :])
    ll1 = -0.5 * (quad1 + logdet1[..., None])

    steps = slice(0, T) if steps is None else steps
    lo, hi = steps.indices(T)[:2]
    gen = slice(max(lo, 1), hi)  # generic steps t = 1..T-1 in the slice
    Ft = Fj[gen]
    Qt = Gj[gen] @ mT(Gj[gen])
    EF = Ft[..., :d, :]
    St = symmetrize(Qt[..., :d, :d]) + eye_d
    x_next = X[gen.start + 1:gen.stop + 1]  # (., ..., d, n)
    if hi <= lo:
        return FilterPieces(ll1, None, Ft, EF, St, x_next)

    chol_St = cholesky(St)
    Kt = mT(cho_solve(chol_St, Qt[..., :d, :]))  # (., ..., j, d)
    A = Ft - Kt @ EF
    C = symmetrize(Qt - Kt @ Qt[..., :d, :])
    J = symmetrize(mT(EF) @ cho_solve(chol_St, EF))
    b = Kt @ x_next
    eta = mT(EF) @ cho_solve(chol_St, x_next)
    elems = _common_batch(FilterElement(A=A, b=b, C=C, eta=eta, J=J))
    if lo == 0:
        # condition z_1 on x_1: the filtered moments at t=1
        K1 = mT(cho_solve(chol1, P1p[..., :d, :]))
        m11 = m1p + K1 @ (X[1] - m1p[..., :d, :])
        P11 = symmetrize(P1p - K1 @ P1p[..., :d, :])
        first = FilterElement(A=torch.zeros_like(P11), b=m11, C=P11,
                              eta=torch.zeros_like(m11),
                              J=torch.zeros_like(P11))
        like = elems if elems.A.shape[0] else _common_batch(
            FilterElement(*(x[None] for x in first)))
        first = FilterElement(*(f.expand(e.shape[1:])[None]
                                for f, e in zip(first, like)))
        elems = FilterElement(*(torch.cat([f, e]) for f, e in zip(first,
                                                                    elems)))
    return FilterPieces(ll1, elems, Ft, EF, St, x_next)


def step_scores(pieces: FilterPieces, m_filt: torch.Tensor,
                P_filt: torch.Tensor) -> torch.Tensor:
    """Summed over the pieces' steps, the log densities of ``x_{t+1} |
    x_{0..t}`` from the filtered moments at time ``t``, ``(..., n)``."""
    d = pieces.EF.shape[-2]
    m_pred = (pieces.F @ m_filt)[..., :d, :]
    S_pred = pieces.EF @ P_filt @ mT(pieces.EF) + pieces.S
    quad, logdet = _gauss_terms(cholesky(symmetrize(S_pred)),
                                pieces.x_next - m_pred)
    return -0.5 * (quad.sum(0) + logdet.sum(0)[..., None])


def _scan_filter(elems: FilterElement) -> FilterElement:
    # prefix_k = elem_k o ... o elem_0
    return associative_scan(lambda a, b: _compose_filter(first=a, second=b),
                            elems)


def trial_log_likelihood_assoc(joint, x: torch.Tensor,
                               jitter: float = 0.0) -> torch.Tensor:
    """Parallel-in-time marginalized trajectory likelihood: the sequential
    path's value (:func:`lqg_tpu_torch.ops.gaussian.conditional_kernel` and
    :func:`~lqg_tpu_torch.ops.gaussian.trial_log_likelihood`) with the
    data-conditioned recursion in O(log T) depth.

    Each exact conditioning (the data is the first ``d`` joint dims) is
    folded into the preceding prediction, so that every element stays
    finite.  With ``E`` the first-``d`` selector, ``Q_t = G_t G_t^T`` and
    ``S_t = E Q_t E^T``, the element of the step "propagate through ``(F_t,
    Q_t)``, then condition on ``x_{t+1}``" is

        K = Q E^T S^{-1},      A = (I - K E) F,   b = K x_{t+1},
        C = (I - K E) Q,       J = F^T E^T S^{-1} E F,
        eta = F^T E^T S^{-1} x_{t+1}.

    Args:
        joint: :class:`lqg_tpu_torch.ops.gaussian.JointSystem` (``F (T,
            ..., j, j)``, ``G (T, ..., j, c)``).
        x: observed trajectories ``(..., n, T+1, d)``, their batch axes
            those of ``joint``.

    Returns ``(..., n)`` log likelihoods of ``x[..., 1:, :]``.
    """
    pieces = filter_pieces(joint, x, jitter)
    if pieces.elems is None:
        return pieces.ll1
    prefix = _scan_filter(pieces.elems)
    # score x_{t+1} | x_{0..t} from the filtered moments at t = 1..T-1
    return pieces.ll1 + step_scores(pieces, prefix.b[:-1], prefix.C[:-1])


class AffineElement(NamedTuple):
    M: torch.Tensor
    c: torch.Tensor


def affine_scan(M: torch.Tensor, c: torch.Tensor, x0: torch.Tensor):
    """Parallel evaluation of ``x_{t+1} = M_t x_t + c_t``.

    ``M (T, n, n)``; ``c (T, n)`` or ``(T, n, k)`` batched columns.  Returns
    the stacked ``x_1..x_T``."""
    vec = c.dim() == M.dim() - 1
    if vec:
        c = c[..., None]
        x0 = x0[..., None]

    def compose(first, second):
        return AffineElement(M=second.M @ first.M,
                             c=second.M @ first.c + second.c)

    prefix = associative_scan(compose, AffineElement(M=M, c=c))
    out = prefix.M @ x0 + prefix.c
    return out[..., 0] if vec else out
