"""K3 and K4: fused conditioned and marginalized trajectory likelihood on the
card, and its analytic adjoint.

K3 replaces ``lqg_tpu/ops/pallas/likelihood.py:_ll_fwd_kernel`` (via
``_ll_fwd_call``), K4 replaces ``likelihood.py:_ll_bwd_kernel`` (via
``_ll_bwd_call``).  :func:`conditioned_log_likelihood_fused` joins them in a
``torch.autograd.Function``, the counterpart of the JAX ``custom_vjp`` of
the same name.  Kernel source: ``lqg_tpu_torch/csrc/likelihood.cu``.

What it computes, per lane (one parameter set ``p``, one trial ``i``):

    init:  Sigma_0 = Q_0,  mu_0 = [x_0; 0]
    t = 0..T-1:
        S = Sigma[:d,:d]; Sinv = S^-1 (closed form, eps on the determinant)
        e = x_t - mu[:d]
        if t >= 1:  quad += e^T Sinv e;  ld += log det S   (Neumaier)
        FS = F_t Sigma;  P = FS[:, :d];  J = P Sinv
        mu    <- F_t mu + J e
        Sigma <- sym(FS F_t^T + Q_t - J P^T)
    final: score x_T against (Sigma_T, mu_T)
    ll = -0.5 ((qc + lc + quad_T + log det S_T) + quad + ld + T d log 2pi)

What bounds it on an H100: latency.  At the main path's 24 parameter sets
x 20 trials there are 480 threads in all, each walking a T-step chain of
dependent scalar operations, while the work itself (~7 MB read, ~0.2
GFLOP at T=1000) would take the card a few microseconds (``chip_smoke.py``
computes the bound).  The carry stays in registers, F and Q are indexed
by parameter set, so the trials of one set read the same addresses (the
Pallas layout copies them per trial), and there is no time chunking.  Sharing the data-free covariance recursion across a set's
trials, and so running fewer, shorter chains, is left for a later change.

K4 (:func:`conditioned_log_likelihood_vjp`) runs the reverse recursion
per lane from the carries K3 stores on the gradient path (``Sigma_t``,
``mu_t`` for ``t = 0..T``), writing per-lane cotangents of ``F`` and ``Q``
that the wrapper sums over trials (no atomics, so the sum's order is fixed)
and the data cotangent of every ``x_t``.  It is latency-bound for the same
reason as K3.

The plain PyTorch versions :func:`conditioned_log_likelihood_reference` and
:func:`conditioned_log_likelihood_vjp_reference` repeat the arithmetic
(same closed-form inverses, same ``eps``, same Neumaier order); the
wrappers take them only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as nnf
from torch.autograd.function import once_differentiable

from lqg_tpu_torch.ops.linalg import mT
from lqg_tpu_torch.ops.kernels import nvcc
from lqg_tpu_torch.ops.kernels.gains import EPS, _on_card, _sym, _sym_inv_det

_LOG_2PI = math.log(2.0 * math.pi)

# (j, d) instantiated in csrc/likelihood.cu: every dim=1 tracking model
# (4, 2), and the SubjectiveActor's 2 + 3 joint states (5, 2)
INSTANCES = frozenset({(4, 2), (5, 2)})


def _neumaier_add(s, comp, v):
    """Compensated ``s += v`` keeping the lost low bits in ``comp``."""
    t = s + v
    comp = comp + torch.where(s.abs() >= v.abs(), (s - t) + v, (v - t) + s)
    return t, comp


def _score(Sigma, mu, x, d):
    """``(e^T S^-1 e, det S)`` of ``x`` against ``(Sigma[:d,:d], mu[:d])``,
    the quadratic form summed in row order; also ``S^-1`` and ``e``."""
    Sinv, det = _sym_inv_det(Sigma[..., :d, :d])
    e = x - mu[..., :d]
    Se = (Sinv @ e[..., None])[..., 0]
    quad = e[..., 0] * Se[..., 0]
    for r in range(1, d):
        quad = quad + e[..., r] * Se[..., r]
    return quad, det, Sinv, e


def conditioned_log_likelihood_reference(F: torch.Tensor, Q: torch.Tensor,
                                         X: torch.Tensor,
                                         stores: bool = False):
    """Plain PyTorch version of K3: batched over lanes, a Python loop over
    T.  Same contract as :func:`conditioned_log_likelihood_fused`, any
    float dtype; with ``stores`` it also returns K3's stores, the carries
    ``(Sigma_t, mu_t)``, ``t = 0..T``, per lane: ``(P, n, T+1, j, j)`` and
    ``(P, n, T+1, j)``."""
    P_, T, j, _ = F.shape
    n, d = X.shape[1], X.shape[-1]
    Fl, Ql = F[:, None], Q[:, None]  # one schedule per parameter set
    Sigma = Ql[:, :, 0].expand(P_, n, j, j)
    mu = nnf.pad(X[:, :, 0], (0, j - d))
    zero = X.new_zeros((P_, n))
    quad_acc = ld_acc = quad_c = ld_c = zero
    Sigmas, mus = [], []
    for t in range(T):
        Sigmas.append(Sigma)
        mus.append(mu)
        quad, det, Sinv, e = _score(Sigma, mu, X[:, :, t], d)
        mask = 1.0 if t >= 1 else 0.0
        quad_acc, quad_c = _neumaier_add(quad_acc, quad_c, mask * quad)
        ld_acc, ld_c = _neumaier_add(ld_acc, ld_c, mask * torch.log(det))
        F_t, Q_t = Fl[:, :, t], Ql[:, :, t]
        FS = F_t @ Sigma
        Pm = FS[..., :d]
        J = Pm @ Sinv
        mu = (F_t @ mu[..., None])[..., 0] + (J @ e[..., None])[..., 0]
        Sigma = _sym((FS @ mT(F_t) + Q_t) - J @ mT(Pm))
    quad, det, _, _ = _score(Sigma, mu, X[:, :, T], d)
    # fold the compensation terms (small) before the large partials
    total = (quad_c + ld_c + quad + torch.log(det)) + quad_acc + ld_acc \
        + T * d * _LOG_2PI
    ll = -0.5 * total
    if not stores:
        return ll
    Sigmas.append(Sigma)
    mus.append(mu)
    return ll, torch.stack(Sigmas, 2), torch.stack(mus, 2)


def conditioned_log_likelihood_vjp_reference(F, X, w, Sig_st, mu_st):
    """Plain PyTorch version of K4: batched over lanes, a Python loop over
    T.  Same contract as :func:`conditioned_log_likelihood_vjp`, any float
    dtype."""
    P_, T, j, _ = F.shape
    d = X.shape[-1]
    w = w[..., None, None]  # (P, n, 1, 1)
    vec = lambda v: v[..., None]  # (..., k) as a column (..., k, 1)
    row = lambda v: v[..., None, :]

    # seed: adjoint of the final score on (Sigma_T, mu_T)
    _, _, Sinv, e = _score(Sig_st[:, :, T], mu_st[:, :, T], X[:, :, T], d)
    Se = Sinv @ vec(e)  # (P, n, d, 1)
    mbar = nnf.pad(w * Se, (0, 0, 0, j - d))
    xbar_T = (-w * Se)[..., 0]
    Sbar = nnf.pad(0.5 * w * (Se @ mT(Se) - Sinv), (0, j - d, 0, j - d))

    Fbars, Qbars, Xbars = [], [], [xbar_T]
    for t in range(T - 1, -1, -1):
        Sigma, mu = Sig_st[:, :, t], vec(mu_st[:, :, t])
        F_t = F[:, None, t]
        # recompute the forward intermediates
        _, _, Sinv, e = _score(Sigma, mu[..., 0], X[:, :, t], d)
        e = vec(e)
        FS = F_t @ Sigma
        Pm = FS[..., :d]
        J = Pm @ Sinv

        Sbn = _sym(Sbar)
        FSbar = Sbn @ F_t
        Fbar = Sbn @ FS + mbar @ mT(mu)
        Jbar = -(Sbn @ Pm) + mbar @ mT(e)
        Pbar = -(Sbn @ J) + Jbar @ Sinv
        Sinvbar = mT(Pm) @ Jbar
        ebar = mT(J) @ mbar
        # score adjoints, masked at t = 0
        mask = 1.0 if t >= 1 else 0.0
        ebar = ebar - (Sinv @ e) * (mask * w)
        Sinvbar = Sinvbar - (e @ mT(e)) * (mask * 0.5 * w)
        Sb = -(Sinv @ (Sinvbar @ Sinv)) - Sinv * (mask * 0.5 * w)
        mubar = mT(F_t) @ mbar
        mubar = torch.cat([mubar[..., :d, :] - ebar, mubar[..., d:, :]], -2)
        # data cotangent: x_0 also reaches the init mu_0 = [x_0; 0]
        xbar = ebar + mubar[..., :d, :] if t == 0 else ebar
        Xbars.append(xbar[..., 0])
        FSbar = FSbar + nnf.pad(Pbar, (0, j - d))
        Fbar = Fbar + FSbar @ Sigma
        Sbar = mT(F_t) @ FSbar + nnf.pad(_sym(Sb), (0, j - d, 0, j - d))
        # t = 0: Sigma_0 = Q_0, so the carry's cotangent folds into Qbar_0
        Qbar = Sbn + _sym(Sbar) if t == 0 else Sbn
        Fbars.append(Fbar)
        Qbars.append(Qbar)
        mbar = mubar
    Fbar = torch.stack(Fbars[::-1], 2).sum(1)
    Qbar = torch.stack(Qbars[::-1], 2).sum(1)
    return Fbar, Qbar, torch.stack(Xbars[::-1], 2)


def fused_ll_available(j: int, d: int, dtype) -> bool:
    """Kernel scope: an instantiated (j, d) in float32."""
    return (j, d) in INSTANCES and dtype == torch.float32


def _lib():
    lib = nvcc.load("likelihood")
    lib.lqg_ll_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                               + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    lib.lqg_ll_fwd.restype = ctypes.c_int
    lib.lqg_ll_bwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                               + [ctypes.c_float, ctypes.c_void_p])
    lib.lqg_ll_bwd.restype = ctypes.c_int
    return lib


def ll_fwd(F, Q, X, stores: bool = False):
    """K3 on checked inputs: ``ll (P, n)`` and, with ``stores``, the
    carries ``(Sigma_t, mu_t)`` K4 reads.  A CUDA tensor launches the
    kernel (float32) or raises; a CPU tensor takes the plain version."""
    if not _on_card((F, Q, X), "fused likelihood"):
        return conditioned_log_likelihood_reference(F, Q, X, stores)
    P_, T, j, _ = F.shape
    n, d = X.shape[1], X.shape[-1]
    F, Q, X = F.contiguous(), Q.contiguous(), X.contiguous()
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=F.device)
    ll = new(P_, n)
    st = (new(P_, n, T + 1, j, j), new(P_, n, T + 1, j)) if stores else ()
    status = _lib().lqg_ll_fwd(
        F.data_ptr(), Q.data_ptr(), X.data_ptr(), ll.data_ptr(),
        *([x.data_ptr() for x in st] if stores else [None, None]),
        j, d, P_, n, T, EPS, T * d * _LOG_2PI,
        torch.cuda.current_stream(F.device).cuda_stream)
    nvcc.check(status, "ll_fwd")
    conditioned_log_likelihood_fused.launches += 1
    return (ll,) + st if stores else ll


def conditioned_log_likelihood_vjp(F, X, w, Sig_st, mu_st):
    """K4: the cotangents of K3's inputs from ``w``, that of its output.

    Args:
        F: ``(P, T, j, j)`` joint transitions; X: ``(P, n, T+1, d)``.
        w: ``(P, n)`` cotangent of the per-trial log likelihoods.
        Sig_st, mu_st: K3's stores, ``(P, n, T+1, j, j)`` and ``(P, n,
            T+1, j)``.

    Returns ``(Fbar, Qbar)``, each ``(P, T, j, j)`` and summed over trials,
    and ``Xbar (P, n, T+1, d)``.  A CUDA tensor launches the kernel
    (float32) or raises; a CPU tensor takes the plain version.
    """
    ins = (F, X, w, Sig_st, mu_st)
    if not _on_card(ins, "fused likelihood adjoint"):
        return conditioned_log_likelihood_vjp_reference(*ins)
    P_, T, j, _ = F.shape
    n, d = X.shape[1], X.shape[-1]
    ins = [x.contiguous() for x in ins]
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=F.device)
    Fbar, Qbar, Xbar = new(P_, n, T, j, j), new(P_, n, T, j, j), \
        new(P_, n, T + 1, d)
    status = _lib().lqg_ll_bwd(
        *(x.data_ptr() for x in ins), Fbar.data_ptr(), Qbar.data_ptr(),
        Xbar.data_ptr(), j, d, P_, n, T, EPS,
        torch.cuda.current_stream(F.device).cuda_stream)
    nvcc.check(status, "ll_bwd")
    conditioned_log_likelihood_vjp.launches += 1
    # per-lane cotangents summed over each parameter set's trials
    return Fbar.sum(1), Qbar.sum(1), Xbar


class _FusedLikelihood(torch.autograd.Function):
    """K3 forward, K4 backward."""

    @staticmethod
    def forward(ctx, F, Q, X):
        if not any(ctx.needs_input_grad):
            return ll_fwd(F, Q, X)
        ll, Sig_st, mu_st = ll_fwd(F, Q, X, stores=True)
        ctx.save_for_backward(F, X, Sig_st, mu_st)
        return ll

    @staticmethod
    @once_differentiable
    def backward(ctx, w):
        F, X, Sig_st, mu_st = ctx.saved_tensors
        return conditioned_log_likelihood_vjp(F, X, w, Sig_st, mu_st)


def conditioned_log_likelihood_fused(F: torch.Tensor, Q: torch.Tensor,
                                     X: torch.Tensor):
    """Marginalized trajectory log likelihood, fused and differentiable.

    Args:
        F: ``(P, T, j, j)`` joint (state, belief) transition schedules.
        Q: ``(P, T, j, j)`` joint noise covariances ``G G^T``.
        X: ``(P, n, T+1, d)`` observed trajectories (first ``d`` joint dims).

    Returns ``(P, n)`` per-trial log likelihoods of ``X[..., 1:, :]``, the
    quantity of :func:`lqg_tpu_torch.ops.gaussian.trial_log_likelihood`.
    A CUDA tensor launches K3 (float32) and, for the gradient, K4, or
    raises; a CPU tensor takes their plain versions.
    """
    if F.dim() != 4 or Q.shape != F.shape or X.dim() != 4:
        raise ValueError("expected F, Q (P, T, j, j) and X (P, n, T+1, d)")
    P_, T, j, _ = F.shape
    d = X.shape[-1]
    if X.shape[0] != P_ or X.shape[2] != T + 1:
        raise ValueError(f"X {tuple(X.shape)} does not match F "
                         f"{tuple(F.shape)}: expected ({P_}, n, {T + 1}, d)")
    if (j, d) not in INSTANCES:
        raise ValueError(f"(j, d) = {(j, d)} outside the kernel's scope "
                         f"{sorted(INSTANCES)}")
    return _FusedLikelihood.apply(F, Q, X)


conditioned_log_likelihood_fused.launches = 0
conditioned_log_likelihood_vjp.launches = 0
