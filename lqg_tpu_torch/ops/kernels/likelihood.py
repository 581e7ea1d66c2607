"""K3 and K4: fused conditioned and marginalized trajectory likelihood on the
card, and its analytic adjoint.

K3 replaces ``lqg_tpu/ops/pallas/likelihood.py:_ll_fwd_kernel`` (via
``_ll_fwd_call``), K4 replaces ``likelihood.py:_ll_bwd_kernel`` (via
``_ll_bwd_call``).  :func:`conditioned_log_likelihood_fused` joins them in a
``torch.autograd.Function``, the counterpart of the JAX ``custom_vjp`` of
the same name.  Kernel source: ``lqg_tpu_torch/csrc/likelihood.cu``.

What it computes, for parameter set ``p`` and its trials ``i``:

    init:  Sigma_0 = Q_0,  mu_0,i = [x_0,i; 0]
    t = 0..T-1:
        S = Sigma[:d,:d]; Sinv = S^-1 (closed form, eps on the determinant)
        e_i = x_t,i - mu_i[:d]
        if t >= 1:  quad_i += e_i^T Sinv e_i;  ld += log det S   (Neumaier)
        FS = F_t Sigma;  P = FS[:, :d];  J = P Sinv
        mu_i  <- F_t mu_i + J e_i
        Sigma <- sym(FS F_t^T + Q_t - J P^T)
    final: score x_T against (Sigma_T, mu_T)
    ll_i = -0.5 ((qc_i + lc + quad_T,i + log det S_T) + quad_i + ld
                 + T d log 2pi)

The split the kernels rest on: ``Sigma``, ``Sinv``, ``log det S``, ``FS``,
``P`` and ``J`` depend on ``(F, Q)`` alone, so they run once per set; only
the mean, ``e`` and the quadratic form are per trial.  The per-set
log-det Neumaier sum is the very sequence each (set, trial) lane of the JAX
kernel computes.  In the adjoint the mean's chain is per trial and never
reads the covariance's cotangent, while the covariance's cotangent is
linear in its per-trial sources with data-free coefficients: its sum over
trials follows the same recursion, fed with four trial sums a step
(``sum mb' mu^T``, ``sum mb' e^T``, ``sum mask w e e^T``, ``sum mask w``;
see :func:`conditioned_log_likelihood_vjp_reference`), so ``F-bar`` and
``Q-bar`` come out once per set.

The kernels: one thread block per set.  A copy warp stages chunks of F_t,
Q_t (K4: Sigma_t) and the trials' data into shared-memory rings with
``cp.async`` on mbarriers; a covariance warp runs the data-free chain with
the matrix spread over its lanes and publishes ``J_t``, ``S_t^-1`` ahead of
the trials; the trials are threads of the block (up to 128, each carrying
several trials beyond that), reading those as broadcasts.  What bounds them
on an H100 is latency: the work (K3 ~3 MB at 24 sets x 20 trials, T=1000)
takes the card microseconds, and the time is one set's chain of dependent
steps (``chip_smoke.py`` computes the bound).  K4's trial warps reduce
their sums in a fixed order (a shuffle transpose, then the warps in turn),
without atomics.

Stores, what ``ctx.save_for_backward`` holds: ``Sigma_t`` once per set,
``(P, T+1, j, j)``, and ``mu_t`` trial-fastest, ``(P, T+1, j, n)``.

The scope is lqg_tpu's (``likelihood.py:456-460``): j <= 12, d <= 4 in
float32.  K3 and K4 are templates on (j, d), built at the instances of
:data:`PART`: the zoo's, the delay wrapper's (12, 2), and at j = 12 an
envelope for each d.  Any other (j, d) in scope is padded with zeros in j
onto the smallest instance with its d (:func:`instance_for`), and the
wrappers slice the padded entries away.  The padding is exact: F and Q are
zero in the padded block and mu_0 is zero there, so the padded joint states
keep a zero covariance and mean, are never observed, and leave the
quadratic form, the log det and the real rows of J as they are; every extra
term of a sum is a product with a zero.

The plain PyTorch versions :func:`conditioned_log_likelihood_reference` and
:func:`conditioned_log_likelihood_vjp_reference` repeat the arithmetic
(same closed-form inverses, same ``eps``, same Neumaier and fold order,
same order of the trial sums); the wrappers take them only for tensors on
the CPU, padded as the kernels would be.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as nnf
from torch.autograd.function import once_differentiable

from lqg_tpu_torch.ops.linalg import mT
from lqg_tpu_torch.ops.kernels import nvcc
from lqg_tpu_torch.ops.kernels.gains import (EPS, _grow, _on_card, _sym,
                                             _sym_inv_det)

_LOG_2PI = math.log(2.0 * math.pi)

# The (j, d) instantiated in csrc/likelihood.cu, each with the part of the
# source (nvcc.PARTS) whose library holds it.  Part 0, the zoo: every dim=1
# tracking model (4, 2), the SubjectiveActor's 2 + 3 joint states (5, 2),
# PointMass (8, 2) or (8, 4) by the dims observed, the dim=2 tracking
# models (8, 4), Hand (10, 2) and SubjectiveActor(dim=2) (10, 4).  Parts
# 1-2, j = 12: TemporalDelayModel at delay 2 around the dim=1 models (12,
# 2), RelativeObservationBoundedActor(dim=3) (12, 3), and the envelopes for
# the other d of the scope.
PART = {(4, 2): 0, (5, 2): 0, (8, 2): 0, (8, 4): 0, (10, 2): 0, (10, 4): 0,
        (12, 2): 1, (12, 1): 1, (12, 3): 2, (12, 4): 2}
INSTANCES = frozenset(PART)
# lqg_tpu's kernel scope (lqg_tpu/ops/pallas/likelihood.py:456-460)
MAX_J, MAX_D = 12, 4


def in_scope(j: int, d: int) -> bool:
    return 1 <= j <= MAX_J and 1 <= d <= MAX_D


def instance_for(j: int, d: int):
    """The instance K3 and K4 launch for ``(j, d)``: itself where it is
    instantiated, else the smallest instance with its d and more joint
    states, onto which the inputs are padded with zeros; None outside the
    scope."""
    if not in_scope(j, d):
        return None
    return min(k for k in INSTANCES if k[1] == d and k[0] >= j)


MAX_TRIAL_THREADS = 128  # csrc/likelihood.cu kMaxTrialThreads


def trial_threads(n: int) -> int:
    """Threads of a block that run trials: ``n`` rounded up to a warp, at
    most :data:`MAX_TRIAL_THREADS` (then each carries several trials)."""
    return min(-(-n // 32) * 32, MAX_TRIAL_THREADS)


def _neumaier_add(s, comp, v):
    """Compensated ``s += v`` keeping the lost low bits in ``comp``."""
    t = s + v
    comp = comp + torch.where(s.abs() >= v.abs(), (s - t) + v, (v - t) + s)
    return t, comp


def _quad(e, Se):
    """``e^T S^-1 e`` summed in row order, from ``e`` and ``S^-1 e``."""
    quad = e[..., 0] * Se[..., 0]
    for r in range(1, e.shape[-1]):
        quad = quad + e[..., r] * Se[..., r]
    return quad


def _apply(M, v):
    """``M v`` for per-set matrices ``M (P, a, b)`` and per-trial vectors
    ``v (P, n, b)``."""
    return (M[:, None] @ v[..., None])[..., 0]


def _trial_sum(v: torch.Tensor, nt: int) -> torch.Tensor:
    """Sum of ``v (P, n, ...)`` over the trial axis in K4's order: trial
    ``g nt + 32 w + l`` is lane ``l`` of trial warp ``w`` in group ``g``;
    a warp's lanes fold by halving (lane l + o onto l, o = 16, 8, 4, 2, 1:
    the xor tree of the shuffle transpose), each warp adds its groups in
    turn, and the warps are added in turn."""
    P_, n = v.shape[:2]
    groups = -(-n // nt)
    v = nnf.pad(v.movedim(1, -1), (0, groups * nt - n)).movedim(-1, 1)
    v = v.reshape(P_, groups, nt // 32, 32, *v.shape[2:])
    for off in (16, 8, 4, 2, 1):
        v = v[:, :, :, :off] + v[:, :, :, off:2 * off]
    v = v[:, :, :, 0]
    acc = v[:, 0]
    for g in range(1, groups):
        acc = acc + v[:, g]
    out = acc[:, 0]
    for w in range(1, nt // 32):
        out = out + acc[:, w]
    return out


def conditioned_log_likelihood_reference(F: torch.Tensor, Q: torch.Tensor,
                                         X: torch.Tensor,
                                         stores: bool = False):
    """Plain PyTorch version of K3: the covariance recursion once per set,
    the means batched over trials, a Python loop over T.  Same contract as
    :func:`conditioned_log_likelihood_fused`, any float dtype; with
    ``stores`` it also returns K3's stores, the carries ``Sigma_t``
    ``(P, T+1, j, j)`` and ``mu_t`` ``(P, T+1, j, n)``, ``t = 0..T``."""
    P_, T, j, _ = F.shape
    d = X.shape[-1]
    Sigma = Q[:, 0]
    mu = nnf.pad(X[:, :, 0], (0, j - d))
    quad_acc = quad_c = X.new_zeros(X.shape[:2])
    ld_acc = ld_c = X.new_zeros((P_,))
    Sigmas, mus = [], []
    for t in range(T):
        Sigmas.append(Sigma)
        mus.append(mu)
        Sinv, det = _sym_inv_det(Sigma[:, :d, :d])
        e = X[:, :, t] - mu[..., :d]
        mask = 1.0 if t >= 1 else 0.0
        quad_acc, quad_c = _neumaier_add(quad_acc, quad_c,
                                         mask * _quad(e, _apply(Sinv, e)))
        ld_acc, ld_c = _neumaier_add(ld_acc, ld_c, mask * torch.log(det))
        F_t = F[:, t]
        FS = F_t @ Sigma
        Pm = FS[..., :d]
        J = Pm @ Sinv
        mu = _apply(F_t, mu) + _apply(J, e)
        Sigma = _sym((FS @ mT(F_t) + Q[:, t]) - J @ mT(Pm))
    Sinv, det = _sym_inv_det(Sigma[:, :d, :d])
    e = X[:, :, T] - mu[..., :d]
    quad = _quad(e, _apply(Sinv, e))
    # fold the compensation terms (small) before the large partials
    total = (quad_c + ld_c[:, None] + quad + torch.log(det)[:, None]) \
        + quad_acc + ld_acc[:, None] + T * d * _LOG_2PI
    ll = -0.5 * total
    if not stores:
        return ll
    Sigmas.append(Sigma)
    mus.append(mu)
    return ll, torch.stack(Sigmas, 1), mT(torch.stack(mus, 1))


def conditioned_log_likelihood_vjp_reference(F, X, w, Sig_st, mu_st):
    """Plain PyTorch version of K4: the mean's cotangent batched over
    trials, the covariance's once per set from four trial sums a step, a
    Python loop over T.  Same contract as
    :func:`conditioned_log_likelihood_vjp`, any float dtype.

    Per step, with ``mb'`` the mean's cotangent entering it and ``mw =
    mask w``: the sums ``A = sum mb' mu^T``, ``B = sum mb' e^T``, ``C =
    sum mw e e^T``, ``sw = sum mw`` (:func:`_trial_sum`); then

        Sbn = sym(Sb');  F-bar = Sbn FS + A + FS-bar Sigma
        J-bar = -(Sbn FS)[:, :d] + B;  P-bar = -(Sbn J) + J-bar S^-1
        FS-bar = Sbn F + [P-bar, 0]
        S^-1-bar = P^T J-bar - C/2;  S-bar = -S^-1 S^-1-bar S^-1 - S^-1 sw/2
        Sb = F^T FS-bar + [sym(S-bar), 0; 0, 0];  Q-bar = Sbn (+ sym(Sb) at 0)

    seeded at ``t = T`` with ``Sb = sum (w/2) Se Se^T - S^-1 (sum w)/2``.
    """
    P_, T, j, _ = F.shape
    d = X.shape[-1]
    nt = trial_threads(X.shape[1])
    mus = mT(mu_st)  # (P, T+1, n, j)
    outer = lambda a, b: a[..., :, None] * b[..., None, :]
    pad = lambda M: nnf.pad(M, (0, j - d, 0, j - d))

    # seed: the adjoint of the final score on (Sigma_T, mu_T)
    Sinv, _ = _sym_inv_det(Sig_st[:, T, :d, :d])
    Se = _apply(Sinv, X[:, :, T] - mus[:, T, :, :d])
    C = _trial_sum((0.5 * w)[..., None, None] * outer(Se, Se), nt)
    sw = _trial_sum(w, nt)
    Sbar = pad(C - (0.5 * sw)[:, None, None] * Sinv)
    mbar = nnf.pad(w[..., None] * Se, (0, j - d))
    Fbars, Qbars, Xbars = [], [], [-w[..., None] * Se]
    for t in range(T - 1, -1, -1):
        Sigma, F_t, mu = Sig_st[:, t], F[:, t], mus[:, t]
        # recompute the forward intermediates
        Sinv, _ = _sym_inv_det(Sigma[:, :d, :d])
        FS = F_t @ Sigma
        Pm = FS[..., :d]
        J = Pm @ Sinv
        e = X[:, :, t] - mu[..., :d]
        mw = (1.0 if t >= 1 else 0.0) * w
        # the step's trial sums
        A = _trial_sum(outer(mbar, mu), nt)
        B = _trial_sum(outer(mbar, e), nt)
        C = _trial_sum(mw[..., None, None] * outer(e, e), nt)
        sw = _trial_sum(mw, nt)
        # the mean's cotangent, per trial
        ebar = _apply(mT(J), mbar) - _apply(Sinv, e) * mw[..., None]
        mubar = _apply(mT(F_t), mbar)
        mubar = torch.cat([mubar[..., :d] - ebar, mubar[..., d:]], -1)
        # data cotangent: x_0 also reaches the init mu_0 = [x_0; 0]
        Xbars.append(ebar + mubar[..., :d] if t == 0 else ebar)
        mbar = mubar
        # the covariance's cotangent, once per set
        Sbn = _sym(Sbar)
        FSbar = Sbn @ F_t
        SbnFS = Sbn @ FS
        Fbar = SbnFS + A
        Jbar = -SbnFS[..., :d] + B
        Pbar = -(Sbn @ J) + Jbar @ Sinv
        FSbar = FSbar + nnf.pad(Pbar, (0, j - d))
        Sinvbar = mT(Pm) @ Jbar - C * 0.5
        Sb = -(Sinv @ (Sinvbar @ Sinv)) - Sinv * (0.5 * sw)[:, None, None]
        Fbar = Fbar + FSbar @ Sigma
        Sbar = mT(F_t) @ FSbar + pad(_sym(Sb))
        # t = 0: Sigma_0 = Q_0, so the carry's cotangent folds into Qbar_0
        Fbars.append(Fbar)
        Qbars.append(Sbn + _sym(Sbar) if t == 0 else Sbn)
    return (torch.stack(Fbars[::-1], 1), torch.stack(Qbars[::-1], 1),
            torch.stack(Xbars[::-1], 2))


def fused_ll_available(j: int, d: int, dtype) -> bool:
    """Kernel scope, lqg_tpu's: j <= 12 and d <= 4 in float32."""
    return in_scope(j, d) and dtype == torch.float32


def _lib(jd):
    """The library of the part that holds instance ``jd``."""
    if jd not in PART:
        raise ValueError(f"(j, d) = {jd} outside the kernels' scope")
    lib = nvcc.load("likelihood", PART[jd])
    lib.lqg_ll_fwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                               + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    lib.lqg_ll_fwd.restype = ctypes.c_int
    lib.lqg_ll_bwd.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                               + [ctypes.c_float, ctypes.c_void_p])
    lib.lqg_ll_bwd.restype = ctypes.c_int
    return lib


def _state(P_, n, nt, per_trial, device):
    """Per-set scratch of the trial carries between time chunks, needed
    when a thread carries several trials (``n > nt``)."""
    if n <= nt:
        return None
    slots = -(-n // nt) * nt
    return torch.empty((P_, per_trial, slots), dtype=torch.float32,
                       device=device)


def _ptr(x):
    return None if x is None else x.data_ptr()


def ll_fwd(F, Q, X, stores: bool = False):
    """K3 on checked inputs: ``ll (P, n)`` and, with ``stores``, the
    carries ``Sigma_t (P, T+1, j, j)`` and ``mu_t (P, T+1, j, n)`` K4
    reads.  A CUDA tensor launches the kernel (float32) or raises; a CPU
    tensor takes the plain version."""
    P_, T, j, _ = F.shape
    n, d = X.shape[1], X.shape[-1]
    J = (instance_for(j, d) or (j,))[0]
    if J != j:  # padded onto the instance, the padding sliced away
        out = ll_fwd(_grow(F, J, J), _grow(Q, J, J), X, stores)
        if not stores:
            return out
        return out[0], out[1][..., :j, :j], out[2][..., :j, :]
    if not _on_card((F, Q, X), "fused likelihood"):
        return conditioned_log_likelihood_reference(F, Q, X, stores)
    nt = trial_threads(n)
    F, Q, X = F.contiguous(), Q.contiguous(), X.contiguous()
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=F.device)
    ll = new(P_, n)
    st = (new(P_, T + 1, j, j), new(P_, T + 1, j, n)) if stores else ()
    state = _state(P_, n, nt, j + 2, F.device)
    status = _lib((j, d)).lqg_ll_fwd(
        F.data_ptr(), Q.data_ptr(), X.data_ptr(), ll.data_ptr(),
        *([x.data_ptr() for x in st] if stores else [None, None]),
        _ptr(state), j, d, P_, n, T, nt, EPS, T * d * _LOG_2PI,
        torch.cuda.current_stream(F.device).cuda_stream)
    nvcc.check(status, "ll_fwd")
    conditioned_log_likelihood_fused.launches += 1
    return (ll,) + st if stores else ll


def conditioned_log_likelihood_vjp(F, X, w, Sig_st, mu_st):
    """K4: the cotangents of K3's inputs from ``w``, that of its output.

    Args:
        F: ``(P, T, j, j)`` joint transitions; X: ``(P, n, T+1, d)``.
        w: ``(P, n)`` cotangent of the per-trial log likelihoods.
        Sig_st, mu_st: K3's stores, ``(P, T+1, j, j)`` and
            ``(P, T+1, j, n)``.

    Returns ``(Fbar, Qbar)``, each ``(P, T, j, j)`` (summed over trials in
    the kernel), and ``Xbar (P, n, T+1, d)``.  A CUDA tensor launches the
    kernel (float32) or raises; a CPU tensor takes the plain version.
    """
    P_, T, j, _ = F.shape
    n, d = X.shape[1], X.shape[-1]
    J = (instance_for(j, d) or (j,))[0]
    if J != j:  # padded onto the instance, the padding sliced away
        Fbar, Qbar, Xbar = conditioned_log_likelihood_vjp(
            _grow(F, J, J), X, w, _grow(Sig_st, J, J), _grow(mu_st, J, n))
        return Fbar[..., :j, :j], Qbar[..., :j, :j], Xbar
    ins = (F, X, w, Sig_st, mu_st)
    if not _on_card(ins, "fused likelihood adjoint"):
        return conditioned_log_likelihood_vjp_reference(*ins)
    nt = trial_threads(n)
    ins = [x.contiguous() for x in ins]
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=F.device)
    Fbar, Qbar, Xbar = new(P_, T, j, j), new(P_, T, j, j), \
        new(P_, n, T + 1, d)
    state = _state(P_, n, nt, j, F.device)
    status = _lib((j, d)).lqg_ll_bwd(
        *(x.data_ptr() for x in ins), Fbar.data_ptr(), Qbar.data_ptr(),
        Xbar.data_ptr(), _ptr(state), j, d, P_, n, T, nt, EPS,
        torch.cuda.current_stream(F.device).cuda_stream)
    nvcc.check(status, "ll_bwd")
    conditioned_log_likelihood_vjp.launches += 1
    return Fbar, Qbar, Xbar


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
    if not in_scope(j, d):
        raise ValueError(f"(j, d) = {(j, d)} outside the kernel's scope: "
                         f"j <= {MAX_J} and d <= {MAX_D} required")
    return _FusedLikelihood.apply(F, Q, X)


conditioned_log_likelihood_fused.launches = 0
conditioned_log_likelihood_vjp.launches = 0
