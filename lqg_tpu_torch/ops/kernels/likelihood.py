"""K3: fused conditioned and marginalized trajectory likelihood on the card.

Replaces ``lqg_tpu/ops/pallas/likelihood.py:_ll_fwd_kernel`` (via
``_ll_fwd_call`` and ``conditioned_log_likelihood_fused``).  Kernel source:
``lqg_tpu_torch/csrc/likelihood.cu``.

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

The plain PyTorch version :func:`conditioned_log_likelihood_reference`
repeats the arithmetic (same closed-form inverses, same ``eps``, same
Neumaier order); the wrapper takes it only for tensors on the CPU.  There
is no gradient: K4 is not ported yet, so gradients go through
``method="scan"``.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as nnf

from lqg_tpu_torch.ops.linalg import mT
from lqg_tpu_torch.ops.kernels import nvcc
from lqg_tpu_torch.ops.kernels.gains import EPS, _sym, _sym_inv_det

_LOG_2PI = math.log(2.0 * math.pi)

# (j, d) instantiated in csrc/likelihood.cu: every dim=1 tracking model
INSTANCES = frozenset({(4, 2)})


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
                                         X: torch.Tensor):
    """Plain PyTorch version of K3: batched over lanes, a Python loop over
    T.  Same contract as :func:`conditioned_log_likelihood_fused`, any
    float dtype."""
    P_, T, j, _ = F.shape
    n, d = X.shape[1], X.shape[-1]
    Fl, Ql = F[:, None], Q[:, None]  # one schedule per parameter set
    Sigma = Ql[:, :, 0].expand(P_, n, j, j)
    mu = nnf.pad(X[:, :, 0], (0, j - d))
    zero = X.new_zeros((P_, n))
    quad_acc = ld_acc = quad_c = ld_c = zero
    for t in range(T):
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
    return -0.5 * total


def fused_ll_available(j: int, d: int, dtype) -> bool:
    """Kernel scope: an instantiated (j, d) in float32."""
    return (j, d) in INSTANCES and dtype == torch.float32


def _lib():
    lib = nvcc.load("likelihood")
    lib.lqg_ll_fwd.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                               + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    lib.lqg_ll_fwd.restype = ctypes.c_int
    return lib


def conditioned_log_likelihood_fused(F: torch.Tensor, Q: torch.Tensor,
                                     X: torch.Tensor):
    """Marginalized trajectory log likelihood, fused.

    Args:
        F: ``(P, T, j, j)`` joint (state, belief) transition schedules.
        Q: ``(P, T, j, j)`` joint noise covariances ``G G^T``.
        X: ``(P, n, T+1, d)`` observed trajectories (first ``d`` joint dims).

    Returns ``(P, n)`` per-trial log likelihoods of ``X[..., 1:, :]``, the
    quantity of :func:`lqg_tpu_torch.ops.gaussian.trial_log_likelihood`.
    A CUDA tensor launches the kernel (float32) or raises; a CPU tensor
    takes the plain version.  An input that requires grad raises.
    """
    if F.dim() != 4 or Q.shape != F.shape or X.dim() != 4:
        raise ValueError("expected F, Q (P, T, j, j) and X (P, n, T+1, d)")
    P_, T, j, _ = F.shape
    n, d = X.shape[1], X.shape[-1]
    if X.shape[0] != P_ or X.shape[2] != T + 1:
        raise ValueError(f"X {tuple(X.shape)} does not match F "
                         f"{tuple(F.shape)}: expected ({P_}, n, {T + 1}, d)")
    if (j, d) not in INSTANCES:
        raise ValueError(f"(j, d) = {(j, d)} outside the kernel's scope "
                         f"{sorted(INSTANCES)}")
    if any(x.requires_grad for x in (F, Q, X)) and torch.is_grad_enabled():
        raise NotImplementedError(
            "the fused likelihood has no backward yet; use method='scan' "
            "for gradients")
    device = F.device
    if Q.device != device or X.device != device:
        raise ValueError("F, Q and X must lie on one device")
    if device.type == "cpu":
        return conditioned_log_likelihood_reference(F, Q, X)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if any(x.dtype != torch.float32 for x in (F, Q, X)):
        raise TypeError("fused likelihood kernel takes float32 tensors")

    F, Q, X = F.contiguous(), Q.contiguous(), X.contiguous()
    ll = torch.empty((P_, n), dtype=torch.float32, device=device)
    status = _lib().lqg_ll_fwd(
        F.data_ptr(), Q.data_ptr(), X.data_ptr(), ll.data_ptr(),
        j, d, P_, n, T, EPS, T * d * _LOG_2PI,
        torch.cuda.current_stream(device).cuda_stream)
    nvcc.check(status, "ll_fwd")
    conditioned_log_likelihood_fused.launches += 1
    return ll


conditioned_log_likelihood_fused.launches = 0
