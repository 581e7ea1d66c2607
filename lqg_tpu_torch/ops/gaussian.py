"""Marginalized trajectory likelihood for partially observed LQG loops
(port of :mod:`lqg_tpu.ops.gaussian`).

The controlled state and the agent's belief form a joint linear-Gaussian
system; conditioning on the observed dims at each step and marginalizing the
belief gives a closed-form Gaussian likelihood of observed trajectories.
The covariance recursion is data-independent, so it runs once per parameter
set (:func:`conditional_kernel`) and the per-trial work is an affine mean
recursion with trials in the trailing matrix axis
(:func:`trial_log_likelihood`).

The observed dims must be the first ``obs_dim`` entries of the joint state.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as nnf

from lqg_tpu_torch.spec import LQGSpec
from lqg_tpu_torch.ops.linalg import mT, cho_solve, symmetrize
from lqg_tpu_torch.utils.numerics import kahan_sum

_LOG_2PI = math.log(2.0 * math.pi)


class JointSystem(NamedTuple):
    """Joint (state, belief) linear system, time-leading: ``F (T, ..., j,
    j)`` transition, ``G (T, ..., j, c)`` noise scale (covariance ``G
    G^T``), with the specs' parameter-set axes after the time axis."""

    F: torch.Tensor
    G: torch.Tensor


def joint_system(dynamics: LQGSpec, actor: LQGSpec, L: torch.Tensor,
                 K: torch.Tensor, horizon: int) -> JointSystem:
    """Assemble the joint (state, belief) system from gains:

        F = [[A_d,         B_d L                                        ],
             [K F_d A_d,   A_a + B_a L - K F_a A_a + K (F_d B_d - F_a B_a) L]]
        G = [[V_d,         0    ],
             [K F_d V_d,   K W_d]]

    ``L``/``K`` are time-leading ``(T, ...)``; spec matrices may be
    stationary or stacked, either with leading parameter-set axes ``(P,
    ...)``.  A spec is stacked when its ``A`` has one more axis than its
    terminal cost ``Qf`` (as ``System`` decides), so a batched stationary
    ``A (P, n, n)`` is not mistaken for ``P`` time steps.
    """

    def tl_of(spec):
        if spec.A.dim() == spec.Qf.dim():  # stationary: one step for all t
            return lambda x: x[None]
        return lambda x: torch.movedim(x, -3, 0)

    tl = tl_of(dynamics)
    A_d, B_d, F_d, V_d, W_d = (tl(dynamics.A), tl(dynamics.B), tl(dynamics.F),
                               tl(dynamics.V), tl(dynamics.W))
    tl = tl_of(actor)
    A_a, B_a, F_a = tl(actor.A), tl(actor.B), tl(actor.F)

    BdL = B_d @ L
    KFd = K @ F_d
    bottom_left = KFd @ A_d
    bottom_right = (A_a + B_a @ L - K @ (F_a @ A_a)
                    + (K @ (F_d @ B_d - F_a @ B_a)) @ L)
    blocks = (A_d, BdL, bottom_left, bottom_right)
    lead = (horizon,) + torch.broadcast_shapes(
        *(x.shape[1:-2] for x in blocks + (V_d, K)))

    def bT(x):
        return x.expand(lead + x.shape[-2:])

    A_d, BdL, bottom_left, bottom_right = (bT(x) for x in blocks)
    Fj = torch.cat([torch.cat([A_d, BdL], dim=-1),
                    torch.cat([bottom_left, bottom_right], dim=-1)], dim=-2)

    xdim, wcols = A_d.shape[-1], W_d.shape[-1]
    zeros = Fj.new_zeros(lead + (xdim, wcols))
    g_top = torch.cat([V_d.expand(lead + V_d.shape[-2:]), zeros], dim=-1)
    KFdV = KFd @ V_d
    KWd = K @ W_d
    g_bottom = torch.cat([KFdV.expand(lead + KFdV.shape[-2:]),
                          KWd.expand(lead + KWd.shape[-2:])], dim=-1)
    Gj = torch.cat([g_top, g_bottom], dim=-2)
    return JointSystem(F=Fj, G=Gj)


class ConditionalKernel(NamedTuple):
    """Data-independent part of the conditioned/marginalized recursion.

    ``M (T, ..., j, j)`` mean transition ``mu_{t+1} = M_t mu_t + J_t
    x_t``; ``J (T, ..., j, d)`` data gain; ``chol (T+1, ..., d, d)``
    Cholesky factors of ``Sigma_t[:d, :d]`` for ``t = 0..T``;
    ``logdet_score (...)``, ``sum_{t=1..T} log det(2 pi Sigma_t[:d, :d])``
    per parameter set.
    """

    M: torch.Tensor
    J: torch.Tensor
    chol: torch.Tensor
    logdet_score: torch.Tensor


def _obs_chol(Sigma, d, jitter):
    S = Sigma[..., :d, :d]
    if jitter:
        S = S + jitter * torch.eye(d, dtype=S.dtype, device=S.device)
    return torch.linalg.cholesky(symmetrize(S))


def _cov_step(Sigma, F, G, d, jitter):
    """One step of ``Sigma' = F Sigma F^T + G G^T - J (F Sigma)[:, :d]^T``
    with ``J = (F Sigma)[:, :d] Sigma[:d, :d]^{-1}``."""
    chol = _obs_chol(Sigma, d, jitter)
    FS = F @ Sigma
    J = mT(cho_solve(chol, mT(FS[..., :, :d])))
    Sigma_new = symmetrize(FS @ mT(F) + G @ mT(G) - J @ mT(FS[..., :, :d]))
    return Sigma_new, J, chol


def conditional_kernel(joint: JointSystem, obs_dim: int,
                       jitter: float = 0.0) -> ConditionalKernel:
    """Run the data-free covariance recursion once per parameter set
    (``Sigma_0 = G_0 G_0^T``)."""
    Fj, Gj = joint
    d = obs_dim
    Sigma = Gj[0] @ mT(Gj[0])
    Ms, Js, chols = [], [], []
    for F, G in zip(Fj, Gj):
        Sigma_next, J, chol = _cov_step(Sigma, F, G, d, jitter)
        # mean transition: mu' = F mu + J (x - mu[:d]) = (F - J E) mu + J x
        Ms.append(F - nnf.pad(J, (0, F.shape[-1] - d)))
        Js.append(J)
        chols.append(chol)
        Sigma = Sigma_next
    chols.append(_obs_chol(Sigma, d, jitter))
    chols = torch.stack(chols)

    diag = torch.diagonal(chols[1:], dim1=-2, dim2=-1)
    # compensated: this scalar multiplies every trial, so its rounding error
    # enters the total likelihood coherently (x n_trials)
    logdet_score = (kahan_sum((2.0 * torch.log(diag)).sum(-1))
                    + (chols.shape[0] - 1) * d * _LOG_2PI)
    return ConditionalKernel(M=torch.stack(Ms), J=torch.stack(Js), chol=chols,
                             logdet_score=logdet_score)


def _init_mean(x0: torch.Tensor, joint_dim: int) -> torch.Tensor:
    """``mu_0 = [x_0, 0...]`` (reference ``system.py:210-211``)."""
    return nnf.pad(x0, (0, joint_dim - x0.shape[-1]))


def _trials_last(x: torch.Tensor) -> torch.Tensor:
    """``x (..., n, T+1, d)`` as ``(T+1, ..., d, n)``: time leading, trials
    in the trailing matrix axis."""
    return torch.movedim(torch.movedim(x, -3, -1), -3, 0)


def _mean_scan(kernel: ConditionalKernel, x: torch.Tensor) -> torch.Tensor:
    """``mu_t`` for ``t = 1..T`` of trajectories ``x (..., n, T+1, d)``,
    with trials in the trailing axis: ``(T, ..., j, n)``."""
    M, J = kernel.M, kernel.J
    X = _trials_last(x)  # (T+1, ..., d, n)
    MU = mT(_init_mean(x[..., 0, :], M.shape[-1]))  # (..., j, n)
    mus = []
    for t in range(M.shape[0]):
        MU = M[t] @ MU + J[t] @ X[t]
        mus.append(MU)
    return torch.stack(mus)


def trial_log_likelihood(kernel: ConditionalKernel,
                         x: torch.Tensor) -> torch.Tensor:
    """Per-trial log likelihood of ``x[..., 1:, :]`` for observed
    trajectories ``x (n, T+1, d)``, summed over time: ``(n,)``.  A kernel
    of ``P`` parameter sets takes ``x (P, n, T+1, d)`` and gives ``(P,
    n)``."""
    d = x.shape[-1]
    X = _trials_last(x)  # (T+1, ..., d, n)
    preds = _mean_scan(kernel, x)[..., :d, :]  # (T, ..., d, n)
    e = X[1:] - preds
    w = torch.linalg.solve_triangular(kernel.chol[1:], e, upper=False)
    # compensated over T: per-trial quads are O(T d) sums
    quad = kahan_sum((w * w).sum(-2), axis=0)  # (..., n)
    return -0.5 * (quad + kernel.logdet_score[..., None])


def conditional_sigma(joint: JointSystem, obs_dim: int,
                      jitter: float = 0.0) -> torch.Tensor:
    """Full conditional covariances ``Sigma_t``, ``t = 1..T``: ``(T, j, j)``."""
    Fj, Gj = joint
    Sigma = Gj[0] @ mT(Gj[0])
    out = []
    for F, G in zip(Fj, Gj):
        Sigma, _, _ = _cov_step(Sigma, F, G, obs_dim, jitter)
        out.append(Sigma)
    return torch.stack(out)


def conditional_mean(kernel: ConditionalKernel, x: torch.Tensor) -> torch.Tensor:
    """Full conditional means ``mu_t``, ``t = 1..T``, per trial: ``(n, T, j)``."""
    return torch.movedim(_mean_scan(kernel, x), -1, 0)
