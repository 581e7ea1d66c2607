"""Point-mass cursor model with exact zero-order-hold discretization (port
of :mod:`lqg_tpu.models.point_mass`).

The cursor is a continuous-time point mass with viscous damping and
first-order muscle activation, discretized exactly through the block matrix
exponential; the process noise is discretized by van Loan's method.  State
= [target, cursor position, cursor velocity, muscle activation]; velocity is
unobserved.

Every parameter, ``damping``, ``m`` and ``tau`` too, broadcasts over leading
batch axes, so the inference models' chains and conditions reach the
exponentials as one batch.  The exponential (:func:`expm`) and the
eigenvalue clip (:func:`make_psd`) are the port's own, which wait for
nothing on the host, so building the model on the card makes no
synchronization and a CUDA graph can capture it.  The model computes them in
float64 at every dtype (:class:`PointMassBoundedActor`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as nnf

from lqg_tpu_torch.config import as_tensors, constant
from lqg_tpu_torch.ops.linalg import cholesky, expm, make_psd, mT
from lqg_tpu_torch.system import System
from lqg_tpu_torch.utils import stationary_spec
from lqg_tpu_torch.models.basic import _common_batch

_TRACKING_COST = ((1.0, -1.0, 0.0, 0.0), (-1.0, 1.0, 0.0, 0.0), (0.0,) * 4,
                  (0.0,) * 4)
_TARGET = ((1.0, 0.0, 0.0, 0.0),) + ((0.0,) * 4,) * 3  # e_0 e_0^T


def _batch_dt(dt, *mats):
    """``dt`` as a tensor of the matrices' dtype and device, with two
    trailing unit axes."""
    (dt,), _ = as_tensors((dt,), mats[0].device, mats[0].dtype)
    return dt[..., None, None]


def discretize_linear_system(A, B, dt):
    """Exact zero-order-hold discretization of ``x' = A x + B u`` through the
    block matrix exponential (reference ``point_mass.py:50-79``); ``A (...,
    n, n)``, ``B (..., n, m)`` and ``dt`` broadcast over leading axes."""
    n, m = A.shape[-1], B.shape[-1]
    batch = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2])
    top = torch.cat([A.expand(batch + (n, n)), B.expand(batch + (n, m))], -1)
    M = nnf.pad(top, (0, 0, 0, m))
    M_exp = expm(M * _batch_dt(dt, A))
    return M_exp[..., :n, :n], M_exp[..., :n, n:]


def van_loan_discretization(A, G, dt, Qc=None):
    """Discrete process-noise covariance by van Loan's method (reference
    ``point_mass.py:82-110``); leading axes broadcast."""
    n = A.shape[-1]
    if Qc is None:
        Qc = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
    Q = G @ Qc @ mT(G)
    batch = torch.broadcast_shapes(A.shape[:-2], Q.shape[:-2])
    top = torch.cat([A.expand(batch + (n, n)), Q.expand(batch + (n, n))], -1)
    bottom = nnf.pad(-mT(A).expand(batch + (n, n)), (n, 0))
    M_exp = expm(torch.cat([top, bottom], -2) * _batch_dt(dt, A))
    return M_exp[..., :n, n:]


def point_mass_dynamics_matrices(damping, m, tau, action_variability, dt):
    """Discretized point-mass and muscle dynamics ``A (..., 3, 3)``, ``B
    (..., 3, 1)`` and the noise scale ``V (..., 3, 3)`` (reference
    ``point_mass.py:113-127``).  ``V`` is the upper-triangular Cholesky
    factor, as the reference's ``jax.scipy`` call returns it, so the noise
    covariance downstream is ``V V^T`` with ``V`` upper."""
    values = (damping, m, tau, action_variability, dt)
    dtype = next((v.dtype for v in values if torch.is_tensor(v)),
                 torch.float32)
    params, _ = as_tensors(values, dtype=dtype)
    batch = _common_batch(*params)
    damping, m, tau, av, dt = (p.expand(batch) for p in params)
    zero, one = torch.zeros_like(dt), torch.ones_like(dt)
    A_c = torch.stack([
        torch.stack([zero, one, zero], -1),
        torch.stack([zero, -damping / m, 1.0 / m], -1),
        torch.stack([zero, zero, -1.0 / tau], -1)], -2)
    B_c = torch.stack([zero, zero, 1.0 / tau], -1)[..., None]
    A, B = discretize_linear_system(A_c, B_c, dt)
    noise = van_loan_discretization(A_c, (1e-2 * av)[..., None, None] * B_c,
                                    dt)
    V = mT(cholesky(make_psd(noise)))
    return A, B, V


class PointMassBoundedActor(System):
    """Scalar parameters broadcast over leading batch axes, as in
    :func:`lqg_tpu_torch.models.basic.tracking_spec`.

    Score the positions (the first two states) in float32.  Scored on all
    four states in float32, the likelihood is NaN, in the fused kernel and
    in ``lqg_tpu``'s alike: the observed block of the joint covariance
    holds the velocity and activation noise (~1e-3) beside the target's
    (~1), and its closed-form determinant loses them.  Score those states
    in float64."""

    def __init__(self, process_noise=1.0, action_variability=1e-3,
                 sigma_target=6.0, sigma_cursor=6.0, action_cost=0.01,
                 dt=1.0 / 60.0, T=1000, damping=0.1, m=1.0, tau=0.0015, *,
                 device=None, dtype=torch.float32):
        params, device = as_tensors(
            (process_noise, action_variability, sigma_target, sigma_cursor,
             action_cost, dt, damping, m, tau), device, dtype)
        batch = _common_batch(*params)
        pn, av, st, sc, c, dt, damping, m, tau = (p.expand(batch)
                                                  for p in params)
        kw = dict(dtype=dtype, device=device)
        # the exponentials in float64 whatever the model's dtype: van Loan's
        # block holds exp(dt/tau) (~7e5 at tau = 1.23 ms) beside the noise it
        # integrates, and float32 leaves the noise factor off by more than
        # 1e-4 of its largest entry, lqg_tpu's float32 construction too
        # (tests/test_torch_models_zoo.py)
        A, B, V = (M.to(dtype) for M in point_mass_dynamics_matrices(
            *(p.double() for p in (damping, m, tau, av, dt))))

        # the target position leads as a constant state
        target = constant(_TARGET, **kw)
        A_full = nnf.pad(A, (1, 0, 1, 0)) + target
        B_full = nnf.pad(B, (0, 0, 1, 0))
        V_full = nnf.pad(V, (1, 0, 1, 0)) + pn[..., None, None] * target
        F = torch.eye(3, 4, **kw).expand(batch + (3, 4))  # velocity hidden
        W = torch.diag_embed(torch.stack([st, sc, sc], -1))
        Q = constant(_TRACKING_COST, **kw).expand(batch + (4, 4))
        R = torch.eye(1, **kw) * c[..., None, None] * dt[..., None, None]
        spec = stationary_spec(A=A_full, B=B_full, F=F, V=V_full, W=W, Q=Q,
                               R=R)
        super().__init__(actor=spec, dynamics=spec, horizon=T)
