"""Subjective-actor model: the agent's internal model differs from the truth
(port of :mod:`lqg_tpu.models.subjective`).

The true system per tracked dimension has 2 states (target, cursor, with a
random-walk target), but the actor believes the target has a velocity: 3
states per dimension (target position, cursor position, target velocity),
with subjective noise magnitudes ``subj_noise`` and ``subj_vel_noise``.  So
the actor's state (``bdim``) is larger than the dynamics' (``xdim``).

``swap_dims`` permutes the actor state so that the observed dims come first
within the joint (state, belief) system, the convention of the likelihood
machinery (:mod:`lqg_tpu_torch.ops.gaussian`).
"""

from __future__ import annotations

from itertools import chain

import torch

from lqg_tpu_torch.config import as_tensors, constant
from lqg_tpu_torch.system import System
from lqg_tpu_torch.utils import stationary_spec
from lqg_tpu_torch.models.basic import (_common_batch, _diag_tile,
                                        _per_dim_blockdiag)


def swap_dims(d: int, dim: int):
    """Permutation putting each per-dimension (position, cursor) pair first
    (reference ``tracking/subjective.py:7-12``)."""
    idx = list(range(d))
    obs_dims = [idx[(d // dim) * i:((d // dim) * i + 2)] for i in range(dim)]
    unobs_dims = [idx[((d // dim) * i + 2):(d // dim) * (i + 1)]
                  for i in range(dim)]
    return list(chain(*(obs_dims + unobs_dims)))


class SubjectiveActor(System):
    """Scalar parameters broadcast over leading batch axes, as in
    :func:`lqg_tpu_torch.models.basic.tracking_spec`: every field of both
    specs then carries the common batch shape."""

    def __init__(self, dim=1, process_noise=1.0, action_cost=1.0,
                 action_variability=0.5, subj_noise=1.0, subj_vel_noise=0.5,
                 sigma_target=6.0, sigma_cursor=6.0, dt=1.0 / 60, T=1000, *,
                 device=None, dtype=torch.float32):
        (pn, c, av, sn, svn, st, sc, dt), device = as_tensors(
            (process_noise, action_cost, action_variability, subj_noise,
             subj_vel_noise, sigma_target, sigma_cursor, dt), device, dtype)
        batch = _common_batch(pn, c, av, sn, svn, st, sc, dt)
        kw = dict(dtype=dtype, device=device)
        ex = lambda M: M.expand(batch + M.shape[-2:])
        const = lambda rows: constant(rows, **kw)
        dt = dt[..., None, None]

        # true dynamics: 2 states per dim, random-walk target
        A = ex(torch.eye(2 * dim, **kw))
        B = ex(dt * _per_dim_blockdiag(const(((0.0,), (1.0,))), dim))
        F = ex(torch.eye(2 * dim, **kw))
        V = ex(_diag_tile((pn, av), dim))
        W = ex(_diag_tile((st, sc), dim))
        dyn = stationary_spec(A=A, B=B, F=F, V=V, W=W,
                              Q=ex(torch.zeros((2 * dim, 2 * dim), **kw)),
                              R=ex(torch.zeros((dim, dim), **kw)))

        # actor's internal model: 3 states per dim (adds target velocity)
        A_a = (_per_dim_blockdiag(torch.eye(3, **kw), dim)
               + dt * _per_dim_blockdiag(
                   const(((0.0, 0.0, 1.0), (0.0,) * 3, (0.0,) * 3)), dim))
        B_a = dt * _per_dim_blockdiag(const(((0.0,), (1.0,), (0.0,))), dim)
        F_a = _per_dim_blockdiag(
            const(((1.0, 0.0, 0.0), (0.0, 1.0, 0.0))), dim)
        V_a = _diag_tile((sn, av, svn), dim)
        Q_a = _per_dim_blockdiag(
            const(((1.0, -1.0, 0.0), (-1.0, 1.0, 0.0), (0.0, 0.0, 0.0))), dim)
        R_a = torch.eye(dim, **kw) * c[..., None, None]

        # permute the actor state: observed dims first
        dims = constant(tuple(swap_dims(3 * dim, dim)), torch.long, device)
        rows = lambda M: M.index_select(-2, dims)
        cols = lambda M: M.index_select(-1, dims)
        A_a = cols(rows(A_a))
        B_a = rows(B_a)
        V_a = rows(V_a)
        F_a = cols(F_a)
        Q_a = cols(rows(Q_a))

        act = stationary_spec(A=ex(A_a), B=ex(B_a), F=ex(F_a), V=ex(V_a), W=W,
                              Q=ex(Q_a), R=ex(R_a))
        super().__init__(actor=act, dynamics=dyn, horizon=T)
