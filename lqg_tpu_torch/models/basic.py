"""Canonical 1D-per-dimension tracking models (port of
:mod:`lqg_tpu.models.basic`).

Per tracked dimension the state is (target, cursor); the target follows a
random walk with standard deviation ``process_noise``; the cursor integrates
the control with motor variability ``action_variability``; both are observed
with separate sensory noises; the cost penalizes (target - cursor) error plus
a quadratic action cost.
"""

from __future__ import annotations

import torch

from lqg_tpu_torch.config import as_tensors, constant
from lqg_tpu_torch.system import System
from lqg_tpu_torch.utils import stationary_spec


def _per_dim_blockdiag(block, dim: int) -> torch.Tensor:
    """Block-diagonal replication of a small constant block, ``dim`` times."""
    return torch.block_diag(*([block] * dim))


def _diag_tile(values, dim: int) -> torch.Tensor:
    """``diag(tile([v_0, v_1, ...], dim))`` over the values' common batch
    shape."""
    row = torch.stack(torch.broadcast_tensors(*values), -1)
    return torch.diag_embed(torch.cat([row] * dim, -1))


def _common_batch(*params: torch.Tensor) -> torch.Size:
    return torch.broadcast_shapes(*(p.shape for p in params))


def tracking_spec(dim, process_noise, action_variability, sigma_target,
                  sigma_cursor, action_cost, dt, *, device=None,
                  dtype=torch.float32):
    """Stationary spec of the basic tracking task (reference
    ``tracking/basic.py:20-38``).

    Scalar parameters broadcast over leading batch axes, the counterpart of
    ``jax.vmap`` over the JAX constructor: every field then carries the
    common batch shape.
    """
    (pn, av, st, sc, c, dt), device = as_tensors(
        (process_noise, action_variability, sigma_target, sigma_cursor,
         action_cost, dt), device, dtype)
    batch = _common_batch(pn, av, st, sc, c, dt)
    d = 2 * dim
    kw = dict(dtype=dtype, device=device)
    ex = lambda M: M.expand(batch + M.shape[-2:])
    A = ex(torch.eye(d, **kw))
    B = ex(dt[..., None, None] * _per_dim_blockdiag(
        constant(((0.0,), (1.0,)), **kw), dim))
    F = ex(torch.eye(d, **kw))
    Q = ex(_per_dim_blockdiag(constant(((1.0, -1.0), (-1.0, 1.0)), **kw),
                              dim))
    R = ex(torch.eye(dim, **kw) * c[..., None, None])
    return stationary_spec(A=A, B=B, F=F, V=ex(_diag_tile((pn, av), dim)),
                           W=ex(_diag_tile((st, sc), dim)), Q=Q, R=R)


class TrackingTask(System):
    def __init__(self, dim=1, process_noise=1.0, action_variability=0.5,
                 sigma_target=6.0, sigma_cursor=6.0, action_cost=1.0,
                 dt=1.0 / 60.0, T=1000, *, device=None, dtype=torch.float32):
        self.dim = dim
        self.process_noise = process_noise
        spec = tracking_spec(dim, process_noise, action_variability,
                             sigma_target, sigma_cursor, action_cost, dt,
                             device=device, dtype=dtype)
        super().__init__(actor=spec, dynamics=spec, horizon=T)


class BoundedActor(TrackingTask):
    """Parameter alias of :class:`TrackingTask`
    (reference ``tracking/basic.py:41-62``)."""

    def __init__(self, dim=1, process_noise=1.0, action_variability=0.5,
                 sigma_target=6.0, sigma_cursor=6.0, action_cost=1.0,
                 dt=1.0 / 60, T=1000, *, device=None, dtype=torch.float32):
        super().__init__(dim=dim, process_noise=process_noise,
                         action_variability=action_variability,
                         sigma_target=sigma_target, sigma_cursor=sigma_cursor,
                         action_cost=action_cost, dt=dt, T=T, device=device,
                         dtype=dtype)


class OptimalActor(TrackingTask):
    """Bounded actor with a fixed, near-zero action cost
    (reference ``tracking/basic.py:65-87``)."""

    def __init__(self, dim=1, process_noise=1.0, action_variability=0.5,
                 sigma_target=6.0, sigma_cursor=6.0, dt=1.0 / 60, T=1000, *,
                 device=None, dtype=torch.float32):
        super().__init__(dim=dim, process_noise=process_noise,
                         action_variability=action_variability,
                         sigma_target=sigma_target, sigma_cursor=sigma_cursor,
                         action_cost=1e-3, dt=dt, T=T, device=device,
                         dtype=dtype)


class RelativeObservationBoundedActor(System):
    """Observes only the (target - cursor) difference, one sensory noise
    (reference ``tracking/basic.py:90-124``).  Scalar parameters broadcast
    over leading batch axes, as in :func:`tracking_spec`."""

    def __init__(self, dim=1, process_noise=1.0, action_variability=0.5,
                 sigma=6.0, action_cost=1.0, dt=1.0 / 60.0, T=1000, *,
                 device=None, dtype=torch.float32):
        self.dim = dim
        self.process_noise = process_noise
        (pn, av, s, c, dt), device = as_tensors(
            (process_noise, action_variability, sigma, action_cost, dt),
            device, dtype)
        batch = _common_batch(pn, av, s, c, dt)
        kw = dict(dtype=dtype, device=device)
        ex = lambda M: M.expand(batch + M.shape[-2:])
        d = 2 * dim
        A = ex(torch.eye(d, **kw))
        B = ex(dt[..., None, None] * _per_dim_blockdiag(
            constant(((0.0,), (1.0,)), **kw), dim))
        F = ex(_per_dim_blockdiag(constant(((1.0, -1.0),), **kw), dim))
        V = ex(_diag_tile((pn, av), dim))
        W = ex(_diag_tile((s,), dim))
        Q = ex(_per_dim_blockdiag(
            constant(((1.0, -1.0), (-1.0, 1.0)), **kw), dim))
        R = ex(torch.eye(dim, **kw) * c[..., None, None])
        spec = stationary_spec(A=A, B=B, F=F, V=V, W=W, Q=Q, R=R)
        super().__init__(actor=spec, dynamics=spec, horizon=T)
