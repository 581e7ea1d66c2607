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

from lqg_tpu_torch.config import as_tensors
from lqg_tpu_torch.system import System
from lqg_tpu_torch.utils import stationary_spec


def _per_dim_blockdiag(block, dim: int) -> torch.Tensor:
    """Block-diagonal replication of a small constant block, ``dim`` times."""
    return torch.block_diag(*([block] * dim))


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
    batch = torch.broadcast_shapes(*(p.shape for p in (pn, av, st, sc, c, dt)))
    d = 2 * dim
    kw = dict(dtype=dtype, device=device)
    ex = lambda M: M.expand(batch + M.shape[-2:])
    A = ex(torch.eye(d, **kw))
    B = ex(dt[..., None, None] * _per_dim_blockdiag(
        torch.tensor([[0.0], [1.0]], **kw), dim))
    F = ex(torch.eye(d, **kw))
    # diag(tile([a, b], dim)) over the batch
    diag = lambda a, b: ex(torch.diag_embed(torch.cat(
        [torch.stack(torch.broadcast_tensors(a, b), -1)] * dim, -1)))
    Q = ex(_per_dim_blockdiag(torch.tensor([[1.0, -1.0], [-1.0, 1.0]], **kw),
                              dim))
    R = ex(torch.eye(dim, **kw) * c[..., None, None])
    return stationary_spec(A=A, B=B, F=F, V=diag(pn, av), W=diag(st, sc),
                           Q=Q, R=R)


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
    (reference ``tracking/basic.py:90-124``)."""

    def __init__(self, dim=1, process_noise=1.0, action_variability=0.5,
                 sigma=6.0, action_cost=1.0, dt=1.0 / 60.0, T=1000, *,
                 device=None, dtype=torch.float32):
        self.dim = dim
        self.process_noise = process_noise
        (pn, av, s, c, dt), device = as_tensors(
            (process_noise, action_variability, sigma, action_cost, dt),
            device, dtype)
        kw = dict(dtype=dtype, device=device)
        d = 2 * dim
        A = torch.eye(d, **kw)
        B = dt * _per_dim_blockdiag(torch.tensor([[0.0], [1.0]], **kw), dim)
        F = _per_dim_blockdiag(torch.tensor([[1.0, -1.0]], **kw), dim)
        V = torch.diag(torch.stack([pn, av]).repeat(dim))
        W = torch.diag(s[None].repeat(dim))
        Q = _per_dim_blockdiag(torch.tensor([[1.0, -1.0], [-1.0, 1.0]], **kw),
                               dim)
        R = torch.eye(dim, **kw) * c
        spec = stationary_spec(A=A, B=B, F=F, V=V, W=W, Q=Q, R=R)
        super().__init__(actor=spec, dynamics=spec, horizon=T)
