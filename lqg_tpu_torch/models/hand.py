"""Hand-motion tracking model with second-order muscle dynamics (port of
:mod:`lqg_tpu.models.hand`).

5 states = [target, hand position, hand velocity, muscle activation, muscle
excitation]; target and hand position are observed; the control drives the
excitation through two first-order lags.
"""

from __future__ import annotations

import torch
import torch.nn.functional as nnf

from lqg_tpu_torch.config import as_tensors, constant
from lqg_tpu_torch.system import System
from lqg_tpu_torch.utils import stationary_spec
from lqg_tpu_torch.models.basic import _common_batch

# the cost: (target - hand position)^2
_TRACKING_COST = ((1.0, -1.0, 0.0, 0.0, 0.0), (-1.0, 1.0, 0.0, 0.0, 0.0),
                  (0.0,) * 5, (0.0,) * 5, (0.0,) * 5)


class HandMotionModelTrackingTask(System):
    """Scalar parameters (``m`` and ``tau`` too) broadcast over leading
    batch axes, as in :func:`lqg_tpu_torch.models.basic.tracking_spec`."""

    def __init__(self, process_noise=1.0, action_variability=0.5,
                 sigma_target=6.0, sigma_cursor=6.0, action_cost=1.0,
                 dt=1.0 / 60.0, m=1.0, tau=0.04, T=1000, *, device=None,
                 dtype=torch.float32):
        self.process_noise = process_noise
        params, device = as_tensors(
            (process_noise, action_variability, sigma_target, sigma_cursor,
             action_cost, dt, m, tau), device, dtype)
        batch = _common_batch(*params)
        pn, av, st, sc, c, dt, m, tau = (p.expand(batch) for p in params)
        kw = dict(dtype=dtype, device=device)
        ex = lambda M: M.expand(batch + M.shape[-2:])
        zero, one = torch.zeros_like(dt), torch.ones_like(dt)
        lag = 1.0 - dt / tau
        A_hand = torch.stack([
            torch.stack([one, dt, zero, zero], -1),
            torch.stack([zero, one, dt / m, zero], -1),
            torch.stack([zero, zero, lag, dt / tau], -1),
            torch.stack([zero, zero, zero, lag], -1)], -2)
        # the target is a constant state ahead of the hand's four
        A = nnf.pad(A_hand, (1, 0, 1, 0)) + constant(
            ((1.0,) + (0.0,) * 4,) + ((0.0,) * 5,) * 4, **kw)
        B = (dt / tau)[..., None, None] * constant(
            ((0.0,),) * 4 + ((1.0,),), **kw)
        F = ex(torch.eye(2, 5, **kw))
        # the 1e-2 hand-position noise floor keeps the observed block's
        # covariance nonsingular (lqg_tpu/models/hand.py:34-37)
        V = torch.diag_embed(torch.stack(
            [pn, torch.full_like(pn, 1e-2), zero, zero, av], -1))
        W = torch.diag_embed(torch.stack([st, sc], -1))
        Q = ex(constant(_TRACKING_COST, **kw))
        R = torch.eye(1, **kw) * c[..., None, None]
        spec = stationary_spec(A=A, B=B, F=F, V=V, W=W, Q=Q, R=R)
        super().__init__(actor=spec, dynamics=spec, horizon=T)
