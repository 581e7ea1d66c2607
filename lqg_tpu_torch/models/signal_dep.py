"""Signal-dependent (control-multiplicative) noise tracking model (port of
:mod:`lqg_tpu.models.signal_dep`).

The bounded actor with Harris & Wolpert (1998)-style motor noise: the
cursor's motor variability scales with the control signal,
``noise = action_variability * eps + signal_dep_noise * eps' * u``.  The
optimal controller under this noise (Todorov 2005) penalizes large controls
(:func:`lqg_tpu_torch.ops.riccati.backward_multiplicative`); the rollout
carries the multiplicative noise exactly, while the marginalized likelihood
keeps the noise covariance at its additive level and takes the
signal-dependent penalty through the gains.  No fused gains kernel has the
penalty, so the gains are the scans; the likelihood takes K3/K4 as the
bounded actor's does.
"""

from __future__ import annotations

import torch

from lqg_tpu_torch.config import as_tensors, constant
from lqg_tpu_torch.system import System
from lqg_tpu_torch.models.basic import (_common_batch, _per_dim_blockdiag,
                                        tracking_spec)


class SignalDependentNoiseActor(System):
    """Scalar parameters broadcast over leading batch axes, as in
    :func:`tracking_spec`; the control-noise scales ``C ([P,] 1, 2 dim,
    dim)`` carry the same batch shape."""

    def __init__(self, dim=1, process_noise=1.0, action_variability=0.5,
                 signal_dep_noise=0.5, sigma_target=6.0, sigma_cursor=6.0,
                 action_cost=1.0, dt=1.0 / 60.0, T=1000, *, device=None,
                 dtype=torch.float32):
        self.dim = dim
        self.process_noise = process_noise
        params, device = as_tensors(
            (process_noise, action_variability, signal_dep_noise,
             sigma_target, sigma_cursor, action_cost, dt), device, dtype)
        batch = _common_batch(*params)
        pn, av, sdn, st, sc, c, dt = (p.expand(batch) for p in params)
        spec = tracking_spec(dim, pn, av, st, sc, c, dt, device=device,
                             dtype=dtype)
        # one noise channel: control-proportional noise along the cursor
        # axis, scaled like the control input itself (dt * u)
        C = ((sdn * dt)[..., None, None] * _per_dim_blockdiag(
            constant(((0.0,), (1.0,)), dtype, device), dim))[..., None, :, :]
        super().__init__(actor=spec, dynamics=spec, horizon=T,
                         control_noise=C)
