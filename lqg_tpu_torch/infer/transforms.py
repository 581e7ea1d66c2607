"""Bijective transforms between constrained and unconstrained spaces (port
of :mod:`lqg_tpu.infer.transforms`).

NUTS and SVI work on unconstrained vectors; model parameters live in
constrained spaces (positivity, intervals).  Each transform maps
unconstrained -> constrained and supplies the log|det Jacobian| of the
change of variables.  All are elementwise, so a batch of chains ``u (C,
...)`` goes through in one call.
"""

from __future__ import annotations

import math

import torch


def _softplus(u: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(u))`` without the linear cut-off of
    ``torch.nn.functional.softplus`` (``jax.nn.softplus`` has none)."""
    return torch.logaddexp(u, torch.zeros_like(u))


class Transform:
    def forward(self, u):
        raise NotImplementedError

    def inverse(self, x):
        raise NotImplementedError

    def log_abs_det_jacobian(self, u):
        """log |d forward(u) / du| evaluated at unconstrained u."""
        raise NotImplementedError


class Identity(Transform):
    def forward(self, u):
        return u

    def inverse(self, x):
        return x

    def log_abs_det_jacobian(self, u):
        return torch.zeros_like(u)


class Exp(Transform):
    """u -> exp(u): the canonical positivity transform."""

    def forward(self, u):
        return torch.exp(u)

    def inverse(self, x):
        return torch.log(x)

    def log_abs_det_jacobian(self, u):
        return u


class Softplus(Transform):
    """u -> log(1 + exp(u)): positivity with linear tails (less prone to
    overflow in long NUTS trajectories than Exp)."""

    def forward(self, u):
        return _softplus(u)

    def inverse(self, x):
        # stable inverse-softplus
        return x + torch.log(-torch.expm1(-x))

    def log_abs_det_jacobian(self, u):
        # d softplus(u)/du = sigmoid(u); log sigmoid(u) = -softplus(-u)
        return -_softplus(-u)


class Sigmoid(Transform):
    """u -> low + (high - low) * sigmoid(u): interval transform."""

    def __init__(self, low=0.0, high=1.0):
        self.low = low
        self.high = high

    def forward(self, u):
        return self.low + (self.high - self.low) * torch.reciprocal(
            1.0 + torch.exp(-u))

    def inverse(self, x):
        p = (x - self.low) / (self.high - self.low)
        return torch.log(p) - torch.log1p(-p)

    def log_abs_det_jacobian(self, u):
        width = self.high - self.low
        log_width = (torch.log(width) if torch.is_tensor(width)
                     else math.log(width))
        return log_width - _softplus(-u) - _softplus(u)


positive = Exp()
identity = Identity()
