"""Probability distributions (port of :mod:`lqg_tpu.infer.dists`): the
scalar priors of the inference front and the Gaussians that
:class:`lqg_tpu_torch.system.System` returns.

``sample`` takes a ``torch.Generator`` where the JAX package takes a key;
draws land on the generator's device (the parameters' device, or the card,
without one).  Parameters may be Python numbers or tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from lqg_tpu_torch.config import resolve_device
from lqg_tpu_torch.ops.linalg import cholesky

_LOG_2PI = math.log(2.0 * math.pi)
_LOG_SQRT_2_OVER_PI = 0.5 * math.log(2.0 / math.pi)


def _log(x):
    return torch.log(x) if torch.is_tensor(x) else math.log(x)


def _draw(fn, generator: Optional[torch.Generator], sample_shape, *params):
    """``fn`` (``torch.randn`` or ``torch.rand``) draws of shape
    ``sample_shape + batch shape`` on the generator's device."""
    tensors = [p for p in params if torch.is_tensor(p)]
    batch = torch.broadcast_shapes(*(p.shape for p in tensors))
    if generator is not None:
        device = generator.device
    else:
        device = tensors[0].device if tensors else resolve_device()
    dtype = tensors[0].dtype if tensors else torch.get_default_dtype()
    return fn(tuple(sample_shape) + tuple(batch), generator=generator,
              dtype=dtype, device=device)


def _normal(generator, sample_shape, *params):
    return _draw(torch.randn, generator, sample_shape, *params)


class Distribution:
    """Minimal distribution interface."""

    def log_prob(self, value):
        raise NotImplementedError

    def sample(self, generator: Optional[torch.Generator] = None,
               sample_shape=()):
        raise NotImplementedError

    @property
    def median(self):
        """Closed-form median; NUTS/SVI initialize here (the reference's
        ``init_to_median``)."""
        raise NotImplementedError


@dataclass(frozen=True)
class Normal(Distribution):
    loc: object = 0.0
    scale: object = 1.0

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        return -0.5 * (z * z + _LOG_2PI) - _log(self.scale)

    def sample(self, generator=None, sample_shape=()):
        return self.loc + self.scale * _normal(generator, sample_shape,
                                               self.loc, self.scale)

    @property
    def mean(self):
        return self.loc

    @property
    def median(self):
        return self.loc


@dataclass(frozen=True)
class HalfNormal(Distribution):
    """|N(0, scale^2)|."""

    scale: object = 1.0

    def log_prob(self, value):
        z = value / self.scale
        lp = -0.5 * z * z + _LOG_SQRT_2_OVER_PI - _log(self.scale)
        return torch.where(value >= 0, lp, -math.inf)

    def sample(self, generator=None, sample_shape=()):
        return torch.abs(_normal(generator, sample_shape, self.scale)) \
            * self.scale

    @property
    def mean(self):
        return self.scale * math.sqrt(2.0 / math.pi)

    @property
    def median(self):
        # sqrt(2) * erfinv(1/2)
        return self.scale * 0.6744897501960817


@dataclass(frozen=True)
class LogNormal(Distribution):
    loc: object = 0.0
    scale: object = 1.0

    def log_prob(self, value):
        logv = torch.log(value)
        z = (logv - self.loc) / self.scale
        return -0.5 * (z * z + _LOG_2PI) - _log(self.scale) - logv

    def sample(self, generator=None, sample_shape=()):
        return torch.exp(self.loc + self.scale * _normal(
            generator, sample_shape, self.loc, self.scale))

    @property
    def mean(self):
        return _exp(self.loc + 0.5 * self.scale**2)

    @property
    def median(self):
        return _exp(self.loc)


@dataclass(frozen=True)
class Uniform(Distribution):
    low: object = 0.0
    high: object = 1.0

    def log_prob(self, value):
        lp = -_log(self.high - self.low)
        like = dict(dtype=value.dtype, device=value.device)
        # a fill kernel for a number: no copy from host memory
        lp = lp.to(**like) if torch.is_tensor(lp) else torch.full((), lp,
                                                                  **like)
        inside = (value >= self.low) & (value <= self.high)
        return torch.where(inside, lp, -math.inf)

    def sample(self, generator=None, sample_shape=()):
        u = _draw(torch.rand, generator, sample_shape, self.low, self.high)
        return self.low + (self.high - self.low) * u

    @property
    def mean(self):
        return 0.5 * (self.low + self.high)

    @property
    def median(self):
        return 0.5 * (self.low + self.high)


def _exp(x):
    return torch.exp(x) if torch.is_tensor(x) else math.exp(x)


@dataclass(frozen=True)
class MultivariateNormal(Distribution):
    """Dense multivariate normal parameterized by covariance."""

    loc: torch.Tensor
    covariance_matrix: torch.Tensor

    @property
    def scale_tril(self) -> torch.Tensor:
        return cholesky(self.covariance_matrix)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        chol = self.scale_tril
        diff = value - self.loc
        w = torch.linalg.solve_triangular(chol, diff[..., None],
                                          upper=False)[..., 0]
        d = self.loc.shape[-1]
        logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
        return -0.5 * ((w * w).sum(-1) + logdet + d * _LOG_2PI)

    def sample(self, generator: Optional[torch.Generator] = None,
               sample_shape=()) -> torch.Tensor:
        shape = tuple(sample_shape) + tuple(self.loc.shape)
        eps = torch.randn(shape, generator=generator, dtype=self.loc.dtype,
                          device=self.loc.device)
        return self.loc + (self.scale_tril @ eps[..., None])[..., 0]

    @property
    def mean(self) -> torch.Tensor:
        return self.loc

    @property
    def median(self) -> torch.Tensor:
        return self.loc

    def shape(self):
        return self.loc.shape


@dataclass(frozen=True)
class GaussianSequence(MultivariateNormal):
    """Multivariate normals with the time axis as an event axis
    (``loc (..., T, d)``, ``covariance_matrix (..., T, d, d)``):
    ``log_prob`` sums the per-step densities over time."""

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return super().log_prob(value).sum(-1)
