"""Gaussian distributions returned by :class:`lqg_tpu_torch.system.System`
(port of ``MultivariateNormal`` and ``GaussianSequence`` in
:mod:`lqg_tpu.infer.dists`; the priors come with the potential)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

_LOG_2PI = math.log(2.0 * math.pi)


@dataclass(frozen=True)
class MultivariateNormal:
    """Dense multivariate normal parameterized by covariance."""

    loc: torch.Tensor
    covariance_matrix: torch.Tensor

    @property
    def scale_tril(self) -> torch.Tensor:
        return torch.linalg.cholesky(self.covariance_matrix)

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
