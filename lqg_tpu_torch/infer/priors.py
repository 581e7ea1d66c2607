"""Prior registry for tracking-model parameters (port of
:mod:`lqg_tpu.infer.priors`).

A declarative table (``PRIOR_TABLE``) maps parameter names to distribution
factories, from which the default prior dict is materialized.  The choices
and hyperparameters are the JAX package's, which reproduce the reference's
published priors.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from lqg_tpu_torch.infer.dists import Distribution, HalfNormal, LogNormal

# Number of blob-width conditions in the Bonnen et al. dataset; the
# hierarchical data fit needs one per-condition target-noise site each.
N_DATA_CONDITIONS = 6

# name -> zero-arg factory producing a fresh Distribution
PRIOR_TABLE: Dict[str, Callable[[], Distribution]] = {
    # control effort weight: broad log-normal centered near e^-2
    "action_cost": lambda: LogNormal(-2.0, 1.0),
    # the delay-register models name their action cost "c"; same prior
    "c": lambda: LogNormal(-2.0, 1.0),
    # motor/process noise scales: half-normals
    "action_variability": lambda: HalfNormal(1.0),
    "signal_dep_noise": lambda: HalfNormal(1.0),
    # observation noise scales
    "sigma_target": lambda: HalfNormal(50.0),
    "sigma_cursor": lambda: HalfNormal(12.5),
    "sigma": lambda: HalfNormal(50.0),
    # subjective internal-model noise scales
    "subj_noise": lambda: HalfNormal(1.0),
    "subj_vel_noise": lambda: HalfNormal(2.0),
}


def default_prior() -> Dict[str, Distribution]:
    """Materialize the default prior dict, with one ``sigma_target_{c}``
    site per dataset condition for the hierarchical model."""
    out = {name: make() for name, make in PRIOR_TABLE.items()}
    per_condition = PRIOR_TABLE["sigma_target"]
    for c in range(N_DATA_CONDITIONS):
        out[f"sigma_target_{c}"] = per_condition()
    return out


DEFAULT_PRIOR = default_prior()


def prior() -> Dict[str, Distribution]:
    """Accessor returning the module-level default prior dict."""
    return DEFAULT_PRIOR


def register_prior(name: str, factory: Callable[[], Distribution]) -> None:
    """Add (or override) a parameter prior in the registry and the
    materialized default dict."""
    PRIOR_TABLE[name] = factory
    DEFAULT_PRIOR[name] = factory()


def sample_params(generator: Optional[torch.Generator] = None,
                  prior_dict=None) -> Dict[str, torch.Tensor]:
    """One joint draw from a prior dict (default: ``DEFAULT_PRIOR``), sites
    drawn in sorted-name order from ``generator`` so that the draw does not
    depend on the dict's insertion order."""
    if prior_dict is None:
        prior_dict = DEFAULT_PRIOR
    return {name: prior_dict[name].sample(generator)
            for name in sorted(prior_dict)}


# --- log-normal hyperparameter helpers -------------------------------------

def lognormal_params(mean, std):
    """``(mu, sigma^2)`` of the log-normal with the given mean and std
    (moment matching)."""
    m2, s2 = np.square(mean), np.square(std)
    return np.log(m2 / np.sqrt(m2 + s2)), np.log1p(s2 / m2)


def lognormal_from_quantiles(x1, x2, p1=0.05, p2=0.95):
    """``(mu, sigma)`` of the log-normal whose CDF passes through
    ``(x1, p1)`` and ``(x2, p2)``: the solution of ``mu + sigma * z_i =
    log(x_i)`` with ``z_i = Phi^{-1}(p_i)``.  Float64 tensors on the
    device of ``x1`` (the CPU for numbers)."""
    x1 = torch.as_tensor(x1, dtype=torch.float64)
    x2 = torch.as_tensor(x2, dtype=torch.float64, device=x1.device)
    z1, z2 = torch.special.ndtri(torch.tensor(
        [p1, p2], dtype=torch.float64, device=x1.device))
    l1, l2 = torch.log(x1), torch.log(x2)
    sigma = (l2 - l1) / (z2 - z1)
    mu = (l2 * z2 - l1 * z1) / (z2 - z1)
    return mu, sigma
