"""Inference layer of the port (counterpart of :mod:`lqg_tpu.infer`): the
distributions, transforms, priors and probabilistic models whose potential
NUTS, SVI and MLE differentiate.  The samplers and optimizers come with
later slices."""

from lqg_tpu_torch.infer.dists import (Distribution, GaussianSequence,
                                       HalfNormal, LogNormal,
                                       MultivariateNormal, Normal, Uniform)
from lqg_tpu_torch.infer.models import (ProbModel, common_lqg_model,
                                        get_model_params, lifted_model,
                                        lqg_model, shared_params_lqg_model)
from lqg_tpu_torch.infer.priors import (DEFAULT_PRIOR, PRIOR_TABLE,
                                        default_prior,
                                        lognormal_from_quantiles,
                                        lognormal_params, prior,
                                        register_prior, sample_params)
from lqg_tpu_torch.infer.transforms import (Exp, Identity, Sigmoid,
                                            Softplus, Transform, identity,
                                            positive)

__all__ = [
    "DEFAULT_PRIOR", "Distribution", "Exp", "GaussianSequence", "HalfNormal",
    "Identity", "LogNormal", "MultivariateNormal", "Normal", "PRIOR_TABLE",
    "ProbModel", "Sigmoid", "Softplus", "Transform", "Uniform",
    "common_lqg_model", "default_prior", "get_model_params", "identity",
    "lifted_model", "lognormal_from_quantiles", "lognormal_params",
    "lqg_model", "positive", "prior", "register_prior", "sample_params",
    "shared_params_lqg_model",
]
