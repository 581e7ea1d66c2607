"""Inference layer of the port (counterpart of :mod:`lqg_tpu.infer`): the
distributions, transforms, priors and probabilistic models whose potential
NUTS, SVI and MLE differentiate; NUTS itself (``infer``, ``MCMC``, the
diagnostics); point estimation and variational guides
(:mod:`~lqg_tpu_torch.infer.svi`, :mod:`~lqg_tpu_torch.infer.flows`,
``max_likelihood``) and NeuTra (``infer(method="neutra")``)."""

from lqg_tpu_torch.infer.diagnostics import ess, split_rhat
from lqg_tpu_torch.infer.dists import (Distribution, GaussianSequence,
                                       HalfNormal, LogNormal,
                                       MultivariateNormal, Normal, Uniform)
from lqg_tpu_torch.infer.mcmc import MCMC
from lqg_tpu_torch.infer.mle import max_likelihood
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
from lqg_tpu_torch.infer.utils import (infer, neutra_reparam,
                                       sample_from_prior)

__all__ = [
    "DEFAULT_PRIOR", "Distribution", "Exp", "GaussianSequence", "HalfNormal",
    "Identity", "LogNormal", "MCMC", "MultivariateNormal", "Normal",
    "PRIOR_TABLE", "ProbModel", "Sigmoid", "Softplus", "Transform",
    "Uniform", "common_lqg_model", "default_prior", "ess",
    "get_model_params", "identity", "infer", "lifted_model",
    "lognormal_from_quantiles", "lognormal_params", "lqg_model",
    "max_likelihood", "neutra_reparam", "positive", "prior", "register_prior",
    "sample_from_prior", "sample_params", "shared_params_lqg_model",
    "split_rhat",
]
