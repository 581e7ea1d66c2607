"""Posterior inference entry points (port of :mod:`lqg_tpu.infer.utils`).

``infer`` runs NUTS on the lifted model; ``sample_from_prior`` draws
ground-truth parameters for recovery studies.  NeuTra (``method="neutra"``,
:func:`neutra_reparam`) needs SVI and the normalizing flows, which come
with ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

import torch

from lqg_tpu_torch.config import resolve_device
from lqg_tpu_torch.infer import priors as prior_module
from lqg_tpu_torch.infer.mcmc import MCMC
from lqg_tpu_torch.infer.models import ProbModel, get_model_params, lifted_model


def _not_ported(what: str):
    from lqg_tpu_torch.system import _not_ported as not_ported
    return not_ported(what, "item 11")


def infer(x, num_samples, num_warmup, model=None, model_fn=lifted_model,
          process_noise=1.0, dt=1.0 / 60, method="nuts", progress_bar=True,
          num_chains=4, seed=0, max_depth=10, neutra_steps=5000,
          neutra_guide="iaf", checkpoint_path=None, mcmc_kwargs=None,
          device=None, **fixed) -> MCMC:
    """Sample the posterior over model parameters given trajectories ``x``.

    Args:
        x: data ``(n, T+1, d)``: a tensor, whose device and dtype the model
            keeps, or an array, made a float32 tensor on ``device`` (the
            card unless named).
        num_samples / num_warmup: draws per chain.
        model: model class (defaults to ``BoundedActor``).
        model_fn: a function returning a :class:`ProbModel` (default: the
            prior-lifted single-condition model).
        method: ``"nuts"``; ``"neutra"`` is not ported yet.
        num_chains: chains, one batch of the potential (default 4, as the
            reference CLIs' ``--nchain 4``).
        seed: the run's seed (:class:`lqg_tpu_torch.infer.mcmc.Draws`).
        checkpoint_path: persist the in-flight run there and resume a
            compatible checkpoint (see :meth:`MCMC.run`).
        mcmc_kwargs: extra :class:`MCMC` constructor options.

    Returns a run :class:`MCMC` object (``get_samples``, ``summary``...).
    On the card every leapfrog replays the potential's captured value and
    gradient; on the CPU it runs eagerly.
    """
    if model is None:
        from lqg_tpu_torch.models import BoundedActor as model
    if method == "neutra":
        raise _not_ported("method='neutra'")
    if method != "nuts":
        raise ValueError(
            "Please specify a valid inference method (nuts, neutra).")
    if not torch.is_tensor(x):
        x = torch.as_tensor(x, dtype=torch.float32,
                            device=resolve_device(device))
    elif device is not None:
        x = x.to(resolve_device(device))

    prob_model = model_fn(x, model, process_noise=process_noise, dt=dt,
                          **fixed)
    mcmc = MCMC(prob_model, num_warmup=num_warmup, num_samples=num_samples,
                num_chains=num_chains, max_depth=max_depth,
                progress=progress_bar, **(mcmc_kwargs or {}))
    mcmc.run(seed, checkpoint_path=checkpoint_path)
    return mcmc


def neutra_reparam(model: ProbModel, guide) -> ProbModel:
    """NeuTra preconditioning through a fitted guide: not ported yet."""
    raise _not_ported("neutra_reparam")


def sample_from_prior(model_type, seed, prior_dict=None,
                      device=None) -> dict:
    """Draw ground-truth parameters for a recovery study (reference
    ``utils.py:42-46``): one joint prior draw from a generator seeded by
    ``seed`` on ``device`` (the card unless named), restricted to the
    model's free parameters."""
    if prior_dict is None:
        prior_dict = prior_module.DEFAULT_PRIOR
    generator = torch.Generator(device=resolve_device(device))
    params = prior_module.sample_params(generator.manual_seed(seed),
                                        prior_dict)
    model_params = get_model_params(model_type).keys()
    return {k: v for k, v in params.items() if k in model_params}
