"""Posterior inference entry points (port of :mod:`lqg_tpu.infer.utils`).

``infer`` runs NUTS (or NeuTra-reparametrized NUTS) on the lifted model;
``sample_from_prior`` draws ground-truth parameters for recovery studies.
"""

from __future__ import annotations

import torch

from lqg_tpu_torch.config import resolve_device
from lqg_tpu_torch.infer import priors as prior_module
from lqg_tpu_torch.infer.mcmc import MCMC
from lqg_tpu_torch.infer.models import ProbModel, get_model_params, lifted_model


def as_data(x, device=None) -> torch.Tensor:
    """Trajectories as the entry points take them: a tensor keeps its dtype
    and device (moved to ``device`` where named), an array becomes float32
    on ``device`` (the card unless named)."""
    if not torch.is_tensor(x):
        return torch.as_tensor(x, dtype=torch.float32,
                               device=resolve_device(device))
    if device is not None:
        return x.to(resolve_device(device))
    return x


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
        method: ``"nuts"`` or ``"neutra"`` (NUTS on a variationally
            preconditioned space, :func:`neutra_reparam`).
        neutra_guide: preconditioner family for ``method="neutra"``:
            ``"iaf"`` (:func:`lqg_tpu_torch.infer.flows.fit_auto_iaf`) or
            ``"mvn"`` (:func:`lqg_tpu_torch.infer.svi.fit_auto_mvn`), fitted
            for ``neutra_steps`` steps from ``seed``.
        num_chains: chains, one batch of the potential (default 4, as the
            reference CLIs' ``--nchain 4``).
        seed: the run's seed (:class:`lqg_tpu_torch.infer.mcmc.Draws`).
        checkpoint_path: persist the in-flight run there and resume a
            compatible checkpoint (see :meth:`MCMC.run`).
        mcmc_kwargs: extra :class:`MCMC` constructor options.

    Returns a run :class:`MCMC` object (``get_samples``, ``summary``...).
    On the card every guide-fit step and every leapfrog replays the
    potential's captured value and gradient; on the CPU it runs eagerly.
    """
    if model is None:
        from lqg_tpu_torch.models import BoundedActor as model
    if method not in ("nuts", "neutra"):
        raise ValueError(
            "Please specify a valid inference method (nuts, neutra).")
    prob_model = model_fn(as_data(x, device), model,
                          process_noise=process_noise, dt=dt, **fixed)

    if method == "neutra":
        if neutra_guide == "iaf":
            from lqg_tpu_torch.infer.flows import fit_auto_iaf as fit_guide
        elif neutra_guide == "mvn":
            from lqg_tpu_torch.infer.svi import fit_auto_mvn as fit_guide
        else:
            raise ValueError(
                "neutra_guide must be 'iaf' or 'mvn', got "
                f"{neutra_guide!r}")
        guide, _ = fit_guide(prob_model, seed, steps=neutra_steps)
        prob_model = neutra_reparam(prob_model, guide)

    mcmc = MCMC(prob_model, num_warmup=num_warmup, num_samples=num_samples,
                num_chains=num_chains, max_depth=max_depth,
                progress=progress_bar, **(mcmc_kwargs or {}))
    mcmc.run(seed, checkpoint_path=checkpoint_path)
    return mcmc


class NeutraModel(ProbModel):
    """A model seen through a guide's transform (see :func:`neutra_reparam`).

    Its likelihood is the base model's, so ``ll_baseline`` and ``method``
    are the base model's too, read and set through to it: there is one copy
    of each, and a change made on either model changes the value and is a
    new key of :meth:`~ProbModel.value_and_grad`'s graph cache.
    """

    def __init__(self, model: ProbModel, guide):
        self.base = model
        # the fields' setters write the base model's values back to it
        super().__init__(init=dict(model.init),
                         transforms=dict(model.transforms),
                         log_likelihood=model.log_likelihood,
                         priors=model.priors, ll_baseline=model.ll_baseline,
                         method=model.method)
        self.guide = guide
        self.init_eps = torch.zeros_like(guide.loc)

    @property
    def ll_baseline(self) -> float:
        return self.base.ll_baseline

    @ll_baseline.setter
    def ll_baseline(self, value: float):
        self.base.ll_baseline = value

    @property
    def method(self) -> str:
        return self.base.method

    @method.setter
    def method(self, value: str):
        self.base.method = value

    def log_joint_unconstrained(self, eps):
        u, logdet = self.guide.transform_and_logdet(eps)
        return self.base.log_joint_unconstrained(u) + logdet

    def init_unconstrained(self):
        return self.init_eps

    def constrain(self, eps):
        # draws come back to the host; the guide stays on its device
        loc = self.guide.loc
        u = self.guide.transform(eps.to(device=loc.device, dtype=loc.dtype))
        return self.base.constrain(u.to(eps.device))


def neutra_reparam(model: ProbModel, guide) -> NeutraModel:
    """Precondition a model through a fitted guide transform (NeuTra).

    NUTS runs in the guide's standardized space ``eps``; positions map back
    through the guide's forward transform ``u = f(eps)`` (affine for
    :class:`~lqg_tpu_torch.infer.svi.AutoMVN`, a masked autoregressive flow
    for :class:`~lqg_tpu_torch.infer.flows.AutoIAF`), and the density picks
    up the transform's log-Jacobian.  The returned model's potential is the
    flow and the LQG potential together, so :class:`MCMC` captures both and
    autograd in one CUDA graph.  Chains start at ``eps = 0`` unless a caller
    assigns ``init_eps`` (e.g. a warped-space MAP polish).  Its
    ``ll_baseline`` and ``method`` are the base model's (:class:`NeutraModel`).
    """
    return NeutraModel(model, guide)


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
