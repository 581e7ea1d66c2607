"""Probabilistic models over LQG parameters (port of
:mod:`lqg_tpu.infer.models`).

A :class:`ProbModel` is a set of named free parameters with transforms and
(optional) priors, plus a likelihood function of the constrained
parameters; ``potential`` is what NUTS, SVI and MLE differentiate.  The
chain parameters -> spec -> gains -> likelihood is one autograd graph, and
on the card it runs through the fused kernels and their backward kernels
(K1-K4).

Free parameters are found in model constructor signatures as in the
reference (``lqg/infer/models.py:9-17``), with the same exclusions plus the
port's keyword-only ``device`` and ``dtype``.

Batch-first: where the JAX package vmaps the likelihood over conditions
(``models.py:253``) and NUTS vmaps chains over the potential, a potential
here takes ``u (D,)`` or a batch of chains ``u (C, D)``, and one call
builds one batched model of ``C`` x ``Nc`` parameter sets, so one value and
gradient is one launch of each kernel.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch

from lqg_tpu_torch.infer import transforms as tfm
from lqg_tpu_torch.infer.dists import Distribution
from lqg_tpu_torch.infer.priors import DEFAULT_PRIOR
from lqg_tpu_torch.utils.numerics import kahan_sum

# constructor kwargs that are never free parameters (reference
# models.py:14), and the port's own device and dtype
_EXCLUDED = ("self", "dim", "dt", "T", "process_noise", "delay", "covar",
             "device", "dtype")


def get_model_params(model_class) -> Dict[str, float]:
    """Free parameters of a model class = constructor kwargs with defaults,
    minus the exclusion list (reference ``models.py:9-17``)."""
    sig = inspect.signature(model_class.__init__)
    return {name: p.default for name, p in sig.parameters.items()
            if name not in _EXCLUDED}


@dataclass
class ProbModel:
    """A differentiable log-density model over named scalar parameters.

    * ``init``: constrained-space initial values per free parameter.
    * ``priors``: optional prior distribution per parameter; a parameter
      without one is a pure-likelihood (MLE) coordinate.
    * ``transforms``: unconstrained -> constrained bijections per parameter.
    * ``log_likelihood``: function of the constrained parameter dict whose
      values are scalars or ``(C,)`` batches of chains.

    Unconstrained vectors are ``u (D,)`` or ``u (C, D)``, coordinates in the
    sorted order of ``names`` (the JAX package's order).
    """

    init: Dict[str, Any]
    transforms: Dict[str, tfm.Transform]
    log_likelihood: Callable[[Dict[str, torch.Tensor]], torch.Tensor]
    priors: Optional[Dict[str, Distribution]] = None
    # Constant shift subtracted inside ``log_likelihood`` (the model
    # factories read it at call time).  HMC/SVI use only potential
    # differences, but float32 quantizes the returned value at ULP(|value|):
    # ~0.03 nats at the data.mat fit's ~3e5-nat likelihood.  Setting it to
    # the MAP's likelihood keeps the returned value O(1-100).
    ll_baseline: float = 0.0

    @property
    def names(self) -> List[str]:
        return sorted(self.init.keys())

    def _like(self) -> dict:
        ref = next((v for v in self.init.values() if torch.is_tensor(v)),
                   None)
        if ref is None:
            return dict(dtype=torch.get_default_dtype())
        return dict(dtype=ref.dtype, device=ref.device)

    # --- constrained <-> unconstrained plumbing ---
    def unconstrain(self, params: Dict[str, Any]) -> torch.Tensor:
        like = self._like()
        return torch.stack([
            self.transforms[n].inverse(torch.as_tensor(params[n], **like))
            for n in self.names], -1)

    def constrain(self, u: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {n: self.transforms[n].forward(u[..., i])
                for i, n in enumerate(self.names)}

    def init_unconstrained(self) -> torch.Tensor:
        return self.unconstrain(self.init)

    # --- densities ---
    def log_prior(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        if not self.priors:
            return torch.zeros((), **self._like())
        lp = 0.0
        for n in self.names:
            if n in self.priors:
                lp = lp + self.priors[n].log_prob(params[n])
        return lp

    def log_joint_unconstrained(self, u: torch.Tensor) -> torch.Tensor:
        """log p(params(u)) + log |J(u)| + log p(x | params(u)).

        Without priors this is a pure-likelihood (MLE) objective: no prior
        term and no Jacobian correction (the reference's ``numpyro.param``
        semantics, ``lqg/infer/mle.py:10-23``).
        """
        params = self.constrain(u)
        if not self.priors:
            return self.log_likelihood(params)
        ljac = 0.0
        for i, n in enumerate(self.names):
            ljac = ljac + self.transforms[n].log_abs_det_jacobian(u[..., i])
        return self.log_prior(params) + ljac + self.log_likelihood(params)

    def potential(self, u: torch.Tensor) -> torch.Tensor:
        """Negative log joint, the NUTS/SVI objective: a scalar for ``u
        (D,)``, ``(C,)`` for ``u (C, D)``."""
        return -self.log_joint_unconstrained(u)


def _lead(params: Dict[str, torch.Tensor]) -> torch.Size:
    """The chain axes the parameter values share: ``()`` or ``(C,)``."""
    return torch.broadcast_shapes(*(v.shape for v in params.values()))


def _total(lls: torch.Tensor, baseline: float) -> torch.Tensor:
    """Compensated total over the trailing (trial) axis, with the baseline
    spread per trial so that partial sums stay small (see ``ll_baseline``)."""
    return kahan_sum(lls - baseline / lls.shape[-1], axis=-1)


def lqg_model(x, model_type, process_noise=1.0, dt=1.0 / 60.0,
              priors=None, **fixed_params) -> ProbModel:
    """Single-condition model over trials ``x (n, T+1, d)``: free params
    positive-constrained, likelihood over all trials (reference
    ``lqg/infer/models.py:20-34``).

    With ``priors=None`` this is the MLE objective; pass a prior dict (e.g.
    ``DEFAULT_PRIOR``) for the Bayesian model.  The model works on ``x``'s
    device and dtype.
    """
    n, T, d = x.shape
    like = dict(dtype=x.dtype, device=x.device)

    init, transforms = {}, {}
    for name, default in get_model_params(model_type).items():
        if name in fixed_params:
            continue
        init[name] = torch.as_tensor(default, **like)
        transforms[name] = tfm.positive

    used_priors = None
    if priors is not None:
        used_priors = {n: priors[n] for n in init if n in priors}
        # initialize at the prior median (reference ``init_to_median``)
        init = {n: (torch.as_tensor(used_priors[n].median, **like)
                    if n in used_priors else init[n]) for n in init}

    model = ProbModel(init=init, transforms=transforms,
                      log_likelihood=None, priors=used_priors)

    def log_likelihood(params):
        full = dict(fixed_params)
        full.update(params)
        lqg = model_type(process_noise=process_noise, dt=dt, T=T - 1,
                         **full, **like)
        lls = lqg.log_likelihood(x)  # (n,) per trial, (C, n) for chains
        return _total(lls, model.ll_baseline)

    model.log_likelihood = log_likelihood
    return model


def lifted_model(x, model_type, process_noise=1.0, dt=1.0 / 60.0,
                 **fixed_params) -> ProbModel:
    """:func:`lqg_model` with the default priors (reference
    ``lifted_model``, ``models.py:134-135``)."""
    return lqg_model(x, model_type, process_noise=process_noise, dt=dt,
                     priors=DEFAULT_PRIOR, **fixed_params)


def common_lqg_model(x, model_type, process_noise=1.0, dt=1.0 / 60.0,
                     priors=None, **fixed_params) -> ProbModel:
    """Multi-condition model with shared parameters and per-condition target
    noise ``sigma_target_{c}`` (reference ``models.py:37-61``): the case of
    :func:`shared_params_lqg_model` where every free parameter except
    ``sigma_target`` is shared."""
    shared = [n for n in get_model_params(model_type) if n != "sigma_target"]
    return shared_params_lqg_model(
        x, model_type, process_noise=process_noise, dt=dt, priors=priors,
        shared_params=shared, **fixed_params)


def shared_params_lqg_model(x, model_type, process_noise=1.0, dt=1.0 / 60.0,
                            priors=None, shared_params=None, dim=1,
                            **fixed_params) -> ProbModel:
    """Hierarchical multi-condition model over ``x (Nc, n, T+1, d)``
    (reference ``models.py:67-130``).

    ``shared_params`` get one latent value across conditions; every other
    free parameter gets a per-condition latent ``f"{name}_{c}"``.  One call
    stacks the conditions' parameters (and the chains', for ``u (C, D)``)
    into ``P = C Nc`` parameter sets, builds one batched model and scores
    ``x`` repeated per chain in one ``log_likelihood``.
    """
    Nc, N, T, d = x.shape
    like = dict(dtype=x.dtype, device=x.device)

    if priors is None:
        priors = DEFAULT_PRIOR
    shared = set(shared_params or [])
    model_params = set(get_model_params(model_type).keys())
    shared = shared & model_params
    per_cond = sorted(model_params - shared - set(fixed_params))
    shared = sorted(shared - set(fixed_params))

    init, transforms, used_priors = {}, {}, {}
    for name in shared:
        pr = priors[name]
        init[name] = torch.as_tensor(pr.median, **like)
        transforms[name] = tfm.positive
        used_priors[name] = pr
    for name in per_cond:
        for c in range(Nc):
            site = f"{name}_{c}"
            pr = priors.get(site, priors[name])
            init[site] = torch.as_tensor(pr.median, **like)
            transforms[site] = tfm.positive
            used_priors[site] = pr

    model = ProbModel(init=init, transforms=transforms,
                      log_likelihood=None, priors=used_priors)
    # the delay-register models fix dim=1 in their constructors; only
    # forward it where accepted
    dim_kw = ({"dim": dim}
              if "dim" in inspect.signature(model_type.__init__).parameters
              else {})

    def log_likelihood(params):
        lead = _lead(params)  # () or (C,)
        sets = lead + (Nc,)
        # (C, Nc) parameters of every (chain, condition), flattened to P
        cond_params = {}
        for name in shared:
            cond_params[name] = params[name][..., None].expand(sets)
        for name in per_cond:
            cond_params[name] = torch.stack(
                [params[f"{name}_{c}"] for c in range(Nc)], -1).expand(sets)
        full = dict(fixed_params)
        full.update({k: v.reshape(-1) for k, v in cond_params.items()})
        lqg = model_type(process_noise=process_noise, dt=dt, T=T - 1,
                         **dim_kw, **full, **like)
        X = x.expand(lead + x.shape).reshape((-1,) + x.shape[1:])
        lls = lqg.log_likelihood(X)  # (P, N)
        return _total(lls.reshape(lead + (Nc * N,)), model.ll_baseline)

    model.log_likelihood = log_likelihood
    return model
