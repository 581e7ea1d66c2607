"""The port's inference front (transforms, distributions, priors, models and
the potential) against ``lqg_tpu.infer`` in float64, and the potential's
value and gradient on the fused route (the kernels' plain versions on the
CPU) against the float64 scan."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqg_tpu.infer import dists as jdists
from lqg_tpu.infer import models as jinfer
from lqg_tpu.infer import priors as jpriors
from lqg_tpu.infer import transforms as jtfm
from lqg_tpu import models as jmodels
from lqg_tpu_torch import infer as tinfer
from lqg_tpu_torch import models as tmodels
from lqg_tpu_torch.infer import dists as tdists
from lqg_tpu_torch.infer import transforms as ttfm
from lqg_tpu_torch import system as tsystem
from lqg_tpu_torch.ops.kernels import gains as kgains
from lqg_tpu_torch.ops.kernels import likelihood as klik
from lqg_tpu_torch.system import System

T = 60
RTOL = 1e-10
SHARED = ["action_cost", "action_variability", "sigma_cursor"]


def close(t, j, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(t.detach()), np.asarray(j),
                               rtol=rtol, atol=atol)


def _data(Nc, n, seed):
    """Trials of ``Nc`` bounded actors with target noise spread over the
    conditions, simulated by the JAX package: ``(Nc, n, T+1, 2)``."""
    return np.stack([np.asarray(jmodels.BoundedActor(
        T=T, sigma_target=5.0 + 10.0 * c).simulate(
            jax.random.PRNGKey(seed + c), n=n)) for c in range(Nc)])


TRANSFORMS = [("identity", (), {}), ("positive", (), {}),
              ("Softplus", (), {}), ("Sigmoid", (), dict(low=-2.0, high=3.0))]


@pytest.mark.parametrize("name,args,kw", TRANSFORMS)
def test_transforms_match_jax(name, args, kw, x64):
    u = np.linspace(-25.0, 25.0, 41)
    jt = getattr(jtfm, name)
    tt = getattr(ttfm, name)
    if kw or name == "Softplus":
        jt, tt = jt(**kw), tt(**kw)
    ut = torch.tensor(u)
    x = tt.forward(ut)
    close(x, jt.forward(jnp.asarray(u)))
    close(tt.log_abs_det_jacobian(ut), jt.log_abs_det_jacobian(jnp.asarray(u)))
    inner = np.abs(u) <= 12  # where the round trip is well conditioned
    close(tt.inverse(x)[inner], u[inner], rtol=1e-8, atol=1e-12)


DISTS = [("Normal", (0.5, 2.0)), ("HalfNormal", (12.5,)),
         ("LogNormal", (-2.0, 1.0)), ("Uniform", (-1.0, 3.0))]


@pytest.mark.parametrize("name,params", DISTS)
def test_distributions_match_jax(name, params, x64):
    jd = getattr(jdists, name)(*params)
    td = getattr(tdists, name)(*params)
    v = np.linspace(0.05, 2.5, 9)
    close(td.log_prob(torch.tensor(v)), jd.log_prob(jnp.asarray(v)))
    close(torch.as_tensor(td.median, dtype=torch.float64), jd.median)
    s = td.sample(torch.Generator().manual_seed(0), (4000,))
    assert s.shape == (4000,) and torch.isfinite(s).all()
    assert abs(float(s.median()) - float(jd.median)) < 0.15 * max(
        1.0, abs(float(jd.median)))


def test_priors_match_jax(x64):
    assert sorted(tinfer.DEFAULT_PRIOR) == sorted(jpriors.DEFAULT_PRIOR)
    for name, jd in jpriors.DEFAULT_PRIOR.items():
        td = tinfer.DEFAULT_PRIOR[name]
        assert type(td).__name__ == type(jd).__name__
        close(torch.as_tensor(td.median, dtype=torch.float64), jd.median)
    draw = tinfer.sample_params(torch.Generator().manual_seed(1))
    assert list(draw) == sorted(jpriors.DEFAULT_PRIOR)
    assert all(bool(torch.isfinite(v)) for v in draw.values())
    for a, b in zip(tinfer.lognormal_from_quantiles(0.1, 4.0),
                    jpriors.lognormal_from_quantiles(0.1, 4.0)):
        close(a, b)
    for a, b in zip(tinfer.lognormal_params(2.0, 0.5),
                    jpriors.lognormal_params(2.0, 0.5)):
        close(torch.as_tensor(a, dtype=torch.float64), b)


def _models(x):
    """(name, JAX model, port model) over the same trials."""
    xj, xt = jnp.asarray(x), torch.tensor(x)
    return [
        ("lqg_model", jinfer.lqg_model(xj[0], jmodels.BoundedActor),
         tinfer.lqg_model(xt[0], tmodels.BoundedActor)),
        ("lifted_model", jinfer.lifted_model(xj[0], jmodels.BoundedActor),
         tinfer.lifted_model(xt[0], tmodels.BoundedActor)),
        ("shared", jinfer.shared_params_lqg_model(
            xj, jmodels.BoundedActor, shared_params=SHARED),
         tinfer.shared_params_lqg_model(xt, tmodels.BoundedActor,
                                        shared_params=SHARED)),
        ("common", jinfer.common_lqg_model(xj, jmodels.BoundedActor),
         tinfer.common_lqg_model(xt, tmodels.BoundedActor)),
    ]


def test_models_names_and_init_match_jax(x64):
    assert tinfer.get_model_params(tmodels.BoundedActor) == \
        jinfer.get_model_params(jmodels.BoundedActor)
    for name, jm, tm in _models(_data(2, 3, 0)):
        assert tm.names == jm.names, name
        close(tm.init_unconstrained(), jm.init_unconstrained())


@pytest.mark.parametrize("which", ["lqg_model", "lifted_model", "shared"])
def test_potential_value_and_grad_match_jax(which, x64):
    """Mirrors ``tests/test_infer.py``'s hierarchical potential at T=60 on
    the scan path, for one ``u`` and for a batch of chains ``u (C, D)``."""
    _, jm, tm = next(m for m in _models(_data(2, 3, 1)) if m[0] == which)
    u0 = np.asarray(jm.init_unconstrained())
    us = u0 + 0.2 * np.random.default_rng(2).normal(size=(3,) + u0.shape)
    u = torch.tensor(us, requires_grad=True)
    pot = tm.potential(u)
    assert pot.shape == (3,)
    (grad,) = torch.autograd.grad(pot.sum(), u)
    jv, jg = jax.jit(jax.vmap(jax.value_and_grad(jm.potential)))(
        jnp.asarray(us))
    close(pot, jv)
    close(grad, jg, atol=1e-9 * float(np.abs(jg).max()))
    u1 = torch.tensor(us[1], requires_grad=True)
    v1 = tm.potential(u1)
    assert v1.shape == ()
    (g1,) = torch.autograd.grad(v1, u1)
    close(v1, jv[1])
    close(g1, jg[1], atol=1e-9 * float(np.abs(jg).max()))


def test_fused_route_potential_matches_float64_scan(monkeypatch):
    """The float32 hierarchical potential with both kernels' routes forced
    on (the JAX tests force ``System._fused_ok`` the same way): the two
    ``autograd.Function``s run their plain versions on the CPU, one forward
    and one backward for all chains and conditions at once."""
    x = _data(2, 3, 3)
    m64 = tinfer.shared_params_lqg_model(torch.tensor(x),
                                         tmodels.BoundedActor,
                                         shared_params=SHARED)
    m32 = tinfer.shared_params_lqg_model(torch.tensor(x, dtype=torch.float32),
                                         tmodels.BoundedActor,
                                         shared_params=SHARED)
    u0 = m64.init_unconstrained()
    us = u0 + 0.2 * torch.tensor(
        np.random.default_rng(4).normal(size=(4,) + u0.shape))
    u = us.clone().requires_grad_()
    v64 = m64.potential(u)
    (g64,) = torch.autograd.grad(v64.sum(), u)

    monkeypatch.setattr(System, "_fused_ok", lambda self, Sigma0: True)
    monkeypatch.setattr(System, "_fused_ll_ok", lambda self, F, x: True)
    calls = []
    for module, name in ((tsystem, "fused_gains"),
                         (tsystem, "conditioned_log_likelihood_fused"),
                         (kgains, "fused_gains_vjp"),
                         (klik, "conditioned_log_likelihood_vjp")):
        monkeypatch.setattr(module, name,
                            _recording(getattr(module, name), calls))
    u32 = us.float().requires_grad_()
    v32 = m32.potential(u32)
    (g32,) = torch.autograd.grad(v32.sum(), u32)
    close(v32.double(), v64.detach(), rtol=5e-4)
    close(g32.double(), g64, rtol=5e-4)
    # one forward and one backward of each, for all chains and conditions
    assert sorted(calls) == sorted(
        ["fused_gains", "conditioned_log_likelihood_fused",
         "fused_gains_vjp", "conditioned_log_likelihood_vjp"])


def _recording(fn, calls):
    def wrapped(*args, **kw):
        calls.append(fn.__name__)
        return fn(*args, **kw)
    return wrapped
