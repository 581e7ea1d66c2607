"""The port's IAF guides and NeuTra (``lqg_tpu_torch.infer.flows``,
``infer.utils.neutra_reparam``, ``infer(method="neutra")``) against
``lqg_tpu.infer`` in float64 on the CPU: the MADE masks, the flow's
transform and log-determinant, ``fit_auto_iaf`` fed JAX's initial guide and
draws, its skip of non-finite steps, the reparametrized potential, and a
whole NUTS run on a reparametrized model fed JAX's draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from lqg_tpu.infer import flows as jflows
from lqg_tpu.infer import transforms as jtfm
from lqg_tpu.infer import utils as jutils
from lqg_tpu.infer.models import ProbModel as JaxProbModel
from lqg_tpu_torch import models as tmodels
from lqg_tpu_torch.convert import guide_from_numpy
from lqg_tpu_torch.infer import flows as tflows
from lqg_tpu_torch.infer import transforms as ttfm
from lqg_tpu_torch.infer.mcmc import MCMC
from lqg_tpu_torch.infer.models import ProbModel, get_model_params
from lqg_tpu_torch.infer.utils import infer, neutra_reparam

from test_torch_svi import JaxGuideDraws, close, models


@pytest.fixture(autouse=True)
def one_thread():
    """These tests run many small ops on the CPU: with one intra-op thread,
    whose pool would otherwise keep every core busy and slow the other
    test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def perturbed_iaf(dim, num_layers, hidden=16, scale=0.4, seed=0):
    """``tests/test_infer.py:151-158``'s perturbed flow, and the port's copy
    of it."""
    g = jflows.make_auto_iaf(random.PRNGKey(seed), dim=dim, hidden=hidden,
                             num_layers=num_layers)
    key = random.PRNGKey(seed + 1)
    loc, ls, layers = jax.tree.map(
        lambda x: x + scale * random.normal(key, x.shape),
        (g.loc, g.log_scale, g.layers))
    jg = jflows.AutoIAF(loc=loc, log_scale=ls, layers=layers, masks=g.masks)
    return jg, guide_from_numpy(jax.tree.map(np.asarray, jg), device="cpu",
                                dtype=torch.float64)


@pytest.mark.parametrize("dim", [1, 2, 5, 9])
@pytest.mark.parametrize("hidden", [3, 16, 32])
@pytest.mark.parametrize("reverse", [False, True])
def test_made_masks_equal_jax(dim, hidden, reverse):
    for a, b in zip(tflows._made_masks(dim, hidden, reverse),
                    jflows._made_masks(dim, hidden, reverse)):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), b)


def test_make_auto_iaf_carries_jax_masks():
    """The port's fresh guide has JAX's masks, layer by layer, and maps a
    batch of ``eps`` to finite points with one log-determinant each."""
    g = tflows.make_auto_iaf(0, 5, hidden=8, num_layers=3, device="cpu")
    jg = jflows.make_auto_iaf(random.PRNGKey(0), 5, hidden=8, num_layers=3)
    for tm, jm in zip(g.masks, jg.masks):
        for a, b in zip(tm, jm):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    eps = torch.randn((4, 5), generator=torch.Generator().manual_seed(0))
    u, ld = g.transform_and_logdet(eps)
    assert u.shape == (4, 5) and ld.shape == (4,)
    assert torch.isfinite(u).all() and torch.isfinite(ld).all()


@pytest.mark.parametrize("guide", ["iaf", "mvn"])
def test_guide_sample_is_the_transform_of_standard_normals(guide, x64):
    """``sample(generator, shape)`` draws ``eps`` of ``shape + (D,)`` from
    the generator and maps them through ``transform``."""
    from lqg_tpu_torch.infer.svi import AutoMVN

    _, g = perturbed_iaf(3, 2)
    if guide == "mvn":
        g = AutoMVN(loc=g.loc, scale_tril=torch.tril(
            torch.ones(3, 3, dtype=torch.float64)))
    u = g.sample(torch.Generator().manual_seed(1), (5, 2))
    eps = torch.randn((5, 2, 3), generator=torch.Generator().manual_seed(1),
                      dtype=torch.float64)
    assert u.shape == (5, 2, 3)
    torch.testing.assert_close(u, g.transform(eps), rtol=0, atol=0)


@pytest.mark.parametrize("num_layers", [1, 3])
def test_iaf_transform_and_logdet_match_jax(num_layers, x64):
    """A perturbed flow carried across: ``transform_and_logdet`` on a batch
    of ``eps`` equals JAX's per vector within rtol 1e-12, and the batch
    equals the port's own vector calls."""
    jg, tg = perturbed_iaf(4, num_layers)
    eps = np.random.default_rng(2).normal(size=(6, 4))
    u, ld = tg.transform_and_logdet(torch.tensor(eps))
    ju, jld = jax.vmap(jg.transform_and_logdet)(jnp.asarray(eps))
    close(u.numpy(), ju, rtol=1e-12)
    close(ld.numpy(), jld, rtol=1e-12)
    u1, ld1 = tg.transform_and_logdet(torch.tensor(eps[3]))
    close(u1.numpy(), u[3].numpy(), rtol=1e-13)
    close(ld1.numpy(), ld[3].numpy(), rtol=1e-13)


@pytest.mark.parametrize("kind", ["lifted", "shared"])
def test_fit_auto_iaf_matches_jax(kind, x64):
    """50 ELBO steps of 4 particles from JAX's initial guide, fed JAX's
    draws (chunks of 25): the loss trace within rtol 1e-8, every final
    parameter within rtol 1e-7 (of its leaf's largest entry where it
    cancels to near zero)."""
    jm, tm = models(kind)
    key = random.PRNGKey(4)
    kw = dict(steps=50, step_size=5e-3, num_particles=4, hidden=8)
    jg, jl = jflows.fit_auto_iaf(jm, key, chunk_steps=25, **kw)
    key_init, key_fit = random.split(key)
    tg, tl = tflows.fit_auto_iaf(tm, JaxGuideDraws(key_fit, 50, 25,
                                                   key_init=key_init), **kw)
    close(tl.numpy(), jl, rtol=1e-8)
    for a, b in zip(jax.tree.leaves((tg.loc, tg.log_scale, tg.layers)),
                    jax.tree.leaves((jg.loc, jg.log_scale, jg.layers))):
        b = np.asarray(b)
        close(a.numpy(), b, rtol=1e-7, atol=1e-9 * np.abs(b).max())
    for tmask, jmask in zip(tg.masks, jg.masks):
        for a, b in zip(tmask, jmask):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _nan_beyond_two(log, where, nan):
    """``tests/test_infer.py:257-278``'s model: NaN once the guide samples
    past ``|log a| > 2``."""

    def log_likelihood(params):
        v = params["a"]
        return where(abs(log(v)) < 2.0, -0.5 * log(v) ** 2, nan)

    return log_likelihood


def test_fit_auto_iaf_skips_nonfinite_steps_as_jax(x64):
    """300 steps (JAX in chunks of 100) on a model whose likelihood is NaN
    at extreme draws: NaN losses at the same steps as JAX, the skipped
    steps' updates zero-gradient Adam steps, and the parameters within
    rtol 1e-9 of JAX's at the end."""
    jm = JaxProbModel(init={"a": jnp.asarray(1.0)},
                      transforms={"a": jtfm.positive},
                      log_likelihood=_nan_beyond_two(jnp.log, jnp.where,
                                                     jnp.nan),
                      priors=None)
    tm = ProbModel(init={"a": torch.tensor(1.0, dtype=torch.float64)},
                   transforms={"a": ttfm.positive},
                   log_likelihood=_nan_beyond_two(torch.log, torch.where,
                                                  torch.nan),
                   priors=None)
    key = random.PRNGKey(3)
    jg, jl = jflows.fit_auto_iaf(jm, key, steps=300, chunk_steps=100,
                                 init_log_scale=0.0)
    key_init, key_fit = random.split(key)
    tg, tl = tflows.fit_auto_iaf(
        tm, JaxGuideDraws(key_fit, 300, 100, key_init=key_init), steps=300,
        init_log_scale=0.0)
    jl = np.asarray(jl)
    assert np.isnan(jl).any() and np.isfinite(jl).any()
    np.testing.assert_array_equal(np.isnan(tl.numpy()), np.isnan(jl))
    close(tl.numpy()[np.isfinite(jl)], jl[np.isfinite(jl)], rtol=1e-9)
    for a, b in zip(jax.tree.leaves((tg.loc, tg.log_scale, tg.layers)),
                    jax.tree.leaves((jg.loc, jg.log_scale, jg.layers))):
        b = np.asarray(b)
        assert np.isfinite(a.numpy()).all()
        close(a.numpy(), b, rtol=1e-9, atol=1e-12 * np.abs(b).max())


@pytest.mark.parametrize("guide", ["iaf", "mvn"])
def test_neutra_potential_and_gradient_match_jax(guide, x64):
    """The lifted bounded actor reparametrized through a carried-across
    guide: the potential and its gradient in ``eps`` at a batch of points
    equal JAX's within rtol 1e-10; ``constrain`` maps ``eps`` through the
    guide; chains start at ``eps = 0``."""
    jm, tm = models("lifted")
    D = len(tm.names)
    if guide == "iaf":
        jg, tg = perturbed_iaf(D, 2, scale=0.1)
    else:
        from lqg_tpu.infer.svi import AutoMVN

        rng = np.random.default_rng(5)
        tril = np.tril(0.1 * rng.normal(size=(D, D)), -1) + np.diag(
            np.exp(0.3 * rng.normal(size=D)))
        jg = AutoMVN(loc=jm.init_unconstrained(), scale_tril=jnp.asarray(tril))
        tg = guide_from_numpy(jax.tree.map(np.asarray, jg), device="cpu",
                              dtype=torch.float64)
    jr, tr = jutils.neutra_reparam(jm, jg), neutra_reparam(tm, tg)
    eps = 0.5 * np.random.default_rng(6).normal(size=(3, D))
    pe, grad = tr.value_and_grad(torch.tensor(eps))
    jpe, jgrad = jax.jit(jax.vmap(jax.value_and_grad(jr.potential)))(
        jnp.asarray(eps))
    close(pe.numpy(), jpe, rtol=1e-10)
    close(grad.numpy(), jgrad, rtol=1e-10,
          atol=1e-12 * float(np.abs(np.asarray(jgrad)).max()))
    assert torch.equal(tr.init_unconstrained(), torch.zeros(D,
                                                            dtype=torch.float64))
    tc, jc = tr.constrain(torch.tensor(eps)), jax.vmap(jr.constrain)(
        jnp.asarray(eps))
    for k in tm.names:
        close(tc[k].numpy(), jc[k], rtol=1e-12)


def test_mcmc_run_on_reparametrized_model_matches_jax(x64):
    """A whole short NUTS run (2 chains, 40 warmup, 10 samples) on the
    correlated Gaussian reparametrized through a perturbed IAF, fed JAX's
    draws: the samples, every extra field and the adapted step size and
    inverse mass equal ``lqg_tpu``'s run with the same guide
    (``tests/test_torch_mcmc.py:92``).  The flow is perturbed by 0.1: a
    flow perturbed by 0.2 (seed 8) warps the target so that the chains
    accept ~20%, and there the two packages' last-bit differences in the
    potential grow to 1e-6 over the 50 transitions."""
    from test_torch_hmc import JaxDraws
    from test_torch_mcmc import (_gaussian_model, _jax_gaussian_model,
                                 _jax_run)

    jg, tg = perturbed_iaf(2, 2, scale=0.1, seed=3)
    key = random.PRNGKey(5)
    want = _jax_run(jutils.neutra_reparam(_jax_gaussian_model(), jg), key, 2,
                    40, 10, dense_mass=True)
    got = MCMC(neutra_reparam(_gaussian_model(), tg), num_warmup=40,
               num_samples=10, num_chains=2, dense_mass=True).run(
                   JaxDraws(key))
    extra = got.get_extra_fields()
    close(got._samples_u.numpy(), want["z"], rtol=1e-8)
    for k in ("accept_prob", "potential_energy"):
        close(extra[k], want[k], rtol=1e-8)
    for k in ("diverging", "num_steps", "tree_depth"):
        np.testing.assert_array_equal(extra[k], want[k])
    for k in ("step_size", "inv_mass"):
        close(extra[k].numpy(), want[k], rtol=1e-8, atol=1e-12)
    samples = got.get_samples()
    assert sorted(samples) == ["a", "b"]
    assert all(torch.isfinite(v).all() for v in samples.values())


@pytest.mark.parametrize("guide", ["iaf", "mvn"])
def test_infer_neutra_end_to_end_on_the_cpu(guide):
    """``infer(method="neutra")`` through the lifted bounded actor, eager on
    the CPU (``tests/test_infer.py:138-148``, cut to fit the CPU): finite,
    positive samples of every parameter."""
    m = tmodels.BoundedActor(T=20, device="cpu")
    x = m.simulate(torch.Generator().manual_seed(0), n=3)
    mcmc = infer(x, num_samples=4, num_warmup=4, model=tmodels.BoundedActor,
                 method="neutra", neutra_guide=guide, neutra_steps=30,
                 num_chains=2, max_depth=3, seed=0, progress_bar=False)
    samples = mcmc.get_samples(group_by_chain=True)
    assert sorted(samples) == sorted(get_model_params(tmodels.BoundedActor))
    for v in samples.values():
        assert v.shape == (2, 4)
        assert torch.isfinite(v).all() and (v > 0).all()
    with pytest.raises(ValueError, match="neutra_guide"):
        infer(x, 2, 2, method="neutra", neutra_guide="bnaf", device="cpu")
