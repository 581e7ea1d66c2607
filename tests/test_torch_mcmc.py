"""The port's MCMC runs (``lqg_tpu_torch.infer.mcmc``) and ``infer``:
whole runs against ``lqg_tpu.infer.mcmc`` fed JAX's draws, the sampler's
moments, checkpoint/resume, and (``-m cuda``, on the card) the value and
gradient replayed from a CUDA graph.

JAX is imported inside the tests that compare with it, so that the card's
tests run where JAX is not installed (``--noconftest``)."""

import numpy as np
import pytest
import torch

from lqg_tpu_torch import models as tmodels
from lqg_tpu_torch.infer import transforms as ttfm
from lqg_tpu_torch.infer.dists import LogNormal
from lqg_tpu_torch.infer.mcmc import MCMC
from lqg_tpu_torch.infer.models import (ProbModel, get_model_params,
                                        lifted_model)
from lqg_tpu_torch.infer.utils import infer, sample_from_prior

MU = np.array([1.0, -2.0])
COV = np.array([[2.0, 1.2], [1.2, 1.5]])


def _gaussian_model(dtype=torch.float64):
    """``tests/test_infer.py``'s correlated Gaussian target."""
    mu, prec = torch.tensor(MU, dtype=dtype), torch.tensor(
        np.linalg.inv(COV), dtype=dtype)

    def ll(p):
        z = torch.stack([p["a"], p["b"]], -1) - mu
        return -0.5 * ((z @ prec) * z).sum(-1)

    zero = torch.zeros((), dtype=dtype)
    return ProbModel(init={"a": zero, "b": zero},
                     transforms={"a": ttfm.identity, "b": ttfm.identity},
                     log_likelihood=ll, priors={})


def _jax_gaussian_model():
    import jax.numpy as jnp
    from lqg_tpu.infer import transforms as jtfm
    from lqg_tpu.infer.models import ProbModel as JaxProbModel

    prec = jnp.asarray(np.linalg.inv(COV))

    def ll(p):
        z = jnp.stack([p["a"], p["b"]]) - MU
        return -0.5 * z @ prec @ z

    return JaxProbModel(init={"a": jnp.asarray(0.0), "b": jnp.asarray(0.0)},
                        transforms={"a": jtfm.identity, "b": jtfm.identity},
                        log_likelihood=ll, priors={})


def _jax_run(model, key, num_chains, num_warmup, num_samples, **kw):
    """``lqg_tpu.infer.mcmc.MCMC.run``'s transitions, driven one by one: its
    launch program (a ``lax.scan`` whose leapfrog counter is float32) does
    not trace in float64, so the chains' init and steps are called as its
    ``run`` calls them (``mcmc.py:296-312``, ``:159``)."""
    import jax
    from jax import random
    from lqg_tpu.infer.mcmc import MCMC as JaxMCMC

    m = JaxMCMC(model, num_warmup=num_warmup, num_samples=num_samples,
                num_chains=num_chains, **kw)
    total = num_warmup + num_samples * m.thinning
    flags, caps = m._build_schedule(total)
    u0 = model.init_unconstrained()
    C, D = num_chains, u0.shape[0]
    m._dense = m.dense_mass if m.dense_mass is not None else 2 <= D <= 64
    keys = random.split(key, C + 1)
    z0 = u0[None, :] + m.init_jitter * random.uniform(
        keys[0], (C, D), minval=-1.0, maxval=1.0)
    state = jax.jit(jax.vmap(m._init_chain))(keys[1:], z0)
    step = jax.jit(jax.vmap(m._step_one, in_axes=(0, None, None)))
    outs = []
    for i in range(total):
        state, out = step(state, tuple(flags[i]), caps[i])
        outs.append(out)
    sel = slice(num_warmup + m.thinning - 1, None, m.thinning)
    zs, accept, div, steps, depth, pes = (
        np.moveaxis(np.stack([np.asarray(o[k]) for o in outs]), 0, 1)[:, sel]
        for k in range(6))
    return dict(z=zs, accept_prob=accept, diverging=div, num_steps=steps,
                tree_depth=depth, potential_energy=pes,
                step_size=np.asarray(state.step_size),
                inv_mass=np.asarray(state.inv_mass))


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "diag"])
def test_mcmc_run_matches_jax(dense, x64):
    """A whole short run, 2 chains, 40 warmup steps (a slow window closes at
    step 35 and the step size freezes at 39) and 10 samples, fed the draws
    of JAX's key schedule: the samples, every extra field and the final step
    size and inverse mass equal JAX's."""
    from jax import random
    from test_torch_hmc import JaxDraws

    key = random.PRNGKey(3)
    want = _jax_run(_jax_gaussian_model(), key, 2, 40, 10, dense_mass=dense)
    got = MCMC(_gaussian_model(), num_warmup=40, num_samples=10,
               num_chains=2, dense_mass=dense).run(JaxDraws(key))
    extra = got.get_extra_fields()
    np.testing.assert_allclose(got._samples_u.numpy(), want["z"], rtol=1e-8)
    for k in ("accept_prob", "potential_energy"):
        np.testing.assert_allclose(extra[k], want[k], rtol=1e-8)
    for k in ("diverging", "num_steps", "tree_depth"):
        np.testing.assert_array_equal(extra[k], want[k])
    for k in ("step_size", "inv_mass"):
        np.testing.assert_allclose(extra[k].numpy(), want[k], rtol=1e-8,
                                   atol=1e-12)
    assert want["tree_depth"].max() >= 2


def test_nuts_gaussian_moments():
    """NUTS samples the correct distribution (``tests/test_infer.py:73``,
    same tolerances)."""
    m = MCMC(_gaussian_model(), num_warmup=500, num_samples=1500,
             num_chains=4).run(0)
    s = m.get_samples()
    a, b = s["a"].numpy(), s["b"].numpy()
    assert m.divergences == 0
    np.testing.assert_allclose(a.mean(), 1.0, atol=0.15)
    np.testing.assert_allclose(b.mean(), -2.0, atol=0.15)
    np.testing.assert_allclose(a.var(), 2.0, rtol=0.15)
    np.testing.assert_allclose(b.var(), 1.5, rtol=0.15)
    np.testing.assert_allclose(np.cov(a, b)[0, 1], 1.2, rtol=0.25)

    df = m.summary()
    assert (df["r_hat"] < 1.05).all()
    assert (df["n_eff"] > 200).all()


def test_nuts_constrained_target():
    """Positive-constrained sampling: with a flat likelihood the posterior
    is the LogNormal prior (``tests/test_infer.py:95``, same tolerances)."""
    model = ProbModel(init={"s": torch.tensor(1.0, dtype=torch.float64)},
                      transforms={"s": ttfm.positive},
                      log_likelihood=lambda p: torch.zeros_like(p["s"]),
                      priors={"s": LogNormal(0.3, 0.7)})
    m = MCMC(model, num_warmup=500, num_samples=2000, num_chains=2).run(1)
    s = m.get_samples()["s"].numpy()
    assert (s > 0).all()
    np.testing.assert_allclose(np.log(s).mean(), 0.3, atol=0.1)
    np.testing.assert_allclose(np.log(s).std(), 0.7, rtol=0.15)


KW = dict(num_warmup=16, num_samples=16, num_chains=2, max_depth=5)


def test_checkpoint_resume_is_exact_with_another_chunk_size(tmp_path):
    """A run stopped after two chunks resumes to the uninterrupted run's
    draws exactly, with another ``chunk_steps`` (``tests/test_infer.py:296``):
    a transition's draws depend on its index alone."""
    model = _gaussian_model()
    ref = MCMC(model, chunk_steps=8, **KW).run(1)
    path = str(tmp_path / "run.npz")
    out = MCMC(model, chunk_steps=8, checkpoint_every=1, **KW).run(
        1, checkpoint_path=path, _stop_after_launches=2)
    assert out is None  # stopped early, the checkpoint left behind
    resumed = MCMC(model, chunk_steps=5, **KW).run(1, checkpoint_path=path)
    assert torch.equal(resumed._samples_u, ref._samples_u)
    for k, v in ref.get_extra_fields().items():
        np.testing.assert_array_equal(np.asarray(resumed.get_extra_fields()[k]),
                                      np.asarray(v))


def test_checkpoint_rejects_another_configuration(tmp_path):
    model = _gaussian_model()
    path = str(tmp_path / "run.npz")
    MCMC(model, chunk_steps=8, checkpoint_every=1, **KW).run(
        1, checkpoint_path=path, _stop_after_launches=1)
    with pytest.raises(ValueError, match="different MCMC configuration"):
        MCMC(model, **{**KW, "num_samples": 32}).run(1, checkpoint_path=path)


def test_checkpoint_rejects_a_stale_chunk(tmp_path):
    """A chunk file of another run at the same path fails its nonce."""
    import shutil

    model = _gaussian_model()
    path, other = str(tmp_path / "run.npz"), str(tmp_path / "other.npz")
    for p in (path, other):
        MCMC(model, chunk_steps=8, checkpoint_every=1, **KW).run(
            1, checkpoint_path=p, _stop_after_launches=1)
    shutil.copy(other + ".chunk_00000.npz", path + ".chunk_00000.npz")
    with pytest.raises(ValueError, match="nonce"):
        MCMC(model, chunk_steps=8, **KW).run(1, checkpoint_path=path)


def test_leapfrog_budget_keeps_the_draws():
    """A budget of one leapfrog ends every chunk after one transition; the
    draws are those of an unbudgeted run (``tests/test_infer.py:344``)."""
    model = _gaussian_model()
    ref = MCMC(model, chunk_steps=16, **KW).run(2)
    tight = MCMC(model, chunk_steps=16, max_leapfrogs_per_launch=1,
                 **KW).run(2)
    assert torch.equal(tight._samples_u, ref._samples_u)


def test_mcmc_defaults_and_one_rank_chain_sharding():
    """The defaults; and ``chain_sharding`` over the chains axis of a
    one-rank mesh (no process group) gives the unsharded draws."""
    from lqg_tpu_torch.parallel.mesh import AxisSharding, make_mesh

    model = _gaussian_model()
    assert MCMC(model).chunk_steps == 64
    assert MCMC(model).max_leapfrogs_per_launch == 1 << 30
    assert MCMC(model, chunk_steps=7).chunk_steps == 7
    mesh = make_mesh([("chains", 1)], device="cpu")
    sharded = MCMC(model, **KW).run(
        0, chain_sharding=AxisSharding(mesh, "chains"))
    ref = MCMC(model, **KW).run(0)
    assert torch.equal(sharded._samples_u, ref._samples_u)
    for k, v in ref.get_extra_fields().items():
        np.testing.assert_array_equal(np.asarray(sharded._extra[k]),
                                      np.asarray(v))


def test_infer_and_sample_from_prior_on_the_cpu():
    """``infer(method="nuts")`` and ``infer(method="neutra")`` through the
    lifted bounded actor, eager on the CPU."""
    params = sample_from_prior(tmodels.BoundedActor, 0, device="cpu")
    assert sorted(params) == sorted(get_model_params(tmodels.BoundedActor))
    assert all(float(v) > 0 for v in params.values())
    x = tmodels.BoundedActor(T=8, device="cpu", **params).simulate(
        torch.Generator().manual_seed(0), n=2)
    mcmc = infer(x.numpy(), num_samples=3, num_warmup=3, num_chains=2,
                 max_depth=2, progress_bar=False, device="cpu")
    samples = mcmc.get_samples(group_by_chain=True)
    assert sorted(samples) == sorted(params)
    assert all(v.shape == (2, 3) and torch.isfinite(v).all()
               for v in samples.values())
    neutra = infer(x, num_samples=3, num_warmup=3, method="neutra",
                   neutra_steps=10, num_chains=2, max_depth=2,
                   progress_bar=False, device="cpu")
    samples = neutra.get_samples(group_by_chain=True)
    assert sorted(samples) == sorted(params)
    assert all(v.shape == (2, 3) and torch.isfinite(v).all()
               and (v > 0).all() for v in samples.values())
    with pytest.raises(ValueError):
        infer(x, 4, 4, method="hmc", device="cpu")


# --- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_model(cuda, T=200, n=5):
    m = tmodels.BoundedActor(T=T, device=cuda)
    x = m.simulate(torch.Generator(device=cuda).manual_seed(0), n=n)
    return lifted_model(x, tmodels.BoundedActor)


@pytest.mark.cuda
def test_replayed_value_and_grad_equals_eager_on_card(cuda):
    from lqg_tpu_torch.infer.capture import (GraphedValueAndGrad,
                                             eager_value_and_grad)

    model = _card_model(cuda)
    u0 = model.init_unconstrained()
    g = torch.Generator(device=cuda).manual_seed(1)
    u = u0 + 0.1 * torch.randn((4,) + u0.shape, generator=g, device=cuda)
    graphed = GraphedValueAndGrad(model.potential, u)
    eager = eager_value_and_grad(model.potential)
    for k in range(3):
        uk = u + 0.05 * k * torch.randn(u.shape, generator=g, device=cuda)
        (pe_g, grad_g), (pe_e, grad_e) = graphed(uk), eager(uk)
        torch.testing.assert_close(pe_g, pe_e, rtol=1e-6, atol=0.0)
        torch.testing.assert_close(
            grad_g, grad_e, rtol=1e-6,
            atol=1e-6 * float(grad_e.abs().max()))
    assert graphed.replays == 3


@pytest.mark.cuda
def test_graph_backed_mcmc_run_on_card(cuda):
    from lqg_tpu_torch.infer.capture import GraphedValueAndGrad

    mcmc = MCMC(_card_model(cuda), num_warmup=20, num_samples=10,
                num_chains=2).run(0)
    assert isinstance(mcmc.value_and_grad, GraphedValueAndGrad)
    assert mcmc.value_and_grad.replays > 0
    samples = mcmc.get_samples(group_by_chain=True)
    assert all(v.shape == (2, 10) and torch.isfinite(v).all()
               for v in samples.values())
