"""The port's point estimation and Gaussian guides
(``lqg_tpu_torch.infer.svi``, ``infer.mle``) against ``lqg_tpu.infer`` in
float64 on the CPU: Adam trajectories (``optimize``, ``max_likelihood``),
``AutoMVN``, ``fit_auto_mvn`` fed JAX's draws, and ``laplace_guide``; on
the card (``-m cuda``) the graph-replayed potential inside an outer autograd
graph and graphed optimizer steps against eager ones.

The models are a lifted ``BoundedActor(T=30)`` over 3 trials and a
2-condition ``shared_params_lqg_model`` at T=30.  JAX is imported inside the
tests and helpers, so that the card's tests run where JAX is not installed
(``--noconftest``)."""

import numpy as np
import pytest
import torch

from lqg_tpu_torch import models as tmodels
from lqg_tpu_torch.convert import guide_from_numpy
from lqg_tpu_torch.infer import models as tinfer
from lqg_tpu_torch.infer import svi as tsvi
from lqg_tpu_torch.infer.capture import GraphedPotential, eager_value_and_grad
from lqg_tpu_torch.infer.mle import max_likelihood

T = 30
SHARED = ["action_cost", "action_variability", "sigma_cursor"]
MODELS = ["lifted", "shared"]


@pytest.fixture(autouse=True)
def one_thread():
    """These tests run many small ops on the CPU: with one intra-op thread,
    whose pool would otherwise keep every core busy and slow the other
    test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trials(n, seed, **params):
    import jax
    from lqg_tpu import models as jmodels

    return np.asarray(jmodels.BoundedActor(T=T, **params).simulate(
        jax.random.PRNGKey(seed), n=n))


def models(kind):
    """``(JAX model, port model)`` on the same trials, float64."""
    import jax.numpy as jnp
    from lqg_tpu import models as jmodels
    from lqg_tpu.infer import models as jinfer

    if kind == "lifted":
        x = _trials(3, 0)
        return (jinfer.lifted_model(jnp.asarray(x), jmodels.BoundedActor),
                tinfer.lifted_model(torch.tensor(x), tmodels.BoundedActor))
    x = np.stack([_trials(3, 1 + c, sigma_target=4.0 + 6.0 * c)
                  for c in range(2)])
    return (jinfer.shared_params_lqg_model(jnp.asarray(x),
                                           jmodels.BoundedActor,
                                           shared_params=SHARED),
            tinfer.shared_params_lqg_model(torch.tensor(x),
                                           tmodels.BoundedActor,
                                           shared_params=SHARED))


def close(t, j, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol)


class JaxGuideDraws:
    """The draw source of the port's guide fits that replays the JAX fits'
    key schedule: per chunk of ``chunk_steps`` steps starting at ``i0``,
    ``random.split(random.fold_in(key, i0), n)``, and step ``i``'s particles
    ``random.normal(keys[i - i0], (P, D))`` (``svi.py:126-131``,
    ``flows.py:210-214``); the IAF's initial guide is JAX's
    ``make_auto_iaf(key_init, ...)``, carried across."""

    def __init__(self, key, steps, chunk_steps, key_init=None):
        self.key, self.steps, self.chunk = key, steps, chunk_steps
        self.key_init = key_init

    def init_iaf(self, dim, hidden, num_layers, loc, init_log_scale):
        import jax
        import jax.numpy as jnp
        from lqg_tpu.infer.flows import make_auto_iaf

        g = make_auto_iaf(self.key_init, dim, hidden=hidden,
                          num_layers=num_layers,
                          loc=jnp.asarray(loc.numpy()),
                          init_log_scale=init_log_scale)
        return guide_from_numpy(jax.tree.map(np.asarray, g), device="cpu",
                                dtype=loc.dtype)

    def eps(self, i, P, D, dtype):
        from jax import random

        i0 = (i // self.chunk) * self.chunk
        n = min(self.chunk, self.steps - i0)
        keys = random.split(random.fold_in(self.key, i0), n)
        return torch.tensor(np.asarray(random.normal(keys[i - i0], (P, D))),
                            dtype=dtype)


# --- Adam and point estimation ---------------------------------------------

def test_adam_matches_optax_on_a_fixed_gradient_sequence(x64):
    """The update rule alone: 30 steps of random gradients on two leaves,
    the same bits-level trajectory as ``optax.adam``."""
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(0)
    params = [rng.normal(size=(3,)), rng.normal(size=(2, 2))]
    grads = [[rng.normal(size=p.shape) * 10.0 ** rng.integers(-3, 3)
              for p in params] for _ in range(30)]
    opt = optax.adam(0.05)
    jp = [jnp.asarray(p) for p in params]
    js = opt.init(jp)
    topt = tsvi.adam(0.05)
    tp = [torch.tensor(p) for p in params]
    ts = topt.init(tp)
    for g in grads:
        upd, js = opt.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, ts = topt.update([torch.tensor(x) for x in g], ts)
        tp = tsvi.apply_updates(tp, tupd)
    for a, b in zip(tp, jp):
        close(a.numpy(), b, rtol=1e-14)


@pytest.mark.parametrize("kind", MODELS)
def test_optimize_matches_jax(kind, x64):
    """100 Adam steps from the model's initial point: the losses and the
    final point equal ``lqg_tpu``'s within rtol 1e-9."""
    from lqg_tpu.infer import svi as jsvi

    jm, tm = models(kind)
    jp, jl, ju = jsvi.optimize(jm, steps=100, step_size=0.05,
                               return_unconstrained=True)
    tp, tl, tu = tsvi.optimize(tm, steps=100, step_size=0.05,
                               return_unconstrained=True)
    assert tl.shape == (100,) and tu.shape == (len(tm.names),)
    close(tl.numpy(), jl, rtol=1e-9)
    close(tu.numpy(), ju, rtol=1e-9)
    for k in tm.names:
        close(tp[k].numpy(), jp[k], rtol=1e-9)
    assert float(tl[-1]) < float(tl[0])


def test_max_likelihood_matches_jax(x64):
    """``max_likelihood`` (MLE, no priors) over 100 steps: the losses and
    the estimates equal ``lqg_tpu``'s within rtol 1e-9."""
    import jax.numpy as jnp
    from lqg_tpu.infer import max_likelihood as jmax_likelihood

    x = _trials(3, 0)
    jp, jl = jmax_likelihood(jnp.asarray(x), steps=100, step_size=0.02)
    tp, tl = max_likelihood(torch.tensor(x), steps=100, step_size=0.02)
    close(tl.numpy(), jl, rtol=1e-9)
    assert sorted(tp) == sorted(jp)
    for k in tp:
        close(tp[k].numpy(), jp[k], rtol=1e-9)


def test_optimize_takes_any_steps_and_ignores_chunk_steps(x64):
    """``chunk_steps`` is accepted for the signature and changes no bit."""
    _, tm = models("lifted")
    a = tsvi.optimize(tm, steps=7, chunk_steps=3, return_unconstrained=True)
    b = tsvi.optimize(tm, steps=7, return_unconstrained=True)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


# --- AutoMVN and its ELBO fit ------------------------------------------------

def test_auto_mvn_transform_matches_jax(x64):
    """A perturbed full-rank guide carried across: ``transform_and_logdet``
    on a batch of ``eps``, rtol 1e-12."""
    import jax
    import jax.numpy as jnp
    from lqg_tpu.infer.svi import AutoMVN

    D = 5
    rng = np.random.default_rng(3)
    tril = np.tril(rng.normal(size=(D, D)), -1) + np.diag(
        np.exp(rng.normal(size=D)))
    jg = AutoMVN(loc=jnp.asarray(rng.normal(size=D)),
                 scale_tril=jnp.asarray(tril))
    tg = guide_from_numpy(jax.tree.map(np.asarray, jg), device="cpu",
                          dtype=torch.float64)
    eps = rng.normal(size=(7, D))
    u, ld = tg.transform_and_logdet(torch.tensor(eps))
    ju = jax.vmap(jg.transform)(jnp.asarray(eps))
    close(u.numpy(), ju, rtol=1e-12)
    close(ld.numpy(), jg.log_det(), rtol=1e-12)


@pytest.mark.parametrize("kind", MODELS)
def test_fit_auto_mvn_matches_jax(kind, x64):
    """50 ELBO steps of 8 particles from JAX's initial point, fed the draws
    of JAX's key schedule (chunks of 25): the loss trace within rtol 1e-8,
    the final guide within rtol 1e-7."""
    from jax import random
    from lqg_tpu.infer import svi as jsvi

    jm, tm = models(kind)
    key = random.PRNGKey(11)
    jg, jl = jsvi.fit_auto_mvn(jm, key, steps=50, step_size=0.01,
                               chunk_steps=25)
    tg, tl = tsvi.fit_auto_mvn(tm, JaxGuideDraws(key, 50, 25), steps=50,
                               step_size=0.01)
    close(tl.numpy(), jl, rtol=1e-8)
    close(tg.loc.numpy(), jg.loc, rtol=1e-7)
    close(tg.scale_tril.numpy(), jg.scale_tril, rtol=1e-7,
          atol=1e-7 * float(np.abs(np.asarray(jg.scale_tril)).max()))


def test_fit_auto_mvn_draws_depend_on_the_step_alone(x64):
    """With an integer seed the particles of step ``i`` depend on ``(seed,
    i)`` alone: ``chunk_steps`` changes nothing, and a shorter fit is the
    start of a longer one."""
    _, tm = models("lifted")
    g1, l1 = tsvi.fit_auto_mvn(tm, 5, steps=6, chunk_steps=2)
    g2, l2 = tsvi.fit_auto_mvn(tm, 5, steps=6)
    _, l3 = tsvi.fit_auto_mvn(tm, 5, steps=4)
    assert torch.equal(l1, l2) and torch.equal(l1[:4], l3)
    assert torch.equal(g1.scale_tril, g2.scale_tril)
    assert not torch.equal(l1, tsvi.fit_auto_mvn(tm, 6, steps=6)[1])


# --- laplace_guide -----------------------------------------------------------

@pytest.mark.parametrize("kind", MODELS)
def test_laplace_guide_matches_jax(kind, x64):
    """At a point off the prior median: the Hessian (the port on its scans,
    ``method="scan"``), the clamped eigenvalues and ``scale_tril`` equal
    ``lqg_tpu``'s within rtol 1e-8; the model's ``method`` is restored.
    No eigenvalue is clamped here, so JAX's Hessian is the inverse of its
    ``scale_tril @ scale_tril.T``."""
    import jax.numpy as jnp
    from lqg_tpu.infer import svi as jsvi

    jm, tm = models(kind)
    rng = np.random.default_rng(7)
    u = np.asarray(jm.init_unconstrained()) + 0.1 * rng.normal(
        size=len(tm.names))
    jm.init = jm.constrain(jnp.asarray(u))
    tm.init = tm.constrain(torch.tensor(u))
    jg, jw = jsvi.laplace_guide(jm)
    tg, tw = tsvi.laplace_guide(tm)
    assert tm.method == "auto"
    jw = np.asarray(jw)
    assert jw.min() > 1e-6 * jw.max()
    L = np.asarray(jg.scale_tril)
    jh = np.linalg.inv(L @ L.T)
    th = tsvi._hessian(tm.potential, torch.tensor(u))
    scale = float(np.abs(np.asarray(jh)).max())
    close(th.numpy(), jh, rtol=1e-8, atol=1e-10 * scale)
    close(tw.numpy(), jw, rtol=1e-8)
    close(tg.loc.numpy(), jg.loc, rtol=1e-12)
    close(tg.scale_tril.numpy(), jg.scale_tril, rtol=1e-8,
          atol=1e-10 * float(np.abs(np.asarray(jg.scale_tril)).max()))


def test_laplace_guide_through_make_psd_matches_jax(x64):
    """The point mass's potential passes through ``make_psd``'s eigenvalue
    clip, which the port differentiates twice through ``linalg._Eigh``:
    the Hessian of its lifted potential (T=8, 2 trials) equals
    ``jax.hessian`` of ``lqg_tpu``'s, and ``laplace_guide``'s eigenvalues
    and ``scale_tril`` equal ``lqg_tpu.infer.svi.laplace_guide``'s, rtol
    1e-6; the model's ``method`` is restored."""
    import jax
    import jax.numpy as jnp
    from lqg_tpu import models as jmodels
    from lqg_tpu.infer import models as jinfer
    from lqg_tpu.infer import svi as jsvi

    m = tmodels.PointMassBoundedActor(T=8, device="cpu", dtype=torch.float64)
    x = m.simulate(torch.Generator().manual_seed(0), n=2)[..., :2]
    tm = tinfer.lifted_model(x, tmodels.PointMassBoundedActor)
    jm = jinfer.lifted_model(jnp.asarray(x.numpy()),
                             jmodels.PointMassBoundedActor)
    rng = np.random.default_rng(11)
    u = np.asarray(jm.init_unconstrained()) + 0.1 * rng.normal(
        size=len(tm.names))
    jm.init = jm.constrain(jnp.asarray(u))
    tm.init = tm.constrain(torch.tensor(u))
    jh = np.asarray(jax.jit(jax.hessian(jm.potential))(jnp.asarray(u)))
    th = tsvi._hessian(tm.potential, torch.tensor(u))
    close(th.numpy(), jh, rtol=1e-6, atol=1e-10 * float(np.abs(jh).max()))
    jg, jw = jsvi.laplace_guide(jm)
    tg, tw = tsvi.laplace_guide(tm)
    assert tm.method == "auto"
    close(tw.numpy(), jw, rtol=1e-6, atol=1e-10 * float(np.abs(jw).max()))
    close(tg.scale_tril.numpy(), jg.scale_tril, rtol=1e-6,
          atol=1e-10 * float(np.abs(np.asarray(jg.scale_tril)).max()))


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_model(cuda, T_=200, n=5):
    m = tmodels.BoundedActor(T=T_, device=cuda)
    x = m.simulate(torch.Generator(device=cuda).manual_seed(0), n=n)
    return tinfer.lifted_model(x, tmodels.BoundedActor)


def _within(a, b, rtol, atol=0.0):
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


@pytest.mark.cuda
def test_graphed_elbo_equals_eager_on_card(cuda):
    """An IAF guide's ELBO on 16 particles: the value and the gradient with
    respect to every guide parameter through ``GraphedPotential`` (one
    replay) equal eager autograd through the potential, float32 (value
    rtol 2e-4, gradient 5e-3 + 1e-6 of each leaf's largest entry)."""
    from lqg_tpu_torch.infer.flows import make_auto_iaf

    model = _card_model(cuda)
    u0 = model.init_unconstrained()
    guide = make_auto_iaf(0, u0.shape[0], loc=u0, init_log_scale=-2.0)
    leaves = [guide.loc, guide.log_scale,
              *(x for layer in guide.layers for x in layer)]
    eps = torch.randn((16, u0.shape[0]),
                      generator=torch.Generator(device=cuda).manual_seed(1),
                      device=cuda)

    def elbo(potential):
        params = [x.detach().requires_grad_() for x in leaves]
        layers = tuple(type(guide.layers[0])(*params[k:k + 8])
                       for k in range(2, len(params), 8))
        g = guide._replace(loc=params[0], log_scale=params[1], layers=layers)
        u, ld = g.transform_and_logdet(eps)
        loss = -torch.mean(-potential(u) + ld)
        return loss, torch.autograd.grad(loss, params)

    for _ in range(2):  # the first call captures, the second replays
        lg, gg = elbo(lambda u: GraphedPotential.apply(u, model))
    le, ge = elbo(model.potential)
    assert torch.isfinite(lg) and _within(lg, le, 2e-4)
    for a, b in zip(gg, ge):
        assert _within(a, b, 5e-3, 1e-6 * float(b.abs().max()))


@pytest.mark.cuda
def test_graphed_optimize_equals_eager_on_card(cuda):
    """20 ``optimize`` steps replayed from the captured graph equal 20
    eager Adam steps (value rtol 2e-4, point 5e-3)."""
    model = _card_model(cuda)
    _, losses, u = tsvi.optimize(model, steps=20, step_size=0.05,
                                 return_unconstrained=True)
    assert len(model.value_and_grad_fns) == 1
    eager = eager_value_and_grad(model.potential)
    opt = tsvi.adam(0.05)
    ue = model.init_unconstrained()[None]
    state, le = opt.init([ue]), []
    for _ in range(20):
        pe, grad = eager(ue)
        upd, state = opt.update([grad], state)
        (ue,) = tsvi.apply_updates([ue], upd)
        le.append(pe[0])
    assert _within(losses, torch.stack(le), 2e-4)
    assert _within(u, ue[0], 5e-3)
