"""The port's NUTS pieces against ``lqg_tpu.infer`` in float64 on the CPU:
the integrator, the U-turn test, the adaptation, the diagnostics and whole
NUTS transitions fed the draws JAX's key schedule makes (:class:`JaxDraws`).

JAX runs one chain per call and vmaps them; the port takes the chains as a
batch axis.  So each test hands both the same numpy inputs, calls JAX per
chain (through ``vmap``) and the port once."""

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax, random

from lqg_tpu import models as jmodels
from lqg_tpu.infer import adaptation as jadapt
from lqg_tpu.infer import diagnostics as jdiag
from lqg_tpu.infer import hmc as jhmc
from lqg_tpu.infer import models as jinfer
from lqg_tpu_torch import models as tmodels
from lqg_tpu_torch.infer import adaptation as tadapt
from lqg_tpu_torch.infer import diagnostics as tdiag
from lqg_tpu_torch.infer import hmc as thmc
from lqg_tpu_torch.infer import models as tinfer
from lqg_tpu_torch.infer.capture import eager_value_and_grad

RTOL = 1e-10
T_BA = 40  # the bounded actor's horizon in these tests (3 trials)


def close(t, j, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol)


# --- JAX's draws, replayed -------------------------------------------------

@partial(jax.jit, static_argnums=(1, 2))
def _nuts_draws(key, D, max_depth):
    """The draws ``lqg_tpu.infer.hmc.nuts_step(key)`` makes, in its order:
    ``key_mom, key_tree = split(key)`` (:243); per doubling ``split(key,
    4)`` into the direction, the half-tree and the acceptance keys
    (:265-266); per leaf ``key, sub = split(key)`` and ``uniform(sub)``
    (:123-124)."""
    key_mom, key_tree = random.split(key)
    eps = random.normal(key_mom, (D,))

    def doubling(k, _):
        k, key_dir, key_sub, key_accept = random.split(k, 4)

        def leaf(ks, _):
            ks, sub = random.split(ks)
            return ks, random.uniform(sub)

        _, us = lax.scan(leaf, key_sub, None, length=1 << (max_depth - 1))
        return k, (random.bernoulli(key_dir), random.uniform(key_accept), us)

    _, (forward, accept, leaves) = lax.scan(doubling, key_tree, None,
                                            length=max_depth)
    return eps, forward, accept, leaves


def nuts_draws(keys, D, max_depth) -> thmc.NUTSDraws:
    """:class:`NUTSDraws` of one transition per chain key."""
    out = jax.vmap(lambda k: _nuts_draws(k, D, max_depth))(keys)
    return thmc.NUTSDraws(*(torch.tensor(np.asarray(x)) for x in out))


class JaxDraws:
    """The draw source of :meth:`lqg_tpu_torch.infer.mcmc.MCMC.run` that
    replays ``lqg_tpu.infer.mcmc.MCMC.run(key)``'s key schedule: the init
    jitter and per-chain keys (``mcmc.py:308-312``), each chain's
    step-size-search key (``:141``), and per transition ``key, sub =
    split(key)`` (``:166``) into :func:`nuts_draws`.  Transitions must be
    asked for in order."""

    def __init__(self, key):
        self.key = key

    def init(self, C, D, dtype):
        keys = random.split(self.key, C + 1)
        jitter = random.uniform(keys[0], (C, D), minval=-1.0, maxval=1.0)
        split = jax.vmap(lambda k: random.split(k, 3))(keys[1:])
        eps = jax.vmap(lambda k: random.normal(k, (D,)))(split[:, 1])
        self.chain_keys, self.s = split[:, 2], 0
        return (torch.tensor(np.asarray(jitter)),
                torch.tensor(np.asarray(eps)))

    def transition(self, s, C, D, max_depth, dtype):
        assert s == self.s, "transitions are replayed in order"
        self.s += 1
        pairs = jax.vmap(random.split)(self.chain_keys)
        self.chain_keys = pairs[:, 0]
        return nuts_draws(pairs[:, 1], D, max_depth)


# --- targets ---------------------------------------------------------------

MU = np.array([1.0, -2.0, 0.5])
COV = np.array([[2.0, 1.2, 0.3], [1.2, 1.5, -0.4], [0.3, -0.4, 0.8]])
PREC = np.linalg.inv(COV)


def gaussian_potentials():
    """A correlated Gaussian's potential for JAX (one chain) and its value
    and gradient for the port (a batch of chains)."""

    def jpot(z):
        d = z - MU
        return 0.5 * d @ PREC @ d

    prec, mu = torch.tensor(PREC), torch.tensor(MU)

    def tvg(z):
        d = z - mu
        return 0.5 * ((d @ prec) * d).sum(-1), d @ prec

    return jpot, tvg


@lru_cache(maxsize=None)
def bounded_actor_potentials():
    """The lifted bounded actor (T=40, 3 trials simulated by JAX), built once
    per process: JAX's potential, the port's model, its eager value and
    gradient, and the initial point."""
    x = np.asarray(jmodels.BoundedActor(T=T_BA).simulate(
        jax.random.PRNGKey(0), n=3))
    jm = jinfer.lifted_model(jnp.asarray(x), jmodels.BoundedActor)
    tm = tinfer.lifted_model(torch.tensor(x), tmodels.BoundedActor)
    return jm.potential, tm, eager_value_and_grad(tm.potential), \
        np.asarray(jm.init_unconstrained())


def _value_and_grad(jpot, z):
    """JAX's value and gradient per chain, compiled (op by op, the
    likelihood's scans take tens of seconds)."""
    return jax.jit(jax.vmap(jax.value_and_grad(jpot)))(z)


def _masses(C, D, dense, seed=0):
    """Per-chain inverse masses: variances or lower-Cholesky factors."""
    rng = np.random.default_rng(seed)
    if not dense:
        return rng.uniform(0.3, 2.0, size=(C, D))
    A = rng.normal(size=(C, D, D))
    cov = A @ np.swapaxes(A, 1, 2) + D * np.eye(D)
    return np.linalg.cholesky(cov) * 0.5


# --- integrator ------------------------------------------------------------

@pytest.mark.parametrize("dense", [False, True], ids=["diag", "dense"])
def test_velocity_kinetic_momentum_uturn_match_jax(dense, x64):
    C, D = 5, 4
    rng = np.random.default_rng(1)
    m, r, r2, rho, eps = (_masses(C, D, dense), rng.normal(size=(C, D)),
                          rng.normal(size=(C, D)), rng.normal(size=(C, D)),
                          rng.normal(size=(C, D)))
    T = lambda a: torch.tensor(a)
    close(thmc.velocity(T(m), T(r)), jax.vmap(jhmc.velocity)(m, r))
    close(thmc.kinetic(T(m), T(r)), jax.vmap(jhmc.kinetic)(m, r))
    # sample_momentum given the normals JAX draws from the key
    keys = random.split(random.PRNGKey(3), C)
    eps = np.asarray(jax.vmap(lambda k: random.normal(k, (D,)))(keys))
    close(thmc.sample_momentum(T(eps), T(m)),
          jax.vmap(lambda k, mm: jhmc.sample_momentum(k, mm, (D,)))(keys, m))
    got = thmc._uturn(T(m), T(r), T(r2), T(rho)).numpy()
    want = np.asarray(jax.vmap(jhmc._uturn)(m, r, r2, rho))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < C  # both outcomes are exercised


@pytest.mark.parametrize("dense", [False, True], ids=["diag", "dense"])
def test_leapfrog_matches_jax(dense, x64):
    jpot, tvg = gaussian_potentials()
    C, D = 4, 3
    rng = np.random.default_rng(2)
    z, r = rng.normal(size=(C, D)), rng.normal(size=(C, D))
    step = np.array([0.1, -0.4, 0.9, -1.3])
    m = _masses(C, D, dense)
    pe = np.array([jpot(zz) for zz in z])
    grad = np.asarray(jax.vmap(jax.grad(jpot))(z))
    want = jax.vmap(lambda *a: jhmc.leapfrog(jpot, a[0], a[1],
                                             jhmc.IntegratorState(*a[2:])))(
        m, step, z, r, pe, grad)
    got = thmc.leapfrog(tvg, torch.tensor(m), torch.tensor(step),
                        thmc.IntegratorState(*(torch.tensor(a) for a in
                                               (z, r, pe, grad))))
    for a, b in zip(got, want):
        close(a, b)


@pytest.mark.parametrize("dense", [False, True], ids=["diag", "dense"])
def test_leapfrog_on_lifted_bounded_actor_matches_jax(dense, x64):
    jpot, _, tvg, u0 = bounded_actor_potentials()
    C, D = 3, u0.shape[0]
    rng = np.random.default_rng(3)
    z = u0 + 0.1 * rng.normal(size=(C, D))
    r = rng.normal(size=(C, D))
    step = np.array([0.02, -0.05, 0.1])
    m = _masses(C, D, dense, seed=4) * 0.2
    pe, grad = _value_and_grad(jpot, z)
    want = jax.jit(jax.vmap(lambda *a: jhmc.leapfrog(
        jpot, a[0], a[1], jhmc.IntegratorState(*a[2:]))))(
        m, step, z, r, pe, grad)
    got = thmc.leapfrog(tvg, torch.tensor(m), torch.tensor(step),
                        thmc.IntegratorState(*(torch.tensor(np.asarray(a))
                                               for a in (z, r, pe, grad))))
    for a, b in zip(got, want):
        close(a, b, atol=1e-9 * float(np.abs(np.asarray(b)).max()))


# --- adaptation ------------------------------------------------------------

def test_dual_averaging_matches_jax(x64):
    C = 4
    rng = np.random.default_rng(5)
    step0 = np.array([0.01, 0.3, 1.0, 4.0])
    accepts = rng.uniform(size=(30, C))
    js = jax.vmap(jadapt.da_init)(step0)
    ts = tadapt.da_init(torch.tensor(step0))
    for a in accepts:
        js = jax.vmap(lambda s, p: jadapt.da_update(s, p, target=0.7))(js, a)
        ts = tadapt.da_update(ts, torch.tensor(a), target=0.7)
    for a, b in zip(ts, js):
        close(a, b)


@pytest.mark.parametrize("dense", [False, True], ids=["diag", "dense"])
def test_welford_matches_jax(dense, x64):
    C, D, N = 3, 4, 25
    rng = np.random.default_rng(6)
    xs = rng.normal(size=(N, C, D)) * np.array([1.0, 3.0, 0.2, 7.0])
    js = jax.vmap(lambda _: jadapt.welford_init(D, dense=dense))(jnp.arange(C))
    ts = tadapt.welford_init(C, D, dense=dense)
    for x in xs:
        js = jax.vmap(jadapt.welford_update)(js, x)
        ts = tadapt.welford_update(ts, torch.tensor(x))
    for a, b in zip(ts, js):
        close(a, b)
    for reg in (True, False):
        close(tadapt.welford_variance(ts, reg),
              jax.vmap(lambda s: jadapt.welford_variance(s, reg))(js))
        close(tadapt.welford_mass(ts, reg),
              jax.vmap(lambda s: jadapt.welford_mass(s, reg))(js))


def test_welford_mass_is_nan_where_not_positive_definite(x64):
    """A dense accumulator whose covariance is not positive-definite gives
    a factor with NaN in its lower triangle in that chain, as
    ``jnp.linalg.cholesky`` does, and does not raise."""
    m2 = np.array([[[1.0, 0.0], [0.0, 1.0]], [[1.0, 3.0], [3.0, 1.0]]])
    ts = tadapt.WelfordState(mean=torch.zeros(2, 2, dtype=torch.float64),
                             m2=torch.tensor(m2),
                             count=torch.tensor([2.0, 2.0]))
    got = np.tril(tadapt.welford_mass(ts, regularize=False).numpy())
    js = jadapt.WelfordState(mean=jnp.zeros(2), m2=jnp.asarray(m2[1]),
                             count=jnp.asarray(2.0))
    want = np.tril(np.asarray(jadapt.welford_mass(js, False)))
    assert np.isfinite(got[0]).all()
    assert np.isnan(got[1][np.tril_indices(2)]).all()
    assert np.isnan(want[np.tril_indices(2)]).all()


@pytest.mark.parametrize("num_warmup", [0, 10, 19, 20, 40, 149, 150, 151,
                                        1000, 2500])
def test_build_schedule_matches_jax(num_warmup):
    for a, b in zip(tadapt.build_schedule(num_warmup),
                    jadapt.build_schedule(num_warmup)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dense", [False, True], ids=["diag", "dense"])
def test_find_reasonable_step_size_matches_jax(dense, x64):
    """Chains that double and chains that halve, each to its own step."""
    jpot, tvg = gaussian_potentials()
    C, D = 4, 3
    rng = np.random.default_rng(7)
    z = MU + rng.normal(size=(C, D)) * np.array([[0.1], [1.0], [3.0], [6.0]])
    m = _masses(C, D, dense, seed=8) * np.array([0.01, 0.1, 1.0, 30.0]
                                                ).reshape((C,) + (1,) * (
                                                    1 + dense))
    keys = random.split(random.PRNGKey(9), C)
    pe, grad = _value_and_grad(jpot, z)
    want = jax.vmap(lambda mm, zz, p, g, k: jadapt.find_reasonable_step_size(
        jpot, mm, zz, p, g, k))(m, z, pe, grad, keys)
    eps = jax.vmap(lambda k: random.normal(k, (D,)))(keys)
    got = tadapt.find_reasonable_step_size(
        tvg, torch.tensor(m), torch.tensor(z), torch.tensor(np.asarray(pe)),
        torch.tensor(np.asarray(grad)), torch.tensor(np.asarray(eps)))
    close(got, want, rtol=0.0)
    assert (np.asarray(want) > 1.0).any() and (np.asarray(want) < 1.0).any()


# --- diagnostics -----------------------------------------------------------

def test_diagnostics_match_jax():
    rng = np.random.default_rng(0)
    iid = rng.standard_normal((4, 1000))
    ar = np.cumsum(rng.standard_normal((2, 1000)), axis=1)
    short = rng.standard_normal((3, 3))
    for x in (iid, ar, short, iid[:1]):
        assert tdiag.split_rhat(x) == pytest.approx(jdiag.split_rhat(x),
                                                    rel=1e-12, nan_ok=True)
        assert tdiag.ess(x) == pytest.approx(jdiag.ess(x), rel=1e-12)
    samples = {"iid": iid, "ar": ar[:, :800].repeat(2, 0)}
    got, want = tdiag.summary(samples), jdiag.summary(samples)
    assert list(got.columns) == list(want.columns)
    np.testing.assert_allclose(got.to_numpy(float), want.to_numpy(float),
                               rtol=1e-12)


# --- whole transitions -----------------------------------------------------

def _nuts_both(jpot, tvg, z, step, m, key, max_depth, depth_cap=None):
    C, D = z.shape
    keys = random.split(key, C)
    pe, grad = _value_and_grad(jpot, z)
    one = jax.jit(lambda k, *a: jhmc.nuts_step(
        jpot, k, *a, max_depth=max_depth, depth_cap=depth_cap))
    want = jax.tree.map(lambda *xs: np.stack(xs), *(
        one(keys[c], z[c], pe[c], grad[c], step[c], m[c]) for c in range(C)))
    T = lambda a: torch.tensor(np.asarray(a))
    got = thmc.nuts_step(tvg, nuts_draws(keys, D, max_depth), T(z), T(pe),
                         T(grad), T(step), T(m), max_depth=max_depth,
                         depth_cap=depth_cap)
    return got, want


def _same_transition(got, want, rtol):
    (tz, tpe, tg, tinfo), (jz, jpe, jg, jinfo) = got, want
    for a, b in ((tz, jz), (tpe, jpe), (tg, jg), (tinfo.accept_prob,
                                                  jinfo.accept_prob),
                 (tinfo.energy, jinfo.energy)):
        close(a, b, rtol=rtol, atol=rtol * float(np.abs(np.asarray(b)).max()))
    for a, b in ((tinfo.num_steps, jinfo.num_steps),
                 (tinfo.diverging, jinfo.diverging),
                 (tinfo.tree_depth, jinfo.tree_depth)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("dense", [False, True], ids=["diag", "dense"])
def test_nuts_step_matches_jax_on_a_gaussian(dense, x64):
    """Eight chains with step sizes from tiny (deep trees that turn inside
    a half-tree) to too large (one divergence), and a depth cap."""
    jpot, tvg = gaussian_potentials()
    C, D, max_depth = 8, 3, 7
    rng = np.random.default_rng(10)
    z = MU + rng.normal(size=(C, D))
    step = np.array([0.02, 0.05, 0.1, 0.3, 0.6, 1.0, 1.6, 40.0])
    m = _masses(C, D, dense, seed=11)
    got, want = _nuts_both(jpot, tvg, z, step, m, random.PRNGKey(12),
                           max_depth)
    _same_transition(got, want, 1e-9)
    depths = np.asarray(want[3].tree_depth)
    assert depths.max() >= 5 and depths.min() <= 2
    assert np.asarray(want[3].diverging).any()
    capped, want = _nuts_both(jpot, tvg, z, step, m, random.PRNGKey(13),
                              max_depth, depth_cap=3)
    _same_transition(capped, want, 1e-9)
    assert np.asarray(want[3].tree_depth).max() == 3


def test_nuts_step_matches_jax_on_the_bounded_actor(x64):
    """The lifted bounded actor (T=40, 3 trials), three chains,
    ``max_depth=5``, the dense metric (MCMC's default at this D)."""
    jpot, _, tvg, u0 = bounded_actor_potentials()
    C, D = 3, u0.shape[0]
    rng = np.random.default_rng(14)
    z = u0 + 0.1 * rng.normal(size=(C, D))
    step = np.array([0.01, 0.05, 0.2])
    m = _masses(C, D, True, seed=15) * 0.1
    got, want = _nuts_both(jpot, tvg, z, step, m, random.PRNGKey(16), 5)
    _same_transition(got, want, 1e-9)


def test_nan_proposal_is_a_divergence_of_its_chain_only(x64):
    """Chain 1's first leapfrog lands on the noise scales at 1e-300, where
    the likelihood is NaN (``tests/test_torch_nonfinite.py``): that chain
    diverges and keeps its position; the other chains' transitions are
    those of a run without it."""
    _, model, tvg, u0 = bounded_actor_potentials()
    names = model.names
    D = u0.shape[0]
    z = torch.tensor(np.stack([u0 + 0.05, u0, u0 - 0.05]))
    pe, grad = tvg(z)
    step = torch.tensor([0.02, 1.0, 0.03])
    m = torch.ones(3, D, dtype=torch.float64)
    draws = thmc.draw_nuts(torch.Generator().manual_seed(17), 3, D, 3,
                           torch.float64)
    # land on the probe: z1 = z + step (eps - 0.5 step grad) with M = I
    target = z[1].clone()
    for n in ("action_variability", "sigma_target", "sigma_cursor"):
        target[names.index(n)] = float(np.log(1e-300))
    eps = draws.eps.clone()
    eps[1] = (target - z[1]) / step[1] + 0.5 * step[1] * grad[1]
    forward = draws.forward.clone()
    forward[1, 0] = True
    draws = draws._replace(eps=eps, forward=forward)
    assert torch.isnan(tvg(target[None])[0]).all()

    z1, pe1, g1, info = thmc.nuts_step(tvg, draws, z, pe, grad, step, m,
                                       max_depth=3)
    assert bool(info.diverging[1]) and int(info.tree_depth[1]) == 1
    assert float(info.num_steps[1]) == 1.0
    assert torch.equal(z1[1], z[1]) and torch.equal(pe1[1], pe[1])
    assert torch.isfinite(z1).all() and torch.isfinite(pe1).all()
    keep = torch.tensor([0, 2])
    solo = thmc.nuts_step(tvg, thmc.NUTSDraws(*(f[keep] for f in draws)),
                          z[keep], pe[keep], grad[keep], step[keep],
                          m[keep], max_depth=3)
    for a, b in zip((z1, pe1, g1) + tuple(info), solo[:3] + tuple(solo[3])):
        np.testing.assert_allclose(a[keep].numpy(), b.numpy(), rtol=1e-12)
