"""The rest of the model zoo in the port (``PointMassBoundedActor``,
``HandMotionModelTrackingTask``, ``SignalDependentNoiseActor``) against
``lqg_tpu`` in float64: the matrix exponential and the eigenvalue clip they
rest on, the point-mass helpers, the specs with batched parameters, the
multiplicative Riccati pass, the rollout with control noise, the likelihood
and the point-mass golden, the potentials' value and gradient, and the
route ``auto`` takes for every model of the zoo.  Inputs are made by numpy
from a seed; each test states its tolerance."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from lqg_tpu import models as jmodels
from lqg_tpu.infer import dists as jdists
from lqg_tpu.infer import models as jinfer
from lqg_tpu.infer.priors import DEFAULT_PRIOR as JPRIOR
from lqg_tpu.models import point_mass as jpm
from lqg_tpu.ops import riccati as jriccati
from lqg_tpu.ops.linalg import make_psd as jmake_psd
from lqg_tpu.ops.pallas.gains import (
    fused_gains_available as jfused_gains_available)
from lqg_tpu.ops.pallas.likelihood import (
    fused_ll_available as jfused_ll_available)
from lqg_tpu_torch import infer as tinfer
from lqg_tpu_torch import models as tmodels
from lqg_tpu_torch import system as tsystem
from lqg_tpu_torch.convert import system_from_numpy
from lqg_tpu_torch.infer import dists as tdists
from lqg_tpu_torch.infer.priors import DEFAULT_PRIOR as TPRIOR
from lqg_tpu_torch.models import point_mass as tpm
from lqg_tpu_torch.ops import kalman, riccati
from lqg_tpu_torch.ops.kernels.gains import fused_gains_available
from lqg_tpu_torch.ops.kernels.likelihood import fused_ll_available
from lqg_tpu_torch.ops.linalg import eigh_jacobi, expm, make_psd
from lqg_tpu_torch.spec import LQGSpec
from lqg_tpu_torch.system import System

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "goldens")
F64 = dict(device="cpu", dtype=torch.float64)
ZOO = {
    "PointMassBoundedActor": dict(action_variability=2e-3, sigma_target=5.0,
                                  action_cost=0.02, damping=0.2, m=1.3,
                                  tau=0.002),
    "HandMotionModelTrackingTask": dict(action_variability=0.4,
                                        sigma_cursor=3.0, m=1.2, tau=0.05),
    "SignalDependentNoiseActor": dict(signal_dep_noise=0.7,
                                      action_cost=0.5),
}
# the parameters each model's test varies over a batch axis
BATCHED = {
    "PointMassBoundedActor": ("damping", "m", "tau", "action_variability"),
    "HandMotionModelTrackingTask": ("m", "tau", "action_cost"),
    "SignalDependentNoiseActor": ("signal_dep_noise", "sigma_cursor"),
}


def close(t, j, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


def _fields(spec):
    return {k: np.asarray(v) for k, v in spec._asdict().items()}


def _draws(key, T, n, system):
    """``lqg_tpu.System.simulate``'s three draws for ``key``, as numpy."""
    key_eps, key_eta, key_u = random.split(key, 3)
    eps = random.normal(key_eps, (T, n, system.dynamics.V.shape[-1]))
    eta = random.normal(key_eta, (T, n, system.dynamics.W.shape[-1]))
    eps_u = (None if system.control_noise is None else
             random.normal(key_u, (T, n, system.control_noise.shape[0])))
    return [None if x is None else np.asarray(x) for x in (eps, eta, eps_u)]


# --- the matrix exponential and the eigenvalue clip ---

# 1-norms that reach every Pade degree (3, 5, 7, 9, 13 in float64) and 0,
# 1, 4, 10 and 16 squarings; beyond 16 the result is NaN
EXPM_NORMS = [0.01, 0.2, 0.9, 2.0, 5.0, 11.0, 60.0, 5.0 * 2 ** 10,
              5.3 * 2 ** 16]


@pytest.mark.parametrize("norm", EXPM_NORMS)
def test_expm_matches_jax(norm, x64):
    """Values and gradients of 4 x 4 matrices at each 1-norm, float64, rtol
    1e-9 of the largest entry (the squarings double the rounding: at 16 of
    them JAX and the port differ by ~1e-11)."""
    rng = np.random.default_rng(int(norm * 10))
    A = rng.normal(size=(3, 4, 4))
    if norm > 100:  # a rotation generator: exp stays bounded
        A = A - np.swapaxes(A, -1, -2)
    A *= norm / np.abs(A).sum(-2).max(-1)[:, None, None]
    W = rng.normal(size=A.shape)
    jv, jg = jax.value_and_grad(
        lambda a: jnp.sum(jax.scipy.linalg.expm(a) * W))(jnp.asarray(A))
    At = torch.tensor(A, requires_grad=True)
    E = expm(At)
    (grad,) = torch.autograd.grad((E * torch.tensor(W)).sum(), At)
    want = np.asarray(jax.scipy.linalg.expm(jnp.asarray(A)))
    close(E, want, rtol=0, atol=1e-9 * np.abs(want).max())
    close(grad, jg, rtol=0, atol=1e-9 * np.abs(np.asarray(jg)).max())


def test_expm_beyond_the_squarings_is_nan(x64):
    A = np.diag([1.0, -1.0]) * 6.0 * 2 ** 17
    assert np.isnan(np.asarray(jax.scipy.linalg.expm(jnp.asarray(A)))).all()
    assert torch.isnan(expm(torch.tensor(A))).all()


def test_expm_float32_matches_jax():
    """The float32 rule (Pade 3, 5, 7): the point-mass block at its
    defaults, rtol 1e-5."""
    A_c = np.array([[0.0, 1.0, 0.0, 0.0], [0.0, -0.1, 1.0, 0.0],
                    [0.0, 0.0, -1 / 0.0015, 1 / 0.0015], [0.0] * 4]) / 60.0
    for A in (A_c, 0.3 * A_c / np.abs(A_c).sum(0).max(),
              1.5 * A_c / np.abs(A_c).sum(0).max()):
        A = A.astype(np.float32)
        want = np.asarray(jax.scipy.linalg.expm(jnp.asarray(A)))
        got = expm(torch.tensor(A))
        assert got.dtype == torch.float32
        close(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_make_psd_matches_jax(x64):
    """Clipped eigenvalues (the point-mass van Loan block has two below
    1e-6), a diagonal matrix, and full-rank ones: values and gradients,
    float64, atol 1e-12 of the largest entry."""
    rng = np.random.default_rng(3)
    M = rng.normal(size=(4, 3, 3))
    M = M @ np.swapaxes(M, -1, -2)
    M[0] = np.asarray(jpm.van_loan_discretization(
        *(jnp.asarray(x) for x in (
            [[0.0, 1.0, 0.0], [0.0, -0.1, 1.0], [0.0, 0.0, -1 / 0.0015]],
            [[0.0], [0.0], [1e-5 / 0.0015]])), 1 / 60))
    M[1] = np.diag([2e-3, -5e-9, 1e-12])
    M[2] += rng.normal(size=(3, 3)) * 0.1  # not symmetric
    W = rng.normal(size=M.shape)
    jv, jg = jax.value_and_grad(lambda a: jnp.sum(jmake_psd(a) * W))(
        jnp.asarray(M))
    w = np.linalg.eigvalsh(0.5 * (M[0] + M[0].T))
    assert (w < 1e-6).sum() == 2  # the clip is load-bearing
    Mt = torch.tensor(M, requires_grad=True)
    out = make_psd(Mt)
    (grad,) = torch.autograd.grad((out * torch.tensor(W)).sum(), Mt)
    want = np.asarray(jmake_psd(jnp.asarray(M)))
    close(out, want, rtol=0, atol=1e-12 * np.abs(want).max())
    close(grad, jg, rtol=0, atol=1e-12 * np.abs(np.asarray(jg)).max())


def test_eigh_jacobi_converges():
    """Six sweeps reach the float64 rounding of a 4 x 4 spectrum."""
    rng = np.random.default_rng(4)
    S = rng.normal(size=(5, 4, 4))
    S = torch.tensor(S + np.swapaxes(S, -1, -2))
    w, V = eigh_jacobi(S)
    torch.testing.assert_close(V @ torch.diag_embed(w) @ V.mT, S, rtol=0,
                               atol=1e-13)
    torch.testing.assert_close(V.mT @ V, torch.eye(4, dtype=S.dtype)
                               .expand_as(S), rtol=0, atol=1e-14)
    torch.testing.assert_close(w.sort(-1).values,
                               torch.linalg.eigvalsh(S), rtol=0, atol=1e-13)


# --- the point-mass helpers and the constructors ---

def test_point_mass_helpers_match_jax(x64):
    """``discretize_linear_system``, ``van_loan_discretization`` and
    ``point_mass_dynamics_matrices`` with a batch of parameters against a
    loop of JAX calls, rtol 1e-12."""
    rng = np.random.default_rng(5)
    damping, m, tau, av = (rng.uniform(lo, hi, 4) for lo, hi in (
        (0.05, 0.5), (0.5, 2.0), (0.001, 0.05), (1e-3, 1.0)))
    dt = 1 / 60
    A, B, V = tpm.point_mass_dynamics_matrices(
        *(torch.tensor(x) for x in (damping, m, tau, av)), dt)
    A_c = rng.normal(size=(4, 3, 3))
    B_c = rng.normal(size=(4, 3, 1))
    Ad, Bd = tpm.discretize_linear_system(torch.tensor(A_c),
                                          torch.tensor(B_c), dt)
    Q = tpm.van_loan_discretization(torch.tensor(A_c), torch.tensor(B_c),
                                    dt)
    for k in range(4):
        jA, jB, jV = jpm.point_mass_dynamics_matrices(
            damping[k], m[k], tau[k], av[k], dt)
        for got, want in ((A[k], jA), (B[k], jB), (V[k], jV)):
            close(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
        jAd, jBd = jpm.discretize_linear_system(jnp.asarray(A_c[k]),
                                                jnp.asarray(B_c[k]), dt)
        close(Ad[k], jAd, rtol=1e-12)
        close(Bd[k], jBd, rtol=1e-12)
        close(Q[k], jpm.van_loan_discretization(
            jnp.asarray(A_c[k]), jnp.asarray(B_c[k]), dt), rtol=1e-12,
            atol=1e-15)
    # V is upper triangular, as the reference's scipy-convention factor
    assert float(torch.tril(V, -1).abs().max()) == 0.0


def test_point_mass_float32_is_built_in_float64():
    """The point mass's exponentials in float32 lose its noise factor: van
    Loan's block holds exp(dt/tau) (~7e5 at tau = 1.23 ms) beside the noise
    it integrates, and the float32 helper's ``V`` (like ``lqg_tpu``'s) is
    off by more than 1e-4 of its largest entry; the float32 model builds
    them in float64 and is within 1e-6."""
    params = dict(damping=0.1, m=1.0, tau=0.00123, av=0.62)
    V64 = tpm.point_mass_dynamics_matrices(
        *(torch.tensor(v, dtype=torch.float64) for v in params.values()),
        1 / 60)[2]
    scaled = lambda V: float((V.double() - V64).abs().max() / V64.abs().max())
    V32 = tpm.point_mass_dynamics_matrices(
        *(torch.tensor(v) for v in params.values()), 1 / 60)[2]
    jV32 = jpm.point_mass_dynamics_matrices(
        *(jnp.float32(v) for v in params.values()), jnp.float32(1 / 60))[2]
    assert scaled(V32) > 1e-4
    assert scaled(torch.tensor(np.asarray(jV32))) > 1e-4
    model = tmodels.PointMassBoundedActor(
        tau=params["tau"], action_variability=params["av"], device="cpu")
    assert model.actor.V.dtype == torch.float32
    assert scaled(model.actor.V[1:, 1:]) < 1e-6


@pytest.mark.parametrize("name", sorted(ZOO))
def test_batched_constructor_matches_jax_loop(name, x64):
    """A batch of parameter sets against JAX constructors one set at a
    time: every field of both specs (and the control-noise scales), rtol
    1e-12."""
    rng = np.random.default_rng(6)
    varied = {k: ZOO[name].get(k, 0.5) * rng.uniform(0.5, 2.0, 3)
              for k in BATCHED[name]}
    fixed = {k: v for k, v in ZOO[name].items() if k not in varied}
    tm = getattr(tmodels, name)(
        T=20, **fixed, **{k: torch.tensor(v) for k, v in varied.items()},
        **F64)
    assert tm.batch_shape == (3,)
    for k in range(3):
        jm = getattr(jmodels, name)(T=20, **fixed,
                                    **{p: v[k] for p, v in varied.items()})
        for tspec, jspec in ((tm.actor, jm.actor), (tm.dynamics, jm.dynamics)):
            assert tspec.zero_affine
            for f, want in _fields(jspec).items():
                got = getattr(tspec, f)[k]
                close(got, want, rtol=1e-12,
                      atol=1e-12 * max(1.0, np.abs(want).max()))
        if jm.control_noise is not None:
            close(tm.control_noise[k], jm.control_noise, rtol=1e-14)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_gains_and_likelihood_match_jax(name, x64):
    """Gains (``auto``: the scans on the CPU, ``backward_multiplicative``
    for the signal-dependent actor) and the scan likelihood of the
    positions of trajectories the JAX model simulates, rtol 1e-9."""
    jm = getattr(jmodels, name)(T=30, **ZOO[name])
    tm = getattr(tmodels, name)(T=30, **ZOO[name], **F64)
    jg, jK = jm.gains()
    tg, tK = tm.gains()
    close(tg.L, jg.L, rtol=1e-9, atol=1e-12 * np.abs(np.asarray(jg.L)).max())
    close(tg.H, jg.H, rtol=1e-9)
    close(tK, jK, rtol=1e-9, atol=1e-14)
    x = jm.simulate(random.PRNGKey(1), n=3)[..., :2]
    close(tm.log_likelihood(torch.tensor(np.asarray(x)), method="scan"),
          jm.log_likelihood(x, method="scan"), rtol=1e-9)


def test_backward_multiplicative_matches_jax(x64):
    """Two noise channels on a dim=2 bounded actor, rtol 1e-10; without
    noise and unguarded it is ``backward``, rtol 1e-10 (the two update the
    value function in different forms)."""
    rng = np.random.default_rng(7)
    jm = jmodels.BoundedActor(T=25, dim=2, action_cost=0.4)
    C = 0.05 * rng.normal(size=(2, 4, 2))
    jg = jriccati.backward_multiplicative(jm.actor, jnp.asarray(C),
                                          horizon=25)
    tm = tmodels.BoundedActor(T=25, dim=2, action_cost=0.4, **F64)
    tg = riccati.backward_multiplicative(tm.actor, torch.tensor(C),
                                         horizon=25)
    for f in ("L", "l", "H"):
        close(getattr(tg, f), getattr(jg, f), rtol=1e-10, atol=1e-13)
    plain = riccati.backward(tm.actor, horizon=25, regularize="none")
    zero = riccati.backward_multiplicative(
        tm.actor, torch.zeros(1, 4, 2, **F64), 25, regularize="none")
    torch.testing.assert_close(zero.L, plain.L, rtol=1e-10, atol=1e-13)
    with pytest.raises(ValueError, match="horizon"):
        riccati.backward_multiplicative(tm.actor, torch.tensor(C))


# --- the rollout with control noise ---

@pytest.mark.parametrize("name", sorted(ZOO))
def test_rollout_matches_jax_simulate(name, x64):
    """``rollout`` fed the three draws ``lqg_tpu.System.simulate`` makes for
    a key gives its (x, x_hat, y, u), rtol 1e-9."""
    jm = getattr(jmodels, name)(T=40, **ZOO[name])
    tm = getattr(tmodels, name)(T=40, **ZOO[name], **F64)
    key = random.PRNGKey(11)
    want = jm.simulate(key, n=3, return_all=True)
    eps, eta, eps_u = _draws(key, 40, 3, jm)
    got = tm.rollout(torch.tensor(eps), torch.tensor(eta),
                     None if eps_u is None else torch.tensor(eps_u),
                     return_all=True)
    for a, b in zip(got, want):
        close(a, b, rtol=1e-9, atol=1e-9 * np.abs(np.asarray(b)).max())


def test_control_noise_draws_and_checks():
    """``simulate`` draws the control noise after the process and the
    observation noise, from the same generator; the rollout needs it
    exactly when the system has control noise."""
    tm = tmodels.SignalDependentNoiseActor(T=12, signal_dep_noise=2.0, **F64)
    x = tm.simulate(torch.Generator().manual_seed(3), n=2)
    g = torch.Generator().manual_seed(3)
    eps = torch.randn((12, 2, 2), generator=g, **F64)
    eta = torch.randn((12, 2, 2), generator=g, **F64)
    eps_u = torch.randn((12, 2, 1), generator=g, **F64)
    torch.testing.assert_close(x, tm.rollout(eps, eta, eps_u), rtol=0,
                               atol=0)
    assert not torch.equal(x, tm.rollout(eps, eta, torch.zeros_like(eps_u)))
    with pytest.raises(ValueError, match="eps_u"):
        tm.rollout(eps, eta)
    plain = tmodels.BoundedActor(T=12, **F64)
    with pytest.raises(ValueError, match="eps_u"):
        plain.rollout(eps, eta, eps_u)


def test_signal_dependent_noise_zero_is_the_bounded_actor(x64):
    """At ``signal_dep_noise=0`` the multiplicative pass, the rollout and
    the likelihood are the bounded actor's, rtol 1e-7: the "jitter" guard
    (1e-8 of the Hessian's scale) enters the two passes' value updates in
    different forms."""
    kw = dict(action_cost=0.7, sigma_cursor=3.0)
    sd = tmodels.SignalDependentNoiseActor(T=30, signal_dep_noise=0.0, **kw,
                                           **F64)
    ba = tmodels.BoundedActor(T=30, **kw, **F64)
    (gs, Ks), (gb, Kb) = sd.gains(), ba.gains()
    for a, b in ((gs.L, gb.L), (gs.H, gb.H), (Ks, Kb)):
        torch.testing.assert_close(a, b, rtol=1e-7, atol=1e-14)
    g = torch.Generator().manual_seed(4)
    eps, eta = (torch.randn((30, 3, 2), generator=g, **F64)
                for _ in range(2))
    x = sd.rollout(eps, eta, torch.randn((30, 3, 1), generator=g, **F64))
    torch.testing.assert_close(x, ba.rollout(eps, eta), rtol=1e-7,
                               atol=1e-9)
    torch.testing.assert_close(sd.log_likelihood(x), ba.log_likelihood(x),
                               rtol=1e-7, atol=0)


def test_fused_with_control_noise_raises():
    """K1 has no control-multiplicative noise: ``method="fused"`` raises
    where ``lqg_tpu`` runs its kernel without the noise; ``auto`` takes the
    scans."""
    tm = tmodels.SignalDependentNoiseActor(T=10, device="cpu")
    with pytest.raises(ValueError, match="control"):
        tm.gains(method="fused")
    assert not tm._fused_ok(tm._default_Sigma0())


def test_converted_signal_dependent_system(x64):
    """``convert.system_from_numpy`` carries the control-noise scales
    across: the same gains and likelihood."""
    jm = jmodels.SignalDependentNoiseActor(T=15, **ZOO[
        "SignalDependentNoiseActor"])
    tm = system_from_numpy(_fields(jm.actor), _fields(jm.dynamics),
                           horizon=15, control_noise=np.asarray(
                               jm.control_noise), **F64)
    assert tm.control_noise.shape == (1, 2, 1)
    close(tm.gains()[0].L, jm.gains()[0].L, rtol=1e-10)
    x = jm.simulate(random.PRNGKey(2), n=2)
    close(tm.log_likelihood(torch.tensor(np.asarray(x))),
          jm.log_likelihood(x, method="scan"), rtol=1e-10)


# --- the golden ---

def test_point_mass_golden():
    """Gains (``"eigh"`` guard), likelihood and belief mean of the
    reference's own point-mass run, as ``tests/test_reference_goldens.py``
    reads them: gains rtol 1e-10, likelihood 1e-5, belief mean 1e-4."""
    data = np.load(os.path.join(GOLDEN_DIR, "point_mass.npz"))
    meta = json.loads(str(data["params"]))
    model = tmodels.PointMassBoundedActor(
        **{k: v for k, v in meta.items() if k not in ("class", "n")}, **F64)
    gains = riccati.backward(model.actor, horizon=model.horizon,
                             regularize="eigh")
    K = kalman.forward(model.actor, Sigma0=model._default_Sigma0(),
                       horizon=model.horizon)
    close(gains.L, data["L"], rtol=1e-10, atol=1e-12)
    close(gains.l, data["l"], rtol=1e-10, atol=1e-12)
    close(K, data["K"], rtol=1e-10, atol=1e-12)
    x = torch.tensor(data["x"])
    np.testing.assert_allclose(model.log_likelihood(x).numpy(),
                               data["log_likelihood"], rtol=1e-5)
    np.testing.assert_allclose(
        model.belief_tracking_distribution(x).loc.numpy(), data["belief_mu"],
        rtol=1e-4, atol=1e-6)


# --- the potentials ---

# damping, m and tau have no default prior; give them one on both sides
EXTRA = {"damping": (np.log(0.1), 0.5), "m": (0.0, 0.5),
         "tau": (np.log(0.01), 1.0)}
SHARED = {
    "PointMassBoundedActor": ["action_cost", "action_variability",
                              "sigma_cursor", "damping", "m", "tau"],
    "HandMotionModelTrackingTask": ["action_cost", "action_variability",
                                    "sigma_cursor", "m", "tau"],
    "SignalDependentNoiseActor": ["action_cost", "action_variability",
                                  "sigma_cursor", "signal_dep_noise"],
}


def _priors(prior, dist):
    out = dict(prior)
    out.update({k: dist(*v) for k, v in EXTRA.items()})
    return out


def _zoo_data(name, Nc, n, T):
    """Trials of ``Nc`` JAX models, ``(Nc, n, T+1, 2)``."""
    return np.stack([np.asarray(getattr(jmodels, name)(
        T=T, **dict(ZOO[name], sigma_target=4.0 + 3.0 * c)).simulate(
            random.PRNGKey(c), n=n)[..., :2]) for c in range(Nc)])


def test_free_parameters_match_jax():
    """``get_model_params``: damping, m and tau of the point mass, m and tau
    of the hand and signal_dep_noise are free, as in ``lqg_tpu``; the MLE
    model (no priors) has one coordinate each."""
    x = torch.zeros(2, 5, 2, dtype=torch.float64)
    for name in ZOO:
        want = jinfer.get_model_params(getattr(jmodels, name))
        assert tinfer.get_model_params(getattr(tmodels, name)) == want
        assert tinfer.lqg_model(x, getattr(tmodels, name)).names == \
            sorted(want)
    assert {"damping", "m", "tau"} <= set(jinfer.get_model_params(
        jmodels.PointMassBoundedActor))
    assert TPRIOR["signal_dep_noise"] == tdists.HalfNormal(1.0)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_potential_value_and_grad_match_jax(name, x64):
    """The slice as a whole: the hierarchical potential of each model, 2
    chains x 2 conditions x 2 trials at T=24, value and gradient against
    ``lqg_tpu.infer`` in float64 with the same priors and ``ll_baseline``:
    value rtol 1e-9, gradient rtol 1e-7 plus 1e-8 of the largest
    component."""
    x = _zoo_data(name, 2, 2, 24)
    jm = jinfer.shared_params_lqg_model(
        jnp.asarray(x), getattr(jmodels, name), shared_params=SHARED[name],
        priors=_priors(JPRIOR, jdists.LogNormal))
    tm = tinfer.shared_params_lqg_model(
        torch.tensor(x), getattr(tmodels, name), shared_params=SHARED[name],
        priors=_priors(TPRIOR, tdists.LogNormal))
    assert tm.names == jm.names
    jm.ll_baseline = tm.ll_baseline = -100.0
    u0 = np.asarray(jm.init_unconstrained())
    close(tm.init_unconstrained(), u0, rtol=1e-12)
    us = u0 + 0.2 * np.random.default_rng(8).normal(size=(2,) + u0.shape)
    u = torch.tensor(us, requires_grad=True)
    pot = tm.potential(u)
    (grad,) = torch.autograd.grad(pot.sum(), u)
    jv, jg = jax.jit(jax.vmap(jax.value_and_grad(jm.potential)))(
        jnp.asarray(us))
    close(pot, jv, rtol=1e-9)
    close(grad, jg, rtol=1e-7, atol=1e-8 * float(np.abs(jg).max()))


# --- the routes ---

def _route_models():
    """Every model of the zoo with a shape on a kernel's edge: (name,
    kwargs, observed dims)."""
    return [
        ("PointMassBoundedActor", {}, 2),
        ("PointMassBoundedActor", {}, 4),
        ("HandMotionModelTrackingTask", {}, 2),
        ("SignalDependentNoiseActor", {}, 2),
        ("RelativeObservationBoundedActor", {"dim": 2}, 4),
        ("BoundedActor", {"dim": 2}, 4),
        ("OptimalActor", {"dim": 2}, 4),
        ("SubjectiveActor", {"dim": 2}, 4),
        ("BoundedActor", {}, 2),
        ("SubjectiveActor", {}, 2),
    ]


def _recording(fn, calls):
    def wrapped(*args, **kw):
        calls.append(fn.__name__)
        return fn(*args, **kw)
    return wrapped


@pytest.mark.parametrize("name,kw,d", _route_models())
def test_auto_routes_as_jax(name, kw, d, monkeypatch):
    """``auto`` takes K1 and K3 exactly where ``lqg_tpu``'s ``auto`` takes
    its Pallas kernels (``fused_gains_available`` and no control noise;
    ``fused_ll_available``), shown with the card's device test forced on,
    float32; the kernels' plain versions then agree with the scans (rtol
    2e-3, atol 0.2, the blocked route's tolerance of the delay tests)."""
    jm = getattr(jmodels, name)(T=8, **kw)
    tm = getattr(tmodels, name)(T=8, **kw, device="cpu")
    n, m, p = tm.xdim, tm.udim, tm.actor.F.shape[-2]
    j = tm.xdim + tm.bdim
    jax_k1 = (jfused_gains_available(jm.actor)
              and jm.control_noise is None)
    jax_k3 = jfused_ll_available(j, d, jnp.float32)
    assert fused_gains_available(tm.actor) == jfused_gains_available(
        jm.actor), (n, m, p)
    assert fused_ll_available(j, d, torch.float32) == jax_k3, (j, d)
    taken = []
    for attr in ("fused_gains", "conditioned_log_likelihood_fused",
                 "conditioned_log_likelihood_blocked"):
        monkeypatch.setattr(tsystem, attr, _recording(getattr(tsystem, attr),
                                                      taken))
    x = tm.simulate(torch.Generator().manual_seed(0), n=2)[..., :d]
    ll_scan = tm.log_likelihood(x, method="scan")
    assert taken == []  # on the CPU auto is the scans
    # what the rule sees on a card: a CUDA float32 spec and tensor
    monkeypatch.setattr(LQGSpec, "device",
                        property(lambda self: torch.device("cuda")))
    assert tm._fused_ok(tm._default_Sigma0()) == jax_k1
    monkeypatch.undo()
    for attr in ("fused_gains", "conditioned_log_likelihood_fused",
                 "conditioned_log_likelihood_blocked"):
        monkeypatch.setattr(tsystem, attr, _recording(getattr(tsystem, attr),
                                                      taken))
    monkeypatch.setattr(System, "_fused_ok", lambda self, S0: (
        self.control_noise is None and fused_gains_available(self.actor)))
    monkeypatch.setattr(System, "_fused_ll_ok", lambda self, F, x: (
        tsystem.fused_ll_available(F.shape[-1], x.shape[-1], F.dtype)))
    ll = tm.log_likelihood(x)
    assert taken == (["fused_gains"] if jax_k1 else []) + (
        ["conditioned_log_likelihood_fused"] if jax_k3 else [])
    if name == "PointMassBoundedActor" and d == 4:
        # the full state's observed block is near-singular in float32: K3
        # gives NaN, as lqg_tpu's kernel does (the golden's test below)
        assert torch.isnan(ll).all()
    else:
        torch.testing.assert_close(ll, ll_scan, rtol=2e-3, atol=0.2)


def test_point_mass_full_state_float32_is_nan_as_pallas():
    """Scoring all four point-mass states in float32, ``lqg_tpu``'s Pallas
    likelihood kernel (interpret mode) and the port's K3 (plain version)
    both give NaN on the golden's trajectories (their first 30 steps): the
    observed block of the joint covariance (velocity and activation noise
    ~1e-3 beside the target's 1) has a closed-form determinant that float32
    loses.  The scans stay finite, and K3 in float64 gives the golden's
    likelihood (all 120 steps, rtol 1e-5)."""
    from lqg_tpu.ops.linalg import mT as jmT
    from lqg_tpu.ops.pallas.likelihood import (
        conditioned_log_likelihood_fused as jfused)
    from lqg_tpu_torch.ops.kernels.likelihood import (
        conditioned_log_likelihood_fused as tfused)

    data = np.load(os.path.join(GOLDEN_DIR, "point_mass.npz"))
    meta = json.loads(str(data["params"]))
    params = {k: v for k, v in meta.items() if k not in ("class", "n")}
    T = 30
    short = dict(params, T=T)
    jm = jmodels.PointMassBoundedActor(**short)
    jx = jnp.asarray(data["x"][:, :T + 1], jnp.float32)
    joint = jm._joint()
    jll = jfused(joint.F[None], (joint.G @ jmT(joint.G))[None], jx[None])
    assert np.isnan(np.asarray(jll)).all()
    tm = tmodels.PointMassBoundedActor(**short, device="cpu")
    x = torch.tensor(data["x"][:, :T + 1], dtype=torch.float32)
    assert torch.isnan(tm.log_likelihood(x, method="fused")).all()
    assert torch.isfinite(tm.log_likelihood(x, method="scan")).all()
    t64 = tmodels.PointMassBoundedActor(**params, **F64)
    np.testing.assert_allclose(
        t64.log_likelihood(torch.tensor(data["x"]), method="fused").numpy(),
        data["log_likelihood"], rtol=1e-5)
    assert tfused is tsystem.conditioned_log_likelihood_fused
