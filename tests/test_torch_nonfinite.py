"""A matrix that is not positive-definite gives NaN, not an exception, on
the port's scan paths, where ``jnp.linalg.cholesky`` gives NaN in the JAX
package: the Riccati and Kalman scans, the conditioned likelihood's
covariance recursion and the dense normal's factor.  JAX's NUTS counts a
NaN energy as a divergence, so a bad proposal must not abort a chain.

All on the CPU in float64, against ``lqg_tpu`` on the same trials; and
``regularize_spd(mode="eigh")`` against ``lqg_tpu``'s, with (``-m cuda``,
on the card) a gains scan that waits on nothing.  JAX is imported inside
the tests that compare with it, so that the card's test runs where JAX is
not installed (``--noconftest``)."""

import numpy as np
import pytest
import torch

from lqg_tpu_torch import infer as tinfer
from lqg_tpu_torch import models as tmodels
from lqg_tpu_torch.infer import dists as tdists
from lqg_tpu_torch.ops import kalman, riccati
from lqg_tpu_torch.ops.linalg import regularize_spd

T = 50
F64 = dict(device="cpu", dtype=torch.float64)
SHARED = ["action_cost", "action_variability", "sigma_cursor"]

# parameter sets whose gains or likelihood meet a matrix that is not
# positive-definite: non-finite parameters, noise scales that underflow,
# and a negative action cost
PROBES = [
    dict(action_cost=float("nan")),
    dict(sigma_target=float("inf")),
    dict(action_variability=1e-300, sigma_target=1e-300, sigma_cursor=1e-300),
    dict(action_cost=-1.0),
]
PROBE_IDS = ["action_cost_nan", "sigma_target_inf", "noise_1e-300",
             "action_cost_negative"]


def _trials(n=3, seed=0):
    import jax
    from lqg_tpu import models as jmodels

    return np.asarray(jmodels.BoundedActor(T=T).simulate(
        jax.random.PRNGKey(seed), n=n))


def _same_nans_and_values(got, want, rtol=1e-10, atol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("params", PROBES, ids=PROBE_IDS)
def test_log_likelihood_is_nan_where_jax_is(params, x64):
    import jax.numpy as jnp
    from lqg_tpu import models as jmodels

    x = _trials()
    want = np.asarray(jmodels.BoundedActor(T=T, **params).log_likelihood(
        jnp.asarray(x)))
    got = tmodels.BoundedActor(T=T, **params, **F64).log_likelihood(
        torch.tensor(x))
    assert np.isnan(want).all()
    _same_nans_and_values(got.numpy(), want)


def test_riccati_gains_are_nan_for_a_control_hessian_not_pd():
    """A negative action cost makes ``H = R + B^T S B`` indefinite at the
    last step: the gains are NaN from there back, and nothing raises."""
    spec = tmodels.BoundedActor(T=T, action_cost=-1.0, **F64).actor
    gains = riccati.backward(spec, horizon=T, regularize="none")
    assert torch.isnan(gains.L[-1]).all() and torch.isnan(gains.l[-1]).all()
    assert torch.isnan(gains.L).all()
    ok = riccati.backward(tmodels.BoundedActor(T=T, **F64).actor, horizon=T)
    assert torch.isfinite(ok.L).all()


def test_kalman_gains_are_nan_for_an_innovation_covariance_not_pd():
    """Noise scales of 1e-300 square to 0: ``G = F P F^T + W W^T`` is the
    zero matrix, so every gain is NaN, and nothing raises."""
    m = tmodels.BoundedActor(T=T, action_variability=1e-300,
                             sigma_target=1e-300, sigma_cursor=1e-300, **F64)
    K = kalman.forward(m.actor, Sigma0=torch.zeros(2, 2, **F64), horizon=T)
    assert K.shape == (T, 2, 2) and torch.isnan(K).all()
    ok = kalman.forward(tmodels.BoundedActor(T=T, **F64).actor,
                        Sigma0=torch.eye(2, **F64), horizon=T)
    assert torch.isfinite(ok).all()


def test_scans_keep_other_batch_members_finite():
    """NaN stays with the parameter set whose matrix is not
    positive-definite; the others' gains are the ones computed alone."""
    cost = torch.tensor([0.5, -1.0, 2.0], **F64)
    spec = tmodels.BoundedActor(T=T, action_cost=cost, **F64).actor
    L = riccati.backward(spec, horizon=T, regularize="none").L
    assert torch.isnan(L[:, 1]).all()
    for k in (0, 2):
        alone = tmodels.BoundedActor(T=T, action_cost=float(cost[k]),
                                     **F64).actor
        torch.testing.assert_close(
            L[:, k], riccati.backward(alone, horizon=T,
                                      regularize="none").L,
            rtol=1e-12, atol=0)


def test_dense_normal_factor_is_nan_not_an_exception():
    cov = torch.tensor([[[2.0, 0.3], [0.3, 1.0]], [[1.0, 2.0], [2.0, 1.0]]],
                       dtype=torch.float64)
    mvn = tdists.MultivariateNormal(torch.zeros(2, 2, dtype=torch.float64),
                                    cov)
    L = mvn.scale_tril
    torch.testing.assert_close(L[0], torch.linalg.cholesky(cov[0]))
    assert torch.isnan(L[1]).all()
    lp = mvn.log_prob(torch.ones(2, 2, dtype=torch.float64))
    assert torch.isfinite(lp[0]) and torch.isnan(lp[1])


def test_potential_value_and_grad_match_jax_where_finite(x64):
    """The hierarchical potential over a batch of chains, two of which meet
    a non-finite parameter: NaN exactly where ``lqg_tpu.infer`` gives NaN,
    and the value and gradient of the other chains equal to it."""
    import jax
    import jax.numpy as jnp
    from lqg_tpu import models as jmodels
    from lqg_tpu.infer import models as jinfer

    x = np.stack([_trials(3, seed) for seed in (1, 2)])
    jm = jinfer.shared_params_lqg_model(jnp.asarray(x), jmodels.BoundedActor,
                                        shared_params=SHARED)
    tm = tinfer.shared_params_lqg_model(torch.tensor(x), tmodels.BoundedActor,
                                        shared_params=SHARED)
    u0 = np.asarray(jm.init_unconstrained())
    us = u0 + 0.2 * np.random.default_rng(5).normal(size=(4,) + u0.shape)
    us[1, 0] = np.nan
    us[3, -1] = np.inf
    u = torch.tensor(us, requires_grad=True)
    pot = tm.potential(u)
    (grad,) = torch.autograd.grad(pot.sum(), u)
    jv, jg = jax.vmap(jax.value_and_grad(jm.potential))(jnp.asarray(us))
    jv, jg = np.asarray(jv), np.asarray(jg)
    assert np.isfinite(jv[[0, 2]]).all() and not np.isfinite(jv[[1, 3]]).any()
    _same_nans_and_values(pot.detach().numpy(), jv)
    for c in (0, 2):
        np.testing.assert_allclose(grad[c].numpy(), jg[c], rtol=1e-10,
                                   atol=1e-9 * float(np.abs(jg[c]).max()))


# --- regularize_spd(mode="eigh") ------------------------------------------

# the probes at the two control dimensions: m = 1 (BoundedActor) and m = 2
# (RelativeObservationBoundedActor(dim=2), one sensory noise ``sigma``)
EIGH_MODELS = {
    "m1": ("BoundedActor", {}, {}),
    "m2": ("RelativeObservationBoundedActor", dict(dim=2),
           dict(sigma_target="sigma", sigma_cursor=None)),
}


def _probe_for(params, rename):
    out = {}
    for k, v in params.items():
        k = rename.get(k, k)
        if k is not None:
            out[k] = v
    return out


@pytest.mark.parametrize("which", sorted(EIGH_MODELS))
@pytest.mark.parametrize("params", PROBES, ids=PROBE_IDS)
def test_eigh_regularized_gains_match_jax(params, which, x64):
    """The Riccati scan with ``regularize="eigh"`` on the four probe
    parameter sets: NaN at the same entries as ``lqg_tpu``, the finite
    entries within rtol 1e-12."""
    from lqg_tpu import models as jmodels
    from lqg_tpu.ops import riccati as jriccati

    name, kw, rename = EIGH_MODELS[which]
    p = _probe_for(params, rename)
    want = jriccati.backward(getattr(jmodels, name)(T=T, **kw, **p).actor,
                             horizon=T, regularize="eigh")
    got = riccati.backward(getattr(tmodels, name)(T=T, **kw, **p,
                                                  **F64).actor,
                           horizon=T, regularize="eigh")
    for field in ("L", "l", "H"):
        _same_nans_and_values(getattr(got, field).numpy(),
                              np.asarray(getattr(want, field)), rtol=1e-12)


@pytest.mark.parametrize("m", [1, 2, 3])
def test_regularize_spd_eigh_matches_jax(m, x64):
    """Random symmetric matrices, many of them lifted (the smallest
    eigenvalue below ``eps``), and the NaN probe ``[[nan, 0], [0, 1]]``,
    whose result is all NaN in ``lqg_tpu``.  A lifted diagonal entry is
    ``H_ii + eps - lambda_min``, and an eigenvalue is determined to a few
    ulp of ``max |H|``: so each entry within rtol 1e-12 plus 1e-14 x
    ``max |H|`` (a diagonal ``H`` gives the same bits)."""
    import jax.numpy as jnp
    from lqg_tpu.ops.linalg import regularize_spd as jregularize

    rng = np.random.default_rng(m)
    H = rng.normal(size=(64, m, m))
    H = H + np.swapaxes(H, -1, -2) + np.eye(m) * rng.uniform(-1, 4, (64, 1, 1))
    H[0] = np.diag(np.arange(1.0, m + 1) * -1e-3)  # diagonal, lifted
    probes = [H]
    if m >= 2:
        nan = np.eye(m)
        nan[0, 0] = np.nan
        probes.append(nan[None])
    for eps in (1e-6, 0.5):
        for Hp in probes:
            want = np.asarray(jregularize(jnp.asarray(Hp), eps, "eigh"))
            got = regularize_spd(torch.tensor(Hp), eps, "eigh").numpy()
            _same_nans_and_values(got, want, rtol=1e-12,
                                  atol=1e-14 * np.nanmax(np.abs(Hp)))
            np.testing.assert_array_equal(got[0], want[0])
    if m >= 2:
        assert np.isnan(want).all()


@pytest.mark.cuda
def test_eigh_regularized_gains_scan_waits_on_nothing_on_card():
    """A ``regularize="eigh"`` gains scan on the card reads nothing on the
    host, so a potential built with it can be captured in a CUDA graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name, kw, _ in EIGH_MODELS.values():
        spec = getattr(tmodels, name)(T=8, **kw, device="cuda").actor
        riccati.backward(spec, horizon=8, regularize="eigh")  # warm-up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            gains = riccati.backward(spec, horizon=8, regularize="eigh")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.isfinite(gains.L).all()
