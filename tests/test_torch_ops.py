"""Port parity: the scan recursions, the likelihood pieces and compensated
summation against ``lqg_tpu`` in float64, and the gains against the
reference goldens."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqg_tpu import models as jmodels
from lqg_tpu.ops import gaussian as jgaussian
from lqg_tpu.ops import kalman as jkalman
from lqg_tpu.ops import riccati as jriccati
from lqg_tpu.utils.numerics import kahan_sum as jkahan_sum
from lqg_tpu_torch import models as tmodels
from lqg_tpu_torch.ops import gaussian, kalman, riccati
from lqg_tpu_torch.ops.linalg import mT
from lqg_tpu_torch.utils.numerics import kahan_sum

F64 = dict(device="cpu", dtype=torch.float64)
T = 50
PARAMS = dict(action_cost=0.4, action_variability=0.6, sigma_target=4.0,
              sigma_cursor=2.5)
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
GOLDENS = ["bounded_actor", "optimal_actor", "relative_observation",
           "tracking_2d"]


def close(t, j, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.fixture
def pair(x64):
    return (jmodels.BoundedActor(T=T, **PARAMS),
            tmodels.BoundedActor(T=T, **PARAMS, **F64))


@pytest.mark.parametrize("mode", ["none", "jitter", "eigh"])
def test_riccati_backward_modes(pair, mode):
    jm, tm = pair
    jg = jriccati.backward(jm.actor, horizon=T, regularize=mode)
    tg = riccati.backward(tm.actor, horizon=T, regularize=mode)
    for t, j in zip(tg, jg):
        close(t, j)


def test_riccati_backward_stacked_affine(x64):
    """Stacked spec with nonzero affine and cross terms."""
    from lqg_tpu.utils import time_stack_spec as jtime_stack_spec
    from lqg_tpu_torch.utils import time_stack_spec

    rng = np.random.default_rng(1)
    actor = jmodels.BoundedActor(T=T, **PARAMS).actor
    mats = [np.array(getattr(actor, k)) for k in "ABFVWQR"]
    affine = dict(q=rng.normal(size=(T, 2)), r=rng.normal(size=(T, 1)),
                  P=0.1 * rng.normal(size=(T, 1, 2)), qf=rng.normal(size=2))
    jspec = jtime_stack_spec(*mats, T=T)._replace(
        **{k: jnp.asarray(v) for k, v in affine.items()})
    tspec = time_stack_spec(*(torch.tensor(M) for M in mats), T=T)._replace(
        **{k: torch.tensor(v) for k, v in affine.items()})
    assert not tspec.zero_affine
    for t, j in zip(riccati.backward(tspec), jriccati.backward(jspec)):
        close(t, j)


def test_kalman_forward(pair):
    jm, tm = pair
    jV, tV = jm.actor.V, tm.actor.V
    close(kalman.forward(tm.actor, tV @ mT(tV), horizon=T),
          jkalman.forward(jm.actor, jV @ jV.T, horizon=T))


def test_likelihood_pieces(pair):
    """joint_system, conditional_kernel, trial_log_likelihood,
    conditional_sigma and conditional_mean on one simulated data set."""
    jm, tm = pair
    rng = np.random.default_rng(2)
    x = np.cumsum(rng.normal(size=(3, T + 1, 2)), axis=1)
    jjoint = jm._joint()
    tjoint = tm._joint()
    close(tjoint.F, jjoint.F)
    close(tjoint.G, jjoint.G)
    jk = jgaussian.conditional_kernel(jjoint, 2)
    tk = gaussian.conditional_kernel(tjoint, 2)
    for t, j in zip(tk, jk):
        close(t, j)
    close(gaussian.trial_log_likelihood(tk, torch.as_tensor(x)),
          jgaussian.trial_log_likelihood(jk, jnp.asarray(x)))
    close(gaussian.conditional_sigma(tjoint, 2),
          jgaussian.conditional_sigma(jjoint, 2))
    close(gaussian.conditional_mean(tk, torch.as_tensor(x)),
          jgaussian.conditional_mean(jk, jnp.asarray(x)))


@pytest.mark.parametrize("shape,axis", [((1000,), 0), ((37, 5), 0),
                                        ((4, 100), 1)])
def test_kahan_sum(shape, axis, x64):
    x = np.random.default_rng(3).normal(size=shape) * 1e3
    close(kahan_sum(torch.as_tensor(x), axis=axis),
          jkahan_sum(jnp.asarray(x), axis=axis))


@pytest.mark.parametrize("case", GOLDENS)
def test_gains_match_goldens(case):
    """Gains with the reference's eigh clamp against its goldens, at the
    tolerances of ``test_reference_goldens.test_gains_parity_exact``."""
    data = np.load(os.path.join(GOLDEN_DIR, f"{case}.npz"))
    meta = json.loads(str(data["params"]))
    params = {k: v for k, v in meta.items() if k not in ("class", "n")}
    model = getattr(tmodels, meta["class"])(**params, **F64)
    gains = riccati.backward(model.actor, horizon=model.horizon,
                             regularize="eigh")
    V = model.actor.V
    K = kalman.forward(model.actor, V @ mT(V), horizon=model.horizon)
    for name, value in (("L", gains.L), ("l", gains.l), ("K", K)):
        np.testing.assert_allclose(value.numpy(), data[name], rtol=1e-12,
                                   atol=1e-13, err_msg=name)
