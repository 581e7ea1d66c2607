"""The port's square-root and steady-state gains (``lqg_tpu_torch.ops.sqrt``,
``ops.dare``, ``System.gains(method="sqrt"|"steady")``) and ``psd_solve``
against ``lqg_tpu`` in float64 on the CPU: the recursions for the bounded
and the subjective actor, stationary and batched; the doubling solvers;
gradients with respect to ``action_cost`` against ``jax.grad``; the
``System`` methods with their raising cases; the likelihood on sqrt gains."""

import numpy as np
import pytest
import torch

from lqg_tpu_torch import models as tmodels
from lqg_tpu_torch.ops import dare as tdare
from lqg_tpu_torch.ops import sqrt as tsqrt
from lqg_tpu_torch.ops.linalg import psd_solve

F64 = dict(device="cpu", dtype=torch.float64)
MODELS = ["BoundedActor", "SubjectiveActor"]
# a parameter that differs between the sets of a batched model
BATCH = {"sigma_target": [3.0, 6.0, 12.0], "action_cost": [0.1, 0.5, 2.0]}


@pytest.fixture(autouse=True)
def one_thread():
    """Many small ops on the CPU: one intra-op thread, so that the pool
    does not keep every core busy and slow the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(t, j, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol)


def _jax_actor(name, **kw):
    import jax
    import jax.numpy as jnp
    from lqg_tpu import models as jmodels

    m = getattr(jmodels, name)(**kw)
    return m, jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), m.actor)


def test_psd_sqrt_of_a_singular_matrix(x64):
    """The tracking error cost ``[[1, -1], [-1, 1]]`` is PSD and singular:
    ``S S^T`` is the matrix, and ``S`` is JAX's."""
    from lqg_tpu.ops import sqrt as jsqrt

    Q = np.array([[1.0, -1.0], [-1.0, 1.0]])
    S = tsqrt.psd_sqrt(torch.tensor(Q))
    close((S @ S.mT).numpy(), Q, rtol=0, atol=1e-12)
    close(S.numpy(), jsqrt.psd_sqrt(Q), rtol=0, atol=1e-12)
    # a negative eigenvalue is clipped to eps, as JAX clips it
    M = np.array([[1.0, 2.0], [2.0, 1.0]])
    close(tsqrt.psd_sqrt(torch.tensor(M), eps=1e-3).numpy(),
          jsqrt.psd_sqrt(M, eps=1e-3), rtol=1e-12)


@pytest.mark.parametrize("name", MODELS)
def test_sqrt_recursions_match_jax(x64, name):
    """L, H and K of the sqrt recursions at T=120 within rtol 1e-9."""
    from lqg_tpu.ops import sqrt as jsqrt

    jm, ja = _jax_actor(name, T=120)
    S0 = jm._default_Sigma0().astype(np.float64)
    tm = getattr(tmodels, name)(T=120, **F64)
    g = tsqrt.riccati_backward_sqrt(tm.actor, horizon=120)
    K = tsqrt.kalman_forward_sqrt(tm.actor, tm._default_Sigma0(), horizon=120)
    jg = jsqrt.riccati_backward_sqrt(ja, horizon=120)
    jK = jsqrt.kalman_forward_sqrt(ja, S0, horizon=120)
    for a, b in ((g.L, jg.L), (g.H, jg.H), (K, jK)):
        b = np.asarray(b)
        close(a.numpy(), b, rtol=1e-9, atol=1e-12 * np.abs(b).max())
    assert not g.l.any() and g.l.shape == (120, tm.udim)


@pytest.mark.parametrize("name", MODELS)
def test_sqrt_and_steady_batched_match_jax(x64, name):
    """A model of 3 parameter sets (one leading axis): each set's sqrt and
    steady gains equal JAX's for that set's model, rtol 1e-9."""
    from lqg_tpu.ops import dare as jdare
    from lqg_tpu.ops import sqrt as jsqrt

    kw = {k: torch.tensor(v, dtype=torch.float64) for k, v in BATCH.items()}
    tm = getattr(tmodels, name)(T=60, **kw, **F64)
    g = tsqrt.riccati_backward_sqrt(tm.actor, horizon=60)
    K = tsqrt.kalman_forward_sqrt(tm.actor, tm._default_Sigma0(), horizon=60)
    ss = tdare.steady_state(tm.actor)
    assert g.L.shape[:2] == (60, 3) and K.shape[:2] == (60, 3)
    for p in range(3):
        jm, ja = _jax_actor(name, T=60, **{k: v[p] for k, v in BATCH.items()})
        S0 = jm._default_Sigma0().astype(np.float64)
        jss = jdare.steady_state(ja)
        for a, b in ((g.L[:, p], jsqrt.riccati_backward_sqrt(ja, 60).L),
                     (K[:, p], jsqrt.kalman_forward_sqrt(ja, S0, 60)),
                     (ss.L[p], jss.L), (ss.K[p], jss.K)):
            b = np.asarray(b)
            close(a.numpy(), b, rtol=1e-9, atol=1e-12 * np.abs(b).max())


@pytest.mark.parametrize("name", MODELS)
def test_steady_state_matches_jax(x64, name):
    from lqg_tpu.ops import dare as jdare

    _, ja = _jax_actor(name, T=10)
    tm = getattr(tmodels, name)(T=10, **F64)
    ss, jss = tdare.steady_state(tm.actor), jdare.steady_state(ja)
    close(ss.L.numpy(), jss.L, rtol=1e-9)
    close(ss.K.numpy(), jss.K, rtol=1e-9, atol=1e-15)


def test_solve_dare_at_its_fixed_point(x64):
    """The returned S satisfies its own DARE residual and equals JAX's."""
    from lqg_tpu.ops import dare as jdare

    a = tmodels.BoundedActor(T=10, **F64).actor
    A, B, Q, R = a.A, a.B, a.Q, a.R
    G = B @ torch.linalg.solve(R, B.mT)
    S = tdare.solve_dare(A, G, Q)
    rhs = Q + A.mT @ S @ torch.linalg.solve(torch.eye(A.shape[-1],
                                                      dtype=A.dtype)
                                            + G @ S, A)
    assert float((S - rhs).abs().max()) < 1e-10
    jS = jdare.solve_dare(*(x.numpy() for x in (A, G, Q)))
    close(S.numpy(), jS, rtol=1e-9, atol=1e-12 * float(S.abs().max()))


def _loss(g, K):
    return (g.L ** 2).sum() + (K ** 2).sum()


@pytest.mark.parametrize("method,T", [("sqrt", 50), ("steady", 10)])
def test_gradients_match_jax(x64, method, T):
    """d/d action_cost of sum(L^2) + sum(K^2) through each method equals
    ``jax.grad`` of the same loss, rtol 1e-7."""
    import jax
    from lqg_tpu import models as jmodels

    def jloss(ac):
        g, K = jmodels.BoundedActor(T=T, action_cost=ac).gains(method=method)
        return _loss(g, K)

    want = float(jax.grad(jloss)(0.5))
    ac = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    loss = _loss(*tmodels.BoundedActor(T=T, action_cost=ac, **F64).gains(
        method=method))
    (got,) = torch.autograd.grad(loss, ac)
    assert want != 0.0
    close(float(got), want, rtol=1e-7)


@pytest.mark.parametrize("method", ["sqrt", "steady"])
def test_system_gains_match_jax(x64, method):
    from lqg_tpu import models as jmodels

    T = {"sqrt": 200, "steady": 400}[method]
    jg, jK = jmodels.BoundedActor(T=T).gains(method=method)
    g, K = tmodels.BoundedActor(T=T, **F64).gains(method=method)
    assert g.L.shape == (T, 1, 2) and K.shape == (T, 2, 2)
    assert not g.l.any() and (g.H is None) == (method == "steady")
    close(g.L.numpy(), jg.L, rtol=1e-9, atol=1e-13)
    close(K.numpy(), jK, rtol=1e-9, atol=1e-13)
    # against the scans: the horizons and bounds of lqg_tpu's
    # tests/test_sqrt.py and tests/test_dare.py
    gs, Ks = tmodels.BoundedActor(T=T, **F64).gains(method="scan")
    if method == "sqrt":
        assert float((g.L - gs.L).abs().max()) < 1e-4
        assert float((K - Ks).abs().max()) < 1e-4
    else:
        assert float((g.L[100] - gs.L[100]).abs().max()) < 1e-2
        assert float((K[-1] - Ks[-1]).abs().max()) < 1e-4


def test_system_gains_layout_and_raising_cases():
    kw = {k: torch.tensor(v) for k, v in BATCH.items()}
    m = tmodels.BoundedActor(T=20, device="cpu", **kw)
    for method in ("sqrt", "steady"):
        g, K = m.gains(method=method)
        assert g.L.shape == (20, 3, 1, 2) and K.shape == (20, 3, 2, 2)
    sig = tmodels.SignalDependentNoiseActor(T=20, device="cpu")
    with pytest.raises(ValueError, match="multiplicative"):
        sig.gains(method="sqrt")
    from lqg_tpu_torch.system import Actor, System

    one = tmodels.BoundedActor(T=20, device="cpu")
    a = one.actor
    stacked = Actor(a.A, a.B, a.F, a.V, a.W, a.Q, a.R, T=20, device="cpu")
    with pytest.raises(ValueError, match="stationary"):
        System(stacked, one.dynamics, horizon=20).gains(method="steady")
    with pytest.raises(ValueError, match="sqrt|steady"):
        one.gains(method="bogus")


@pytest.mark.parametrize("method", ["scan", "fused"])
def test_log_likelihood_on_sqrt_gains_matches_jax(x64, method):
    """``log_likelihood(gains_method="sqrt")`` (the scan, and K3's plain
    version) against JAX's scan likelihood on JAX's sqrt gains."""
    import jax
    import jax.numpy as jnp
    from lqg_tpu import models as jmodels
    from lqg_tpu.ops import gaussian as jgaussian

    jm = jmodels.BoundedActor(T=60)
    x = np.asarray(jm.simulate(jax.random.PRNGKey(0), n=4))
    g, K = jm.gains(method="sqrt")
    joint = jgaussian.joint_system(jm.dynamics, jm.actor, g.L, K, jm.horizon)
    want = np.asarray(jgaussian.trial_log_likelihood(
        jgaussian.conditional_kernel(joint, 2), jnp.asarray(x)))
    tm = tmodels.BoundedActor(T=60, **F64)
    got = tm.log_likelihood(torch.tensor(x), method=method,
                            gains_method="sqrt")
    close(got.numpy(), want, rtol=1e-9)


def test_psd_solve_matches_jax(x64):
    from lqg_tpu.ops import linalg as jlinalg

    rng = np.random.default_rng(0)
    A = rng.normal(size=(4, 3, 3))
    M = A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(3)
    for b in (rng.normal(size=(4, 3, 2)), rng.normal(size=(4, 3))):
        for jitter in (0.0, 1e-3):
            close(psd_solve(torch.tensor(M), torch.tensor(b),
                            jitter=jitter).numpy(),
                  jlinalg.psd_solve(M, b, jitter=jitter), rtol=1e-10)
    # not positive-definite: NaN, as lqg_tpu gives
    bad = np.array([[1.0, 2.0], [2.0, 1.0]])
    got = psd_solve(torch.tensor(bad), torch.ones(2, dtype=torch.float64))
    want = np.asarray(jlinalg.psd_solve(bad, np.ones(2)))
    assert np.isnan(want).all() and torch.isnan(got).all()
