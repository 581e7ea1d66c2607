"""The port's associative scans (``lqg_tpu_torch.parallel.pscan``),
``System.log_likelihood(method="pscan")`` and the twins of the fused gains'
backward (``GAINS_VJP_METHOD``): against a sequential fold, against
``lqg_tpu.parallel.pscan`` and against the port's scans, in float64 on the
CPU.  JAX is imported inside the tests only."""

import numpy as np
import pytest
import torch

from lqg_tpu_torch import models as tmodels
from lqg_tpu_torch.ops import kalman, riccati
from lqg_tpu_torch.ops.kernels import gains as kg
from lqg_tpu_torch.parallel import pscan
from lqg_tpu_torch.utils import stationary_spec

F64 = dict(device="cpu", dtype=torch.float64)
PARAMS = dict(action_cost=0.6, sigma_cursor=2.0)


def _spec_arrays(seed, n=3, m=2, p=3):
    """``tests/test_parallel.py``'s random stationary spec, as arrays."""
    rng = np.random.default_rng(seed)
    Qh = rng.standard_normal((n, n)) * 0.3
    return dict(A=np.eye(n) + 0.05 * rng.standard_normal((n, n)),
                B=0.1 * rng.standard_normal((n, m)), F=np.eye(p, n),
                V=np.diag(0.5 + rng.random(n)), W=np.diag(0.5 + rng.random(p)),
                Q=Qh @ Qh.T + 0.1 * np.eye(n), R=np.diag(0.2 + rng.random(m)))


def _specs(case):
    """The same actor spec for ``lqg_tpu`` and for the port."""
    import jax.numpy as jnp
    from lqg_tpu import models as jmodels
    from lqg_tpu.utils import stationary_spec as jax_stationary_spec

    if case == "random":
        arrays = _spec_arrays(1)
        return (jax_stationary_spec(**{k: jnp.asarray(v)
                                       for k, v in arrays.items()}),
                stationary_spec(**{k: torch.tensor(v)
                                   for k, v in arrays.items()}))
    return (getattr(jmodels, case)(T=50).actor,
            getattr(tmodels, case)(T=50, **F64).actor)


def _jax_pscan(model, x):
    """``lqg_tpu``'s ``log_likelihood(x, method="pscan")``, compiled (op by
    op, JAX compiles each of the scan's shapes on its own)."""
    import jax

    return np.asarray(jax.jit(
        lambda x_: model.log_likelihood(x_, method="pscan"))(x))


def _trials(model, n, seed, d=None):
    """``n`` trials of the port's ``model`` from a seed, as an array."""
    x = model.simulate(torch.Generator().manual_seed(seed), n=n).numpy()
    return x if d is None else x[..., :d]


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("length", list(range(1, 10)) + [16, 33])
def test_associative_scan_matches_a_sequential_fold(length, reverse, x64):
    """2x2 matrix products, which do not commute: entry k is e_0 e_1 ...
    e_k (reverse: e_k ... e_last, the later element first, as
    ``fn(later, earlier)``), and JAX's scan to rounding."""
    import jax.numpy as jnp
    from jax import lax

    M = np.random.default_rng(length).standard_normal((length, 2, 2))
    got = pscan.associative_scan(torch.matmul, torch.tensor(M),
                                 reverse=reverse).numpy()
    want, acc = [], None
    for k in (range(length - 1, -1, -1) if reverse else range(length)):
        acc = M[k] if acc is None else acc @ M[k]
        want.append(acc)
    want = np.stack(want[::-1] if reverse else want)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    jax_scan = np.asarray(lax.associative_scan(jnp.matmul, jnp.asarray(M),
                                               reverse=reverse))
    np.testing.assert_allclose(got, jax_scan, rtol=1e-14, atol=1e-14)
    # a NamedTuple of tensors goes through leaf by leaf
    pair = pscan.AffineElement(M=torch.tensor(M), c=torch.tensor(M))
    out = pscan.associative_scan(
        lambda a, b: pscan.AffineElement(a.M @ b.M, a.c @ b.c), pair,
        reverse=reverse)
    assert torch.equal(out.M, out.c) and np.array_equal(out.M.numpy(), got)


@pytest.mark.parametrize("T", [1, 2, 7, 50])
@pytest.mark.parametrize("case", ["random", "BoundedActor", "SubjectiveActor"])
def test_gains_assoc_match_jax_and_the_scans(case, T, x64):
    import jax
    from lqg_tpu.parallel import pscan as jax_pscan

    jspec, tspec = _specs(case)
    S0 = tspec.V @ tspec.V.mT
    K = pscan.kalman_forward_assoc(tspec, S0, horizon=T)
    K_jax, g_jax = jax.jit(lambda s: (
        jax_pscan.kalman_forward_assoc(s, s.V @ s.V.T, horizon=T),
        jax_pscan.lqr_backward_assoc(s, horizon=T)))(jspec)
    np.testing.assert_allclose(K.numpy(), np.asarray(K_jax), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(
        K.numpy(), kalman.forward(tspec, S0, horizon=T).numpy(), rtol=1e-7,
        atol=1e-9)

    g = pscan.lqr_backward_assoc(tspec, horizon=T)
    g_scan = riccati.backward(tspec, horizon=T, regularize="none")
    for got, jax_, scan in ((g.L, g_jax.L, g_scan.L), (g.H, g_jax.H,
                                                        g_scan.H)):
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(got.numpy(), scan.numpy(), rtol=1e-6,
                                   atol=1e-8)
    assert torch.equal(g.l, torch.zeros_like(g.l))


@pytest.mark.parametrize("columns", [None, 3], ids=["vector", "matrix"])
def test_affine_scan_matches_jax(columns, x64):
    import jax
    import jax.numpy as jnp
    from lqg_tpu.parallel import pscan as jax_pscan

    rng = np.random.default_rng(2)
    T, n = 33, 4
    M = np.eye(n) * 0.9 + 0.01 * rng.standard_normal((T, n, n))
    tail = (n,) if columns is None else (n, columns)
    c = 0.1 * rng.standard_normal((T,) + tail)
    x0 = rng.standard_normal(tail)
    got = pscan.affine_scan(torch.tensor(M), torch.tensor(c),
                            torch.tensor(x0)).numpy()
    want = jax.jit(jax_pscan.affine_scan)(jnp.asarray(M), jnp.asarray(c),
                                          jnp.asarray(x0))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12,
                               atol=1e-14)
    x, seq = x0, []
    for t in range(T):
        x = M[t] @ x + c[t]
        seq.append(x)
    np.testing.assert_allclose(got, np.stack(seq), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("T,n,d", [(1, 3, 2), (2, 3, 2), (7, 5, 2),
                                   (64, 4, 2)])
def test_pscan_log_likelihood_matches_jax_and_the_scan(T, n, d, x64):
    from lqg_tpu import models as jmodels

    jm = jmodels.BoundedActor(T=T, **PARAMS)
    tm = tmodels.BoundedActor(T=T, **PARAMS, **F64)
    x = _trials(tm, n, 4, d)
    got = tm.log_likelihood(torch.tensor(x), method="pscan")
    assert got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), _jax_pscan(jm, x), rtol=1e-8)
    np.testing.assert_allclose(
        got.numpy(), tm.log_likelihood(torch.tensor(x),
                                       method="scan").numpy(), rtol=1e-8)


@pytest.mark.parametrize("delay", [None, 4], ids=["subjective", "delay4"])
def test_pscan_log_likelihood_subjective_and_delay(delay, x64):
    """Mismatched-actor and delay-augmented models (non-square joint
    blocks, singular delay dynamics) at T=60."""
    from lqg_tpu import models as jmodels

    def build(models, **kw):
        m = models.SubjectiveActor(T=60, **kw)
        return m if delay is None else models.TemporalDelayModel(m,
                                                                 delay=delay)

    jm, tm = build(jmodels), build(tmodels, **F64)
    x = _trials(tm, 3, 5)
    got = tm.log_likelihood(torch.tensor(x), method="pscan").numpy()
    np.testing.assert_allclose(got, _jax_pscan(jm, x), rtol=1e-7)
    np.testing.assert_allclose(
        got, tm.log_likelihood(torch.tensor(x), method="scan").numpy(),
        rtol=1e-7)


def test_pscan_gradient_matches_jax(x64):
    """The gradient in ``action_cost`` at T=40 against ``jax.grad`` of
    ``lqg_tpu``'s pscan, through autograd."""
    import jax
    import jax.numpy as jnp
    from lqg_tpu import models as jmodels

    x = _trials(tmodels.BoundedActor(T=40, **F64), 4, 6)

    def jax_ll(c):
        return jnp.sum(jmodels.BoundedActor(T=40, action_cost=c)
                       .log_likelihood(jnp.asarray(x), method="pscan"))

    want = jax.jit(jax.grad(jax_ll))(jnp.asarray(0.5))
    c = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    ll = tmodels.BoundedActor(T=40, action_cost=c, **F64).log_likelihood(
        torch.tensor(x), method="pscan").sum()
    got = torch.autograd.grad(ll, c)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_pscan_log_likelihood_of_parameter_sets():
    """A System of P=3 sets scores ``x (P, n, T+1, d)`` as ``(P, n)``, each
    row the set's own likelihood; trajectories shared by the sets
    broadcast."""
    costs = [0.3, 0.6, 1.2]
    g = torch.Generator().manual_seed(0)
    x = torch.stack([tmodels.BoundedActor(T=30, action_cost=c, **F64)
                     .simulate(g, n=4) for c in costs])
    sets = tmodels.BoundedActor(T=30, action_cost=torch.tensor(costs), **F64)
    got = sets.log_likelihood(x, method="pscan")
    assert got.shape == (3, 4)
    for k, c in enumerate(costs):
        one = tmodels.BoundedActor(T=30, action_cost=c, **F64)
        np.testing.assert_allclose(
            got[k].numpy(), one.log_likelihood(x[k], method="pscan").numpy(),
            rtol=1e-8)
    shared = sets.log_likelihood(x[0], method="pscan")
    np.testing.assert_allclose(shared[0].numpy(), got[0].numpy(), rtol=1e-12)


def test_pscan_is_nan_where_jax_is(x64):
    """A negative action cost: the control Hessian is not positive-definite
    and the likelihood NaN in both packages, with nothing raised."""
    from lqg_tpu import models as jmodels

    x = _trials(tmodels.BoundedActor(T=30, **F64), 3, 0)
    want = _jax_pscan(jmodels.BoundedActor(T=30, action_cost=-1.0), x)
    got = tmodels.BoundedActor(T=30, action_cost=-1.0, **F64).log_likelihood(
        torch.tensor(x), method="pscan").numpy()
    assert np.isnan(want).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


@pytest.mark.parametrize("method", ["scan", "assoc"])
def test_gains_vjp_twins_match_the_kernel(monkeypatch, method):
    """The fused gains' backward through autograd of the scan twin or the
    associative twin against K2 (its plain version on the CPU): the
    likelihood's gradient in the parameters of 2 sets, and the raw
    cotangents of K1's inputs on a random cotangent (the symmetric inputs
    compared in the symmetric gauge), rtol 1e-8."""
    x = tmodels.BoundedActor(T=40, **F64).simulate(
        torch.Generator().manual_seed(0), n=4)
    spec, ins = _random_gains_inputs()
    cot = [torch.randn(o.shape, generator=torch.Generator().manual_seed(k),
                       dtype=torch.float64)
           for k, o in enumerate(kg.fused_gains(spec, ins[-1], 40))]

    def grads():
        c = torch.tensor([0.5, 0.9], dtype=torch.float64, requires_grad=True)
        m = tmodels.BoundedActor(T=40, action_cost=c, **F64)
        ll = m.log_likelihood(x.expand(2, *x.shape), method="scan",
                              gains_method="fused").sum()
        leaves = [t.detach().requires_grad_() for t in ins]
        sp = spec._replace(A=leaves[0], B=leaves[1], Q=leaves[2],
                           R=leaves[3], Qf=leaves[4], F=leaves[5],
                           V=leaves[6], W=leaves[7], zero_affine=True)
        out = kg.fused_gains(sp, leaves[8], 40)
        raw = torch.autograd.grad(out, leaves, cot)
        return torch.autograd.grad(ll, c)[0], raw

    want, want_raw = grads()
    monkeypatch.setattr(kg, "GAINS_VJP_METHOD", method)
    got, got_raw = grads()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-8)
    for k, (a, b) in enumerate(zip(got_raw, want_raw)):
        if k in (2, 3, 4, 8):  # Q, R, Qf, Sigma0: the symmetric gauge
            a, b = 0.5 * (a + a.mT), 0.5 * (b + b.mT)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-8,
                                   atol=1e-10 * float(b.abs().max()))
    monkeypatch.setattr(kg, "GAINS_VJP_METHOD", "bogus")
    with pytest.raises(ValueError, match="GAINS_VJP_METHOD"):
        grads()


def _random_gains_inputs():
    """A batch of 3 random (2, 1, 2) specs near the bounded actor's, as a
    spec and K1's nine inputs."""
    rng = np.random.default_rng(3)
    arrays = _spec_arrays(3, n=2, m=1, p=2)
    batch = {k: torch.tensor(np.stack([
        v + (0.02 * rng.standard_normal(v.shape) if k in "AB" else 0.0)
        for _ in range(3)])) for k, v in arrays.items()}
    spec = stationary_spec(**batch)
    S0 = spec.V @ spec.V.mT
    return spec, [spec.A, spec.B, spec.Q, spec.R, spec.Qf, spec.F, spec.V,
                  spec.W, S0]
