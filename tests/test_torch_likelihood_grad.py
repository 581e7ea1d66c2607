"""K4, the likelihood adjoint, behind ``conditioned_log_likelihood_fused``'s
``torch.autograd.Function``.

On the CPU the Function runs the plain versions of K3 (with stores) and
K4: held against ``jax.grad`` of the JAX package's fused likelihood (its
adjoint kernel in interpret mode, float32) and against autograd through the
plain K3 (float64); the per-set plain K4 against the per-lane one it
replaced (float64).  On a card (``-m cuda``): K3's stores and K4 against
their plain versions, with one trial, with more trials than a block has
trial threads and at every other instance, and two K4 launches bit for
bit.  JAX is imported inside the tests that use it, so
that the card's tests collect where JAX is not installed.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as nnf

from lqg_tpu_torch.models import (BoundedActor, HandMotionModelTrackingTask,
                                  PointMassBoundedActor, SubjectiveActor)
from lqg_tpu_torch.ops.kernels import likelihood as kl
from lqg_tpu_torch.ops.kernels.gains import _sym, _sym_inv_det
from lqg_tpu_torch.ops.linalg import mT

# as tests/test_pallas.py holds the Pallas adjoint on the CPU: F and Q
# (symmetric gauge) at :206-210, the data at :228-229
FQ_TOL = dict(rtol=1e-2, atol=1e-3)
X_TOL = dict(rtol=1e-2, atol=1e-4)


def _sym(M):
    return 0.5 * (M + np.swapaxes(M, -1, -2))


def _inputs(P, n, T, seed=0):
    """F, Q of P bounded actors (from JAX, float64) and n random-walk
    trials each, with a cotangent ``w (P, n)``."""
    import jax.numpy as jnp
    from lqg_tpu import models as jmodels

    Fs, Qs = [], []
    for k in range(P):
        m = jmodels.BoundedActor(T=T, sigma_target=3.0 + 2 * k,
                                 action_cost=0.5 + 0.3 * k)
        joint = m._joint()
        Fs.append(np.asarray(joint.F, np.float64))
        Qs.append(np.asarray(joint.G @ jnp.swapaxes(joint.G, -1, -2),
                             np.float64))
    rng = np.random.default_rng(seed)
    X = np.cumsum(rng.normal(size=(P, n, T + 1, 2)), axis=2)
    return np.stack(Fs), np.stack(Qs), X, rng.normal(size=(P, n))


# the model of each instantiated (j, d): its joint dim j, d observed dims
MODELS = {
    (4, 2): BoundedActor,
    (5, 2): SubjectiveActor,
    (8, 2): PointMassBoundedActor,  # target and cursor positions
    (8, 4): lambda **kw: BoundedActor(dim=2, **kw),
    (10, 2): HandMotionModelTrackingTask,
    (10, 4): lambda **kw: SubjectiveActor(dim=2, **kw),
}
ZOO = [(8, 2), (8, 4), (10, 2), (10, 4)]  # the model zoo's instances


def _port_case(j, P, n, T, seed=0, device="cpu", dtype=torch.float64, d=2):
    """F, Q of P port models of joint dim j and d observed dims
    (:data:`MODELS`) with spread parameters, n random-walk trials each and
    a cotangent ``w (P, n)``, drawn with numpy."""
    Fs, Qs = [], []
    for k in range(P):
        joint = MODELS[(j, d)](T=T, sigma_target=3.0 + 2.0 * k,
                               action_cost=0.5 + 0.3 * k, device=device,
                               dtype=dtype)._joint()
        Fs.append(joint.F)
        Qs.append(joint.G @ mT(joint.G))
    rng = np.random.default_rng(seed)
    X = np.cumsum(rng.normal(size=(P, n, T + 1, d)), axis=2)
    as_t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return torch.stack(Fs), torch.stack(Qs), as_t(X), as_t(rng.normal(
        size=(P, n)))


def _per_lane_vjp(F, X, w, Sig_st, mu_st):
    """K4 before the split: every (set, trial) lane runs the reverse
    recursion from its own carries ``Sigma_t (P, n, T+1, j, j)``, ``mu_t
    (P, n, T+1, j)``; the per-lane cotangents of F and Q summed over
    trials."""
    P_, T, j, _ = F.shape
    d = X.shape[-1]
    w = w[..., None, None]
    vec = lambda v: v[..., None]

    def score(Sigma, mu, x):
        Sinv, _ = _sym_inv_det(Sigma[..., :d, :d])
        return Sinv, x - mu[..., :d]

    Sinv, e = score(Sig_st[:, :, T], mu_st[:, :, T], X[:, :, T])
    Se = Sinv @ vec(e)
    mbar = nnf.pad(w * Se, (0, 0, 0, j - d))
    Sbar = nnf.pad(0.5 * w * (Se @ mT(Se) - Sinv), (0, j - d, 0, j - d))
    Fbars, Qbars, Xbars = [], [], [(-w * Se)[..., 0]]
    for t in range(T - 1, -1, -1):
        Sigma, mu = Sig_st[:, :, t], vec(mu_st[:, :, t])
        F_t = F[:, None, t]
        Sinv, e = score(Sigma, mu[..., 0], X[:, :, t])
        e = vec(e)
        FS = F_t @ Sigma
        Pm = FS[..., :d]
        J = Pm @ Sinv
        Sbn = _sym(Sbar)
        FSbar = Sbn @ F_t
        Fbar = Sbn @ FS + mbar @ mT(mu)
        Jbar = -(Sbn @ Pm) + mbar @ mT(e)
        Pbar = -(Sbn @ J) + Jbar @ Sinv
        Sinvbar = mT(Pm) @ Jbar
        ebar = mT(J) @ mbar
        mask = 1.0 if t >= 1 else 0.0
        ebar = ebar - (Sinv @ e) * (mask * w)
        Sinvbar = Sinvbar - (e @ mT(e)) * (mask * 0.5 * w)
        Sb = -(Sinv @ (Sinvbar @ Sinv)) - Sinv * (mask * 0.5 * w)
        mubar = mT(F_t) @ mbar
        mubar = torch.cat([mubar[..., :d, :] - ebar, mubar[..., d:, :]], -2)
        xbar = ebar + mubar[..., :d, :] if t == 0 else ebar
        Xbars.append(xbar[..., 0])
        FSbar = FSbar + nnf.pad(Pbar, (0, j - d))
        Fbar = Fbar + FSbar @ Sigma
        Sbar = mT(F_t) @ FSbar + nnf.pad(_sym(Sb), (0, j - d, 0, j - d))
        Qbar = Sbn + _sym(Sbar) if t == 0 else Sbn
        Fbars.append(Fbar)
        Qbars.append(Qbar)
        mbar = mubar
    return (torch.stack(Fbars[::-1], 2).sum(1),
            torch.stack(Qbars[::-1], 2).sum(1), torch.stack(Xbars[::-1], 2))


@pytest.mark.parametrize("n", [1, 3, 37])
@pytest.mark.parametrize("j", [4, 5])
def test_per_set_adjoint_matches_per_lane(j, n):
    """The Sigma-bar chain once per set from the trial sums gives the sum
    over trials of the per-lane chains."""
    F, Q, X, w = _port_case(j, P=2, n=n, T=17, seed=2)
    _, Sig, mu = kl.conditioned_log_likelihood_reference(F, Q, X, stores=True)
    got = kl.conditioned_log_likelihood_vjp_reference(F, X, w, Sig, mu)
    want = _per_lane_vjp(F, X, w, Sig[:, None].expand(2, n, *Sig.shape[1:]),
                         mu.permute(0, 3, 1, 2))
    for name, a, b in zip("FQX", got, want):
        assert a.shape == b.shape, name
        if name == "Q":
            a, b = _sym(a), _sym(b)
        torch.testing.assert_close(a, b, rtol=1e-10,
                                   atol=1e-10 * float(b.abs().max()), msg=name)


@pytest.mark.parametrize("n", [1, 37])
@pytest.mark.parametrize("jd", ZOO)
def test_per_set_adjoint_matches_per_lane_zoo(jd, n):
    """The model zoo's instances: PointMass (8, 2), BoundedActor(dim=2) (8,
    4), Hand (10, 2), SubjectiveActor(dim=2) (10, 4)."""
    (j, d), P = jd, 2
    F, Q, X, w = _port_case(j, P=P, n=n, T=17, seed=2, d=d)
    _, Sig, mu = kl.conditioned_log_likelihood_reference(F, Q, X, stores=True)
    got = kl.conditioned_log_likelihood_vjp_reference(F, X, w, Sig, mu)
    want = _per_lane_vjp(F, X, w, Sig[:, None].expand(P, n, *Sig.shape[1:]),
                         mu.permute(0, 3, 1, 2))
    for name, a, b in zip("FQX", got, want):
        assert a.shape == b.shape, name
        if name == "Q":
            a, b = _sym(a), _sym(b)
        torch.testing.assert_close(a, b, rtol=1e-10,
                                   atol=1e-10 * float(b.abs().max()), msg=name)


def test_trial_sum_order():
    """The plain trial sum folds each warp's lanes by halving, then the
    groups and the warps in turn, padding with zeros."""
    v = torch.arange(300, dtype=torch.float64).reshape(1, 300) ** 1.5
    nt = kl.trial_threads(300)
    assert nt == 128
    torch.testing.assert_close(kl._trial_sum(v, nt), v.sum(1), rtol=1e-14,
                               atol=0)
    lanes = torch.zeros(1, 32, dtype=torch.float64)
    lanes[0, 0], lanes[0, 1], lanes[0, 17] = 1.0, 2.0 ** 60, -(2.0 ** 60)
    # the tree adds x_1 + x_17 before x_0 meets them: x_0 survives; a sum
    # in index order loses it
    in_order = 0.0
    for x in lanes[0].tolist():
        in_order += x
    assert float(kl._trial_sum(lanes, 32)) == 1.0 and in_order == 0.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("T", [13])  # a prime horizon
def test_plain_adjoint_matches_pallas(T):
    import jax
    import jax.numpy as jnp
    from lqg_tpu.ops.pallas.likelihood import (
        conditioned_log_likelihood_fused as jll_fused)

    F, Q, X, w = (a.astype(np.float32) for a in _inputs(2, 3, T))
    jgrads = jax.grad(lambda *a: jnp.sum(jll_fused(*a) * w),
                      argnums=(0, 1, 2))(*map(jnp.asarray, (F, Q, X)))
    leaves = [torch.tensor(a, requires_grad=True) for a in (F, Q, X)]
    ll = kl.conditioned_log_likelihood_fused(*leaves)
    grads = torch.autograd.grad(ll, leaves, torch.tensor(w))
    for name, g, j, tol in zip("FQX", grads, jgrads,
                               (FQ_TOL, FQ_TOL, X_TOL)):
        g, j = g.numpy(), np.asarray(j)
        if name == "Q":
            g, j = _sym(g), _sym(j)
        np.testing.assert_allclose(g, j, err_msg=name, **tol)
    assert np.abs(grads[2].numpy()).max() > 0


@pytest.mark.parametrize("T", [12, 13])
def test_plain_adjoint_matches_autograd(T):
    F, Q, X, w = (torch.tensor(a) for a in _inputs(2, 3, T, seed=1))
    leaves = [a.clone().requires_grad_() for a in (F, Q, X)]
    got = torch.autograd.grad(kl.conditioned_log_likelihood_fused(*leaves),
                              leaves, w)
    want = torch.autograd.grad(
        kl.conditioned_log_likelihood_reference(*leaves), leaves, w)
    for name, a, b in zip("FQX", got, want):
        if name == "Q":
            a, b = 0.5 * (a + mT(a)), 0.5 * (b + mT(b))
        torch.testing.assert_close(a, b, rtol=1e-9,
                                   atol=1e-9 * float(b.abs().max()), msg=name)


def test_function_on_cpu_launches_nothing():
    F, Q, X, _ = (torch.tensor(a, dtype=torch.float32)
                  for a in _inputs(2, 3, 9))
    leaves = [a.requires_grad_() for a in (F, Q, X)]
    before = (kl.conditioned_log_likelihood_fused.launches,
              kl.conditioned_log_likelihood_vjp.launches)
    kl.conditioned_log_likelihood_fused(*leaves).sum().backward()
    assert all(torch.isfinite(a.grad).all() for a in leaves)
    assert before == (kl.conditioned_log_likelihood_fused.launches,
                      kl.conditioned_log_likelihood_vjp.launches)
    ll, Sig, mu = kl.ll_fwd(F.detach(), Q.detach(), X.detach(), stores=True)
    assert Sig.shape == (2, 10, 4, 4) and mu.shape == (2, 10, 4, 3)
    torch.testing.assert_close(Sig[:, 0], Q.detach()[:, 0], rtol=0,
                               atol=0)  # Sigma_0 = Q_0
    torch.testing.assert_close(mu[:, 0, :2], mT(X.detach()[:, :, 0]),
                               rtol=0, atol=0)  # mu_0 = [x_0; 0]


@pytest.mark.cuda
def test_adjoint_kernel_matches_reference_on_card(cuda):
    P, n, T = 6, 20, 1008
    g = torch.Generator(device=cuda).manual_seed(0)
    Fs, Qs, Xs = [], [], []
    for k in range(P):
        m = BoundedActor(T=T, sigma_target=3.0 + 5 * k, device=cuda)
        joint = m._joint()
        Fs.append(joint.F)
        Qs.append(joint.G @ mT(joint.G))
        Xs.append(m.simulate(g, n=n))
    F, Q, X = torch.stack(Fs), torch.stack(Qs), torch.stack(Xs)
    out = kl.ll_fwd(F, Q, X, stores=True)
    ref = kl.conditioned_log_likelihood_reference(F, Q, X, stores=True)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-3)
    w = torch.randn((P, n), generator=g, device=cuda)
    got = kl.conditioned_log_likelihood_vjp(F, X, w, *out[1:])
    want = kl.conditioned_log_likelihood_vjp_reference(F, X, w, *out[1:])
    torch.cuda.synchronize()
    for a, b, tol in zip(got, want, (FQ_TOL, FQ_TOL, X_TOL)):
        torch.testing.assert_close(a, b, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("j, n", [(4, 1), (4, 300), (5, 20)])
def test_adjoint_kernel_variants_on_card(cuda, j, n):
    """One trial; three trials a thread; the (5, 2) instance.  K4 against
    its plain version, and a second launch equal bit for bit (the trial
    sums take a fixed order, no atomics)."""
    F, Q, X, w = _port_case(j, P=3, n=n, T=300, seed=3, device=cuda,
                            dtype=torch.float32)
    _, *st = kl.ll_fwd(F, Q, X, stores=True)
    got = kl.conditioned_log_likelihood_vjp(F, X, w, *st)
    again = kl.conditioned_log_likelihood_vjp(F, X, w, *st)
    want = kl.conditioned_log_likelihood_vjp_reference(F, X, w, *st)
    torch.cuda.synchronize()
    for a, b, c, tol in zip(got, again, want, (FQ_TOL, FQ_TOL, X_TOL)):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=tol["rtol"],
                                   atol=tol["atol"] + 1e-5 * float(
                                       c.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("jd", ZOO)
def test_adjoint_kernel_zoo_instances_on_card(cuda, jd):
    """The zoo's instances at the fit's shape, 24 sets x 20 trials at T=1008
    (K4's step sums: up to 157 values, five rounds of a warp), and at 3 sets
    x 300 trials: K4 against its plain version, two launches bit for
    bit."""
    j, d = jd
    for P, n, T in ((24, 20, 1008), (3, 300, 120)):
        F, Q, X, w = _port_case(j, P=P, n=n, T=T, seed=3, d=d, device=cuda,
                                dtype=torch.float32)
        _, *st = kl.ll_fwd(F, Q, X, stores=True)
        got = kl.conditioned_log_likelihood_vjp(F, X, w, *st)
        again = kl.conditioned_log_likelihood_vjp(F, X, w, *st)
        want = kl.conditioned_log_likelihood_vjp_reference(F, X, w, *st)
        torch.cuda.synchronize()
        for a, b, c, tol in zip(got, again, want, (FQ_TOL, FQ_TOL, X_TOL)):
            assert torch.equal(a, b)
            torch.testing.assert_close(a, c, rtol=tol["rtol"],
                                       atol=tol["atol"] + 1e-5 * float(
                                           c.abs().max()))
