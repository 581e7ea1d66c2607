"""K3, the fused likelihood kernel of the port.

On the CPU: the plain PyTorch version against the JAX package's Pallas
kernel in interpret mode (float32) and against the per-lane formulation
(every trial running the covariance recursion itself, float64), and the
wrapper's checks.  On a card (``-m cuda``): the CUDA kernel against the
plain version, with one trial, with more trials than a block has trial
threads, and at every other instance.  JAX is imported
inside the tests that use it, so that the card's tests collect where JAX
is not installed.
"""

import numpy as np
import pytest
import torch

import torch.nn.functional as nnf

from lqg_tpu_torch.models import (BoundedActor, HandMotionModelTrackingTask,
                                  PointMassBoundedActor, SubjectiveActor)
from lqg_tpu_torch.ops.kernels.gains import _sym, _sym_inv_det
from lqg_tpu_torch.ops.kernels.likelihood import (
    _LOG_2PI, _neumaier_add, conditioned_log_likelihood_fused,
    conditioned_log_likelihood_reference, fused_ll_available, ll_fwd,
    trial_threads)
from lqg_tpu_torch.ops import gaussian
from lqg_tpu_torch.ops.linalg import mT

RTOL, ATOL = 2e-4, 2e-3  # as tests/test_pallas.py holds the Pallas kernel
# the stores at the zoo's instances: each entry also STORE_SCALE x the
# largest |plain| of its row, one state over every set, step and column
# (the point mass's hidden-state means reach ~1e4 on random walks and keep
# float32 rounding of that scale; chip_smoke.py's K3_STORE_SCALE)
STORE_SCALE = 1e-3


def _inputs(P, n, T, seed=0):
    """F, Q of P bounded actors (from JAX, float32) and n random-walk
    trials each."""
    import jax.numpy as jnp
    from lqg_tpu import models as jmodels

    Fs, Qs = [], []
    for k in range(P):
        m = jmodels.BoundedActor(T=T, sigma_target=3.0 + 2 * k,
                                 action_cost=0.5 + 0.3 * k)
        joint = m._joint()
        Fs.append(np.asarray(joint.F))
        Qs.append(np.asarray(joint.G @ jnp.swapaxes(joint.G, -1, -2)))
    X = np.cumsum(np.random.default_rng(seed).normal(size=(P, n, T + 1, 2)),
                  axis=2).astype(np.float32)
    return np.stack(Fs), np.stack(Qs), X


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


def _delayed(name, delay):
    from lqg_tpu_torch import models

    def make(sigma_target, **kw):
        noise = ({"sigma": sigma_target} if name.startswith("Relative")
                 else {"sigma_target": sigma_target})
        return models.TemporalDelayModel(getattr(models, name)(**noise, **kw),
                                         delay=delay)
    return make


def _relative(dim):
    from lqg_tpu_torch.models import RelativeObservationBoundedActor

    return lambda sigma_target, **kw: RelativeObservationBoundedActor(
        dim=dim, sigma=sigma_target, **kw)


# the instances at j = 12: the delay-2 bounded actor (12, 2), the delay-2
# relative-observation actor scored on one dim (12, 1),
# RelativeObservationBoundedActor(dim=3) (12, 3), BoundedActor(dim=3) on
# four dims (12, 4); and two shapes padded onto them (a random stable
# joint system, :func:`_stable_case`)
MODELS.update({(12, 2): _delayed("BoundedActor", 2),
               (12, 1): _delayed("RelativeObservationBoundedActor", 2),
               (12, 3): _relative(3),
               (12, 4): lambda **kw: BoundedActor(dim=3, **kw)})
SCOPE = [(12, 1), (12, 2), (12, 3), (12, 4), (6, 3), (3, 1)]


def _port_case(j, P, n, T, seed=0, device="cpu", dtype=torch.float64, d=2):
    """F, Q of P port models of joint dim j and d observed dims
    (:data:`MODELS`) with spread parameters, and n random-walk trials
    each, drawn with numpy."""
    Fs, Qs = [], []
    for k in range(P):
        joint = MODELS[(j, d)](T=T, sigma_target=3.0 + 2.0 * k,
                               action_cost=0.5 + 0.3 * k, device=device,
                               dtype=dtype)._joint()
        Fs.append(joint.F)
        Qs.append(joint.G @ mT(joint.G))
    X = np.cumsum(np.random.default_rng(seed).normal(size=(P, n, T + 1, d)),
                  axis=2)
    return (torch.stack(Fs), torch.stack(Qs),
            torch.tensor(X, dtype=dtype, device=device))


def _stable_case(j, P, n, T, d, device="cpu", dtype=torch.float32, seed=0):
    """A random joint system with a stable transition (orthogonal x 0.97)
    and n random-walk trials each, drawn with numpy."""
    rng = np.random.default_rng(seed + j + 10 * d)
    A = np.stack([np.linalg.qr(rng.normal(size=(j, j)))[0] * 0.97
                  for _ in range(P)])
    G = 0.3 * rng.normal(size=(P, j, j)) + 0.5 * np.eye(j)
    X = 0.3 * np.cumsum(rng.normal(size=(P, n, T + 1, d)), axis=2)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    F = t(A)[:, None].expand(P, T, j, j).contiguous()
    Q = (t(G) @ mT(t(G)))[:, None].expand(P, T, j, j).contiguous()
    return F, Q, t(X)


def _per_lane_reference(F, Q, X):
    """K3 before the split: every (set, trial) lane runs the covariance
    recursion itself.  Returns ``ll (P, n)`` and the per-lane carries
    ``Sigma_t (P, n, T+1, j, j)`` and ``mu_t (P, n, T+1, j)``."""
    P_, T, j, _ = F.shape
    n, d = X.shape[1], X.shape[-1]
    Fl, Ql = F[:, None], Q[:, None]
    Sigma = Ql[:, :, 0].expand(P_, n, j, j)
    mu = nnf.pad(X[:, :, 0], (0, j - d))
    quad_acc = ld_acc = quad_c = ld_c = X.new_zeros((P_, n))

    def score(Sigma, mu, x):
        Sinv, det = _sym_inv_det(Sigma[..., :d, :d])
        e = x - mu[..., :d]
        Se = (Sinv @ e[..., None])[..., 0]
        quad = e[..., 0] * Se[..., 0]
        for r in range(1, d):
            quad = quad + e[..., r] * Se[..., r]
        return quad, det, Sinv, e

    Sigmas, mus = [], []
    for t in range(T):
        Sigmas.append(Sigma)
        mus.append(mu)
        quad, det, Sinv, e = score(Sigma, mu, X[:, :, t])
        mask = 1.0 if t >= 1 else 0.0
        quad_acc, quad_c = _neumaier_add(quad_acc, quad_c, mask * quad)
        ld_acc, ld_c = _neumaier_add(ld_acc, ld_c, mask * torch.log(det))
        F_t, Q_t = Fl[:, :, t], Ql[:, :, t]
        FS = F_t @ Sigma
        Pm = FS[..., :d]
        J = Pm @ Sinv
        mu = (F_t @ mu[..., None])[..., 0] + (J @ e[..., None])[..., 0]
        Sigma = _sym((FS @ mT(F_t) + Q_t) - J @ mT(Pm))
    Sigmas.append(Sigma)
    mus.append(mu)
    quad, det, _, _ = score(Sigma, mu, X[:, :, T])
    total = (quad_c + ld_c + quad + torch.log(det)) + quad_acc + ld_acc \
        + T * d * _LOG_2PI
    return -0.5 * total, torch.stack(Sigmas, 2), torch.stack(mus, 2)


@pytest.mark.parametrize("n", [1, 3, 37])
@pytest.mark.parametrize("j", [4, 5])
def test_reference_matches_per_lane(j, n):
    """The covariance recursion once per set gives the per-lane values."""
    F, Q, X = _port_case(j, P=2, n=n, T=17)
    ll, Sig, mu = conditioned_log_likelihood_reference(F, Q, X, stores=True)
    ll_l, Sig_l, mu_l = _per_lane_reference(F, Q, X)
    assert Sig.shape == (2, 18, j, j) and mu.shape == (2, 18, j, n)
    torch.testing.assert_close(ll, ll_l, rtol=1e-12, atol=0)
    for a, b in ((Sig[:, None].expand_as(Sig_l), Sig_l),
                 (mu.permute(0, 3, 1, 2), mu_l)):
        torch.testing.assert_close(a, b, rtol=1e-12,
                                   atol=1e-12 * float(b.abs().max()))


@pytest.mark.parametrize("n", [1, 37])
@pytest.mark.parametrize("jd", ZOO)
def test_reference_matches_per_lane_zoo(jd, n):
    """The model zoo's instances: PointMass (8, 2), BoundedActor(dim=2) (8,
    4), Hand (10, 2), SubjectiveActor(dim=2) (10, 4)."""
    (j, d), P, T = jd, 2, 17
    F, Q, X = _port_case(j, P=P, n=n, T=T, d=d)
    assert fused_ll_available(j, d, torch.float32)
    ll, Sig, mu = conditioned_log_likelihood_reference(F, Q, X, stores=True)
    ll_l, Sig_l, mu_l = _per_lane_reference(F, Q, X)
    assert Sig.shape == (P, T + 1, j, j) and mu.shape == (P, T + 1, j, n)
    torch.testing.assert_close(ll, ll_l, rtol=1e-12, atol=0)
    for a, b in ((Sig[:, None].expand_as(Sig_l), Sig_l),
                 (mu.permute(0, 3, 1, 2), mu_l)):
        torch.testing.assert_close(a, b, rtol=1e-12,
                                   atol=1e-12 * float(b.abs().max()))


def test_trial_threads():
    assert [trial_threads(n) for n in (1, 20, 32, 33, 128, 129, 300)] == [
        32, 32, 32, 64, 128, 128, 128]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_reference_matches_pallas():
    import jax.numpy as jnp
    from lqg_tpu.ops.pallas.likelihood import (
        conditioned_log_likelihood_fused as jll_fused)

    F, Q, X = _inputs(P=3, n=4, T=40)
    ll_jax = np.asarray(jll_fused(jnp.asarray(F), jnp.asarray(Q),
                                  jnp.asarray(X)))
    ll = conditioned_log_likelihood_reference(
        torch.tensor(F), torch.tensor(Q), torch.tensor(X))
    assert ll.shape == (3, 4)
    np.testing.assert_allclose(ll.numpy(), ll_jax, rtol=RTOL, atol=ATOL)


def test_wrapper_on_cpu_is_the_reference():
    F, Q, X = (torch.tensor(a) for a in _inputs(P=2, n=3, T=12))
    before = conditioned_log_likelihood_fused.launches
    torch.testing.assert_close(conditioned_log_likelihood_fused(F, Q, X),
                               conditioned_log_likelihood_reference(F, Q, X),
                               rtol=0, atol=0)
    assert conditioned_log_likelihood_fused.launches == before
    assert fused_ll_available(4, 2, torch.float32)
    assert not fused_ll_available(4, 2, torch.float64)
    # lqg_tpu's scope, j <= 12 and d <= 4: (6, 2) has no instance and is
    # padded onto (8, 2)
    assert fused_ll_available(6, 2, torch.float32)
    assert not fused_ll_available(13, 2, torch.float32)
    assert not fused_ll_available(4, 5, torch.float32)


def test_wrapper_checks():
    F, Q, X = (torch.tensor(a) for a in _inputs(P=2, n=3, T=12))
    # a gradient goes through the Function, equal to the scan's
    m = BoundedActor(T=12, device="cpu", dtype=torch.float64)
    x = m.simulate(torch.Generator().manual_seed(0), n=3)
    joint = m._joint()
    Fj = joint.F.clone().requires_grad_()
    ll = conditioned_log_likelihood_fused(Fj[None], (joint.G @ mT(joint.G))[None],
                                          x[None])
    (g_fused,) = torch.autograd.grad(ll.sum(), Fj)
    kernel = gaussian.conditional_kernel(gaussian.JointSystem(Fj, joint.G), 2)
    (g_scan,) = torch.autograd.grad(
        gaussian.trial_log_likelihood(kernel, x).sum(), Fj)
    assert torch.isfinite(g_fused).all()
    torch.testing.assert_close(g_fused, g_scan, rtol=1e-7,
                               atol=1e-7 * float(g_scan.abs().max()))
    with pytest.raises(ValueError, match="does not match"):
        conditioned_log_likelihood_fused(F.detach(), Q, X[:, :, :-1])
    with pytest.raises(ValueError, match="scope"):  # d = 5 > 4
        conditioned_log_likelihood_fused(F.detach(), Q,
                                          torch.cat([X] * 3, -1)[..., :5])


@pytest.mark.cuda
def test_kernel_matches_reference_on_card(cuda):
    P, n, T = 6, 20, 1000
    g = torch.Generator(device=cuda).manual_seed(0)
    Fs, Qs, Xs = [], [], []
    for k in range(P):
        m = BoundedActor(T=T, sigma_target=3.0 + 5 * k, device=cuda)
        joint = m._joint()
        Fs.append(joint.F)
        Qs.append(joint.G @ mT(joint.G))
        Xs.append(m.simulate(g, n=n))
    F, Q, X = torch.stack(Fs), torch.stack(Qs), torch.stack(Xs)
    ll = conditioned_log_likelihood_fused(F, Q, X)
    ref = conditioned_log_likelihood_reference(F, Q, X)
    torch.cuda.synchronize()
    torch.testing.assert_close(ll, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("j, n", [(4, 1), (4, 300), (5, 20)])
def test_kernel_variants_match_reference_on_card(cuda, j, n):
    """One trial; more trials than a block's trial threads (each thread
    carries three); the (5, 2) instance.  Both variants of K3 and the
    per-set stores against the plain version."""
    F, Q, X = _port_case(j, P=3, n=n, T=300, device=cuda,
                         dtype=torch.float32)
    ll = ll_fwd(F, Q, X)
    got = ll_fwd(F, Q, X, stores=True)
    want = conditioned_log_likelihood_reference(F, Q, X, stores=True)
    torch.cuda.synchronize()
    assert got[1].shape == (3, 301, j, j) and got[2].shape == (3, 301, j, n)
    assert torch.equal(ll, got[0])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("jd", ZOO + SCOPE)
def test_kernel_zoo_instances_match_reference_on_card(cuda, jd):
    """The zoo's instances, the instances at j = 12 and two shapes padded
    onto them, at the fit's shape, 24 sets x 20 trials at T=1008 (j^2 > 32:
    the covariance warp takes several element rounds a step), and at 3 sets
    x 300 trials (three a thread): both variants of K3 and the stores
    against the plain version at the true shape."""
    j, d = jd
    for P, n, T in ((24, 20, 1008), (3, 300, 120)):
        case = _port_case if jd in MODELS else _stable_case
        F, Q, X = case(j, P=P, n=n, T=T, d=d, device=cuda,
                       dtype=torch.float32)
        ll = ll_fwd(F, Q, X)
        got = ll_fwd(F, Q, X, stores=True)
        want = conditioned_log_likelihood_reference(F, Q, X, stores=True)
        torch.cuda.synchronize()
        assert torch.equal(ll, got[0])
        torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=ATOL)
        for a, b in zip(got[1:], want[1:]):
            row = b.abs().amax(dim=(0, 1, 3), keepdim=True)
            err = (a - b).abs()
            assert bool((err <= ATOL + RTOL * b.abs()
                         + STORE_SCALE * row).all()), float(
                (err.amax(dim=(0, 1, 3), keepdim=True) / row).max())


def probe_ll_inputs(j=6, T=37, n=3):
    """F, Q ``(5, T, j, j)`` of the joint systems of the probe bounded
    actors of tests/test_torch_nonfinite.py and the default one (last),
    float32, (4, 2) padded by hand with zeros to j joint states: at j = 6, a
    shape that K3 and K4 pad once more, onto (8, 2); and X, n trials of the
    default actor for every set."""
    from test_torch_gains_kernel import PROBES

    Fs, Qs = [], []
    for p in PROBES:
        joint = BoundedActor(T=T, **p, device="cpu")._joint(
            gains_method="scan")
        Fs.append(joint.F)
        Qs.append(joint.G @ mT(joint.G))
    grow = lambda M: nnf.pad(M, (0, j - 4, 0, j - 4))
    x = BoundedActor(T=T, device="cpu").simulate(
        torch.Generator().manual_seed(0), n=n)
    return (grow(torch.stack(Fs)), grow(torch.stack(Qs)),
            x.expand((len(PROBES),) + x.shape).contiguous())


@pytest.mark.cuda
def test_probe_nans_stay_in_their_set_on_card(cuda):
    """The probe parameter sets at a padded shape, (6, 2) onto (8, 2): K3
    (with the stores) and K4 give NaN exactly where their plain versions
    give NaN on the same inputs (where lqg_tpu's kernels do,
    tests/test_torch_kernel_scope.py), and the default actor's set,
    launched beside them, gives the bits of its launch alone: no NaN leaks
    from one set into another."""
    from lqg_tpu_torch.ops.kernels.likelihood import (
        conditioned_log_likelihood_vjp)

    cpu = probe_ll_inputs()
    F, Q, X = (x.to(cuda) for x in cpu)
    out = ll_fwd(F, Q, X, stores=True)
    alone = ll_fwd(F[-1:], Q[-1:], X[-1:], stores=True)
    want = ll_fwd(*cpu, stores=True)
    w = torch.randn(want[0].shape, generator=torch.Generator().manual_seed(1))
    got = conditioned_log_likelihood_vjp(F, X, w.to(cuda), *out[1:])
    got_alone = conditioned_log_likelihood_vjp(F[-1:], X[-1:],
                                               w[-1:].to(cuda), *alone[1:])
    want_vjp = conditioned_log_likelihood_vjp(cpu[0], cpu[2], w, *want[1:])
    torch.cuda.synchronize()
    for a, b, one in zip(out + got, want + want_vjp, alone + got_alone):
        assert torch.equal(torch.isnan(a.cpu()), torch.isnan(b))
        assert torch.isfinite(a[-1]).all()
        assert torch.equal(a[-1:], one)

