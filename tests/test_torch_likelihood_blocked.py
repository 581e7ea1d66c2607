"""K5 and K6, the blocked large-j likelihood and its adjoint, behind
``conditioned_log_likelihood_blocked``'s ``torch.autograd.Function``.

On the CPU the Function runs the plain versions: K5 held against the JAX
package's scan (float64) and its Pallas kernel in interpret mode (float32),
K6 against autograd through an independent propagate-then-correct twin
(float64) and against ``jax.grad`` of the JAX scan twin.  On a card (``-m
cuda``): the CUDA kernels against their plain versions, up to the top of
the scope, and the (3, 1, 2) / (5, 2) instances of K1-K4 through
``SubjectiveActor``.  JAX is imported inside the tests that use it, so that
the card's tests collect where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from lqg_tpu_torch.models import (DelayedSubjectiveActor, SubjectiveActor,
                                  TemporalDelayModel)
from lqg_tpu_torch.ops.kernels import gains as kg
from lqg_tpu_torch.ops.kernels import likelihood as kl
from lqg_tpu_torch.ops.kernels import likelihood_blocked as kb
from lqg_tpu_torch.ops.linalg import mT

# (delay, T, n, dim) of tests/test_pallas.py:456-460
CASES = [
    (None, 24, 3, 1),  # DelayedSubjectiveActor (delay 12): j = 65
    (4, 13, 2, 1),  # prime T, j = 25
    (4, 16, 2, 2),  # dim = 2: j = 50, observed d = 4
]
IDS = ["j65", "j25_prime_T", "j50_d4"]


def _sym(M):
    return 0.5 * (M + np.swapaxes(M, -1, -2))


def _jax_case(delay, T, n, dim):
    """F, Q, X (float64 numpy, one parameter set) of a JAX delay model, its
    scan log likelihood and the model."""
    import jax.numpy as jnp
    from jax import random
    from lqg_tpu import models as jmodels

    if delay is None:
        m = jmodels.DelayedSubjectiveActor(T=T)
    else:
        m = jmodels.TemporalDelayModel(jmodels.SubjectiveActor(T=T, dim=dim),
                                       delay=delay)
    joint = m._joint()
    x = m.simulate(random.PRNGKey(0), n=n)[..., :2 * dim]
    Q = joint.G @ jnp.swapaxes(joint.G, -1, -2)
    ll = m.log_likelihood(x, method="scan")
    return (np.asarray(joint.F)[None], np.asarray(Q)[None],
            np.asarray(x)[None], np.asarray(ll))


def _torch_case(j_delay, T, n, dim, P=1, device="cpu", dtype=torch.float32):
    """F, Q, X of P port delay models with spread parameters."""
    g = torch.Generator(device=device).manual_seed(0)
    Fs, Qs, Xs = [], [], []
    for k in range(P):
        kw = dict(T=T, sigma_target=3.0 + 2.0 * k, device=device, dtype=dtype)
        if j_delay is None:
            m = DelayedSubjectiveActor(c=0.3 + 0.2 * k, **kw)
        else:
            m = TemporalDelayModel(
                SubjectiveActor(dim=dim, action_cost=0.3 + 0.2 * k, **kw),
                delay=j_delay)
        joint = m._joint()
        Fs.append(joint.F)
        Qs.append(joint.G @ mT(joint.G))
        Xs.append(m.simulate(g, n=n)[..., :2 * dim])
    return torch.stack(Fs), torch.stack(Qs), torch.stack(Xs)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_forward_matches_jax_scan(case, x64):
    F, Q, X, ll_scan = _jax_case(*case)
    ll, Sig, MU = kb.conditioned_log_likelihood_blocked_reference(
        *map(torch.tensor, (F, Q, X)), stores=True)
    np.testing.assert_allclose(ll[0].numpy(), ll_scan, rtol=1e-9)
    T, j, n = F.shape[1], F.shape[-1], X.shape[1]
    assert Sig.shape == (1, T + 1, j, j) and MU.shape == (1, T + 1, j, n)
    np.testing.assert_array_equal(Sig[:, 0].numpy(), Q[:, 0])  # Sig_0 = Q_0


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_forward_matches_pallas(case):
    """float32, against the Pallas kernel in interpret mode at the tolerance
    of tests/test_pallas.py:481."""
    import jax.numpy as jnp
    from lqg_tpu.ops.pallas.likelihood_blocked import _blocked_ll_call

    F, Q, X, _ = (a.astype(np.float32) for a in _jax_case(*case))
    want = np.asarray(_blocked_ll_call(*map(jnp.asarray, (F, Q, X))))
    got = kb.conditioned_log_likelihood_blocked(*map(torch.tensor, (F, Q, X)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=0.2)


def _twin(F, Q, X):
    """An independent differentiable twin, propagate-then-correct with
    ``torch.linalg.solve`` (the form of ``likelihood_blocked.py:531-575``)."""
    P_, T, j, _ = F.shape
    d = X.shape[-1]
    Xt = X.permute(0, 2, 3, 1)
    Sigma = Q[:, 0]
    MU = torch.cat([Xt[:, 0], X.new_zeros((P_, j - d, X.shape[1]))], 1)
    total = 0.0
    for t in range(T + 1):
        S = 0.5 * (Sigma[:, :d, :d] + mT(Sigma[:, :d, :d]))
        E = Xt[:, t] - MU[:, :d]
        if t >= 1:
            total = total + (E * torch.linalg.solve(S, E)).sum(1) \
                + torch.logdet(S)[:, None]
        if t == T:
            break
        FS = F[:, t] @ Sigma
        J = mT(torch.linalg.solve(S, mT(FS[..., :d])))
        MU = F[:, t] @ MU + J @ E
        Sigma = FS @ mT(F[:, t]) + Q[:, t] - J @ mT(FS[..., :d])
        Sigma = 0.5 * (Sigma + mT(Sigma))
    return -0.5 * (total + T * d * np.log(2 * np.pi))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_adjoint_matches_autograd(case):
    """float64: K6's plain version against autograd through the plain K5 and
    through the independent twin, ``Qbar`` in the symmetric gauge."""
    F, Q, X = _torch_case(*case, P=2, dtype=torch.float64)
    w = torch.tensor(np.random.default_rng(1).normal(size=X.shape[:2]))
    leaves = [a.clone().requires_grad_() for a in (F, Q, X)]
    got = torch.autograd.grad(kb.conditioned_log_likelihood_blocked(*leaves),
                              leaves, w)
    for fn in (kb.conditioned_log_likelihood_blocked_reference, _twin):
        want = torch.autograd.grad(fn(*leaves), leaves, w)
        for name, a, b in zip("FQX", got, want):
            if name == "Q":
                a, b = 0.5 * (a + mT(a)), 0.5 * (b + mT(b))
            torch.testing.assert_close(
                a, b, rtol=1e-9, atol=1e-9 * float(b.abs().max()),
                msg=lambda m: f"{fn.__name__}, cotangent of {name}: {m}")
    assert float(got[2].abs().max()) > 0


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_adjoint_matches_jax_scan_twin(case):
    """float32, against ``jax.grad`` of the JAX scan twin at the tolerance of
    tests/test_pallas.py:499-507 (scaled by each cotangent's largest entry)."""
    import jax
    import jax.numpy as jnp
    from lqg_tpu.ops.pallas.likelihood_blocked import _scan_twin

    F, Q, X, _ = (a.astype(np.float32) for a in _jax_case(*case))
    want = jax.grad(lambda FQX: jnp.sum(_scan_twin(*FQX)))(
        tuple(map(jnp.asarray, (F, Q, X))))
    leaves = [torch.tensor(a, requires_grad=True) for a in (F, Q, X)]
    got = torch.autograd.grad(
        kb.conditioned_log_likelihood_blocked(*leaves).sum(), leaves)
    for name, a, b in zip("FQX", got, want):
        a, b = a.numpy(), np.asarray(b)
        if name == "Q":
            a, b = _sym(a), _sym(b)
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, rtol=2e-4, atol=2e-5,
                                   err_msg=f"cotangent of {name}")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_adjoint_matches_jax_scan_twin_float64(case, x64):
    """float64: the plain K6, which groups ``Fbar = 2 (Bs F) Sc + m MUc^T``
    and ``Scrb = (Bs F)^T F`` as the clustered kernel does, against
    ``jax.grad`` of the JAX scan twin."""
    import jax
    import jax.numpy as jnp
    from lqg_tpu.ops.pallas.likelihood_blocked import _scan_twin

    F, Q, X, _ = _jax_case(*case)
    want = jax.jit(jax.grad(lambda FQX: jnp.sum(_scan_twin(*FQX))))(
        tuple(map(jnp.asarray, (F, Q, X))))
    leaves = [torch.tensor(a, requires_grad=True) for a in (F, Q, X)]
    got = torch.autograd.grad(
        kb.conditioned_log_likelihood_blocked(*leaves).sum(), leaves)
    for name, a, b in zip("FQX", got, want):
        a, b = a.numpy(), np.asarray(b)
        if name == "Q":
            a, b = _sym(a), _sym(b)
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, rtol=1e-9,
                                   atol=1e-10, err_msg=f"cotangent of {name}")


def test_function_on_cpu_launches_nothing():
    F, Q, X = _torch_case(4, 9, 3, 1, P=2)
    leaves = [a.requires_grad_() for a in (F, Q, X)]
    before = (kb.conditioned_log_likelihood_blocked.launches,
              kb.conditioned_log_likelihood_blocked_vjp.launches)
    kb.conditioned_log_likelihood_blocked(*leaves).sum().backward()
    assert all(torch.isfinite(a.grad).all() for a in leaves)
    torch.testing.assert_close(leaves[1].grad, mT(leaves[1].grad), rtol=0,
                               atol=0)  # Qbar in the symmetric gauge
    assert before == (kb.conditioned_log_likelihood_blocked.launches,
                      kb.conditioned_log_likelihood_blocked_vjp.launches)


def test_wrapper_rejects_what_the_kernels_do_not_take():
    F, Q, X = _torch_case(4, 5, 2, 1)
    with pytest.raises(ValueError, match="expected F, Q"):
        kb.conditioned_log_likelihood_blocked(F[0], Q[0], X)
    with pytest.raises(ValueError, match="does not match"):
        kb.conditioned_log_likelihood_blocked(F, Q, X[:, :, :-1])
    with pytest.raises(ValueError, match="scope"):  # j = 4
        kb.conditioned_log_likelihood_blocked(F[..., :4, :4], Q[..., :4, :4],
                                              X)
    with pytest.raises(ValueError, match="scope"):  # 129 trials
        kb.conditioned_log_likelihood_blocked(F, Q,
                                              X[:, :1].expand(1, 129, 6, 2))


@pytest.mark.parametrize("j,d,n", [(13, 1, 1), (65, 2, 20), (120, 4, 20),
                                   (128, 4, 128), (128, 2, 64), (25, 2, 128)])
def test_buffer_plan_fits_the_block(j, d, n):
    """Every buffer of a rank gets its room, in shared memory or in the
    scratch, without overlap, at every cluster size; the model family's
    shapes fit shared memory whole."""
    for C in kb.CLUSTERS:
        for plan, sizes, small in (
                (kb.fwd_plan, kb.fwd_sizes(j, n, C), kb._small_floats(j, d, n)),
                (kb.bwd_plan, kb.bwd_sizes(j, n, C),
                 kb._small_floats(j, d, n, C))):
            place, smem, scratch = plan(j, d, n, C)
            assert smem * 4 <= kb.SMEM_LIMIT - kb.SMEM_RESERVE
            in_smem = sorted((p, s) for p, s in zip(place, sizes) if p >= 0)
            in_scratch = sorted((-p - 1, s) for p, s in zip(place[:-1],
                                                            sizes[:-1])
                                if p < 0)
            assert in_smem[0][0] >= small
            for spans, end in ((in_smem, smem), (in_scratch, scratch)):
                for (a, size), (b, _) in zip(spans, spans[1:] + [(end, 0)]):
                    assert a + size <= b
            if j <= 65:
                assert scratch == 0 and all(p >= 0 for p in place)
    assert kb.MAX_THREADS % 32 == 0 and kb.MAX_THREADS >= n


def test_top_of_scope_needs_the_scratch():
    place, smem, scratch = kb.bwd_plan(128, 4, 128)
    assert scratch > 0 and place[-1] == -1  # F_t read where it lies
    for C in kb.CLUSTERS:  # a rank holds the full carries at every C
        assert kb.fwd_plan(128, 4, 128, C)[2] > 0
        assert kb.bwd_plan(128, 4, 128, C)[2] > 0


@pytest.mark.parametrize("P,j,sms,want", [
    (24, 65, 132, 4),  # the fit's 24 sets: 96 SMs
    (1, 65, 132, 8),  # the forward delay path's one set
    (33, 65, 132, 4), (34, 65, 132, 2), (66, 65, 132, 2), (67, 65, 132, 1),
    (24, 65, 114, 4), (24, 65, 78, 2),  # smaller cards
    (1, 13, 132, 1), (1, 16, 132, 2), (1, 28, 132, 2), (1, 29, 132, 4),
    (1, 57, 132, 8), (2, 120, 132, 8), (200, 128, 132, 1),
])
def test_cluster_size_rule(P, j, sms, want):
    assert kb.cluster_size(P, j, sms) == want


def test_cluster_size_is_the_largest_that_fits():
    for sms in (78, 114, 132):
        for P in range(1, 140):
            for j in range(kb.MIN_J, kb.MAX_J + 1):
                C = kb.cluster_size(P, j, sms)
                fits = lambda c: P * c <= sms and -(-j // c) >= kb.MIN_PANEL
                assert C in kb.CLUSTERS and (C == 1 or fits(C))
                assert not any(fits(c) for c in kb.CLUSTERS if c > C)


def test_row_panels_cover_the_rows_once():
    for j in range(kb.MIN_J, kb.MAX_J + 1):
        for C in kb.CLUSTERS:
            panels = kb.row_panels(j, C)
            assert len(panels) == C
            assert [s for s, _ in panels] == list(
                np.cumsum([0] + [r for _, r in panels[:-1]]))
            assert sum(r for _, r in panels) == j
            rows = [r for _, r in panels]
            assert rows == sorted(rows, reverse=True)
            assert max(rows) - min(rows) <= 1 and min(rows) >= 1
            assert max(rows) == -(-j // C)
    assert kb.row_panels(65, 4) == [(0, 17), (17, 16), (33, 16), (49, 16)]


# --- on the card ---

# K5 against its plain version as tests/test_pallas.py:481 holds the Pallas
# kernel; the stores and K6 scaled by each output's largest entry
LL_TOL = dict(rtol=2e-3, atol=0.2)
SCALED_TOL = 2e-3


def _scaled_close(got, want, name):
    scale = float(want.abs().max().clamp_min(1e-6))
    err = float((got - want).abs().max()) / scale
    assert err <= SCALED_TOL, f"{name}: {err:.3e} of max {scale:.4g}"


@pytest.mark.cuda
@pytest.mark.parametrize("j_delay,T,n,dim,P", [
    (None, 1008, 20, 1, 3),  # the data fit's shape, j = 65
    (4, 719, 7, 1, 2),  # prime T, j = 25
    (11, 40, 20, 2, 2),  # j = 120, d = 4
    (5, 30, 128, 1, 2),  # n = 128, j = 30
])
def test_kernels_match_reference_on_card(cuda, j_delay, T, n, dim, P):
    F, Q, X = _torch_case(j_delay, T, n, dim, P=P, device=cuda)
    out = kb.ll_blocked_fwd(F, Q, X, stores=True)
    ref = kb.conditioned_log_likelihood_blocked_reference(F, Q, X,
                                                          stores=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out[0], ref[0], **LL_TOL)
    torch.testing.assert_close(kb.ll_blocked_fwd(F, Q, X), out[0], rtol=0,
                               atol=0)  # the store-free variant
    _scaled_close(out[1], ref[1], "Sig stores")
    _scaled_close(out[2], ref[2], "MU stores")
    w = torch.randn(X.shape[:2], generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    got = kb.conditioned_log_likelihood_blocked_vjp(F, X, w, *out[1:])
    want = kb.conditioned_log_likelihood_blocked_vjp_reference(F, X, w,
                                                               *out[1:])
    torch.cuda.synchronize()
    for name, a, b in zip(("Fbar", "Qbar", "Xbar"), got, want):
        assert torch.isfinite(a).all()
        _scaled_close(a, b, name)


@pytest.mark.cuda
@pytest.mark.parametrize("j_delay,T,n,dim,P", [
    (None, 1008, 20, 1, 3),  # the data fit's shape, j = 65, d = 2
    (11, 40, 20, 2, 2),  # j = 120, d = 4
])
def test_every_cluster_size_matches_reference_on_card(cuda, j_delay, T, n,
                                                      dim, P):
    """K5 (both variants) and K6 at every cluster size against their plain
    versions; K5 the same bits at every size, K6 the same bits twice."""
    F, Q, X = _torch_case(j_delay, T, n, dim, P=P, device=cuda)
    ref = kb.conditioned_log_likelihood_blocked_reference(F, Q, X,
                                                          stores=True)
    w = torch.randn(X.shape[:2], generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    first = None
    for C in kb.CLUSTERS:
        out = kb.ll_blocked_fwd(F, Q, X, stores=True, cluster=C)
        free = kb.ll_blocked_fwd(F, Q, X, cluster=C)
        torch.cuda.synchronize()
        assert kb.conditioned_log_likelihood_blocked.cluster == C
        torch.testing.assert_close(out[0], ref[0], **LL_TOL)
        assert torch.equal(free, out[0]), f"C={C}: store-free variant"
        _scaled_close(out[1], ref[1], f"C={C}: Sig stores")
        _scaled_close(out[2], ref[2], f"C={C}: MU stores")
        first = first or out
        assert all(torch.equal(a, b) for a, b in zip(out, first)), \
            f"K5 at C={C} differs from C=1"
        got = kb.conditioned_log_likelihood_blocked_vjp(F, X, w, *out[1:],
                                                        cluster=C)
        again = kb.conditioned_log_likelihood_blocked_vjp(F, X, w, *out[1:],
                                                          cluster=C)
        want = kb.conditioned_log_likelihood_blocked_vjp_reference(
            F, X, w, *out[1:])
        torch.cuda.synchronize()
        assert kb.conditioned_log_likelihood_blocked_vjp.cluster == C
        for name, a, b, c in zip(("Fbar", "Qbar", "Xbar"), got, again, want):
            assert torch.isfinite(a).all() and torch.equal(a, b), name
            _scaled_close(a, c, f"C={C}: {name}")


@pytest.mark.cuda
def test_wrapper_runs_a_set_on_a_cluster_on_card(cuda):
    """At the fit's 24 sets the wrapper picks a cluster of more than one
    block, and for one set no fewer."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    F, Q, X = _torch_case(None, 12, 20, 1, P=2, device=cuda)
    F24, Q24, X24 = (a.repeat(12, 1, 1, 1) for a in (F, Q, X))
    leaves = [a.requires_grad_() for a in (F24, Q24, X24)]
    kb.conditioned_log_likelihood_blocked(*leaves).sum().backward()
    torch.cuda.synchronize()
    picked = (kb.conditioned_log_likelihood_blocked.cluster,
              kb.conditioned_log_likelihood_blocked_vjp.cluster)
    assert all(1 < C <= kb.cluster_size(24, 65, sms) for C in picked), picked
    kb.ll_blocked_fwd(F[:1], Q[:1], X[:1])
    assert (kb.conditioned_log_likelihood_blocked.cluster
            >= picked[0]), kb.conditioned_log_likelihood_blocked.cluster


@pytest.mark.cuda
def test_kernels_at_the_top_of_the_scope_on_card(cuda):
    """j = n = 128, d = 4: buffers spill to the scratch and ``F_t`` is read
    from device memory.  Random stable systems: no model is that large."""
    P, T, j, n, d = 2, 6, 128, 128, 4
    g = torch.Generator(device=cuda).manual_seed(3)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=cuda)
    F = 0.9 * torch.eye(j, device=cuda) + 0.3 / j ** 0.5 * rnd(P, T, j, j)
    G = rnd(P, T, j, j // 2) / j ** 0.5
    Q = G @ mT(G) + 0.1 * torch.eye(j, device=cuda)
    X = rnd(P, n, T + 1, d).cumsum(2)
    out = kb.ll_blocked_fwd(F, Q, X, stores=True)
    ref = kb.conditioned_log_likelihood_blocked_reference(F, Q, X,
                                                          stores=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out[0], ref[0], **LL_TOL)
    _scaled_close(out[1], ref[1], "Sig stores")
    w = rnd(P, n)
    got = kb.conditioned_log_likelihood_blocked_vjp(F, X, w, *out[1:])
    want = kb.conditioned_log_likelihood_blocked_vjp_reference(F, X, w,
                                                               *out[1:])
    torch.cuda.synchronize()
    for name, a, b in zip(("Fbar", "Qbar", "Xbar"), got, want):
        _scaled_close(a, b, name)


@pytest.mark.cuda
def test_function_launches_both_kernels_on_card(cuda):
    F, Q, X = _torch_case(None, 50, 4, 1, P=2, device=cuda)
    leaves = [a.requires_grad_() for a in (F, Q, X)]
    before = (kb.conditioned_log_likelihood_blocked.launches,
              kb.conditioned_log_likelihood_blocked_vjp.launches)
    kb.conditioned_log_likelihood_blocked(*leaves).sum().backward()
    torch.cuda.synchronize()
    assert (before[0] + 1, before[1] + 1) == (
        kb.conditioned_log_likelihood_blocked.launches,
        kb.conditioned_log_likelihood_blocked_vjp.launches)
    with pytest.raises(TypeError, match="float32"):
        kb.ll_blocked_fwd(F.detach().double(), Q.detach().double(),
                          X.detach().double())


@pytest.mark.cuda
def test_subjective_actor_instances_on_card(cuda):
    """K1/K2 at (n, m, p) = (3, 1, 2) and K3/K4 at (j, d) = (5, 2): the
    SubjectiveActor's value and gradient through the kernels against their
    plain versions on the same tensors."""
    T, n = 1000, 20
    sv = torch.tensor([0.5, 1.5, 4.0], device=cuda)
    m = SubjectiveActor(T=T, subj_vel_noise=sv, device=cuda)
    spec = m.actor
    S0 = m._default_Sigma0()
    out = kg.fused_gains(spec, S0, T)
    ref = kg.fused_gains_reference(spec, S0, T)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5)
    joint = m._joint()
    assert joint.F.shape[-1] == 5
    F, Q = (torch.movedim(M, 0, 1).contiguous()
            for M in (joint.F, joint.G @ mT(joint.G)))
    x = SubjectiveActor(T=T, device=cuda).simulate(
        torch.Generator(device=cuda).manual_seed(0), n=n)
    X = x.expand(3, *x.shape).contiguous()
    got = kl.ll_fwd(F, Q, X, stores=True)
    want = kl.conditioned_log_likelihood_reference(F, Q, X, stores=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-3)
    w = torch.randn((3, n), generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    gk = kl.conditioned_log_likelihood_vjp(F, X, w, *got[1:])
    gp = kl.conditioned_log_likelihood_vjp_reference(F, X, w, *got[1:])
    torch.cuda.synchronize()
    for a, b, atol in zip(gk, gp, (1e-3, 1e-3, 1e-4)):
        torch.testing.assert_close(a, b, rtol=1e-2,
                                   atol=atol + 1e-5 * float(b.abs().max()))
    before = (kg.fused_gains.launches, kg.fused_gains_vjp.launches,
              kl.conditioned_log_likelihood_fused.launches,
              kl.conditioned_log_likelihood_vjp.launches)
    sv.requires_grad_()
    ll = SubjectiveActor(T=T, subj_vel_noise=sv, device=cuda).log_likelihood(x)
    (grad,) = torch.autograd.grad(ll.sum(), sv)
    assert torch.isfinite(grad).all()
    after = (kg.fused_gains.launches, kg.fused_gains_vjp.launches,
             kl.conditioned_log_likelihood_fused.launches,
             kl.conditioned_log_likelihood_vjp.launches)
    assert after == tuple(b + 1 for b in before)
