"""K4, the likelihood adjoint, behind ``conditioned_log_likelihood_fused``'s
``torch.autograd.Function``.

On the CPU the Function runs the plain versions of K3 (with stores) and
K4: held against ``jax.grad`` of the JAX package's fused likelihood (its
adjoint kernel in interpret mode, float32) and against autograd through the
plain K3 (float64).  On a card (``-m cuda``): K3's stores and K4 against
their plain versions.  JAX is imported inside the tests that use it, so
that the card's tests collect where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from lqg_tpu_torch.models import BoundedActor
from lqg_tpu_torch.ops.kernels import likelihood as kl
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
    assert Sig.shape == (2, 3, 10, 4, 4) and mu.shape == (2, 3, 10, 4)
    torch.testing.assert_close(Sig[:, :, 0], Q.detach()[:, None, 0].expand(
        2, 3, 4, 4), rtol=0, atol=0)  # Sigma_0 = Q_0


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
