"""K3, the fused likelihood kernel of the port.

On the CPU: the plain PyTorch version against the JAX package's Pallas
kernel in interpret mode (float32), and the wrapper's checks.  On a card
(``-m cuda``): the CUDA kernel against the plain version.  JAX is imported
inside the tests that use it, so that the card's tests collect where JAX
is not installed.
"""

import numpy as np
import pytest
import torch

from lqg_tpu_torch.models import BoundedActor
from lqg_tpu_torch.ops.kernels.likelihood import (
    conditioned_log_likelihood_fused, conditioned_log_likelihood_reference,
    fused_ll_available)
from lqg_tpu_torch.ops.linalg import mT

RTOL, ATOL = 2e-4, 2e-3  # as tests/test_pallas.py holds the Pallas kernel


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
    assert not fused_ll_available(8, 4, torch.float32)


def test_wrapper_checks():
    F, Q, X = (torch.tensor(a) for a in _inputs(P=2, n=3, T=12))
    with pytest.raises(NotImplementedError):
        conditioned_log_likelihood_fused(F.requires_grad_(), Q, X)
    with pytest.raises(ValueError, match="does not match"):
        conditioned_log_likelihood_fused(F.detach(), Q, X[:, :, :-1])
    with pytest.raises(ValueError, match="scope"):
        conditioned_log_likelihood_fused(F.detach(), Q, X[..., :1])


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
