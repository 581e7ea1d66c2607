"""K1, the fused gains kernel of the port.

On the CPU: the plain PyTorch version against the JAX package's Pallas
kernel in interpret mode (float32), and the wrapper's checks.  On a card
(``-m cuda``): the CUDA kernel against the plain version.  JAX is imported
inside the tests that use it, so that the card's tests collect where JAX
is not installed.
"""

import numpy as np
import pytest
import torch

from lqg_tpu_torch.models import RelativeObservationBoundedActor
from lqg_tpu_torch.models.basic import tracking_spec
from lqg_tpu_torch.ops.kernels.gains import (fused_gains,
                                             fused_gains_available,
                                             fused_gains_reference)
from lqg_tpu_torch.ops.linalg import mT

ATOL = 2e-5  # as tests/test_pallas.py holds the Pallas kernel


def _sweep(B):
    """Parameters of B bounded actors, spread like bench.py's sweep."""
    return (np.logspace(-2, 1, B), np.linspace(0.1, 1.0, B),
            np.linspace(2.0, 40.0, B), np.linspace(0.5, 10.0, B))


def _torch_spec(B, device="cpu"):
    c, av, st, sc = (torch.tensor(p, dtype=torch.float32) for p in _sweep(B))
    return tracking_spec(1, 1.0, av, st, sc, c, 1 / 60, device=device)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("T", [40, 41])  # 41: a prime horizon
def test_reference_matches_pallas_bounded(T):
    import jax
    import jax.numpy as jnp
    from lqg_tpu.models.basic import tracking_spec as jtracking_spec
    from lqg_tpu.ops.pallas.gains import fused_gains as jfused_gains

    c, av, st, sc = (jnp.asarray(p, jnp.float32) for p in _sweep(5))
    jspec = jax.vmap(lambda *p: jtracking_spec(1, 1.0, *p, 1 / 60))(
        av, st, sc, c)
    jout = jfused_gains(jspec, jspec.V @ jnp.swapaxes(jspec.V, -1, -2),
                        horizon=T)
    spec = _torch_spec(5)
    tout = fused_gains_reference(spec, spec.V @ mT(spec.V), T)
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


def test_reference_matches_pallas_relative_observation():
    """(n, m, p) = (2, 1, 1)."""
    import jax
    import jax.numpy as jnp
    from lqg_tpu.models import RelativeObservationBoundedActor as JRel
    from lqg_tpu.ops.pallas.gains import fused_gains as jfused_gains

    T = 40
    jspec = jax.tree.map(lambda a: jnp.stack([jnp.asarray(a)] * 3),
                         JRel(T=T, sigma=4.0).actor)
    jout = jfused_gains(jspec, jspec.V @ jnp.swapaxes(jspec.V, -1, -2),
                        horizon=T)
    spec = RelativeObservationBoundedActor(T=T, sigma=4.0, device="cpu").actor
    batched = spec._replace(**{k: getattr(spec, k)[None]
                               for k in ("A", "B", "F", "V", "W", "Q", "R",
                                         "Qf")})
    assert fused_gains_available(batched)
    tout = fused_gains(batched, batched.V @ mT(batched.V), T)
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t.numpy(), np.broadcast_to(
            np.asarray(j)[:, :1], t.shape), atol=ATOL)


def test_wrapper_on_cpu_is_the_reference():
    spec = _torch_spec(4)
    S0 = spec.V @ mT(spec.V)
    before = fused_gains.launches
    for a, b in zip(fused_gains(spec, S0, 9),
                    fused_gains_reference(spec, S0, 9)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert fused_gains.launches == before  # no kernel launch on the CPU


def test_wrapper_checks():
    spec = _torch_spec(3)
    S0 = spec.V @ mT(spec.V)
    with pytest.raises(ValueError, match="zero"):
        fused_gains(spec._replace(q=spec.q + 1), S0, 5)
    with pytest.raises(NotImplementedError):
        fused_gains(spec._replace(R=spec.R.clone().requires_grad_()), S0, 5)
    with pytest.raises(ValueError, match="scope"):
        fused_gains(tracking_spec(2, 1.0, 0.5, 6.0, 6.0, 1.0, 1 / 60,
                                  device="cpu"), S0, 5)


def test_build_and_launch_failures_raise(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp

    from lqg_tpu_torch.ops.kernels import nvcc

    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setattr(nvcc, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        nvcc.build_all(["gains", "likelihood"])
    with pytest.raises(RuntimeError, match="error 1"):
        nvcc.check(1, "gains_fwd")
    nvcc.check(0, "gains_fwd")


@pytest.mark.cuda
def test_kernel_matches_reference_on_card(cuda):
    for T, B in ((1000, 2048), (719, 333)):
        spec = _torch_spec(B, device=cuda)
        S0 = spec.V @ mT(spec.V)
        out = fused_gains(spec, S0, T)
        ref = fused_gains_reference(spec, S0, T)
        torch.cuda.synchronize()
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=ATOL)
