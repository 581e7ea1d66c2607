"""The port's scipy bridge (``lqg_tpu_torch.optim.minimize``) against
``lqg_tpu.optim.minimize`` in float64 on the CPU: structured arguments,
the Jacobian from autograd, restructured iterates, and L-BFGS-B on the
lifted bounded actor's potential."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqg_tpu.optim import minimize as jminimize
from lqg_tpu_torch.optim import minimize

from test_torch_svi import models


@pytest.fixture(autouse=True)
def one_thread():
    """These tests run many small ops on the CPU: with one intra-op thread,
    whose pool would otherwise keep every core busy and slow the other
    test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rosenbrock(p):
    """``tests/test_periphery.py:18-28``'s objective, written once for both
    packages (the operators are the same)."""
    x, y = p["x"], p["y"]
    return (1.0 - x) ** 2 + 100.0 * (y - x ** 2) ** 2


@pytest.mark.parametrize("method", ["BFGS", "L-BFGS-B"])
def test_minimize_dict_matches_jax(method, x64):
    """Rosenbrock over a dict from (-1, 2): ``res.x`` equals the JAX
    bridge's within rtol 1e-8, at the minimum (1, 1), with the same number
    of iterations; the callback sees dicts of tensors."""
    seen = []
    res = minimize(rosenbrock, {"x": torch.tensor(-1.0, dtype=torch.float64),
                                "y": torch.tensor(2.0, dtype=torch.float64)},
                   method=method, callback=seen.append)
    want = jminimize(rosenbrock, {"x": jnp.asarray(-1.0),
                                  "y": jnp.asarray(2.0)}, method=method)
    assert res.success and want.success
    assert sorted(res.x) == ["x", "y"] and res.nit == want.nit
    for k in ("x", "y"):
        assert torch.is_tensor(res.x[k]) and res.x[k].dtype == torch.float64
        np.testing.assert_allclose(res.x[k].numpy(), np.asarray(want.x[k]),
                                   rtol=1e-8)
        np.testing.assert_allclose(float(res.x[k]), 1.0, rtol=1e-4)
    assert len(seen) == res.nit
    assert all(isinstance(s, dict) and sorted(s) == ["x", "y"] for s in seen)


def test_minimize_nested_structure_and_bounds(x64):
    """A tuple of a vector and a dict, flattened in ``ravel_pytree``'s order
    (dict keys sorted), with bounds given in that order: the same optimum
    as the JAX bridge, and ``res.x`` restructured as a tuple."""
    def fun(p):
        v, d = p
        return ((v[0] - 0.5) ** 2 + (v[1] + 2.0) ** 2 + (d["b"] - 3.0) ** 2
                + 0.1 * d["a"] ** 2)

    bounds = [(None, None), (-1.0, None), (-5.0, 5.0), (None, 2.5)]
    res = minimize(fun, (torch.zeros(2, dtype=torch.float64),
                         {"b": torch.tensor(0.0, dtype=torch.float64),
                          "a": torch.tensor(1.0, dtype=torch.float64)}),
                   method="L-BFGS-B", bounds=bounds)
    want = jminimize(fun, (jnp.zeros(2), {"b": jnp.asarray(0.0),
                                          "a": jnp.asarray(1.0)}),
                     method="L-BFGS-B", bounds=bounds)
    v, d = res.x
    assert isinstance(res.x, tuple) and sorted(d) == ["a", "b"]
    np.testing.assert_allclose(v.numpy(), np.asarray(want.x[0]), rtol=1e-8)
    for k in ("a", "b"):
        np.testing.assert_allclose(d[k].numpy(), np.asarray(want.x[1][k]),
                                   rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(v.numpy(), [0.5, -1.0], atol=1e-6)
    np.testing.assert_allclose(float(d["b"]), 2.5, atol=1e-6)


def test_minimize_lifted_potential_matches_jax(x64):
    """L-BFGS-B on the lifted bounded actor's potential from its prior
    median: ``res.x`` equals the JAX bridge's within rtol 1e-8."""
    jm, tm = models("lifted")
    res = minimize(tm.potential, tm.init_unconstrained(), method="L-BFGS-B")
    want = jminimize(jax.jit(jm.potential), jm.init_unconstrained(),
                     method="L-BFGS-B")
    assert res.success and want.success
    np.testing.assert_allclose(res.x.numpy(), np.asarray(want.x), rtol=1e-8)
    np.testing.assert_allclose(res.fun, want.fun, rtol=1e-12)
