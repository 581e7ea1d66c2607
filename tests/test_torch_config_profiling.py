"""The port's debugging and profiling helpers (``lqg_tpu_torch.config``,
``lqg_tpu_torch.utils.profiling``) against ``lqg_tpu``'s: the message of
``assert_finite``, the condition numbers, ``debug_nans`` raising where
JAX's does, and the timing and tracing helpers on the CPU."""

import json
import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

from lqg_tpu_torch import config as tconfig
from lqg_tpu_torch import models as tmodels
from lqg_tpu_torch.utils import profiling as tprof


class Pair(NamedTuple):
    L: object
    K: object


def _trees(bad):
    """The same nest with ``bad`` at one leaf, as numpy (for JAX) and as
    tensors (for the port)."""
    leaf = np.array([1.0, bad, 3.0])
    np_tree = {"gains": Pair(L=np.ones((2, 2)), K=[np.zeros(3), leaf]),
               "a": np.float64(2.0)}
    t_tree = {"gains": Pair(L=torch.ones(2, 2),
                            K=[torch.zeros(3), torch.tensor(leaf)]),
              "a": torch.tensor(2.0)}
    return np_tree, t_tree


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_assert_finite_message_matches_jax(bad):
    from lqg_tpu import config as jconfig

    np_tree, t_tree = _trees(bad)
    with pytest.raises(FloatingPointError) as jerr:
        jconfig.assert_finite(np_tree, "state")
    with pytest.raises(FloatingPointError) as terr:
        tconfig.assert_finite(t_tree, "state")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(FloatingPointError, match=r"^value: 1 non-finite"):
        tconfig.assert_finite(torch.tensor([0.0, bad]))
    tconfig.assert_finite(_trees(0.0)[1])


def test_condition_numbers_match_jax(x64):
    from lqg_tpu import config as jconfig
    from lqg_tpu import models as jmodels

    rng = np.random.default_rng(0)
    A = rng.normal(size=(5, 3, 3))
    M = A @ np.swapaxes(A, -1, -2) + 1e-3 * np.eye(3)
    np.testing.assert_allclose(
        tconfig.condition_number(torch.tensor(M)).numpy(),
        jconfig.condition_number(M), rtol=1e-10)
    for name, kw in (("BoundedActor", {}),
                     ("BoundedActor", dict(sigma_target=1e4,
                                           action_cost=1e-6)),
                     ("SubjectiveActor", {})):
        want = jconfig.check_spec_conditioning(
            getattr(jmodels, name)(T=10, **kw).actor, warn_threshold=1e3)
        got = tconfig.check_spec_conditioning(
            getattr(tmodels, name)(T=10, **kw, device="cpu",
                                   dtype=torch.float64).actor,
            warn_threshold=1e3)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-10)


# computations and whether each gives a NaN: (jax.numpy, torch) versions
NAN_CASES = {
    "log of a negative": (lambda np_, x: np_.log(-x), True),
    "sqrt of a negative": (lambda np_, x: np_.sqrt(x - 5.0), True),
    "zero over zero": (lambda np_, x: (x - x) / (x - x), True),
    "finite": (lambda np_, x: np_.exp(x) / (1.0 + x * x), False),
}


@pytest.mark.parametrize("case", sorted(NAN_CASES))
def test_debug_nans_raises_where_jax_raises(case):
    import jax
    import jax.numpy as jnp
    from lqg_tpu import config as jconfig

    fn, nan = NAN_CASES[case]

    def raises(run):
        try:
            run()
        except FloatingPointError:
            return True
        return False

    # an executable cached earlier in the process can skip JAX's NaN check
    jax.clear_caches()
    with jconfig.debug_nans():
        jax_raises = raises(lambda: fn(jnp, jnp.asarray([1.0, 2.0]))
                            .block_until_ready())
    with tconfig.debug_nans():
        torch_raises = raises(lambda: fn(torch, torch.tensor([1.0, 2.0])))
    assert (jax_raises, torch_raises) == (nan, nan)
    # outside the context, and with enable=False, nothing raises
    fn(torch, torch.tensor([1.0, 2.0]))
    with tconfig.debug_nans(False):
        fn(torch, torch.tensor([1.0, 2.0]))


def test_debug_nans_raises_in_a_backward():
    """A NaN that only the backward makes (the derivative of sqrt at 0,
    times 0) raises, as under ``jax.grad``."""
    import jax
    import jax.numpy as jnp
    from lqg_tpu import config as jconfig

    jax.clear_caches()
    with jconfig.debug_nans(), pytest.raises(FloatingPointError):
        jax.grad(lambda x: jnp.sqrt(x) * 0.0)(0.0)
    x = torch.tensor(0.0, requires_grad=True)
    with tconfig.debug_nans(), pytest.raises(FloatingPointError), \
            pytest.warns(UserWarning, match="SqrtBackward"):
        torch.autograd.grad(torch.sqrt(x) * 0.0, x)


def test_timeit_returns_a_timing():
    t = tprof.timeit(lambda a, b=1: a + b, torch.ones(3), iters=4, warmup=1,
                     b=2, name="add")
    assert isinstance(t, tprof.Timing) and t.name == "add" and t.iters == 4
    assert 0 < t.min_s <= t.mean_s and t.per_s == 1.0 / t.mean_s
    assert "ms/call" in str(t)


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path)) as d:
        torch.ones(4) @ torch.ones(4)
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") or "dot" in e.get("name", "")
               for e in events)


def test_kernel_counts_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("counts the card's kernels on a card")
    assert tprof.SESSIONS > 1
    assert tprof.kernel_counts(lambda: torch.ones(3) + 1, ["add"]) == {
        "add": 0}
    wall, events = tprof.device_events(lambda: torch.ones(3) + 1)
    assert wall > 0 and events == []


@pytest.mark.cuda
def test_kernel_counts_on_card():
    """Two launches of the same kernel counted over several sessions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = torch.ones(1000, device="cuda")
    counts = tprof.kernel_counts(lambda: (a + 1, a + 2), ["elementwise"])
    assert counts["elementwise"] >= 2
    t = tprof.timeit(lambda: a * 2, iters=3)
    assert t.mean_s > 0
