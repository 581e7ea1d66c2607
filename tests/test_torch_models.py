"""Port parity: tracking-model specs and the spec container.

The same scalar parameters build a spec in ``lqg_tpu`` (JAX) and in
``lqg_tpu_torch``; every field must agree exactly in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqg_tpu import models as jmodels
from lqg_tpu.models.basic import tracking_spec as jtracking_spec
from lqg_tpu_torch import models as tmodels
from lqg_tpu_torch.convert import spec_from_numpy, system_from_numpy
from lqg_tpu_torch.models.basic import tracking_spec
from lqg_tpu_torch.utils import time_stack_spec

F64 = dict(device="cpu", dtype=torch.float64)

MODELS = [
    ("BoundedActor", dict(action_cost=0.5, action_variability=0.4,
                          sigma_target=5.0, sigma_cursor=3.0)),
    ("BoundedActor", dict(dim=2, action_cost=0.3, sigma_target=8.0)),
    ("OptimalActor", dict(action_variability=0.3, sigma_target=7.0,
                          sigma_cursor=2.0)),
    ("RelativeObservationBoundedActor", dict(action_cost=0.8, sigma=4.0)),
]


def _numpy_fields(spec):
    return {k: np.asarray(v) for k, v in spec._asdict().items()}


def _assert_spec_equal(tspec, jfields):
    for k, v in jfields.items():
        np.testing.assert_array_equal(getattr(tspec, k).numpy(), v, err_msg=k)


@pytest.mark.parametrize("name,params", MODELS)
def test_model_spec_matches_jax(name, params, x64):
    jm = getattr(jmodels, name)(T=30, **params)
    tm = getattr(tmodels, name)(T=30, **params, **F64)
    assert tm.horizon == jm.horizon
    assert (tm.xdim, tm.ydim, tm.bdim, tm.udim) == (jm.xdim, jm.ydim,
                                                    jm.bdim, jm.udim)
    for tspec, jspec in ((tm.actor, jm.actor), (tm.dynamics, jm.dynamics)):
        assert tspec.zero_affine
        _assert_spec_equal(tspec, _numpy_fields(jspec))


def test_tracking_spec_broadcasts_like_vmap(x64):
    rng = np.random.default_rng(0)
    c, av, st, sc = (rng.uniform(0.1, 5.0, 5) for _ in range(4))
    jspec = jax.vmap(lambda *p: jtracking_spec(1, 1.0, *p, 1 / 60))(
        jnp.asarray(av), jnp.asarray(st), jnp.asarray(sc), jnp.asarray(c))
    tspec = tracking_spec(1, 1.0, *(torch.as_tensor(p) for p in (av, st, sc, c)),
                          1 / 60, **F64)
    assert tspec.zero_affine
    _assert_spec_equal(tspec, _numpy_fields(jspec))


def test_spec_from_numpy_round_trip_and_flag(x64):
    jm = jmodels.BoundedActor(T=20, action_cost=0.7)
    fields = _numpy_fields(jm.actor)
    spec = spec_from_numpy(fields, **F64)
    assert spec.zero_affine
    _assert_spec_equal(spec, fields)
    back = {k: v.numpy() for k, v in zip(spec._fields, spec.tensors())}
    for k in fields:
        np.testing.assert_array_equal(back[k], fields[k])

    fields["q"] = fields["q"] + 1.0
    assert not spec_from_numpy(fields, **F64).zero_affine

    sysm = system_from_numpy(_numpy_fields(jm.actor),
                             _numpy_fields(jm.dynamics), horizon=20, **F64)
    assert sysm.horizon == 20 and sysm.actor.zero_affine


def test_replace_keeps_or_voids_flag():
    spec = tracking_spec(1, 1.0, 0.5, 6.0, 6.0, 1.0, 1 / 60, device="cpu")
    assert spec._replace(R=spec.R * 2).zero_affine
    assert not spec._replace(q=spec.q + 1).zero_affine
    assert spec._replace(q=spec.q, zero_affine=True).zero_affine
    assert spec.to(dtype=torch.float64).zero_affine


def test_time_stack_spec_matches_jax(x64):
    from lqg_tpu.utils import time_stack_spec as jtime_stack_spec

    jm = jmodels.BoundedActor(T=7)
    a = jm.actor
    mats = [np.array(getattr(a, k)) for k in "ABFVWQR"]
    jspec = jtime_stack_spec(*mats, T=7)
    tspec = time_stack_spec(*(torch.tensor(M) for M in mats), T=7)
    assert tspec.zero_affine and tspec.horizon == 7
    _assert_spec_equal(tspec, _numpy_fields(jspec))
