"""The delay-register model family of the port (``SubjectiveActor``,
``TemporalDelayModel``, ``DelayedSubjectiveActor``) against ``lqg_tpu`` in
float64: specs, gains, joint system, likelihood, the goldens, the dispatch
of ``System.log_likelihood`` and the hierarchical delay potential as a
whole."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from lqg_tpu import models as jmodels
from lqg_tpu.infer import models as jinfer
from lqg_tpu.models.delay import delay_system as jdelay_system
from lqg_tpu.models.subjective import swap_dims as jswap_dims
from lqg_tpu.ops import kalman as jkalman
from lqg_tpu.ops import riccati as jriccati
from lqg_tpu_torch import infer as tinfer
from lqg_tpu_torch import models as tmodels
from lqg_tpu_torch.convert import system_from_numpy
from lqg_tpu_torch.models.delay import delay_system
from lqg_tpu_torch.ops import kalman, riccati
from lqg_tpu_torch.ops.kernels import likelihood_blocked as kb
from lqg_tpu_torch.system import System

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "goldens")
F64 = dict(device="cpu", dtype=torch.float64)
SUBJ = dict(action_cost=0.7, action_variability=0.4, subj_noise=0.8,
            subj_vel_noise=1.5, sigma_target=5.0, sigma_cursor=3.0)
DELAYED = dict(c=0.6, action_variability=0.4, subj_noise=0.9,
               subj_vel_noise=8.0, sigma_target=5.0, sigma_cursor=2.5)
DELAY_SHARED = ["c", "subj_noise", "subj_vel_noise", "sigma_cursor",
                "action_variability"]


def _pair(case, T=20):
    """(JAX model, port model) of one of the family's cases."""
    if case == "subjective":
        return (jmodels.SubjectiveActor(T=T, **SUBJ),
                tmodels.SubjectiveActor(T=T, **SUBJ, **F64))
    if case == "subjective_2d":
        return (jmodels.SubjectiveActor(T=T, dim=2, **SUBJ),
                tmodels.SubjectiveActor(T=T, dim=2, **SUBJ, **F64))
    if case == "delay4":
        return (jmodels.TemporalDelayModel(
                    jmodels.SubjectiveActor(T=T, **SUBJ), delay=4),
                tmodels.TemporalDelayModel(
                    tmodels.SubjectiveActor(T=T, **SUBJ, **F64), delay=4))
    if case == "delayed":
        return (jmodels.DelayedSubjectiveActor(T=T, **DELAYED),
                tmodels.DelayedSubjectiveActor(T=T, **DELAYED, **F64))
    raise ValueError(case)


CASES = ["subjective", "subjective_2d", "delay4", "delayed"]


def _numpy_fields(spec):
    return {k: np.asarray(v) for k, v in spec._asdict().items()}


def close(t, j, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("d,dim", [(3, 1), (6, 2), (9, 3), (8, 2)])
def test_swap_dims_matches_jax(d, dim):
    assert tmodels.swap_dims(d, dim) == jswap_dims(d, dim)


@pytest.mark.parametrize("case", CASES)
def test_spec_matches_jax(case, x64):
    jm, tm = _pair(case)
    assert tm.horizon == jm.horizon
    assert (tm.xdim, tm.ydim, tm.bdim, tm.udim) == (jm.xdim, jm.ydim,
                                                    jm.bdim, jm.udim)
    for tspec, jspec in ((tm.actor, jm.actor), (tm.dynamics, jm.dynamics)):
        assert tspec.zero_affine
        for k, v in _numpy_fields(jspec).items():
            np.testing.assert_allclose(getattr(tspec, k).numpy(), v,
                                       rtol=1e-12, atol=0, err_msg=k)


def test_delay_system_stacked_matches_jax(x64):
    """The stacked branch: a time axis at -3, augmented slice-wise."""
    import lqg_tpu as jlqg
    import lqg_tpu_torch as tlqg

    T = 6
    mats = {k: np.array(getattr(jmodels.BoundedActor(T=1).actor, k))
            for k in "ABFVWQR"}
    mats["A"] = mats["A"] * 0.9
    jspec = jdelay_system(jlqg.Actor(**mats, T=T), delay=3)
    tspec = delay_system(tlqg.Actor(**mats, T=T, **F64), delay=3)
    assert tspec.zero_affine and tspec.A.shape == (T, 8, 8)
    for k, v in _numpy_fields(jspec).items():
        np.testing.assert_array_equal(getattr(tspec, k).numpy(), v, err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_gains_and_joint_system_match_jax(case, x64):
    """Riccati (jitter) and Kalman at n up to 39 with a singular ``A`` and a
    rank-deficient ``Sigma0``, and the joint system with ``bdim != xdim``."""
    jm, tm = _pair(case)
    jg, jK = jm.gains(method="scan")
    tg, tK = tm.gains(method="auto")  # the scans on the CPU
    close(tg.L, jg.L)
    close(tg.l, jg.l)
    close(tK, jK)
    jj, tj = jm._joint(), tm._joint()
    assert tj.F.shape[-1] == tm.xdim + tm.bdim
    close(tj.F, jj.F)
    close(tj.G, jj.G)


@pytest.mark.parametrize("case", CASES)
def test_log_likelihood_scan_and_blocked_match_jax(case, x64):
    jm, tm = _pair(case)
    d = 2 * (2 if case == "subjective_2d" else 1)
    jx = jm.simulate(random.PRNGKey(2), n=3)[..., :d]
    x = torch.tensor(np.asarray(jx))
    want = jm.log_likelihood(jx, method="scan")
    close(tm.log_likelihood(x, method="scan"), want, rtol=1e-9)
    close(tm.log_likelihood(x, method="auto"), want, rtol=1e-9)
    j = tm.xdim + tm.bdim
    if j > 12:  # in the blocked kernels' scope: their plain version here
        before = kb.conditioned_log_likelihood_blocked.launches
        close(tm.log_likelihood(x, method="blocked"), want, rtol=1e-9)
        assert before == kb.conditioned_log_likelihood_blocked.launches
    else:
        with pytest.raises(ValueError, match="scope"):
            tm.log_likelihood(x, method="blocked")


@pytest.mark.parametrize("name", ["subjective_actor", "delayed_subjective"])
def test_golden(name):
    """Gains, likelihood and belief mean of the reference's own runs, read
    as ``tests/test_reference_goldens.py`` reads them."""
    data = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    meta = json.loads(str(data["params"]))
    params = {k: v for k, v in meta.items() if k not in ("class", "n")}
    model = tmodels.SubjectiveActor(**params, **F64)
    d, methods = data["x"].shape[-1], ("scan",)
    if meta["class"] == "TemporalDelayModel":
        # only the (target, cursor) dims are scored; j = 65: K5's scope
        model, d = tmodels.TemporalDelayModel(model, delay=12), 2
        methods = ("scan", "blocked")
    gains = riccati.backward(model.actor, horizon=model.horizon,
                             regularize="eigh")
    K = kalman.forward(model.actor, Sigma0=model._default_Sigma0(),
                       horizon=model.horizon)
    close(gains.L, data["L"], rtol=1e-10, atol=1e-12)
    close(K, data["K"], rtol=1e-10, atol=1e-12)
    x = torch.tensor(data["x"][..., :d])
    for method in methods:
        ll = model.log_likelihood(x, method=method)
        np.testing.assert_allclose(ll.numpy(), data["log_likelihood"],
                                   rtol=1e-5)
    mu = model.belief_tracking_distribution(x).loc
    np.testing.assert_allclose(mu.numpy(), data["belief_mu"], rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("model,param,values", [
    ("SubjectiveActor", "subj_vel_noise", [0.5, 1.5, 4.0]),
    ("SubjectiveActor", "action_cost", [0.3, 1.2]),
    ("DelayedSubjectiveActor", "c", [0.3, 0.7, 1.5]),
    ("DelayedSubjectiveActor", "sigma_target", [3.0, 9.0]),
])
def test_batched_model_equals_loop_over_parameter_sets(model, param, values):
    """A model whose parameter carries a leading axis P equals P unbatched
    models: every spec field, the gains, and the likelihood on the scan and
    on the kernels' routes."""
    T = 6
    cls = getattr(tmodels, model)
    batched = cls(T=T, **{param: torch.tensor(values, dtype=torch.float64)},
                  **F64)
    singles = [cls(T=T, **{param: v}, **F64) for v in values]
    P = len(values)
    assert batched.batch_shape == (P,)
    for spec, loop in ((batched.actor, [m.actor for m in singles]),
                       (batched.dynamics, [m.dynamics for m in singles])):
        for got, *want in zip(spec.tensors(), *(s.tensors() for s in loop)):
            torch.testing.assert_close(got, torch.stack(want), rtol=0, atol=0)
    g, K = batched.gains()
    loop = [m.gains() for m in singles]
    close(g.L, torch.stack([gi.L for gi, _ in loop], 1), rtol=1e-12, atol=0)
    close(K, torch.stack([Ki for _, Ki in loop], 1), rtol=1e-12, atol=0)
    x = singles[0].simulate(torch.Generator().manual_seed(2), n=3)[..., :2]
    kernel_route = "blocked" if batched.xdim + batched.bdim > 12 else "fused"
    for method in ("scan", kernel_route):
        want = torch.stack([m.log_likelihood(x, method=method)
                            for m in singles])
        ll = batched.log_likelihood(x, method=method)
        assert ll.shape == (P, 3)
        close(ll, want, rtol=1e-12, atol=0)


def test_riccati_and_kalman_at_n39_with_a_parameter_axis(x64):
    """``riccati.backward`` in its ``"jitter"`` mode and ``kalman.forward``
    on the delayed actor (n = 39, ``A`` a singular shift register, ``Sigma0 =
    V V^T`` of rank 3) with a leading P axis, against JAX per set."""
    cs = [0.3, 0.9]
    tm = tmodels.DelayedSubjectiveActor(
        T=15, c=torch.tensor(cs, dtype=torch.float64), **F64)
    assert tm.actor.A.shape == (2, 39, 39)
    tg = riccati.backward(tm.actor, horizon=15, regularize="jitter")
    tK = kalman.forward(tm.actor, Sigma0=tm._default_Sigma0(), horizon=15)
    for k, c in enumerate(cs):
        ja = jmodels.DelayedSubjectiveActor(T=15, c=c).actor
        jg = jriccati.backward(ja, horizon=15, regularize="jitter")
        jK = jkalman.forward(ja, Sigma0=ja.V @ ja.V.T, horizon=15)
        close(tg.L[:, k], jg.L)
        close(tg.H[:, k], jg.H)
        close(tK[:, k], jK)


def test_converted_jax_system_gives_the_same_likelihood(x64):
    """``convert.system_from_numpy`` carries a JAX delay model (actor and
    dynamics of different sizes, a horizon) across."""
    jm = jmodels.TemporalDelayModel(jmodels.SubjectiveActor(T=12, **SUBJ),
                                    delay=5)
    tm = system_from_numpy(_numpy_fields(jm.actor),
                           _numpy_fields(jm.dynamics), horizon=jm.horizon,
                           **F64)
    assert (tm.xdim, tm.bdim) == (12, 18) and tm.actor.zero_affine
    jx = jm.simulate(random.PRNGKey(3), n=2)[..., :2]
    x = torch.tensor(np.asarray(jx))
    want = jm.log_likelihood(jx, method="scan")
    for method in ("scan", "blocked"):
        close(tm.log_likelihood(x, method=method), want, rtol=1e-9)


def test_auto_resolves_as_jax_rule(monkeypatch):
    """``auto``: fused where it fits, else blocked where it fits, else the
    scan (``lqg_tpu/system.py:357-389``), with the card's conditions forced
    on as the JAX tests force ``_fused_ok``."""
    from lqg_tpu_torch import system as tsystem

    taken = []
    for name in ("fused", "blocked"):
        attr = f"conditioned_log_likelihood_{name}"
        monkeypatch.setattr(tsystem, attr, _recording(getattr(tsystem, attr),
                                                      taken))
    f32 = dict(device="cpu")
    models = [
        (tmodels.SubjectiveActor(T=8, **f32), 2, "fused"),  # j = 5
        (tmodels.DelayedSubjectiveActor(T=8, **f32), 2, "blocked"),  # j = 65
        (tmodels.SubjectiveActor(T=8, dim=2, **f32), 4, "fused"),  # (10, 4)
        # j = 12 with d = 6: in neither kernel's scope
        (tmodels.BoundedActor(T=8, dim=3, **f32), 6, None),
    ]
    data = [m.simulate(torch.Generator().manual_seed(0), n=2)[..., :d]
            for m, d, _ in models]
    for (m, _, _), x in zip(models, data):
        m.log_likelihood(x)  # on the CPU auto is the scan
    assert taken == []
    # what the rule sees on a card: a CUDA float32 tensor
    monkeypatch.setattr(System, "_fused_ll_ok", lambda self, F, x: (
        tsystem.fused_ll_available(F.shape[-1], x.shape[-1], F.dtype)))
    monkeypatch.setattr(System, "_blocked_ll_ok", lambda self, F, x: (
        tsystem.blocked_ll_available(F.shape[-1], x.shape[-1], x.shape[-3],
                                     F.dtype)))
    for (m, _, want), x in zip(models, data):
        taken.clear()
        ll = m.log_likelihood(x)
        assert taken == ([f"conditioned_log_likelihood_{want}"] if want
                         else [])
        torch.testing.assert_close(ll, m.log_likelihood(x, method="scan"),
                                   rtol=2e-3, atol=0.2)
    # float64, too many trials and joint dims outside 13..128 stay off it
    assert not kb.blocked_ll_available(65, 2, 20, torch.float64)
    assert not kb.blocked_ll_available(65, 2, 129, torch.float32)
    assert not kb.blocked_ll_available(12, 2, 20, torch.float32)
    assert not kb.blocked_ll_available(129, 2, 20, torch.float32)
    assert not kb.blocked_ll_available(65, 5, 20, torch.float32)
    assert kb.blocked_ll_available(128, 4, 128, torch.float32)


def _delay_data(Nc, n, T):
    """Trials of ``Nc`` delayed actors simulated by the JAX package:
    ``(Nc, n, T+1, 2)``."""
    return np.stack([np.asarray(jmodels.DelayedSubjectiveActor(
        T=T, sigma_target=4.0 + 3.0 * c).simulate(
            random.PRNGKey(c), n=n)[..., :2]) for c in range(Nc)])


def test_delay_potential_names_match_jax(x64):
    x = _delay_data(2, 2, 12)
    jm = jinfer.shared_params_lqg_model(
        jnp.asarray(x), jmodels.DelayedSubjectiveActor,
        shared_params=DELAY_SHARED)
    tm = tinfer.shared_params_lqg_model(
        torch.tensor(x), tmodels.DelayedSubjectiveActor,
        shared_params=DELAY_SHARED)
    assert tinfer.get_model_params(tmodels.DelayedSubjectiveActor) == \
        jinfer.get_model_params(jmodels.DelayedSubjectiveActor)
    assert tm.names == jm.names
    assert set(tm.names) == {"c", "subj_noise", "subj_vel_noise",
                             "sigma_cursor", "action_variability",
                             "sigma_target_0", "sigma_target_1"}
    close(tm.init_unconstrained(), jm.init_unconstrained())


@pytest.mark.parametrize("which", ["shared", "lqg_model"])
def test_delay_potential_value_and_grad_match_jax(which, x64):
    """The slice as a whole: value and gradient of the delay potential for 2
    chains x 2 conditions x 2 trials at T = 40 against ``lqg_tpu.infer`` in
    float64, with the same ``ll_baseline`` on both sides."""
    x = _delay_data(2, 2, 40)
    if which == "shared":
        jm = jinfer.shared_params_lqg_model(
            jnp.asarray(x), jmodels.DelayedSubjectiveActor,
            shared_params=DELAY_SHARED)
        tm = tinfer.shared_params_lqg_model(
            torch.tensor(x), tmodels.DelayedSubjectiveActor,
            shared_params=DELAY_SHARED)
    else:
        jm = jinfer.lqg_model(jnp.asarray(x[0]),
                              jmodels.DelayedSubjectiveActor)
        tm = tinfer.lqg_model(torch.tensor(x[0]),
                              tmodels.DelayedSubjectiveActor)
    jm.ll_baseline = tm.ll_baseline = -150.0
    u0 = np.asarray(jm.init_unconstrained())
    us = u0 + 0.2 * np.random.default_rng(5).normal(size=(2,) + u0.shape)
    u = torch.tensor(us, requires_grad=True)
    pot = tm.potential(u)
    assert pot.shape == (2,)
    (grad,) = torch.autograd.grad(pot.sum(), u)
    jv, jg = jax.jit(jax.vmap(jax.value_and_grad(jm.potential)))(
        jnp.asarray(us))
    close(pot, jv, rtol=1e-9)
    close(grad, jg, rtol=1e-7, atol=1e-8 * float(np.abs(jg).max()))


def test_delay_potential_on_the_blocked_route_matches_float64_scan(
        monkeypatch):
    """The float32 delay potential with the blocked route forced on: the
    ``autograd.Function`` runs the plain K5 and K6 on the CPU, one forward
    and one backward for all chains and conditions at once."""
    x = _delay_data(2, 2, 24)
    m64 = tinfer.shared_params_lqg_model(
        torch.tensor(x), tmodels.DelayedSubjectiveActor,
        shared_params=DELAY_SHARED)
    m32 = tinfer.shared_params_lqg_model(
        torch.tensor(x, dtype=torch.float32), tmodels.DelayedSubjectiveActor,
        shared_params=DELAY_SHARED)
    u0 = m64.init_unconstrained()
    us = u0 + 0.1 * torch.tensor(
        np.random.default_rng(6).normal(size=(2,) + u0.shape))
    u = us.clone().requires_grad_()
    v64 = m64.potential(u)
    (g64,) = torch.autograd.grad(v64.sum(), u)

    monkeypatch.setattr(System, "_blocked_ll_ok", lambda self, F, x: True)
    calls = []
    monkeypatch.setattr(kb, "ll_blocked_fwd", _recording(
        kb.ll_blocked_fwd, calls))
    monkeypatch.setattr(kb, "conditioned_log_likelihood_blocked_vjp",
                        _recording(kb.conditioned_log_likelihood_blocked_vjp,
                                   calls))
    u32 = us.float().requires_grad_()
    v32 = m32.potential(u32)
    (g32,) = torch.autograd.grad(v32.sum(), u32)
    close(v32.double(), v64.detach(), rtol=2e-3)
    close(g32.double(), g64, rtol=2e-2, atol=2e-3 * float(g64.abs().max()))
    assert sorted(calls) == ["conditioned_log_likelihood_blocked_vjp",
                             "ll_blocked_fwd"]


def _recording(fn, calls):
    def wrapped(*args, **kw):
        calls.append(fn.__name__)
        return fn(*args, **kw)
    return wrapped
