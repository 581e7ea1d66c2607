"""The joint-system kernels of the port (``ops/kernels/joint.py``,
``csrc/joint.cu``).

On the CPU: ``joint_fq`` (its plain version) against
``gaussian.joint_system`` with ``G G^T`` and the time axis moved, values and
gradients, in float64, at every model that takes the kernels' route in the
benchmark and beyond (the spec matrices with a parameter-set axis and
shared by every set); the dispatch rule of ``System.log_likelihood``; NaN
gains.  On a card (``-m cuda``): the kernels, through ``joint_fq`` and
autograd, against the plain version and its autograd in float64 at the
benchmark cells' models and shapes and at the padded instances, the
adjoint's skipped outputs, two launches bit for bit, and the launches of
one captured value+grad.  No JAX: the card's tests collect where JAX is not
installed.
"""

import numpy as np
import pytest
import torch

from lqg_tpu_torch import models as tmodels
from lqg_tpu_torch.ops import gaussian
from lqg_tpu_torch.ops.kernels import joint as kj
from lqg_tpu_torch.ops.linalg import mT
from lqg_tpu_torch.system import System
from lqg_tpu_torch.utils import time_stack_spec

T = 23
P = 3
F64 = dict(device="cpu", dtype=torch.float64)


def _delayed(base, delay):
    return lambda **kw: tmodels.TemporalDelayModel(base(**kw), delay)


# models by the instance they launch; the last three are padded onto one
MODELS = {
    "bounded": tmodels.BoundedActor,
    "subjective": tmodels.SubjectiveActor,
    "bounded_delay1": _delayed(tmodels.BoundedActor, 1),
    "bounded_delay2": _delayed(tmodels.BoundedActor, 2),
    "hand": tmodels.HandMotionModelTrackingTask,
    "bounded_dim2": lambda **kw: tmodels.BoundedActor(dim=2, **kw),
    "subjective_dim2": lambda **kw: tmodels.SubjectiveActor(dim=2, **kw),
    "bounded_dim3": lambda **kw: tmodels.BoundedActor(dim=3, **kw),
    "point_mass": tmodels.PointMassBoundedActor,
    "relative_obs": tmodels.RelativeObservationBoundedActor,
    "relative_obs_delay2": _delayed(tmodels.RelativeObservationBoundedActor,
                                    2),
}


def _sets(name, sets=True, **dtype):
    """The model at P parameter sets (action costs apart) or, unbatched, at
    its defaults."""
    kw = dict(T=T, device="cpu", **(dtype or dict(dtype=torch.float64)))
    if sets:
        kw["action_cost"] = torch.tensor([0.3, 1.0, 2.5], **{
            k: v for k, v in kw.items() if k in ("device", "dtype")})
    return MODELS[name](**kw)


def _gains(m):
    """L (T, P, m, na), K (T, P, na, p) of a model, by the scans."""
    gains, K = m.gains(method="scan")
    return gains.L, K


def _leaf_specs(name, sets):
    """The model's dynamics and actor, with a P axis or shared by every set,
    each of the eight matrices the joint system reads a leaf of its own, so
    that each gets its own gradient."""
    m = _sets(name, sets)
    leaf = lambda x: x.detach().clone().requires_grad_()
    dyn = m.dynamics._replace(**{k: leaf(getattr(m.dynamics, k))
                                 for k in "ABFVW"})
    act = m.actor._replace(**{k: leaf(getattr(m.actor, k)) for k in "ABF"})
    return dyn, act


def _old_route(dyn, act, L, K):
    """What ``System.log_likelihood`` assembled before the kernels: ``F``,
    ``G G^T``, time axis second."""
    joint = gaussian.joint_system(dyn, act, L, K, T)
    return (torch.movedim(joint.F, 0, 1),
            torch.movedim(joint.G @ mT(joint.G), 0, 1))


CASES = [(name, sets) for name in MODELS for sets in (True, False)]
CASE_IDS = [f"{n}-{'sets' if s else 'shared'}" for n, s in CASES]


@pytest.mark.parametrize("name,sets", CASES, ids=CASE_IDS)
def test_plain_joint_fq_matches_joint_system(name, sets):
    """F and Q of the plain version equal ``joint_system`` + ``G G^T`` +
    the move of the time axis in float64, with the spec matrices per set
    and shared by every set, at 1e-12 of each output's largest entry."""
    m = _sets(name)
    L, K = _gains(m)
    dyn, act = _leaf_specs(name, sets)
    F, Q = kj.joint_fq(dyn, act, L, K, T)
    F0, Q0 = _old_route(dyn, act, L, K)
    assert F.shape == F0.shape == (P, T, m.xdim + m.bdim, m.xdim + m.bdim)
    assert F.is_contiguous() and Q.is_contiguous()
    for got, want in ((F, F0), (Q, Q0)):
        torch.testing.assert_close(got, want, rtol=1e-12,
                                   atol=1e-12 * float(want.detach().abs().max()))
    assert torch.equal(Q, mT(Q))  # exactly symmetric


@pytest.mark.parametrize("name,sets", CASES, ids=CASE_IDS)
def test_plain_adjoint_matches_autograd(name, sets):
    """The gradients of L, K and of the eight spec matrices (summed over
    the steps, and over the sets where a matrix is shared) through
    ``joint_fq`` (the plain adjoint) equal autograd through the old
    assembly, in float64."""
    m = _sets(name)
    L, K = (x.detach().requires_grad_() for x in _gains(m))
    dyn, act = _leaf_specs(name, sets)
    leaves = [L, K, dyn.A, dyn.B, dyn.F, dyn.V, dyn.W, act.A, act.B, act.F]
    g = torch.Generator().manual_seed(7)
    j = m.xdim + m.bdim
    Fbar, Qbar = (torch.randn((P, T, j, j), generator=g, **F64)
                  for _ in range(2))

    def grads(F, Q):
        return torch.autograd.grad((F * Fbar).sum() + (Q * Qbar).sum(),
                                   leaves)

    got = grads(*kj.joint_fq(dyn, act, L, K, T))
    want = grads(*_old_route(dyn, act, L, K))
    for gg, ww in zip(got, want):
        assert gg.shape == ww.shape
        torch.testing.assert_close(gg, ww, rtol=1e-12,
                                   atol=1e-12 * float(ww.abs().max()))


def test_launchers_take_cuda_tensors_only():
    """``joint_fwd`` and ``joint_fq_vjp`` launch the kernels and raise on
    CPU tensors; ``joint_fq`` takes the plain version there."""
    m = _sets("bounded", dtype=torch.float32)
    L, K = _gains(m)
    mats = kj._spec_mats(m.dynamics, m.actor)
    ones = torch.ones((P, T, 4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        kj.joint_fwd(mats, L, K)
    with pytest.raises(ValueError, match="CUDA"):
        kj.joint_fq_vjp(mats, L, K, ones, ones)
    F, Q = kj.joint_fq(m.dynamics, m.actor, L, K, T)
    assert F.shape == Q.shape == (P, T, 4, 4)


def test_instances_hold_every_model_in_scope():
    """Every model at j <= 12 of the zoo has an instance (padded where its
    dims are not one); the delay wrapper at delay 3 and the delayed
    subjective actor (j > 12) have none and keep the old assembly."""
    for name in MODELS:
        m = _sets(name, sets=False, dtype=torch.float32)
        dims = kj.spec_dims(m.dynamics, m.actor)
        assert kj.joint_fq_available(dims, torch.float32), name
        assert not kj.joint_fq_available(dims, torch.float64), name
    assert kj.instance_for((2, 2, 1, 1, 2, 1)) == (2, 2, 1, 2, 2, 2)
    assert kj.instance_for((4, 4, 1, 3, 4, 3)) == (4, 4, 2, 4, 4, 4)
    for m in (tmodels.TemporalDelayModel(tmodels.BoundedActor(T=T, device="cpu"), 3),
              tmodels.DelayedSubjectiveActor(T=T, device="cpu")):
        assert not kj.joint_fq_available(kj.spec_dims(m.dynamics, m.actor),
                                         torch.float32)


class _OnCard:
    """A stand-in for gains on the card: what the dispatch rule reads."""

    def __init__(self, x):
        self.device, self.dtype = torch.device("cuda"), x.dtype
        self._dim = x.dim()

    def dim(self):
        return self._dim


def _rule(m, on_card=True):
    L, K = _gains(m)
    if on_card:
        L, K = _OnCard(L), _OnCard(K)
    return m._joint_fq_ok(L, K)


@pytest.mark.parametrize("case", [
    "bounded", "subjective", "bounded_delay2", "unbatched",
    "stacked", "j_above_12", "float64", "cpu"])
def test_dispatch_rule(case):
    """``System.log_likelihood`` assembles with the kernels where the gains
    are on the card, float32, both specs stationary, j <= 12; the old
    assembly for a stacked spec, j > 12, float64 and the CPU."""
    f32 = dict(dtype=torch.float32)
    if case in ("bounded", "subjective", "bounded_delay2"):
        assert _rule(_sets(case, **f32))
    elif case == "unbatched":
        assert _rule(_sets("bounded", sets=False, **f32))
    elif case == "stacked":
        a = tmodels.BoundedActor(T=T, device="cpu").actor
        stacked = time_stack_spec(a.A, a.B, a.F, a.V, a.W, a.Q, a.R, T)
        assert not _rule(System(stacked, stacked, horizon=T))
        assert not _rule(System(a, stacked, horizon=T))
    elif case == "j_above_12":
        assert not _rule(tmodels.TemporalDelayModel(
            tmodels.SubjectiveActor(T=T, device="cpu"), 2))  # j = 15
        assert not _rule(tmodels.TemporalDelayModel(
            tmodels.BoundedActor(T=T, device="cpu"), 3))  # j = 16
    elif case == "float64":
        assert not _rule(_sets("bounded"))
    else:
        assert not _rule(_sets("bounded", **f32), on_card=False)


@pytest.mark.parametrize("batch", ["sets", "unbatched"])
def test_log_likelihood_route_through_joint_fq(monkeypatch, batch):
    """With the dispatch rule forced on the CPU, the kernel route's
    likelihood and gradient through ``joint_fq`` (plain versions) equal the
    old assembly's in float64, batched and unbatched; unforced, the CPU
    never calls it."""
    import lqg_tpu_torch.system as sysm

    calls = []
    real = sysm.joint_fq
    monkeypatch.setattr(sysm, "joint_fq",
                        lambda *a: calls.append(1) or real(*a))
    x = _sets("bounded", sets=False).simulate(
        torch.Generator().manual_seed(3), n=4)[..., :2]
    noise = torch.tensor([4.0, 6.0, 9.0][:1 if batch == "unbatched" else 3],
                         **F64).requires_grad_()

    def ll():
        m = tmodels.BoundedActor(
            T=T, sigma_target=noise[0] if batch == "unbatched" else noise,
            **F64)
        out = m.log_likelihood(x, method="fused")
        return out, torch.autograd.grad(out.sum(), noise)[0]

    ll0, g0 = ll()
    assert not calls
    monkeypatch.setattr(System, "_joint_fq_ok", lambda self, L, K: True)
    ll1, g1 = ll()
    assert len(calls) == 1
    assert ll1.shape == ll0.shape == ((4,) if batch == "unbatched" else (3, 4))
    torch.testing.assert_close(ll1, ll0, rtol=1e-12, atol=0.0)
    torch.testing.assert_close(g1, g0, rtol=1e-10, atol=0.0)


@pytest.mark.parametrize("params", [
    dict(action_cost=float("nan")),
    dict(sigma_target=float("inf")),
    dict(action_variability=1e-300, sigma_target=1e-300, sigma_cursor=1e-300),
    dict(action_cost=-1.0)], ids=["action_cost_nan", "sigma_target_inf",
                                  "noise_1e-300", "action_cost_negative"])
def test_nan_gains_give_nan_where_joint_system_does(params):
    """At the probe sets of ``test_torch_nonfinite.py``, beside a sound
    set: every entry of F and Q the old assembly leaves NaN is NaN, and
    the finite ones agree."""
    vals = {k: torch.tensor([v, 1.0 if k == "action_cost" else 6.0], **F64)
            for k, v in params.items()}
    m = tmodels.BoundedActor(T=T, device="cpu", dtype=torch.float64, **vals)
    L, K = _gains(m)
    F, Q = kj.joint_fq(m.dynamics, m.actor, L, K, T)
    for got, want in zip((F, Q), _old_route(m.dynamics, m.actor, L, K)):
        nan = torch.isnan(want)
        assert torch.isnan(got[nan]).all()
        finite = torch.isfinite(want)
        torch.testing.assert_close(got[finite], want[finite], rtol=1e-12,
                                   atol=1e-12)
        assert torch.isfinite(got[1]).all()  # the sound set


# --- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


EPS32 = float(np.finfo(np.float32).eps)
# the benchmark cells' models and parameter sets (vg1 and MAP at 6, nuts4 at
# 24, vg16 at 96), then the other instances at 6 sets and the padded ones
CARD_CASES = [("bounded", 6), ("bounded", 24), ("bounded", 96),
              ("subjective", 6), ("bounded_delay1", 6), ("bounded_delay2", 6),
              ("hand", 6), ("bounded_dim2", 6), ("subjective_dim2", 6),
              ("bounded_dim3", 6), ("point_mass", 6), ("relative_obs", 6),
              ("relative_obs_delay2", 6)]


def _card_inputs(name, sets, cuda, T_=1008):
    """The model at ``sets`` parameter sets around its defaults (float32),
    the gains K1 or the scans give them, and cotangents of F and Q."""
    g = torch.Generator().manual_seed(sets)
    cost = torch.exp(torch.randn(sets, generator=g) * 0.5)
    noise = 6.0 * torch.exp(torch.randn(sets, generator=g) * 0.3)
    kw = {"sigma" if name.startswith("relative") else "sigma_cursor":
          noise.to(cuda)}
    m = MODELS[name](T=T_, device=cuda, action_cost=cost.to(cuda), **kw)
    gains, K = m.gains()
    j = m.xdim + m.bdim
    Fbar, Qbar = (torch.randn((sets, T_, j, j), generator=g).to(cuda)
                  for _ in range(2))
    return m, gains.L.contiguous(), K.contiguous(), Fbar, Qbar


def _joint_grads(fn, m, L, K, Fbar, Qbar, cast=lambda k, x: x):
    """F, Q of ``fn`` (``joint_fq`` or its plain version) and the gradients
    of ``<F, F-bar> + <Q, Q-bar>`` with respect to L, K and the eight spec
    matrices, each input ``cast(name, x)`` and made a leaf of its own."""
    leaf = lambda k, x: cast(k, x).detach().clone().requires_grad_()
    dyn = m.dynamics._replace(**{k: leaf("d" + k, getattr(m.dynamics, k))
                                 for k in "ABFVW"})
    act = m.actor._replace(**{k: leaf("a" + k, getattr(m.actor, k))
                              for k in "ABF"})
    L, K = leaf("L", L), leaf("K", K)
    leaves = [L, K, dyn.A, dyn.B, dyn.F, dyn.V, dyn.W, act.A, act.B, act.F]
    F, Q = fn(dyn, act, L, K, L.shape[0])
    grads = torch.autograd.grad(
        (F * cast("F", Fbar)).sum() + (Q * cast("Q", Qbar)).sum(), leaves)
    return [F.detach(), Q.detach(), *grads]


def _f64(k, x):
    return x.double()


def _magnitudes(k, x):
    """The inputs of the bound: absolute values, the actor's F negated.
    F_a enters the joint system only with a minus sign, so every term of
    each output, and of each gradient (summed over t), then adds with one
    sign: the outputs' absolute values are the sums of their terms'."""
    return -x.double().abs() if k == "aF" else x.double().abs()


def _tol(bound, depth):
    """The bound on a float32 result from float32 inputs: ``depth``
    roundings of the largest partial sum, at most the largest entry of the
    same computation on the terms' magnitudes, in float32 ulps."""
    return depth * EPS32 * float(bound.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name,sets", CARD_CASES,
                         ids=[f"{n}-{s}" for n, s in CARD_CASES])
def test_kernels_match_plain_on_card(cuda, name, sets):
    """F, Q and the gradients of L, K and of the eight spec matrices
    through ``joint_fq`` (the kernels; padded where the model's dims are
    not an instance) against the plain version and its autograd in float64
    on the same float32 inputs, at T = 1008.  Tolerance of each output: 4
    (j + 8) float32 ulps of the largest entry of the same computation on the
    terms' magnitudes (every product and partial sum is below it; j + 8
    bounds the roundings of an entry: a dot product j deep, the per-set
    products, and for the spec gradients the fold over T in the threads and
    the 8-level tree of the block)."""
    m, L, K, Fbar, Qbar = _card_inputs(name, sets, cuda)
    dims = kj.spec_dims(m.dynamics, m.actor)
    assert (kj.instance_for(dims) == dims) == (
        name not in ("point_mass", "relative_obs", "relative_obs_delay2"))
    before = (kj.joint_fq.launches, kj.joint_fq_vjp.launches)
    got = _joint_grads(kj.joint_fq, m, L, K, Fbar, Qbar)
    assert (kj.joint_fq.launches, kj.joint_fq_vjp.launches) == (
        before[0] + 1, before[1] + 1)
    want = _joint_grads(kj.joint_fq_reference, m, L, K, Fbar, Qbar, _f64)
    bound = _joint_grads(kj.joint_fq_reference, m, L, K, Fbar, Qbar,
                         _magnitudes)
    depth = 4 * (m.xdim + m.bdim + 8)
    for gg, w, b in zip(got, want, bound):
        assert gg.shape == w.shape and gg.dtype == torch.float32
        torch.testing.assert_close(gg.double(), w, rtol=0.0,
                                   atol=_tol(b, depth))
    assert torch.equal(got[1], mT(got[1]))


@pytest.mark.cuda
def test_adjoint_skips_what_is_not_needed(cuda):
    """``needs`` false leaves an output None (the benchmark's A, B, F are
    constants); the others are the full adjoint's, bit for bit."""
    m, L, K, Fbar, Qbar = _card_inputs("bounded", 24, cuda)
    mats = kj._spec_mats(m.dynamics, m.actor)
    needs = [True, True, False, False, False, True, True, False, False, False]
    part = kj.joint_fq_vjp(mats, L, K, Fbar, Qbar, needs)
    full = kj.joint_fq_vjp(mats, L, K, Fbar, Qbar)
    for p_, f_, need in zip(part, full, needs):
        assert (p_ is None) != need
        if need:
            assert torch.equal(p_, f_)


@pytest.mark.cuda
@pytest.mark.parametrize("name,sets", [("bounded", 96), ("subjective", 6)])
def test_two_launches_give_the_same_bits_on_card(cuda, name, sets):
    m, L, K, Fbar, Qbar = _card_inputs(name, sets, cuda)
    mats = kj._spec_mats(m.dynamics, m.actor)
    a = kj.joint_fwd(mats, L, K) + kj.joint_fq_vjp(mats, L, K, Fbar, Qbar)
    b = kj.joint_fwd(mats, L, K) + kj.joint_fq_vjp(mats, L, K, Fbar, Qbar)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["BoundedActor", "SubjectiveActor"])
def test_captured_value_and_grad_launches_each_kernel_once(cuda, model):
    """One value+grad of the fit's potential launches the forward and the
    adjoint kernel once each: eagerly the counters rise by one each; a
    CUDA graph's construction by three (two warm-ups, the capture) and its
    replays by none, and the profiler finds each kernel once in a replay.
    The replay gives the eager value and gradient."""
    from lqg_tpu_torch.infer.capture import (GraphedValueAndGrad,
                                             eager_value_and_grad)
    from lqg_tpu_torch.infer.models import shared_params_lqg_model

    cls = getattr(tmodels, model)
    x = torch.stack([cls(T=200, device=cuda, sigma_target=s).simulate(
        torch.Generator(device=cuda).manual_seed(k), n=5)[..., :2]
        for k, s in enumerate((4.0, 8.0))])
    pm = shared_params_lqg_model(x, cls, shared_params=["action_cost"])
    u = pm.init_unconstrained()[None].expand(3, -1).contiguous()
    count = lambda: (kj.joint_fq.launches, kj.joint_fq_vjp.launches)
    before = count()
    eager = eager_value_and_grad(pm.potential)
    pe_e, grad_e = eager(u)
    assert count() == (before[0] + 1, before[1] + 1)
    graphed = GraphedValueAndGrad(pm.potential, u)
    assert count() == (before[0] + 4, before[1] + 4)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        pe_g, grad_g = graphed(u)
        torch.cuda.synchronize()
    assert count() == (before[0] + 4, before[1] + 4)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    for kernel in ("joint_fwd", "joint_bwd"):
        assert sum(kernel in n for n in names) == 1, (kernel, names)
    torch.testing.assert_close(pe_g, pe_e, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(grad_g, grad_e, rtol=1e-6,
                               atol=1e-6 * float(grad_e.abs().max()))
