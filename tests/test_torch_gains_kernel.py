"""K1, the fused gains kernel of the port.

On the CPU: the plain PyTorch version against the JAX package's Pallas
kernel in interpret mode (float32), at every instance, and the wrapper's
checks, its choice between K1's two designs (thread, block) among them.
On a card (``-m cuda``): the CUDA kernel against the plain version, at the
bench's (2, 1, 2), at the model zoo's (4, 1, 3), (5, 1, 2) and (4, 2, 2),
at the instances added for the delay wrapper and the envelopes at n = 8,
and through the padded route; the block design against the plain version
and against the thread design bit for bit at every instance; and the
probe parameter sets of tests/test_torch_nonfinite.py at a padded shape.  JAX is imported inside the tests
that use it, so that the card's tests collect where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from lqg_tpu_torch.models import (BoundedActor, HandMotionModelTrackingTask,
                                  PointMassBoundedActor,
                                  RelativeObservationBoundedActor,
                                  SubjectiveActor)
from lqg_tpu_torch.models.basic import tracking_spec
from lqg_tpu_torch.ops.kernels import gains as kg
from lqg_tpu_torch.ops.kernels.gains import (fused_gains,
                                             fused_gains_available,
                                             fused_gains_reference)
from lqg_tpu_torch.ops import riccati
from lqg_tpu_torch.ops.linalg import mT

ATOL = 2e-5  # as tests/test_pallas.py holds the Pallas kernel
# at n = 3-4, as tests/test_pallas.py:60 holds it against the scans
ZOO_ATOL = 5e-4

# the models of K1's zoo instances, (n, m, p): name, keyword arguments and
# the action costs of their parameter sets
ZOO = {
    (4, 1, 3): ("PointMassBoundedActor", {}, (0.01, 0.05, 0.3)),
    (5, 1, 2): ("HandMotionModelTrackingTask", {}, (0.3, 1.0, 3.0)),
    (4, 2, 2): ("RelativeObservationBoundedActor", {"dim": 2},
                (0.1, 0.5, 2.0)),
}
_PORT = {"PointMassBoundedActor": PointMassBoundedActor,
         "HandMotionModelTrackingTask": HandMotionModelTrackingTask,
         "RelativeObservationBoundedActor": RelativeObservationBoundedActor,
         "BoundedActor": BoundedActor, "SubjectiveActor": SubjectiveActor}
# each instance's model: name and keyword arguments; its action costs are
# spread over the batch
INSTANCE_MODELS = {
    (2, 1, 2): ("BoundedActor", {}),
    (2, 1, 1): ("RelativeObservationBoundedActor", {}),
    (3, 1, 2): ("SubjectiveActor", {}),
    **{nmp: v[:2] for nmp, v in ZOO.items()},
}


# the instances added for TemporalDelayModel at delays 1-3 (the wrapped
# model and the delay; the point mass at delay 1 is the envelope (8, 1, 3))
# and the other envelopes at n = 8 (None: a random spec with a stable open
# loop), and two shapes padded onto envelopes
SCOPE_MODELS = {(4, 1, 2): ("BoundedActor", 1), (6, 1, 2): ("BoundedActor", 2),
                (8, 1, 2): ("BoundedActor", 3),
                (4, 1, 1): ("RelativeObservationBoundedActor", 1),
                (6, 1, 1): ("RelativeObservationBoundedActor", 2),
                (8, 1, 1): ("RelativeObservationBoundedActor", 3),
                (8, 1, 3): ("PointMassBoundedActor", 1), (8, 2, 1): None,
                (8, 2, 2): None, (8, 2, 3): None, (3, 2, 3): None,
                (7, 1, 3): None}
SCOPE = sorted(SCOPE_MODELS)


def _stable_spec(nmp, B, device="cpu", seed=0):
    """B random stationary specs at ``nmp`` with a stable open loop (A =
    0.9 I + noise), float32."""
    from lqg_tpu_torch.utils import stationary_spec

    n, m, p = nmp
    rng = np.random.default_rng(seed + sum(nmp))
    rnd = lambda *sh: 0.3 * rng.normal(size=sh)
    sym = lambda M: 0.5 * (M + np.swapaxes(M, -1, -2))
    f = dict(A=0.9 * np.eye(n) + 0.1 * rnd(B, n, n), B=rnd(B, n, m) + 0.5,
             Q=sym(np.eye(n) + 0.05 * rnd(B, n, n)),
             R=sym(0.8 * np.eye(m) + 0.01 * np.abs(rnd(B, m, m))),
             F=rnd(B, p, n) + np.eye(p, n),
             V=0.7 * np.eye(n) + 0.05 * rnd(B, n, n),
             W=0.9 * np.eye(p) + 0.05 * rnd(B, p, p),
             Qf=sym(1.5 * np.eye(n) + 0.05 * rnd(B, n, n)))
    t = {k: torch.tensor(v, dtype=torch.float32, device=device)
         for k, v in f.items()}
    return stationary_spec(**{k: t[k] for k in "ABFVWQR"})._replace(
        Qf=t["Qf"])


def _scope_spec(nmp, B, T, device="cpu"):
    """The actor spec of B parameter sets at a scope shape: the delay
    wrapper's model, the action cost spread over the batch, or a stable
    random spec; float32, every field ``(B, ., .)``."""
    from lqg_tpu_torch.models import TemporalDelayModel

    model = SCOPE_MODELS[nmp]
    if model is None:
        return _stable_spec(nmp, B, device)
    name, delay = model
    spec = TemporalDelayModel(_PORT[name](
        T=T, action_cost=torch.tensor(_costs(B), dtype=torch.float32),
        device=device), delay=delay).actor
    return spec._replace(**{k: getattr(spec, k).expand(
        (B,) + getattr(spec, k).shape[-2:]) for k in (
        "A", "B", "F", "V", "W", "Q", "R", "Qf")})


def _zoo_spec(nmp, T, device="cpu"):
    """The port's batched actor spec of a zoo instance, float32."""
    name, kw, costs = ZOO[nmp]
    return _PORT[name](T=T, action_cost=torch.tensor(costs), device=device,
                       **kw).actor


def _costs(B):
    return np.logspace(-1.5, 0.5, B)


def _instance_spec(nmp, B, T, device="cpu"):
    """The port's actor spec of B parameter sets of the instance's model,
    the action cost spread over the batch (at a scope shape,
    :func:`_scope_spec`), float32; and K1's inputs."""
    if nmp in INSTANCE_MODELS:
        name, kw = INSTANCE_MODELS[nmp]
        spec = _PORT[name](T=T, action_cost=torch.tensor(
            _costs(B), dtype=torch.float32), device=device, **kw).actor
    else:
        spec = _scope_spec(nmp, B, T, device)
    VV = spec.V @ mT(spec.V)
    ins = [x.expand((B,) + x.shape[-2:]).contiguous() for x in (
        spec.A, spec.B, spec.Q, spec.R, spec.Qf, spec.F, VV,
        spec.W @ mT(spec.W), VV)]
    return spec, ins


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


@pytest.mark.parametrize("nmp", sorted(ZOO))
def test_reference_matches_pallas_zoo(nmp):
    """The zoo's instances: PointMass (4, 1, 3), Hand (5, 1, 2),
    RelativeObservation(dim=2) (4, 2, 2), each JAX model's actor against
    the port's, three parameter sets, at a horizon the Pallas kernel's time
    chunk does not divide."""
    import jax
    import jax.numpy as jnp
    from lqg_tpu import models as jmodels
    from lqg_tpu.ops.pallas.gains import fused_gains as jfused_gains
    from lqg_tpu.ops.pallas.gains import (
        fused_gains_available as jfused_gains_available)

    T = 41
    name, kw, costs = ZOO[nmp]
    actors = [getattr(jmodels, name)(T=T, action_cost=c, **kw).actor
              for c in costs]
    jspec = jax.tree.map(lambda *a: jnp.stack(a), *actors)
    assert jfused_gains_available(actors[0])
    jout = jfused_gains(jspec, jspec.V @ jnp.swapaxes(jspec.V, -1, -2),
                        horizon=T, time_chunk=10)
    spec = _zoo_spec(nmp, T)
    n, m, p = spec.A.shape[-1], spec.B.shape[-1], spec.F.shape[-2]
    assert (n, m, p) == nmp and fused_gains_available(spec)
    tout = fused_gains_reference(spec, spec.V @ mT(spec.V), T)
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=ZOO_ATOL)


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
    # a gradient goes through the Function, equal to the scans'
    R = spec.R.clone().requires_grad_()
    L, H, K = fused_gains(spec._replace(R=R), S0, 5)
    (g_fused,) = torch.autograd.grad(L[..., 0].sum() + H.sum(), R)
    scan = riccati.backward(spec._replace(R=R), horizon=5, regularize="none")
    (g_scan,) = torch.autograd.grad(scan.L[..., 0].sum() + scan.H.sum(), R)
    assert torch.isfinite(g_fused).all()
    torch.testing.assert_close(g_fused, g_scan, rtol=1e-4, atol=1e-6)
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


@pytest.mark.cuda
@pytest.mark.parametrize("nmp", sorted(ZOO) + SCOPE)
def test_zoo_instances_match_reference_on_card(cuda, nmp):
    """K1 at the zoo's instances, the models' own specs, at the instances
    added for the delay wrapper and the envelopes, and at two shapes padded
    onto envelopes, 3 parameter sets at T=1000 and 96 at a prime T, against
    the plain version at the true shape."""
    for T, reps in ((1000, 1), (719, 32)):
        spec = (_zoo_spec(nmp, T, device=cuda) if nmp in ZOO
                else _scope_spec(nmp, 3, T, device=cuda))
        spec = spec._replace(**{k: torch.cat([getattr(spec, k)] * reps)
                                for k in ("A", "B", "F", "V", "W", "Q", "R",
                                          "Qf")})
        S0 = spec.V @ mT(spec.V)
        before = fused_gains.launches
        out = fused_gains(spec, S0, T)
        ref = fused_gains_reference(spec, S0, T)
        torch.cuda.synchronize()
        assert fused_gains.launches == before + 1
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=ZOO_ATOL)


@pytest.mark.parametrize("nmp", sorted(INSTANCE_MODELS))
@pytest.mark.parametrize("B", [1, 4, 24])
def test_reference_matches_pallas_at_the_main_path_batches(nmp, B):
    """The plain K1 against the Pallas kernel in interpret mode at the
    batches the main path launches K1 at (the forward path's 1, the NUTS
    recovery's 4 chains, the potential's 4 chains x 6 conditions), at every
    instance, T=23 (the Pallas time chunk of 10 does not divide it)."""
    import jax
    import jax.numpy as jnp
    from lqg_tpu import models as jmodels
    from lqg_tpu.ops.pallas.gains import fused_gains as jfused_gains

    T = 23
    name, kw = INSTANCE_MODELS[nmp]
    actors = [getattr(jmodels, name)(T=T, action_cost=float(c), **kw).actor
              for c in np.float32(_costs(B))]
    jspec = jax.tree.map(lambda *a: jnp.stack(a), *actors)
    jout = jfused_gains(jspec, jspec.V @ jnp.swapaxes(jspec.V, -1, -2),
                        horizon=T, time_chunk=10)
    spec, _ = _instance_spec(nmp, B, T)
    assert (spec.A.shape[-1], spec.B.shape[-1], spec.F.shape[-2]) == nmp
    tout = fused_gains_reference(spec, spec.V @ mT(spec.V), T)
    atol = ATOL if nmp[0] == 2 else ZOO_ATOL
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("nmp", sorted(kg.INSTANCES))
@pytest.mark.parametrize("stores", [False, True])
def test_auto_design_is_a_function_of_instance_and_batch(nmp, stores):
    """``design="auto"`` takes the block design below the instance's
    crossover batch and the thread design from it on (never, where the
    table has None), whatever else; the batches the main path launches K1
    at (1, 4, 24) take the block design at every instance."""
    assert set(kg.THREAD_FROM) == kg.INSTANCES
    cross = kg.THREAD_FROM[nmp][int(stores)]
    batches = [1, 4, 24, 132, 264, 528, 1056, 2048, 16384, 2 ** 20]
    if cross is not None:
        assert cross > 24
        batches += [cross - 1, cross, cross + 1]
    for B in batches:
        want = "block" if cross is None or B < cross else "thread"
        assert kg.design_for(*nmp, B, stores) == want
    assert all(kg.design_for(*nmp, B, stores) == "block" for B in (1, 4, 24))


def test_unknown_design_raises():
    _, ins = _instance_spec((2, 1, 2), 2, 5)
    for design in ("warp", "", None, "Block"):
        with pytest.raises(ValueError, match="design"):
            kg.gains_fwd(*ins, 5, design=design)


@pytest.mark.parametrize("design", kg.DESIGNS)
@pytest.mark.parametrize("stores", [False, True])
def test_cpu_takes_the_plain_version_under_every_design(design, stores):
    spec, ins = _instance_spec((4, 2, 2), 3, 7)
    before = (fused_gains.launches, dict(fused_gains.design_launches))
    out = kg.gains_fwd(*ins, 7, stores=stores, design=design)
    ref = fused_gains_reference(spec, ins[-1], 7, stores=stores)
    assert len(out) == len(ref) == (5 if stores else 3)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # no kernel launch on the CPU
    assert (fused_gains.launches, fused_gains.design_launches) == before


class _FakeLib:
    """A stand-in for the built gains library: each entry returns its
    status; entries named in ``missing`` are absent, as from a build that
    lacks them."""

    class _Entry:
        def __init__(self, status, calls, name):
            self.status, self.calls, self.name = status, calls, name

        def __call__(self, *args):
            self.calls.append(self.name)
            return self.status

    def __init__(self, statuses, missing=()):
        self.calls = []
        for name in ("lqg_gains_fwd", "lqg_gains_fwd_block", "lqg_gains_bwd",
                     "lqg_gains_bwd_chunk"):
            if name not in missing:
                status = kg.CHUNK if name.endswith("chunk") else statuses.get(
                    name, 0)
                setattr(self, name, self._Entry(status, self.calls, name))


def _as_if_on_card(monkeypatch, lib):
    """gains_fwd's card path on CPU tensors, with ``lib`` as the library."""
    from lqg_tpu_torch.ops.kernels import nvcc

    monkeypatch.setattr(nvcc, "load", lambda name, part=0: lib)
    monkeypatch.setattr(kg, "_on_card", lambda tensors, what: True)
    monkeypatch.setattr(kg, "_stream", lambda device: 0)
    monkeypatch.setattr(fused_gains, "launches", 0)
    monkeypatch.setattr(fused_gains, "design", None)
    monkeypatch.setattr(fused_gains, "design_launches",
                        {"thread": 0, "block": 0})


def test_block_design_failures_raise(monkeypatch):
    """No fallback: with the block design's entry missing from the library
    or its launch failing, gains_fwd raises and counts no launch; each
    design goes to its own entry."""
    _, ins = _instance_spec((2, 1, 2), 4, 5)
    _as_if_on_card(monkeypatch, _FakeLib({}, missing=("lqg_gains_fwd_block",)))
    for design in ("block", "auto", "thread"):
        with pytest.raises(AttributeError, match="lqg_gains_fwd_block"):
            kg.gains_fwd(*ins, 5, design=design)
    assert fused_gains.launches == 0
    failing = _FakeLib({"lqg_gains_fwd_block": 1})
    _as_if_on_card(monkeypatch, failing)
    for design, stores in (("block", False), ("auto", True)):
        with pytest.raises(RuntimeError, match="block design.*error 1"):
            kg.gains_fwd(*ins, 5, stores=stores, design=design)
    assert fused_gains.launches == 0 and fused_gains.design is None
    assert failing.calls == ["lqg_gains_bwd_chunk", "lqg_gains_fwd_block"] * 2
    ok = _FakeLib({})
    _as_if_on_card(monkeypatch, ok)
    kg.gains_fwd(*ins, 5, design="thread")
    assert fused_gains.design == "thread"
    kg.gains_fwd(*ins, 5, stores=True)  # auto at B=4
    assert fused_gains.design == kg.design_for(2, 1, 2, 4, True)
    assert [c for c in ok.calls if c != "lqg_gains_bwd_chunk"] == [
        "lqg_gains_fwd", {"block": "lqg_gains_fwd_block",
                          "thread": "lqg_gains_fwd"}[fused_gains.design]]
    assert fused_gains.launches == 2
    assert sum(fused_gains.design_launches.values()) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("nmp", sorted(INSTANCE_MODELS) + SCOPE)
def test_block_design_matches_thread_design_bits_on_card(cuda, nmp):
    """The block design gives the thread design's bits, store-free and with
    the stores, at B in {1, 4, 24, 33} and T in {1, 37, 1008}; K2 fed the
    block design's stores gives the bits of K2 fed the thread design's."""
    g = torch.Generator(device=cuda).manual_seed(3)
    for B in (1, 4, 24, 33):
        for T in (1, 37, 1008):
            _, ins = _instance_spec(nmp, B, T, device=cuda)
            for stores in (False, True):
                th = kg.gains_fwd(*ins, T, stores=stores, design="thread")
                assert fused_gains.design == "thread"
                bl = kg.gains_fwd(*ins, T, stores=stores, design="block")
                assert fused_gains.design == "block"
                torch.cuda.synchronize()
                for a, b in zip(th, bl):
                    assert torch.isfinite(a).all()
                    assert torch.equal(a, b)
            cots = [0.3 * torch.randn(x.shape, generator=g, device=cuda)
                    for x in th[:3]]
            A, Bm, _, R, _, F, VV, WW, _ = ins
            k2 = [kg.fused_gains_vjp(A, Bm, R, F, VV, WW, *out[3:], *cots)
                  for out in (th, bl)]
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(*k2))


@pytest.mark.cuda
@pytest.mark.parametrize("nmp", sorted(INSTANCE_MODELS))
def test_block_design_matches_reference_on_card(cuda, nmp):
    """The block design against the plain version, K1's tolerances, at the
    potential's batch and T=1008, and at 96 sets, T=719."""
    atol = ATOL if nmp[0] == 2 else ZOO_ATOL
    for B, T in ((24, 1008), (96, 719)):
        spec, ins = _instance_spec(nmp, B, T, device=cuda)
        out = kg.gains_fwd(*ins, T, stores=True, design="block")
        ref = fused_gains_reference(spec, ins[-1], T, stores=True)
        torch.cuda.synchronize()
        for a, b in zip(out[:3], ref[:3]):
            torch.testing.assert_close(a, b, rtol=0, atol=atol)
        for a, b in zip(out[3:], ref[3:]):  # the stores, at K2's tolerance
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)


# the probe parameter sets of tests/test_torch_nonfinite.py, and the
# default bounded actor last
PROBES = [dict(action_cost=float("nan")), dict(sigma_target=float("inf")),
          dict(action_variability=1e-300, sigma_target=1e-300,
               sigma_cursor=1e-300),
          dict(action_cost=-1.0), {}]


def probe_gains_inputs(n=7, device="cpu"):
    """K1's nine inputs for the probe bounded actors, (2, 1, 2), padded by
    hand with zeros to n states: at n = 7, a shape that K1 and K2 pad once
    more, onto (8, 1, 2).  The real block is the bounded actor's."""
    specs = [BoundedActor(T=8, **p, device="cpu").actor for p in PROBES]
    fields = [torch.stack([getattr(s, k) for s in specs])
              for k in ("A", "B", "Q", "R", "Qf", "F", "V", "W")]
    A, Bm, Q, R, Qf, F, V, W = fields
    VV, WW = V @ mT(V), W @ mT(W)
    grow = kg._grow
    return [x.to(device) for x in (
        grow(A, n, n), grow(Bm, n, 1), grow(Q, n, n), R, grow(Qf, n, n),
        grow(F, 2, n), grow(VV, n, n), WW, grow(VV, n, n))]


@pytest.mark.cuda
def test_probe_nans_stay_in_their_particle_on_card(cuda):
    """The probe parameter sets at a padded shape, (7, 1, 2) onto (8, 1,
    2): K1 (with the stores) and K2 give NaN exactly where their plain
    versions give NaN on the same inputs (where lqg_tpu's kernels do,
    tests/test_torch_kernel_scope.py), and the default actor, launched
    beside them, gives the bits of its launch alone: no NaN leaks from one
    particle into another."""
    T = 37
    ins_cpu = probe_gains_inputs()
    ins = [x.to(cuda) for x in ins_cpu]
    out = kg.gains_fwd(*ins, T, stores=True)
    alone = kg.gains_fwd(*(x[-1:] for x in ins), T, stores=True)
    want = kg.gains_fwd(*ins_cpu, T, stores=True)
    g = torch.Generator().manual_seed(0)
    cots = [0.3 * torch.randn(x.shape, generator=g) for x in want[:3]]
    A, Bm, _, R, _, F, VV, WW, _ = ins
    vjp_ins = (A, Bm, R, F, VV, WW)
    got = kg.fused_gains_vjp(*vjp_ins, *out[3:], *(c.to(cuda) for c in cots))
    got_alone = kg.fused_gains_vjp(*(x[-1:] for x in vjp_ins),
                                   *(x[:, -1:] for x in alone[3:]),
                                   *(c[:, -1:].to(cuda) for c in cots))
    A, Bm, _, R, _, F, VV, WW, _ = ins_cpu
    want_vjp = kg.fused_gains_vjp(A, Bm, R, F, VV, WW, *want[3:], *cots)
    torch.cuda.synchronize()
    for a, b, one in zip(out, want, alone):  # (T, B, ., .)
        assert torch.equal(torch.isnan(a.cpu()), torch.isnan(b))
        assert torch.isfinite(a[:, -1]).all()
        assert torch.equal(a[:, -1:], one)
    for a, b, one in zip(got, want_vjp, got_alone):  # (B, ., .)
        assert torch.equal(torch.isnan(a.cpu()), torch.isnan(b))
        assert torch.isfinite(a[-1]).all()
        assert torch.equal(a[-1:], one)

