"""The scope of K1-K4 in the port against that of lqg_tpu's Pallas kernels.

lqg_tpu runs its fused gains kernels for any stationary spec with n <= 8,
m <= 2, p <= 3 (``lqg_tpu/ops/pallas/gains.py:621-630``) and its fused
likelihood kernels for any float32 (j, d) with j <= 12, d <= 4
(``lqg_tpu/ops/pallas/likelihood.py:456-460``).  The port builds its CUDA
templates at a set of instances and pads every other shape in scope with
zeros onto one of them.  On the CPU: the port's scope checks against JAX's
over a grid; the plain versions against the Pallas kernels in interpret
mode at the delay paths' instances and on the padded route; the padded
route against the unpadded plain computation in float64; the probe
parameter sets of tests/test_torch_nonfinite.py through the padded route;
and ``method="fused"`` of the delay models, which raised before these
instances came, against lqg_tpu's.

Interpret mode unrolls the Pallas kernels' scalar algebra, so its cost
grows steeply with the shape: on one CPU core K1 took 16-22 s at n = 8, K2
218 s at (8, 2, 3), K3 and K4 together 150-260 s at j = 12.  So the Pallas
comparisons run at the instances of the delay paths at delays 1-2 ((4, 1,
2), (6, 1, 2); (12, 2) through ``log_likelihood``) and at padded shapes,
where the Pallas kernel runs at the true (small) shape and the port at the
envelope ((3, 2, 3) onto (8, 2, 3); (3, 1) and (6, 3) onto (12, 1) and
(12, 3)); every instance runs against its plain version on the card
(tests/test_torch_gains_kernel.py, tests/test_torch_likelihood_kernel.py,
chip_smoke.py's phase 20).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqg_tpu import models as jmodels
from lqg_tpu.ops.pallas import gains as jg
from lqg_tpu.ops.pallas import likelihood as jl
from lqg_tpu.utils import stationary_spec as jstationary_spec
from lqg_tpu_torch import models as tmodels
from lqg_tpu_torch.ops.kernels import gains as kg
from lqg_tpu_torch.ops.kernels import likelihood as kl
from lqg_tpu_torch.ops.kernels import nvcc
from lqg_tpu_torch.ops.linalg import mT
from lqg_tpu_torch.utils import stationary_spec

GAINS_ATOL = 5e-4  # K1 at n >= 3, as tests/test_pallas.py:60
ADJ_TOL = dict(rtol=1e-3, atol=1e-4)  # K2, tests/test_pallas.py:370-371
LL_TOL = dict(rtol=2e-4, atol=2e-3)  # K3, tests/test_pallas.py
FQ_TOL = dict(rtol=1e-2, atol=1e-3)  # K4, tests/test_pallas.py:206-210
X_TOL = dict(rtol=1e-2, atol=1e-4)  # K4's data, tests/test_pallas.py:228
FIELDS = ("A", "B", "Q", "R", "Qf", "F", "V", "W")

# two padded shapes of each pair of kernels
PADDED_GAINS = [(3, 2, 3), (7, 1, 3)]
PADDED_LL = [(6, 3), (3, 1)]
# the delay paths' gains instances: (base model, delay)
DELAY_GAINS = {(4, 1, 2): ("BoundedActor", 1), (6, 1, 2): ("BoundedActor", 2)}
# the shapes of the Pallas comparisons (see above)
PALLAS_K1 = [(4, 1, 2), (6, 1, 2), (3, 2, 3)]
PALLAS_K2 = [(4, 1, 2), (3, 2, 3)]
PALLAS_LL = [(3, 1), (6, 3)]


@pytest.fixture(autouse=True)
def one_thread():
    """Many small ops on the CPU: one intra-op thread, so that the pool
    does not cost more than the work."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_fields(seed, B, n, m, p, k_v=None, k_w=None, a=1.0):
    """numpy fields of B random stationary specs (tests/test_pallas.py's
    ``_random_spec``, with ``a`` I + noise for A), with a separate terminal
    cost; V is (n, k_v) and W (p, k_w), square by default."""
    rng = np.random.default_rng(seed)
    rnd = lambda *sh: 0.3 * rng.normal(size=sh)
    sym = lambda M: 0.5 * (M + np.swapaxes(M, -1, -2))
    k_v, k_w = k_v or n, k_w or p
    return dict(
        A=np.eye(n) * a + 0.1 * rnd(B, n, n), B=rnd(B, n, m) + 0.5,
        Q=sym(np.eye(n) + 0.05 * rnd(B, n, n)),
        R=sym(np.eye(m) * 0.8 + 0.01 * np.abs(rnd(B, m, m))),
        F=rnd(B, p, n) + np.eye(p, n),
        V=np.eye(n, k_v) * 0.7 + 0.05 * rnd(B, n, k_v),
        W=np.eye(p, k_w) * 0.9 + 0.05 * rnd(B, p, k_w),
        Qf=sym(np.eye(n) * 1.5 + 0.05 * rnd(B, n, n)))


def _delay_fields(nmp, B):
    """numpy fields of the delay wrapper's actor at ``nmp``, B action costs,
    built in float64 by the port."""
    base, delay = DELAY_GAINS[nmp]
    costs = torch.tensor(np.logspace(-1.0, 0.5, B), dtype=torch.float64)
    actor = tmodels.TemporalDelayModel(getattr(tmodels, base)(
        T=10, action_cost=costs, device="cpu", dtype=torch.float64),
        delay=delay).actor
    return {k: getattr(actor, k).expand((B,) + getattr(actor, k).shape[-2:])
            .numpy().copy() for k in FIELDS}


def _fields(nmp, B=3):
    """The delay wrapper's actor at the delay paths' instances, else random
    specs whose open loop is stable (A = 0.9 I + noise): at m = 2 the
    Pallas kernel does not project its Riccati carry onto symmetric
    matrices where the port does (ROADMAP, Queue 3), and where the open
    loop is unstable the two carries' rounding parts by more than
    float32's."""
    return (_delay_fields(nmp, B) if nmp in DELAY_GAINS
            else _random_fields(sum(nmp), B, *nmp, a=0.9))


def _specs(f, dtype=np.float32):
    """(JAX spec, port spec) of numpy fields ``f``."""
    j = {k: jnp.asarray(v.astype(dtype)) for k, v in f.items()}
    t = {k: torch.tensor(v.astype(dtype)) for k, v in f.items()}
    jspec = jstationary_spec(**{k: j[k] for k in "ABFVWQR"})
    spec = stationary_spec(**{k: t[k] for k in "ABFVWQR"})
    return jspec._replace(Qf=j["Qf"]), spec._replace(Qf=t["Qf"])


# --- the scope checks ---


@pytest.mark.parametrize("n", range(1, 10))
def test_gains_scope_is_jax(n):
    """Over m 1-3 x p 1-4, with square and non-square noise scales, and
    stacked (time-varying) specs: the port's ``fused_gains_available`` is
    JAX's."""
    for m in range(1, 4):
        for p in range(1, 5):
            for k_v, k_w in ((None, None), (n + 1, None), (None, p + 1)):
                f = _random_fields(n + m + p, 1, n, m, p, k_v, k_w)
                jspec, spec = _specs({k: v[0] for k, v in f.items()})
                want = jg.fused_gains_available(jspec)
                assert kg.fused_gains_available(spec) == want, (n, m, p,
                                                                k_v, k_w)
                if want:
                    assert kg.instance_for(n, m, p) in kg.INSTANCES
            stacked = jspec._replace(A=jnp.stack([jspec.A] * 2))
            tstacked = spec._replace(A=torch.stack([spec.A] * 2))
            assert (kg.fused_gains_available(tstacked)
                    == jg.fused_gains_available(stacked) == False)


@pytest.mark.parametrize("j", range(1, 15))
def test_likelihood_scope_is_jax(j):
    """Over d 1-5, float32 and float64: the port's ``fused_ll_available`` is
    JAX's, and every (j, d) in scope has an instance to launch."""
    for d in range(1, 6):
        for tdt, jdt in ((torch.float32, jnp.float32),
                         (torch.float64, jnp.float64)):
            want = jl.fused_ll_available(j, d, jdt)
            assert kl.fused_ll_available(j, d, tdt) == want, (j, d, tdt)
        if jl.fused_ll_available(j, d, jnp.float32):
            J, D = kl.instance_for(j, d)
            assert (J, D) in kl.INSTANCES and J >= j and D == d


def test_instances_are_the_sources():
    """Each part's instances in the wrappers' tables are those its source
    dispatches, and nvcc builds every part."""
    import os
    import re

    for name, table, dims in (("gains", kg.PART, 3), ("likelihood", kl.PART,
                                                     2)):
        with open(os.path.join(nvcc.CSRC, f"{name}.cu")) as f:
            src = f.read()
        assert nvcc.PARTS[name] == max(table.values()) + 1
        for part in range(nvcc.PARTS[name]):
            body = re.search(rf"LQG_PART == {part}\n(.*?)#(?:elif|else)", src,
                             re.S).group(1)
            got = {tuple(int(v) for v in t) for t in re.findall(
                r"fn\((?:Dims|JD)<" + ", ".join([r"(\d+)"] * dims) + r">",
                body)}
            assert got == {k for k, v in table.items() if v == part}, (name,
                                                                      part)
    # every (m, p) of the scope has an envelope at n = 8, every d one at 12
    assert all((8, m, p) in kg.INSTANCES for m in (1, 2) for p in (1, 2, 3))
    assert all((12, d) in kl.INSTANCES for d in range(1, 5))
    # the shapes already built are never padded
    assert all(kg.instance_for(*k) == k for k in kg.INSTANCES)
    assert all(kl.instance_for(*k) == k for k in kl.INSTANCES)
    assert kg.instance_for(3, 2, 3) == (8, 2, 3)
    assert kg.instance_for(7, 1, 3) == (8, 1, 3)
    assert kg.instance_for(9, 1, 2) is None
    assert kl.instance_for(6, 3) == (12, 3) and kl.instance_for(3, 1) == (12, 1)
    assert kl.instance_for(9, 4) == (10, 4) and kl.instance_for(13, 2) is None


def test_errors_name_the_scope():
    f = _random_fields(1, 2, 9, 1, 2)
    spec = _specs(f)[1]
    with pytest.raises(ValueError, match=r"n <= 8, m <= 2, p <= 3"):
        kg.fused_gains(spec._replace(zero_affine=True),
                       spec.V @ mT(spec.V), 4)
    F = torch.zeros(1, 3, 13, 13)
    with pytest.raises(ValueError, match=r"j <= 12 and d <= 4"):
        kl.conditioned_log_likelihood_fused(F, F, torch.zeros(1, 2, 4, 2))


# --- the plain versions against the Pallas kernels in interpret mode ---


def _unrows(raw, T, B, n):
    """A Pallas store ``(T, n n, Bp / 128, 128)`` as ``(T, B, n, n)``."""
    flat = np.asarray(raw).reshape(T, n * n, -1)[..., :B]
    return np.moveaxis(flat, -1, 1).reshape(T, B, n, n)


@pytest.mark.parametrize("nmp", PALLAS_K1)
def test_plain_k1_with_stores_matches_pallas(nmp):
    """The plain K1 through its wrapper (padded where the shape is not an
    instance), gains and stores, against the Pallas forward kernel with its
    stores, float32, T=7 (a prime number of steps), B=3."""
    T, B = 7, 3
    f = _fields(nmp, B)
    jspec, spec = _specs(f)
    jS0 = jspec.V @ jnp.swapaxes(jspec.V, -1, -2)
    *jout, (jS, jP) = jg.fused_gains(jspec, jS0, T, time_chunk=T,
                                     with_stores=True)
    VV = spec.V @ mT(spec.V)
    out = kg.gains_fwd(spec.A, spec.B, spec.Q, spec.R, spec.Qf, spec.F, VV,
                       spec.W @ mT(spec.W), VV, T, stores=True)
    want = [np.asarray(x) for x in jout] + [_unrows(x, T, B, nmp[0])
                                            for x in (jS, jP)]
    for name, t, j in zip(("L", "H", "K", "S", "P"), out, want):
        assert t.shape == j.shape, name
        scale = max(1.0, float(np.abs(j).max()))
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=GAINS_ATOL * scale, err_msg=name)


@pytest.mark.parametrize("nmp", PALLAS_K2)
def test_plain_k2_matches_pallas(nmp):
    """The plain K2 (the Function's backward on the CPU) against the Pallas
    adjoint ``_gains_adjoint_call``, float32, T=12, B=3, at
    tests/test_pallas.py's CPU tolerance.  At m = 2 the Pallas kernel does
    not project its Riccati carry where K1 and K2 do; over 12 steps on these
    specs the carry stays symmetric to within float32."""
    T, B = 12, 3
    n, m, p = nmp
    f = _fields(nmp, B)
    jspec, _ = _specs(f)
    rng = np.random.default_rng(7)
    cots = [0.3 * rng.normal(size=(T, B) + s).astype(np.float32)
            for s in ((m, n), (m, m), (n, p))]
    S0 = f["V"] @ np.swapaxes(f["V"], -1, -2)
    jbar, jS0bar = jg._gains_adjoint_call(
        jspec, jnp.asarray(S0, jnp.float32), T, *map(jnp.asarray, cots))
    leaves = {k: torch.tensor(f[k].astype(np.float32), requires_grad=True)
              for k in FIELDS}
    spec = stationary_spec(**{k: leaves[k] for k in "ABFVWQR"})._replace(
        Qf=leaves["Qf"])
    Sigma0 = torch.tensor(S0.astype(np.float32), requires_grad=True)
    grads = torch.autograd.grad(kg.fused_gains(spec, Sigma0, T),
                                [leaves[k] for k in FIELDS] + [Sigma0],
                                [torch.tensor(c) for c in cots])
    want = [np.asarray(getattr(jbar, k)) for k in FIELDS] + [
        np.asarray(jS0bar)]
    sym = lambda M: 0.5 * (M + np.swapaxes(M, -1, -2))
    for name, g, w in zip(FIELDS + ("Sigma0",), grads, want):
        g = g.numpy()
        if name in ("Q", "R", "Qf", "Sigma0"):
            g, w = sym(g), sym(w)
        np.testing.assert_allclose(g, w, err_msg=name, **ADJ_TOL)


def _joint_case(jd, P=2, n=3, T=17, seed=0):
    """F, Q (P, T, j, j) and X (P, n, T+1, d), float32 numpy: the delay-2
    bounded actor's joint system at (12, 2), else a stable random one
    (orthogonal transitions scaled by 0.97, a random noise factor) with
    random-walk data."""
    j, d = jd
    rng = np.random.default_rng(seed + j + d)
    if jd == (12, 2):
        Fs, Qs = [], []
        for k in range(P):
            joint = jmodels.TemporalDelayModel(jmodels.BoundedActor(
                T=T, sigma_target=3.0 + 2.0 * k, action_cost=0.5 + 0.3 * k),
                delay=2)._joint()
            Fs.append(np.asarray(joint.F))
            Qs.append(np.asarray(joint.G @ jnp.swapaxes(joint.G, -1, -2)))
        F, Q = np.stack(Fs), np.stack(Qs)
    else:
        A = np.stack([np.linalg.qr(rng.normal(size=(j, j)))[0] * 0.97
                      for _ in range(P)])
        F = np.repeat(A[:, None], T, 1)
        G = 0.3 * rng.normal(size=(P, 1, j, j)) + 0.5 * np.eye(j)
        Q = np.repeat(G @ np.swapaxes(G, -1, -2), T, 1)
    X = 0.3 * np.cumsum(rng.normal(size=(P, n, T + 1, d)), axis=2)
    return tuple(a.astype(np.float32) for a in (F, Q, X))


@pytest.mark.parametrize("jd", PALLAS_LL)
def test_plain_k3_k4_match_pallas(jd):
    """The plain K3 and K4 through the Function (padded where the shape is
    not an instance) against lqg_tpu's ``conditioned_log_likelihood_fused``
    and its ``jax.grad``, float32, T=17, 2 sets x 3 trials."""
    F, Q, X = _joint_case(jd)
    w = np.random.default_rng(3).normal(size=X.shape[:2]).astype(np.float32)
    jll = jl.conditioned_log_likelihood_fused(*map(jnp.asarray, (F, Q, X)))
    jgrads = jax.grad(lambda *a: jnp.sum(jl.conditioned_log_likelihood_fused(
        *a) * w), argnums=(0, 1, 2))(*map(jnp.asarray, (F, Q, X)))
    leaves = [torch.tensor(a, requires_grad=True) for a in (F, Q, X)]
    ll = kl.conditioned_log_likelihood_fused(*leaves)
    np.testing.assert_allclose(ll.detach().numpy(), np.asarray(jll),
                               **LL_TOL)
    grads = torch.autograd.grad(ll, leaves, torch.tensor(w))
    sym = lambda M: 0.5 * (M + np.swapaxes(M, -1, -2))
    for name, g, j, tol in zip("FQX", grads, jgrads, (FQ_TOL, FQ_TOL, X_TOL)):
        g, j = g.numpy(), np.asarray(j)
        if name == "Q":
            g, j = sym(g), sym(j)
        np.testing.assert_allclose(g, j, err_msg=name, **tol)


# --- the padded route against the unpadded plain computation ---


@pytest.mark.parametrize("nmp", PADDED_GAINS + [(1, 1, 2), (5, 1, 1),
                                                (2, 2, 1)])
def test_padded_gains_route_is_the_unpadded_plain_computation(nmp):
    """float64: K1 (with the stores) and K2 through their wrappers, which
    pad onto ``instance_for``, against the plain versions at the true
    shape.  Both sum in the same order, but PyTorch's products of the
    padded and the unpadded matrices may not, so the test allows 1e-12 of
    each output's largest entry."""
    n, m, p = nmp
    assert kg.instance_for(*nmp) != nmp
    T = 2 * kg.CHUNK + 3
    f = {k: torch.tensor(v)
         for k, v in _random_fields(5, 3, *nmp, a=0.9).items()}
    VV, WW = f["V"] @ mT(f["V"]), f["W"] @ mT(f["W"])
    ins = (f["A"], f["B"], f["Q"], f["R"], f["Qf"], f["F"], VV, WW, VV)
    got = kg.gains_fwd(*ins, T, stores=True)
    want = kg._gains_reference(*ins, T, stores=True)
    rng = np.random.default_rng(1)
    cots = [torch.tensor(0.3 * rng.normal(size=x.shape)) for x in want[:3]]
    vjp_in = (f["A"], f["B"], f["R"], f["F"], VV, WW)
    got += kg.fused_gains_vjp(*vjp_in, *got[3:], *cots)
    want += kg.fused_gains_vjp_reference(*vjp_in, *want[3:], *cots)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-12 * float(b.abs().max()))


@pytest.mark.parametrize("jd", PADDED_LL + [(2, 1), (9, 4), (11, 2)])
def test_padded_likelihood_route_is_the_unpadded_plain_computation(jd):
    """float64: K3 (with the stores) and K4 through their wrappers, padded
    onto ``instance_for``, against the plain versions at the true shape,
    within 1e-12 of each output's largest entry."""
    assert kl.instance_for(*jd) != jd
    F, Q, X = (torch.tensor(a, dtype=torch.float64)
               for a in _joint_case(jd, n=40, T=23))
    got = kl.ll_fwd(F, Q, X, stores=True)
    want = kl.conditioned_log_likelihood_reference(F, Q, X, stores=True)
    w = torch.tensor(np.random.default_rng(2).normal(size=X.shape[:2]))
    got += kl.conditioned_log_likelihood_vjp(F, X, w, *got[1:])
    want += kl.conditioned_log_likelihood_vjp_reference(F, X, w, *want[1:])
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-12 * float(b.abs().max()))


# --- the delay models' method="fused", which raised before ---


@pytest.mark.parametrize("base,delay", [("BoundedActor", 1)])
def test_delay_model_fused_gains_match_lqg_tpu(base, delay):
    """``TemporalDelayModel(..., delay=k).gains(method="fused")``, which
    raised in the port before (4, 1, 2) was built: the port's plain K1
    against lqg_tpu's Pallas kernel (interpret mode), float32, T=12."""
    T = 12
    jm = jmodels.TemporalDelayModel(getattr(jmodels, base)(T=T), delay=delay)
    tm = tmodels.TemporalDelayModel(getattr(tmodels, base)(T=T,
                                                           device="cpu"),
                                    delay=delay)
    jgains, jK = jm.gains(method="fused")
    tgains, tK = tm.gains(method="fused")
    for t, j in ((tgains.L, jgains.L), (tgains.H, jgains.H), (tK, jK)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=GAINS_ATOL)


@pytest.mark.parametrize("base,delay", [("BoundedActor", 2)])
def test_delay_model_fused_likelihood_matches_lqg_tpu(base, delay):
    """``log_likelihood(x, method="fused")`` at the delay-2 joint dim 12,
    which raised in the port before (12, 2) was built: the port's plain K3
    against lqg_tpu's Pallas kernel, float32, T=12, on trajectories lqg_tpu
    simulates."""
    T = 12
    jm = jmodels.TemporalDelayModel(getattr(jmodels, base)(T=T), delay=delay)
    tm = tmodels.TemporalDelayModel(getattr(tmodels, base)(T=T,
                                                           device="cpu"),
                                    delay=delay)
    x = np.asarray(jm.simulate(jax.random.PRNGKey(0), n=3))[..., :2]
    want = np.asarray(jm.log_likelihood(jnp.asarray(x), method="fused"))
    got = tm.log_likelihood(torch.tensor(x), method="fused")
    np.testing.assert_allclose(got.numpy(), want, **LL_TOL)


# --- the probe parameter sets through the padded route ---


def test_padded_probe_nans_match_pallas():
    """The probe parameter sets of tests/test_torch_nonfinite.py (and the
    default bounded actor), (2, 1, 2) padded by hand to (7, 1, 2), which the
    wrappers pad onto (8, 1, 2): the plain K1 and K2 give NaN in the real
    block exactly where lqg_tpu's Pallas kernels give NaN at (2, 1, 2),
    float32, T=7, and the default actor stays finite.  The card's test
    (tests/test_torch_gains_kernel.py) holds the kernels to these plain
    versions."""
    from test_torch_gains_kernel import PROBES, probe_gains_inputs

    T = 7
    actors = [jmodels.BoundedActor(T=8, **p).actor for p in PROBES]
    jspec = jax.tree.map(lambda *a: jnp.stack(a), *actors)
    jS0 = jspec.V @ jnp.swapaxes(jspec.V, -1, -2)
    jout = jg.fused_gains(jspec, jS0, T, time_chunk=T)
    A, Bm, Q, R, Qf, F, VV, WW, S0 = probe_gains_inputs()
    out = kg.gains_fwd(A, Bm, Q, R, Qf, F, VV, WW, S0, T, stores=True)
    real = (out[0][..., :2], out[1], out[2][:, :, :2])
    for t, j in zip(real, jout):
        np.testing.assert_array_equal(np.isnan(t.numpy()),
                                      np.isnan(np.asarray(j)))
        assert np.isfinite(t[:, -1].numpy()).all()
    rng = np.random.default_rng(0)
    cots = [0.3 * rng.normal(size=x.shape).astype(np.float32)
            for x in jout]
    jbar, jS0bar = jg._gains_adjoint_call(jspec, jS0, T,
                                          *map(jnp.asarray, cots))
    big = [torch.tensor(c) for c in cots]
    big = [kg._grow(big[0], 1, 7), big[1], kg._grow(big[2], 7, 2)]
    bars = kg.fused_gains_vjp(A, Bm, R, F, VV, WW, *out[3:], *big)
    # the nine raw cotangents' real blocks against those of the JAX
    # adjoint's A, B, Q, R, Qf and F (V and W come through V V^T, W W^T)
    sq = lambda x: x[..., :2, :2]
    for name, t in (("A", sq(bars[0])), ("B", bars[1][..., :2, :]),
                    ("Q", sq(bars[2])), ("R", bars[3]), ("Qf", sq(bars[4])),
                    ("F", bars[5][..., :2])):
        j = np.asarray(getattr(jbar, name))
        np.testing.assert_array_equal(np.isnan(t.numpy()), np.isnan(j),
                                      err_msg=name)
        assert np.isfinite(t[-1].numpy()).all(), name


def test_padded_probe_likelihood_nans_match_pallas():
    """The probe actors' joint systems, (4, 2) padded by hand to (6, 2),
    which the wrappers pad onto (8, 2), float32, T=37: the plain K3 and K4
    give NaN exactly where they do unpadded, and where lqg_tpu's Pallas
    likelihood and its ``jax.grad`` do at (4, 2), but for one block: at the
    last step, Q's cotangent outside the observed d x d block is the
    adjoint's seed there, zero in exact arithmetic: 0 in the port (as in
    K4), NaN in the Pallas adjoint where a probe's covariances are not
    finite (ROADMAP, Queue 3).  The default actor's set stays finite."""
    from test_torch_likelihood_kernel import probe_ll_inputs

    F, Q, X = probe_ll_inputs()
    F4, Q4 = F[..., :4, :4], Q[..., :4, :4]
    w = np.random.default_rng(1).normal(size=X.shape[:2]).astype(np.float32)
    jargs = [jnp.asarray(a.numpy()) for a in (F4, Q4, X)]
    jll = np.asarray(jl.conditioned_log_likelihood_fused(*jargs))
    jgrads = jax.grad(lambda *a: jnp.sum(jl.conditioned_log_likelihood_fused(
        *a) * w), argnums=(0, 1, 2))(*jargs)

    def port(F, Q):
        leaves = [a.clone().requires_grad_() for a in (F, Q, X)]
        ll = kl.conditioned_log_likelihood_fused(*leaves)
        grads = torch.autograd.grad(ll, leaves, torch.tensor(w))
        return [ll.detach(), grads[0][..., :4, :4], grads[1][..., :4, :4],
                grads[2]]

    got, unpadded = port(F, Q), port(F4, Q4)
    seed = np.zeros(Q4.shape, bool)
    seed[:, -1] = True
    seed[:, -1, :2, :2] = False  # the observed block
    for name, t, u, j in zip(("ll", "F", "Q", "X"), got, unpadded,
                             [jll, *jgrads]):
        t, j = t.numpy(), np.isnan(np.asarray(j))
        np.testing.assert_array_equal(np.isnan(t), np.isnan(u.numpy()),
                                      err_msg=name)
        if name == "Q":
            np.testing.assert_array_equal(np.isnan(t)[~seed], j[~seed])
            assert not np.isnan(t[seed]).any()
        else:
            np.testing.assert_array_equal(np.isnan(t), j, err_msg=name)
        assert np.isfinite(t[-1]).all(), name
