"""K2, the gains adjoint, behind ``fused_gains``'s ``torch.autograd.Function``.

On the CPU the Function runs the plain versions of K1 (with stores) and K2:
held against the JAX package's adjoint kernel in interpret mode (float32)
and against autograd through the plain K1 (float64).  The plain K2 runs in
the kernel's three parts and sum order; it is held against a serial
per-step oracle (the one time loop of both carries and all sums) in
float64.  On a card (``-m cuda``): K1's stores and K2 against their plain
versions, and two K2 launches bit for bit.  JAX is imported
inside the tests that use it, so that the card's tests collect where JAX
is not installed.
"""

import numpy as np
import pytest
import torch

from lqg_tpu_torch import models
from lqg_tpu_torch.models.basic import tracking_spec
from lqg_tpu_torch.ops.kernels import gains as kg
from lqg_tpu_torch.ops.linalg import mT
from lqg_tpu_torch.utils import stationary_spec

FIELDS = ("A", "B", "Q", "R", "Qf", "F", "V", "W")
SYMMETRIC = ("Q", "R", "Qf", "Sigma0")  # compared in the symmetric gauge
RTOL, ATOL = 1e-3, 1e-4  # as tests/test_pallas.py holds the Pallas adjoint


def _sym(M):
    return 0.5 * (M + np.swapaxes(M, -1, -2))


def _random_spec(seed, B=3, n=2, m=1, p=2):
    """numpy fields of B random stationary specs (as tests/test_pallas.py's
    ``_random_spec``) with a separate terminal cost."""
    rng = np.random.default_rng(seed)
    rnd = lambda *sh: 0.3 * rng.normal(size=sh)
    sym = lambda M: 0.5 * (M + np.swapaxes(M, -1, -2))
    f = dict(
        A=np.eye(n) + 0.1 * rnd(B, n, n), B=rnd(B, n, m) + 0.5,
        Q=sym(np.eye(n) + 0.05 * rnd(B, n, n)),
        R=sym(np.eye(m) * 0.8 + 0.01 * np.abs(rnd(B, m, m))),
        F=rnd(B, p, n) + np.eye(p, n), V=np.eye(n) * 0.7 + 0.05 * rnd(B, n, n),
        W=np.eye(p) * 0.9 + 0.05 * rnd(B, p, p))
    f["Qf"] = sym(np.eye(n) * 1.5 + 0.05 * rnd(B, n, n))
    return f


def _torch_spec(f, dtype, requires_grad=False):
    t = {k: torch.tensor(v, dtype=dtype, requires_grad=requires_grad)
         for k, v in f.items()}
    spec = stationary_spec(**{k: t[k] for k in "ABFVWQR"})._replace(Qf=t["Qf"])
    return spec, t


# the models of the zoo's gains instances, (n, m, p): name, keyword
# arguments and the action costs of three parameter sets
ZOO_MODELS = {
    (4, 1, 3): ("PointMassBoundedActor", {}, (0.01, 0.05, 0.3)),
    (5, 1, 2): ("HandMotionModelTrackingTask", {}, (0.3, 1.0, 3.0)),
    (4, 2, 2): ("RelativeObservationBoundedActor", {"dim": 2},
                (0.1, 0.5, 2.0)),
}


def _model_fields(nmp):
    """numpy fields of a zoo model's actor, three parameter sets, built in
    float64 by the port."""
    name, kw, costs = ZOO_MODELS[nmp]
    actor = getattr(models, name)(
        T=10, action_cost=torch.tensor(costs, dtype=torch.float64),
        dtype=torch.float64, device="cpu", **kw).actor
    return {k: getattr(actor, k).expand(
        (len(costs),) + getattr(actor, k).shape[-2:]).numpy().copy()
        for k in FIELDS}


def _cotangents(seed, T, B, n, m, p):
    rng = np.random.default_rng(seed)
    return [0.3 * rng.normal(size=(T, B) + s) for s in ((m, n), (m, m),
                                                        (n, p))]


def _serial_vjp(A, Bm, R, F, VV, WW, S_st, P_st, Lbar, Hbar, Kbar):
    """Per-step oracle of K2: one time loop runs both adjoint carries and
    adds every cotangent as it goes (K2's arithmetic before it was split
    into recompute, carries and chunked sums)."""
    At, Bt, Ft = mT(A), mT(Bm), mT(F)
    T = S_st.shape[0]
    zero = torch.zeros_like
    Sb, Pb = zero(S_st[0]), zero(P_st[0])
    aA, aB, aQ, aR = zero(A), zero(Bm), zero(S_st[0]), zero(R)
    aF, aV, aW = zero(F), zero(VV), zero(WW)
    for i in range(T):
        S = S_st[i]
        SB = S @ Bm
        SA = S @ A
        H = R + Bt @ SB
        G = Bt @ SA
        Hinv = kg._sym_inv_det(H)[0]
        L = -(Hinv @ G)
        HL = H @ L
        if Bm.shape[-1] > 1:  # K1 projects its Riccati carry at m > 1
            Sb = 0.5 * (Sb + mT(Sb))
        Sbt = mT(Sb)
        LSb = L @ Sb
        Lb = Lbar[i] + (HL @ Sbt + (G @ Sbt + (G @ Sb + H @ LSb)))
        Hb = Hbar[i] + L @ (Sb @ mT(L))
        HinvLb = Hinv @ Lb
        Hb = Hb + HinvLb @ (mT(G) @ Hinv)
        Gbar = (LSb + L @ Sbt) - HinvLb
        aR = aR + Hb
        aQ = aQ + Sb
        SBbar = Bm @ Hb
        SAbar = A @ Sb + Bm @ Gbar
        aA = aA + (SA @ Sbt + S @ SAbar)
        aB = aB + (SA @ mT(Gbar) + (SB @ mT(Hb) + S @ SBbar))
        Sb = SBbar @ Bt + SAbar @ At
        Pb = 0.5 * (Pb + mT(Pb))
        P = P_st[T - 1 - i]
        Pp = A @ (P @ At) + VV
        PFt = Pp @ Ft
        Gki = kg._sym_inv_det(F @ PFt + WW)[0]
        K = PFt @ Gki
        Kb = Kbar[T - 1 - i] - Pb @ PFt
        KbGki = Kb @ Gki
        PFtb = -(mT(Pb) @ K) + KbGki
        Gkbar = -(Gki @ (mT(PFt) @ KbGki))
        aW = aW + Gkbar
        aF = aF + Gkbar @ mT(PFt)
        PFtb = PFtb + Ft @ Gkbar
        aF = aF + mT(PFtb) @ Pp
        Ppbar = Pb + PFtb @ F
        aV = aV + Ppbar
        aA = aA + (Ppbar + mT(Ppbar)) @ (A @ P)
        Pb = At @ (Ppbar @ A)
    return aA, aB, aQ, aR, Sb, aF, aV, aW, Pb


def _vjp_inputs(f, T, dtype=torch.float64, seed=5):
    """K2's inputs for the numpy spec fields ``f``: the fields, the plain
    K1's stores and random cotangents."""
    t = {k: torch.tensor(v, dtype=dtype) for k, v in f.items()}
    VV, WW = t["V"] @ mT(t["V"]), t["W"] @ mT(t["W"])
    out = kg._gains_reference(t["A"], t["B"], t["Q"], t["R"], t["Qf"], t["F"],
                              VV, WW, VV, T, stores=True)
    B, n, m, p = t["A"].shape[0], t["A"].shape[-1], t["B"].shape[-1], \
        t["F"].shape[-2]
    cots = [torch.tensor(x, dtype=dtype)
            for x in _cotangents(seed, T, B, n, m, p)]
    return (t["A"], t["B"], t["R"], t["F"], VV, WW, *out[3:], *cots)


VJP_OUTPUTS = ("A", "B", "Q", "R", "Qf", "F", "VV", "WW", "Sigma0")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _against_pallas(f, T):
    """The Function's backward (the plain K2) against the JAX package's
    adjoint kernel in interpret mode, float32, on the numpy spec fields
    ``f`` of three parameter sets and random cotangents."""
    import jax.numpy as jnp
    from lqg_tpu.ops.pallas.gains import _gains_adjoint_call
    from lqg_tpu.utils import stationary_spec as jstationary_spec

    n, m, p = f["A"].shape[-1], f["B"].shape[-1], f["F"].shape[-2]
    cots = _cotangents(7, T, 3, n, m, p)
    jspec = jstationary_spec(**{k: jnp.asarray(f[k], jnp.float32)
                                for k in "ABFVWQR"})
    jspec = jspec._replace(Qf=jnp.asarray(f["Qf"], jnp.float32))
    S0 = f["V"] @ np.swapaxes(f["V"], -1, -2)
    jbar, jS0bar = _gains_adjoint_call(
        jspec, jnp.asarray(S0, jnp.float32), T,
        *(jnp.asarray(c, jnp.float32) for c in cots))

    spec, leaves = _torch_spec(f, torch.float32, requires_grad=True)
    Sigma0 = torch.tensor(S0, dtype=torch.float32, requires_grad=True)
    out = kg.fused_gains(spec, Sigma0, T)
    grads = torch.autograd.grad(
        out, [leaves[k] for k in FIELDS] + [Sigma0],
        [torch.tensor(c, dtype=torch.float32) for c in cots])
    want = [np.asarray(getattr(jbar, k)) for k in FIELDS] + [np.asarray(jS0bar)]
    for name, g, w in zip(FIELDS + ("Sigma0",), grads, want):
        g = g.numpy()
        if name in SYMMETRIC:
            g, w = _sym(g), _sym(w)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("n,m,p,T", [(2, 1, 2, 12), (2, 1, 2, 7),
                                     (2, 1, 1, 12)])
def test_plain_adjoint_matches_pallas(n, m, p, T):
    _against_pallas(_random_spec(42 + T + p, n=n, m=m, p=p), T)


@pytest.mark.parametrize("nmp", sorted(ZOO_MODELS))
def test_plain_adjoint_matches_pallas_zoo(nmp):
    """The zoo's instances on the models' own specs: PointMass (4, 1, 3),
    Hand (5, 1, 2) and RelativeObservation(dim=2) (4, 2, 2), where the
    JAX kernel's carries need no projection to stay symmetric within
    float32 over a short horizon (see ROADMAP's Queue 3)."""
    _against_pallas(_model_fields(nmp), 12)


def _against_autograd(case, T, B=3):
    """The Function's backward (the plain K2) against autograd through the
    plain K1, float64, on random cotangents: the K1 that autograd
    differentiates projects its Riccati carry at m > 1, so this holds K2's
    adjoint of that projection to a derivation it does not share."""
    ins = [getattr(case, k).expand((B,) + getattr(case, k).shape[-2:])
           .clone().requires_grad_() for k in FIELDS]
    spec = case._replace(**dict(zip(FIELDS, ins)))
    Sigma0 = (ins[6] @ mT(ins[6])).detach().requires_grad_()
    n, m, p = ins[0].shape[-1], ins[1].shape[-1], ins[5].shape[-2]
    cots = [torch.tensor(x) for x in _cotangents(5, T, B, n, m, p)]
    leaves = ins + [Sigma0]
    got = torch.autograd.grad(kg.fused_gains(spec, Sigma0, T), leaves, cots)
    want = torch.autograd.grad(kg.fused_gains_reference(spec, Sigma0, T),
                               leaves, cots)
    for name, a, b in zip(FIELDS + ("Sigma0",), got, want):
        if name in SYMMETRIC:
            a, b = 0.5 * (a + mT(a)), 0.5 * (b + mT(b))
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9 * float(
            b.abs().max()), msg=name)


@pytest.mark.parametrize("T", [13, 240])
def test_plain_adjoint_matches_autograd(T):
    """Against autograd through the plain K1 (``_against_autograd``) on a
    random (2, 1, 2) spec and the bounded actor's; 240 steps reach the
    regime in which an unprojected Kalman adjoint carry grows (see
    csrc/gains.cu)."""
    B = 3
    c, av, st, sc = (torch.tensor(v) for v in (np.logspace(-2, 1, B),
                                               np.linspace(0.1, 1.0, B),
                                               np.linspace(2.0, 40.0, B),
                                               np.linspace(0.5, 10.0, B)))
    for case in (_torch_spec(_random_spec(3), torch.float64)[0],
                 tracking_spec(1, 1.0, av, st, sc, c, 1 / 60, device="cpu",
                               dtype=torch.float64)):
        _against_autograd(case, T, B)


# the zoo's instances (the source's first part), and of the instances that
# the delay wrapper and the envelopes added, the delay paths' and the
# largest: the plain K2's code is the same at every shape, and at n = 8 a
# float64 case takes tens of seconds on the CPU
ZOO_INSTANCES = sorted(k for k, part in kg.PART.items() if part == 0)
SCOPE_CASES = [(4, 1, 2), (6, 1, 2), (8, 2, 3)]


@pytest.mark.parametrize("kind,nmp,T", [
    (kind, nmp, T) for nmp in ZOO_INSTANCES for T in (13, 65)
    for kind in ("random",)] + [
    ("model", nmp, T) for nmp in sorted(ZOO_MODELS) for T in (13, 240)] + [
    ("random", nmp, 65) for nmp in SCOPE_CASES])
def test_plain_adjoint_matches_autograd_at_every_instance(kind, nmp, T):
    """Every instance of K2 against autograd through the plain K1: a random
    spec at each, the (4, 2, 2) one open-loop unstable, and the zoo
    models' own specs (PointMass, Hand, RelativeObservation(dim=2)).  The
    random specs stop at T=65: on them the float64 rounding of the gains
    grows by about 10% a step, so that at (5, 1, 2), T=240, the two
    adjoints differ by 3.8e-4 of the largest entry and a central difference
    of the objective moves by 25% between steps 1e-4 and 1e-5: no adjoint
    is an oracle there."""
    n, m, p = nmp
    f = (_random_spec(3, n=n, m=m, p=p) if kind == "random"
         else _model_fields(nmp))
    _against_autograd(_torch_spec(f, torch.float64)[0], T)


def test_kalman_adjoint_step_needs_the_projection():
    """Why K2 symmetrizes its Kalman carry: the hand-derived Kalman adjoint
    step (lqg_tpu/ops/pallas/gains.py:366-378, with K-bar = 0) assumes a
    symmetric carry.  At the steady state of a bounded actor with a small
    action cost it maps some carries to larger ones (spectral radius
    ~1.07 > 1, so 1.07^T over a T=1008 run); projected onto symmetric
    matrices first, as K2 does, it contracts."""
    spec = tracking_spec(1, 1.0, 0.1, 2.0, 0.5, 0.01, 1 / 60, device="cpu",
                         dtype=torch.float64)
    A, F = spec.A, spec.F
    P = kg.fused_gains_reference(spec._replace(**{
        k: getattr(spec, k)[None] for k in FIELDS}),
        (spec.V @ mT(spec.V))[None], 400, stores=True)[4][-1, 0]
    Pp = A @ P @ mT(A) + spec.V @ mT(spec.V)
    PFt = Pp @ mT(F)
    Gki = torch.linalg.inv(F @ PFt + spec.W @ mT(spec.W))
    K = PFt @ Gki

    def step(Pb, project):
        if project:
            Pb = 0.5 * (Pb + mT(Pb))
        KbGki = -(Pb @ PFt) @ Gki
        PFtb = -(mT(Pb) @ K) + KbGki - mT(F) @ (Gki @ (mT(PFt) @ KbGki))
        return mT(A) @ ((Pb + PFtb @ F) @ A)

    def radius(project):
        basis = torch.eye(4, dtype=torch.float64).reshape(4, 2, 2)
        M = torch.stack([step(E, project).flatten() for E in basis], 1)
        return float(torch.linalg.eigvals(M).abs().max())

    assert radius(project=False) > 1.05
    assert radius(project=True) < 1.0


def test_riccati_carry_needs_the_projection_at_two_controls():
    """Why K1 symmetrizes its Riccati carry at m > 1: the carry's
    antisymmetric part reaches the 2 x 2 control Hessian, whose closed-form
    inverse reads one off-diagonal entry, and on an open-loop unstable
    random (4, 2, 2) spec it grows from float32 rounding until ``L`` is off
    by more than 1 against float64 at T=65; projected each step (the plain
    K1), ``L`` stays within 1e-4."""
    f = _random_spec(4, B=5, n=4, m=2, p=2)

    def riccati_L(dtype, project):
        t = {k: torch.tensor(v, dtype=dtype) for k, v in f.items()}
        A, Bm, Q, R = t["A"], t["B"], t["Q"], t["R"]
        S, Ls = t["Qf"], []
        for _ in range(65):
            SA = S @ A
            H = R + mT(Bm) @ (S @ Bm)
            G = mT(Bm) @ SA
            L = -(kg._sym_inv_det(H)[0] @ G)
            S = (Q + mT(A) @ SA) + (mT(L) @ (H @ L)
                                    + (mT(L) @ G + mT(G) @ L))
            S = 0.5 * (S + mT(S)) if project else S
            Ls.append(L)
        return torch.stack(Ls)

    exact = riccati_L(torch.float64, True)
    assert float((riccati_L(torch.float32, False).double()
                  - exact).abs().max()) > 1.0
    VV = lambda t: t @ mT(t)
    t32 = {k: torch.tensor(v, dtype=torch.float32) for k, v in f.items()}
    L32 = kg._gains_reference(t32["A"], t32["B"], t32["Q"], t32["R"],
                              t32["Qf"], t32["F"], VV(t32["V"]),
                              VV(t32["W"]), VV(t32["V"]), 65)[0]
    assert float((L32.flip(0).double() - exact).abs().max()) < 1e-4


@pytest.mark.parametrize("n,m,p,T", [
    (*nmp, T) for T in (1, kg.CHUNK - 1, kg.CHUNK, kg.CHUNK + 1,
                        2 * kg.CHUNK + 5, 37)
    for nmp in ZOO_INSTANCES] + [
    (*nmp, 2 * kg.CHUNK + 5) for nmp in SCOPE_CASES])
def test_three_pass_adjoint_matches_serial_oracle(n, m, p, T):
    """The plain K2 in the kernel's parts (recompute over all steps, the
    two carries alone, chunked sums) gives the serial loop's cotangents,
    float64; T = 1, a chunk less one, a chunk, a chunk and one, a ragged
    third chunk and a prime T."""
    ins = _vjp_inputs(_random_spec(11 + T, n=n, m=m, p=p), T)
    got = kg.fused_gains_vjp_reference(*ins)
    want = _serial_vjp(*ins)
    for name, a, b in zip(VJP_OUTPUTS, got, want):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, rtol=1e-10,
                                   atol=1e-10 * float(b.abs().max()), msg=name)


@pytest.mark.parametrize("T", [1, kg.CHUNK, kg.CHUNK + 1, 100])
def test_chunk_sum_order(T):
    """The plain chunk sum equals torch.sum in float64, and folds a chunk's
    lanes by halving before the chunks are added in turn."""
    rng = np.random.default_rng(T)
    x = torch.tensor(rng.normal(size=(T, 3, 2, 2)))
    torch.testing.assert_close(kg._chunk_sum(x), x.sum(0), rtol=1e-14,
                               atol=1e-14 * float(x.abs().max()))
    if T >= kg.CHUNK:
        lanes = torch.zeros(T, dtype=torch.float64)
        lanes[0], lanes[1], lanes[17] = 1.0, 2.0 ** 60, -(2.0 ** 60)
        # the tree adds x_1 + x_17 before x_0 meets them: x_0 survives; a
        # sum in index order loses it
        assert float(kg._chunk_sum(lanes)) == 1.0
        assert float((lanes[0] + lanes[1]) + lanes[17]) == 0.0


def test_function_on_cpu_launches_nothing():
    f = _random_spec(9)
    spec, leaves = _torch_spec(f, torch.float32, requires_grad=True)
    before = (kg.fused_gains.launches, kg.fused_gains_vjp.launches)
    L, H, K = kg.fused_gains(spec, spec.V @ mT(spec.V), 6)
    (L.sum() + H.sum() + K.sum()).backward()
    assert all(torch.isfinite(leaves[k].grad).all() for k in FIELDS)
    assert before == (kg.fused_gains.launches, kg.fused_gains_vjp.launches)
    # the stores are written only where a gradient is needed
    out = kg.gains_fwd(*(x.detach() for x in (
        spec.A, spec.B, spec.Q, spec.R, spec.Qf, spec.F, spec.V @ mT(spec.V),
        spec.W @ mT(spec.W), spec.V @ mT(spec.V))), 6, stores=True)
    assert [x.shape for x in out[3:]] == [(6, 3, 2, 2)] * 2


def _sweep_spec(B, device):
    c, av, st, sc = (torch.tensor(v, dtype=torch.float32, device=device)
                     for v in (np.logspace(-2, 1, B), np.linspace(0.1, 1.0, B),
                               np.linspace(2.0, 40.0, B),
                               np.linspace(0.5, 10.0, B)))
    return tracking_spec(1, 1.0, av, st, sc, c, 1 / 60, device=device)


def _adjoint_cases(cuda):
    """(spec, K1's inputs, T): the potential's shape, 2,048 specs at a
    prime T, each of the zoo's instances on a random spec at a ragged T
    (two chunks and one step), and each instance added for the delay
    wrapper and the envelopes, and two padded shapes, at the same T.
    These take the card tests' scope specs (the delay wrapper's models, a
    stable random spec; tests/test_torch_gains_kernel.py): at n >= 6 the
    random specs here are ill-conditioned in float32, whose plain version
    is then 2-19x this test's tolerance from float64."""
    from test_torch_gains_kernel import SCOPE, _scope_spec

    cases = []
    for B, T in ((24, 1008), (2048, 719)):
        spec = _sweep_spec(B, cuda)
        VV, WW = spec.V @ mT(spec.V), spec.W @ mT(spec.W)
        cases.append((spec, [x.expand((B,) + x.shape[-2:]).contiguous()
                             for x in (spec.A, spec.B, spec.Q, spec.R,
                                       spec.Qf, spec.F, VV, WW, VV)], T))
    T = 2 * kg.CHUNK + 1
    for n, m, p in ZOO_INSTANCES:
        spec = _torch_spec(_random_spec(4, B=5, n=n, m=m, p=p),
                           torch.float32)[0]
        spec = spec._replace(**{k: getattr(spec, k).to(cuda)
                                for k in FIELDS})
        VV, WW = spec.V @ mT(spec.V), spec.W @ mT(spec.W)
        cases.append((spec, [spec.A, spec.B, spec.Q, spec.R, spec.Qf, spec.F,
                             VV, WW, VV], T))
    for nmp in SCOPE:
        spec = _scope_spec(nmp, 5, T, device=cuda)
        VV, WW = spec.V @ mT(spec.V), spec.W @ mT(spec.W)
        cases.append((spec, [x.contiguous() for x in (
            spec.A, spec.B, spec.Q, spec.R, spec.Qf, spec.F, VV, WW, VV)],
            T))
    return cases


@pytest.mark.cuda
def test_adjoint_kernel_matches_reference_on_card(cuda):
    """K1's stores and K2 against their plain versions: the potential's
    shape, 2,048 specs at a prime T, and each instance at a ragged T (two
    chunks and one step); two K2 launches give the same bits."""
    for spec, ins, T in _adjoint_cases(cuda):
        out = kg.gains_fwd(*ins, T, stores=True)
        ref = kg.fused_gains_reference(spec, ins[-1], T, stores=True)
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        g = torch.Generator(device=cuda).manual_seed(0)
        cots = [0.3 * torch.randn(x.shape, generator=g, device=cuda)
                for x in out[:3]]
        A, Bm, _, R, _, F, VV, WW, _ = ins
        args = (A, Bm, R, F, VV, WW, *out[3:], *cots)
        got = kg.fused_gains_vjp(*args)
        again = kg.fused_gains_vjp(*args)
        want = kg.fused_gains_vjp_reference(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        # a cotangent summed over T steps that cancels to a small value
        # keeps its terms' rounding, which differs between the kernel's
        # fused multiply-adds and cuBLAS: an absolute allowance of 1e-5 of
        # each output's largest entry (chip_smoke.py's K2_SCALE)
        for a, b in zip(got, want):
            torch.testing.assert_close(
                a, b, rtol=RTOL, atol=ATOL + 1e-5 * float(b.abs().max()))


@pytest.mark.cuda
def test_adjoint_kernel_matches_float64_reference_on_card(cuda):
    """A second reference beside the test above: K2 against the plain K2 in
    float64 on the same float32 stores and cotangents (upcast), so that K2
    is held to its arithmetic's exact value and not only to the float32
    plain version's rounding, which the last bit of K1's stores moves; the
    same cases and the same tolerance."""
    for spec, ins, T in _adjoint_cases(cuda):
        out = kg.gains_fwd(*ins, T, stores=True)
        g = torch.Generator(device=cuda).manual_seed(0)
        cots = [0.3 * torch.randn(x.shape, generator=g, device=cuda)
                for x in out[:3]]
        A, Bm, _, R, _, F, VV, WW, _ = ins
        args = (A, Bm, R, F, VV, WW, *out[3:], *cots)
        got = kg.fused_gains_vjp(*args)
        want = kg.fused_gains_vjp_reference(*(x.double() for x in args))
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            torch.testing.assert_close(
                a.double(), b, rtol=RTOL,
                atol=ATOL + 1e-5 * float(b.abs().max()))

