"""K2, the gains adjoint, behind ``fused_gains``'s ``torch.autograd.Function``.

On the CPU the Function runs the plain versions of K1 (with stores) and K2:
held against the JAX package's adjoint kernel in interpret mode (float32)
and against autograd through the plain K1 (float64).  On a card (``-m
cuda``): K1's stores and K2 against their plain versions.  JAX is imported
inside the tests that use it, so that the card's tests collect where JAX
is not installed.
"""

import numpy as np
import pytest
import torch

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


def _cotangents(seed, T, B, n, m, p):
    rng = np.random.default_rng(seed)
    return [0.3 * rng.normal(size=(T, B) + s) for s in ((m, n), (m, m),
                                                        (n, p))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n,m,p,T", [(2, 1, 2, 12), (2, 1, 2, 7),
                                     (2, 1, 1, 12)])
def test_plain_adjoint_matches_pallas(n, m, p, T):
    import jax.numpy as jnp
    from lqg_tpu.ops.pallas.gains import _gains_adjoint_call
    from lqg_tpu.utils import stationary_spec as jstationary_spec

    f = _random_spec(42 + T + p, n=n, m=m, p=p)
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


@pytest.mark.parametrize("T", [13, 240])
def test_plain_adjoint_matches_autograd(T):
    """The Function's backward (the plain K2) against autograd through the
    plain K1, float64, on random cotangents; 240 steps reach the regime in
    which an unprojected Kalman adjoint carry grows (see csrc/gains.cu)."""
    f = _random_spec(3)
    B = 3
    c, av, st, sc = (torch.tensor(v) for v in (np.logspace(-2, 1, B),
                                               np.linspace(0.1, 1.0, B),
                                               np.linspace(2.0, 40.0, B),
                                               np.linspace(0.5, 10.0, B)))
    cases = [_torch_spec(f, torch.float64)[0],
             tracking_spec(1, 1.0, av, st, sc, c, 1 / 60, device="cpu",
                           dtype=torch.float64)]
    for case in cases:
        ins = [getattr(case, k).expand((B,) + getattr(case, k).shape[-2:])
               .clone().requires_grad_() for k in FIELDS]
        spec = case._replace(**dict(zip(FIELDS, ins)))
        Sigma0 = (ins[6] @ mT(ins[6])).detach().requires_grad_()
        n, m, p = ins[0].shape[-1], ins[1].shape[-1], ins[5].shape[-2]
        cots = [torch.tensor(x) for x in _cotangents(5, T, B, n, m, p)]
        leaves = ins + [Sigma0]
        got = torch.autograd.grad(kg.fused_gains(spec, Sigma0, T), leaves,
                                  cots)
        want = torch.autograd.grad(kg.fused_gains_reference(spec, Sigma0, T),
                                   leaves, cots)
        for name, a, b in zip(FIELDS + ("Sigma0",), got, want):
            if name in SYMMETRIC:
                a, b = 0.5 * (a + mT(a)), 0.5 * (b + mT(b))
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9 * float(
                b.abs().max()), msg=name)


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


@pytest.mark.cuda
def test_adjoint_kernel_matches_reference_on_card(cuda):
    for B, T in ((24, 1008), (2048, 719)):
        spec = _sweep_spec(B, cuda)
        VV, WW = spec.V @ mT(spec.V), spec.W @ mT(spec.W)
        ins = [x.expand((B,) + x.shape[-2:]).contiguous() for x in (
            spec.A, spec.B, spec.Q, spec.R, spec.Qf, spec.F, VV, WW, VV)]
        out = kg.gains_fwd(*ins, T, stores=True)
        ref = kg.fused_gains_reference(spec, ins[-1], T, stores=True)
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        g = torch.Generator(device=cuda).manual_seed(0)
        cots = [0.3 * torch.randn(x.shape, generator=g, device=cuda)
                for x in out[:3]]
        A, Bm, _, R, _, F, VV, WW, _ = ins
        got = kg.fused_gains_vjp(A, Bm, R, F, VV, WW, *out[3:], *cots)
        want = kg.fused_gains_vjp_reference(A, Bm, R, F, VV, WW, *out[3:],
                                            *cots)
        torch.cuda.synchronize()
        # a cotangent summed over T steps that cancels to a small value
        # keeps its terms' rounding, which differs between the kernel's
        # fused multiply-adds and cuBLAS: an absolute allowance of 1e-5 of
        # each output's largest entry (chip_smoke.py's K2_SCALE)
        for a, b in zip(got, want):
            torch.testing.assert_close(
                a, b, rtol=RTOL, atol=ATOL + 1e-5 * float(b.abs().max()))
