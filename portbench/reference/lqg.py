"""The plain reference of the hierarchical data fit: gains, the joint
(state, belief) system, the marginalized trajectory likelihood, the priors
and transforms, the potential with its gradient, Adam, and the closed-loop
simulator that makes the trials.

Written from the published model (Straub & Rothkopf 2022, eLife e76635,
Methods: the LQG observer-actor, its joint system and the Kalman-filter
likelihood of the observed trajectories), in plain PyTorch, step by step,
with autograd for the gradient.  It imports nothing of the program under
test and takes nothing it made: the benchmark hands it the same trials and
parameter points it hands the program.

Every product goes through :class:`Arith`: float64 for the reference, or
float32 with each product's inputs rounded to TF32 for the control (the
precision one step below the float32, TF32-off arithmetic the
configuration states).
"""

from __future__ import annotations

import importlib.util
import math
import os
from typing import Dict, List

import torch

_LOG_2PI = math.log(2.0 * math.pi)
_MODELS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "models")


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, to nearest."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """``a @ b`` with both inputs rounded to TF32 and a float32 sum, as a
    TF32 tensor-core product computes it; the backward's products alike."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = _tf32(a), _tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _tf32(g)
        ga = (g @ b.mT).sum_to_size(a.shape)
        gb = (a.mT @ g).sum_to_size(b.shape)
        return ga, gb


class Arith:
    """The arithmetic of a reference pass: ``dtype`` and whether products
    run in TF32."""

    def __init__(self, dtype=torch.float64, tf32: bool = False):
        if tf32 and dtype != torch.float32:
            raise ValueError("TF32 products take float32 inputs")
        self.dtype, self.tf32 = dtype, tf32

    def mm(self, a, b):
        return _TF32MatMul.apply(a, b) if self.tf32 else a @ b


REFERENCE = Arith(torch.float64)
CONTROL = Arith(torch.float32, tf32=True)


def model_specs(name: str):
    """The spec builder of a model, ``reference/models/<name>.py``."""
    path = os.path.join(_MODELS, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_portbench_ref_{name}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cholesky(H):
    """The lower Cholesky factor of each matrix of ``H`` (its lower
    triangle read); NaN where one is not positive definite, so that a point
    where the model breaks down reads NaN rather than stopping the pass."""
    L, info = torch.linalg.cholesky_ex(H)
    return torch.where((info == 0)[..., None, None], L, math.nan)


def _solve(H, G):
    """``H^-1 G``; NaN where ``H`` is singular."""
    X, info = torch.linalg.solve_ex(H, G)
    return torch.where((info == 0)[..., None, None], X, math.nan)


def control_gains(actor: dict, T: int, ar: Arith):
    """LQR feedback gains ``L_t (T, P, m, n)``, ``u_t = L_t x_t``, by the
    backward Riccati recursion from ``S_T = Q``:

        H = R + B^T S B,  G = B^T S A,  L = -H^-1 G,
        S <- Q + A^T S A + G^T L
    """
    A, B, Q, R = actor["A"], actor["B"], actor["Q"], actor["R"]
    mm = ar.mm
    S = Q
    Ls: List[torch.Tensor] = [None] * T
    for t in range(T - 1, -1, -1):
        SA = mm(S, A)
        G = mm(B.mT, SA)
        L = -_solve(R + mm(B.mT, mm(S, B)), G)
        S = Q + mm(A.mT, SA) + mm(G.mT, L)
        Ls[t] = L
    return torch.stack(Ls)


def kalman_gains(actor: dict, T: int, ar: Arith):
    """Kalman gains ``K_t (T, P, n, p)`` of the actor's internal model from
    ``P_0 = V V^T``: predict, then update on each observation,

        P <- A P A^T + V V^T,  K = P F^T (F P F^T + W W^T)^-1,
        P <- P - K F P
    """
    A, F, V, W = actor["A"], actor["F"], actor["V"], actor["W"]
    mm = ar.mm
    VV, WW = mm(V, V.mT), mm(W, W.mT)
    Pc, Ks = VV, []
    for _ in range(T):
        Pc = mm(mm(A, Pc), A.mT) + VV
        FP = mm(F, Pc)
        K = _solve(mm(FP, F.mT) + WW, FP).mT
        Pc = Pc - mm(K, FP)
        Ks.append(K)
    return torch.stack(Ks)


def joint_system(dyn: dict, act: dict, Ls, Ks, ar: Arith):
    """The joint (state, belief) transitions ``F (T, P, j, j)`` and noise
    scales ``G (T, P, j, c)`` of every step, from the gains:

        F = [[A_d,       B_d L                                       ],
             [K F_d A_d, A_a + B_a L - K F_a A_a + K (F_d B_d - F_a B_a) L]]
        G = [[V_d,       0    ],
             [K F_d V_d, K W_d]]
    """
    mm = ar.mm
    T = Ls.shape[0]
    ex = lambda M: M.expand((T,) + M.shape)
    Ad, Bd, Fd, Vd, Wd = (ex(dyn[k]) for k in "ABFVW")
    Aa, Ba, Fa = (ex(act[k]) for k in "ABF")
    KFd = mm(Ks, Fd)
    top = torch.cat([Ad, mm(Bd, Ls)], -1)
    bottom = torch.cat([mm(KFd, Ad),
                        Aa + mm(Ba, Ls) - mm(Ks, mm(Fa, Aa))
                        + mm(mm(Ks, mm(Fd, Bd) - mm(Fa, Ba)), Ls)], -1)
    zeros = Vd.new_zeros(Vd.shape[:-1] + (Wd.shape[-1],))
    G = torch.cat([torch.cat([Vd, zeros], -1),
                   torch.cat([mm(KFd, Vd), mm(Ks, Wd)], -1)], -2)
    return torch.cat([top, bottom], -2), G


def log_likelihood(Fj, Gj, x, ar: Arith):
    """Per-trial log likelihood ``(P, N)`` of trajectories ``x (P, N, T+1,
    d)`` under the joint system ``(Fj, Gj)``, whose ``d`` observed dims lead
    the state: each step ``x_t`` given ``x_0 .. x_{t-1}``, the belief
    marginalized, for ``t = 1 .. T``.  The covariance, from ``G_0 G_0^T``,
    is conditioned on the observed dims and propagated; the mean likewise
    per trial, from ``(x_0, 0)``."""
    mm = ar.mm
    T, d = Fj.shape[0], x.shape[-1]
    j = Fj.shape[-1]
    X = x.movedim(-3, -1)  # (P, T+1, d, N)
    Q = mm(Gj, Gj.mT)
    Sigma = Q[0]
    mu = torch.cat([X[:, 0], X.new_zeros(X.shape[:1] + (j - d,)
                                         + X.shape[-1:])], -2)
    chols, mus = [], []
    for t in range(T + 1):
        chol = _cholesky(Sigma[..., :d, :d])
        chols.append(chol)
        mus.append(mu[..., :d, :])
        if t == T:
            break
        FS = mm(Fj[t], Sigma)
        J = torch.cholesky_solve(FS[..., :d].mT, chol).mT
        Sigma = mm(FS, Fj[t].mT) + Q[t] - mm(J, FS[..., :d].mT)
        mu = mm(Fj[t], mu) + mm(J, X[:, t] - mu[..., :d, :])
    # the scores of steps 1 .. T at once
    chol = torch.stack(chols[1:])  # (T, P, d, d)
    w = torch.linalg.solve_triangular(
        chol, X[:, 1:].movedim(1, 0) - torch.stack(mus[1:]), upper=False)
    quad = (w * w).sum((0, -2))  # (P, N)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(
        (0, -1))
    return -0.5 * (quad + (logdet + T * d * _LOG_2PI)[:, None])


class Fit:
    """The hierarchical fit of one configuration: shared parameters, one
    latent per condition for the others, positive by ``exp``, the
    configuration's priors, over trials ``x (Nc, N, T+1, d)``.

    ``names`` are the coordinates of ``u`` in sorted order."""

    def __init__(self, config: dict, x: torch.Tensor):
        self.config = config
        self.specs = model_specs(config["model"]).specs
        self.x = x
        shared = sorted(config["shared_params"])
        per = sorted(config["per_condition"])
        nc = config["conditions"]
        self.shared, self.per = shared, per
        self.names = sorted(shared + [f"{p}_{c}" for p in per
                                      for c in range(nc)])

    def prior_of(self, name: str):
        priors = self.config["priors"]
        return priors[name] if name in priors else priors[name.rsplit(
            "_", 1)[0]]

    def log_prior(self, params: Dict[str, torch.Tensor]):
        lp = 0.0
        for name in self.names:
            kind, *h = self.prior_of(name)
            v = params[name]
            if kind == "halfnormal":
                (scale,) = h
                lp = lp + (0.5 * math.log(2.0 / math.pi) - math.log(scale)
                           - 0.5 * (v / scale) ** 2)
            elif kind == "lognormal":
                loc, scale = h
                z = (torch.log(v) - loc) / scale
                lp = lp + (-0.5 * (z * z + _LOG_2PI) - math.log(scale)
                           - torch.log(v))
            else:
                raise ValueError(f"unknown prior {kind!r}")
        return lp

    def prior_median(self, name: str) -> float:
        kind, *h = self.prior_of(name)
        if kind == "halfnormal":
            return h[0] * math.sqrt(2.0) * 0.4769362762044699  # erfinv(0.5)
        return math.exp(h[0])

    def set_params(self, params: Dict[str, torch.Tensor], C: int):
        """The model's parameters ``(C Nc,)`` of every (chain, condition)
        from the chains' ``(C,)`` values."""
        nc = self.config["conditions"]
        out = {n: params[n][:, None].expand(C, nc).reshape(-1)
               for n in self.shared}
        for p in self.per:
            out[p] = torch.stack([params[f"{p}_{c}"] for c in range(nc)],
                                 -1).reshape(-1)
        return out

    def log_likelihood(self, u: torch.Tensor, ar: Arith):
        """The total log likelihood of each chain, ``(C,)``, at ``u (C,
        D)``, and the constrained parameters."""
        cfg = self.config
        C = u.shape[0]
        params = {n: torch.exp(u[:, i]) for i, n in enumerate(self.names)}
        act, dyn = self.specs(self.set_params(params, C), cfg, ar.dtype,
                              u.device)
        T = self.x.shape[-2] - 1
        Fj, Gj = joint_system(dyn, act, control_gains(act, T, ar),
                              kalman_gains(act, T, ar), ar)
        x = self.x.to(ar.dtype)
        X = x.expand((C,) + x.shape).reshape((-1,) + x.shape[1:])
        lls = log_likelihood(Fj, Gj, X, ar)
        return lls.reshape(C, -1).sum(-1), params

    def evaluate(self, u: torch.Tensor, ar: Arith, grad: bool = True,
                 block: int = 64):
        """``(pe, grad, ll)`` at ``u (C, D)``, in blocks of chains: ``ll``
        the total log likelihood, ``pe = -(log prior + log |J| + ll)`` the
        potential before the baseline's shift (which moves no gradient),
        ``grad`` its gradient (``None`` without ``grad``)."""
        outs = []
        for lo in range(0, u.shape[0], block):
            with torch.set_grad_enabled(grad):
                ub = u[lo:lo + block].to(ar.dtype).detach().requires_grad_(
                    grad)
                ll, params = self.log_likelihood(ub, ar)
                pe = -(self.log_prior(params) + ub.sum(-1) + ll)
                g = torch.autograd.grad(pe.sum(), ub)[0] if grad else None
            outs.append((pe.detach(), g, ll.detach()))
        pe, g, ll = zip(*outs)
        return torch.cat(pe), (torch.cat(g) if grad else None), torch.cat(ll)


def adam_follow(fit: Fit, u0: torch.Tensor, first, steps: int, lr: float,
                ar: Arith, b1=0.9, b2=0.999, eps=1e-8):
    """The potentials (before the baseline's shift) and log likelihoods
    ``(steps,)`` at the start points of ``steps`` Adam steps from ``u0 (1,
    D)``, whose own ``(pe, grad, ll)`` are ``first``: each update
    ``-lr m_hat / (sqrt(v_hat) + eps)`` with bias-corrected moments."""
    u = u0.to(ar.dtype)
    m, v = torch.zeros_like(u), torch.zeros_like(u)
    pe, g, ll = first
    losses, lls = [pe[0]], [ll[0]]
    for k in range(1, steps):
        m = (1 - b1) * g + b1 * m
        v = (1 - b2) * g * g + b2 * v
        u = u - lr * (m / (1 - b1 ** k)) / (torch.sqrt(v / (1 - b2 ** k))
                                            + eps)
        pe, g, ll = fit.evaluate(u, ar, grad=k < steps - 1)
        losses.append(pe[0])
        lls.append(ll[0])
    return torch.stack(losses), torch.stack(lls)


def simulate(config: dict, generator: torch.Generator, device) -> torch.Tensor:
    """Trials ``(Nc, N, T+1, d)`` (float64) of the configuration's model at
    its ``truth``, one parameter set per condition: the closed loop run from
    zero state and belief, noise drawn from ``generator``.  ``d`` is the
    number of observed dims, the leading entries of the true state."""
    cfg, ar = config, REFERENCE
    nc, N, T = cfg["conditions"], cfg["trials"], cfg["T"]
    truth = cfg["truth"]
    like = dict(dtype=torch.float64, device=device)
    params = {p: torch.full((nc,), float(truth[p]), **like)
              for p in cfg["shared_params"]}
    for p in cfg["per_condition"]:
        params[p] = torch.tensor([truth[f"{p}_{c}"] for c in range(nc)],
                                 **like)
    act, dyn = model_specs(cfg["model"]).specs(params, cfg, torch.float64,
                                               device)
    Ls, Ks = control_gains(act, T, ar), kalman_gains(act, T, ar)
    n, b = dyn["A"].shape[-1], act["A"].shape[-1]
    kw = dict(generator=generator, **like)
    eps = torch.randn((T, nc, dyn["V"].shape[-1], N), **kw)
    eta = torch.randn((T, nc, dyn["W"].shape[-1], N), **kw)
    xs = torch.zeros((nc, n, N), **like)
    xh = torch.zeros((nc, b, N), **like)
    out = [xs]
    for t in range(T):
        u = Ls[t] @ xh
        xs = dyn["A"] @ xs + dyn["B"] @ u + dyn["V"] @ eps[t]
        y = dyn["F"] @ xs + dyn["W"] @ eta[t]
        pred = act["A"] @ xh + act["B"] @ u
        xh = pred + Ks[t] @ (y - act["F"] @ pred)
        out.append(xs)
    d = cfg["observed_dims"]
    return torch.stack(out, 1)[:, :, :d].permute(0, 3, 1, 2).contiguous()
