"""The System layer: closed-loop simulation and the marginalized likelihood
(port of :mod:`lqg_tpu.system`).

``simulate`` rolls all trials out together in one time loop; the likelihood
computes gains and the data-free covariance recursion once per parameter
set.  Dispatch between the hand-written kernels and the scans is explicit:
``method="auto"`` picks a kernel exactly where the JAX package picks its
Pallas kernel on a TPU - a CUDA float32 tensor, a spec in the kernel's scope
with ``zero_affine`` set - whether or not a gradient is needed: each
kernel's ``torch.autograd.Function`` carries its backward kernel (K2, K4).
``method="fused"`` or ``"scan"`` forces a path.

A stationary spec may carry one leading parameter-set axis ``P`` (the
tracking models broadcast tensor parameters over it): ``gains`` then
returns ``(T, P, ., .)`` and ``log_likelihood`` takes ``x (P, n, T+1, d)``
and returns ``(P, n)``, the batch-first counterpart of ``jax.vmap`` over
the JAX constructors.
"""

from __future__ import annotations

from typing import Optional

import torch

from lqg_tpu_torch.config import as_tensors, pin_precision
from lqg_tpu_torch.spec import LQGSpec
from lqg_tpu_torch.ops import riccati, kalman, gaussian
from lqg_tpu_torch.ops.kernels.gains import fused_gains, fused_gains_available
from lqg_tpu_torch.ops.kernels.likelihood import (
    conditioned_log_likelihood_fused, fused_ll_available)
from lqg_tpu_torch.ops.linalg import mT
from lqg_tpu_torch.utils import time_stack_spec, stationary_spec
from lqg_tpu_torch.infer.dists import GaussianSequence, MultivariateNormal


def _stacked(spec: LQGSpec) -> bool:
    return spec.A.dim() > spec.Qf.dim()


def _at(x: torch.Tensor, spec: LQGSpec, t: int) -> torch.Tensor:
    """Step ``t`` of a per-step spec field."""
    return x[..., t, :, :] if _stacked(spec) else x


def _batch_shape(spec: LQGSpec) -> torch.Size:
    """The parameter-set axes of a spec: those before its matrix (and, when
    stacked, time) axes."""
    return spec.Qf.shape[:-2]


def _not_ported(method: str, item: str):
    return NotImplementedError(
        f"method={method!r} is not ported yet (ROADMAP.md Queue 1, {item})")


class System:
    """An actor (subjective internal model) controlling true dynamics.

    Gains are computed from ``actor``; trajectories evolve under
    ``dynamics`` (reference ``lqg/system.py:12-15``).  The specs' tensors
    set the device and dtype of everything the system computes.
    """

    def __init__(self, actor: LQGSpec, dynamics: LQGSpec,
                 horizon: Optional[int] = None):
        self.actor = actor
        self.dynamics = dynamics
        if horizon is None:
            if not _stacked(dynamics):
                raise ValueError("stationary specs require an explicit horizon")
            horizon = dynamics.A.shape[-3]
        self.horizon = horizon
        if actor.device.type == "cuda":
            pin_precision()

    # --- dims API (reference system.py:17-60) ---
    @property
    def T(self) -> int:
        return self.horizon

    @property
    def xdim(self) -> int:
        return self.dynamics.A.shape[-1]

    @property
    def ydim(self) -> int:
        return self.dynamics.F.shape[-2]

    @property
    def bdim(self) -> int:
        return self.actor.A.shape[-1]

    @property
    def udim(self) -> int:
        return self.dynamics.B.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.dynamics.device

    @property
    def dtype(self) -> torch.dtype:
        return self.dynamics.dtype

    # --- gains ---
    @property
    def batch_shape(self) -> torch.Size:
        """Parameter-set axes of the system, ``()`` or ``(P,)``."""
        return torch.broadcast_shapes(_batch_shape(self.actor),
                                      _batch_shape(self.dynamics))

    def _default_Sigma0(self) -> torch.Tensor:
        V0 = _at(self.actor.V, self.actor, 0)
        return V0 @ mT(V0)

    def _fused_ok(self, Sigma0: torch.Tensor) -> bool:
        """Does ``auto`` take the fused gains kernels (K1, K2)?"""
        a = self.actor
        return (a.device.type == "cuda" and a.A.dim() <= 3
                and a.dtype == torch.float32 and a.zero_affine
                and Sigma0.dim() <= 3 and fused_gains_available(a))

    def _fused_ll_ok(self, F: torch.Tensor, x: torch.Tensor) -> bool:
        """Does ``auto`` take the fused likelihood kernels (K3, K4) for the
        joint transitions ``F (T, [P,] j, j)``?"""
        return (x.device.type == "cuda" and F.dim() <= 4
                and x.dtype == F.dtype
                and fused_ll_available(F.shape[-1], x.shape[-1], F.dtype))

    def gains(self, Sigma0=None, method: str = "auto"):
        """Control gains and Kalman gains from the actor's internal model.

        Args:
            method: ``"auto"`` (K1 where it applies, else the scans),
                ``"fused"`` (K1; its plain version on the CPU) or
                ``"scan"`` (:func:`riccati.backward` with ``"jitter"`` and
                :func:`kalman.forward`).  ``"sqrt"`` and ``"steady"`` are
                not ported yet.

        Returns ``(Gains, K)`` with time-leading ``L (T, m, n)``,
        ``l (T, m)``, ``H (T, m, m)`` and ``K (T, n, p)``, each with the
        parameter-set axis after time, ``(T, P, ., .)``, for a batched spec.
        """
        Sigma0 = self._default_Sigma0() if Sigma0 is None else Sigma0
        if method in ("sqrt", "steady"):
            raise _not_ported(method, "item 15")
        if method == "auto":
            method = "fused" if self._fused_ok(Sigma0) else "scan"
        if method == "fused":
            one = self.actor.A.dim() == 2  # unbatched: a batch of one
            spec = LQGSpec(*(x[None] for x in self.actor.tensors()),
                           zero_affine=self.actor.zero_affine) if one \
                else self.actor
            L, H, K = fused_gains(spec, Sigma0[None] if one else Sigma0,
                                  self.horizon)
            if one:
                L, H, K = L[:, 0], H[:, 0], K[:, 0]
            l = L.new_zeros(L.shape[:-1])  # zero affine terms
            return riccati.Gains(L=L, l=l, H=H), K
        if method != "scan":
            raise ValueError(f"method must be auto|fused|scan, got {method!r}")
        gains = riccati.backward(self.actor, horizon=self.horizon)
        K = kalman.forward(self.actor, Sigma0=Sigma0, horizon=self.horizon)
        return gains, K

    # --- forward simulation ---
    def simulate(self, generator: Optional[torch.Generator] = None, n=1,
                 x0=None, xhat0=None, Sigma0=None, return_all=False):
        """Simulate ``n`` closed-loop trials.

        Draws the process and observation noise from ``generator`` (on the
        system's device) and runs :meth:`rollout`.  Returns ``(n, T+1,
        xdim)`` states with ``x0`` prepended, or ``(x, x_hat, y, u)`` when
        ``return_all``.
        """
        kw = dict(generator=generator, dtype=self.dtype, device=self.device)
        eps = torch.randn((self.horizon, n, self.dynamics.V.shape[-1]), **kw)
        eta = torch.randn((self.horizon, n, self.dynamics.W.shape[-1]), **kw)
        return self.rollout(eps, eta, x0=x0, xhat0=xhat0, Sigma0=Sigma0,
                            return_all=return_all)

    def rollout(self, eps, eta, x0=None, xhat0=None, Sigma0=None,
                return_all=False):
        """Closed-loop trials driven by given standard-normal noise:
        ``eps (T, n, k)`` for the process, ``eta (T, n, l)`` for the
        observations (reference ``system.py:62-140``)."""
        T, n = eps.shape[:2]
        if self.batch_shape:
            raise ValueError(
                f"simulate takes an unbatched System; this one has "
                f"parameter-set axes {tuple(self.batch_shape)}")
        if T != self.horizon:
            raise ValueError(f"noise has {T} steps, horizon is {self.horizon}")
        gains, K = self.gains(Sigma0)
        like = dict(dtype=self.dtype, device=self.device)
        x = torch.zeros(self.xdim, **like) if x0 is None else x0
        x_hat = torch.zeros(self.bdim, **like) if xhat0 is None else xhat0
        x = x.expand(n, self.xdim)
        x_hat = x_hat.expand(n, self.bdim)
        x_init, xhat_init = x, x_hat

        dyn, act = self.dynamics, self.actor
        out = []
        for t in range(T):
            Ad, Bd, Fd, Vd, Wd = (_at(M, dyn, t) for M in
                                  (dyn.A, dyn.B, dyn.F, dyn.V, dyn.W))
            Aa, Ba, Fa = (_at(M, act, t) for M in (act.A, act.B, act.F))
            # control from the agent's current belief
            u = x_hat @ mT(gains.L[t]) + gains.l[t]
            # true dynamics
            x = x @ mT(Ad) + u @ mT(Bd) + eps[t] @ mT(Vd)
            # observation
            y = x @ mT(Fd) + eta[t] @ mT(Wd)
            # belief update with the actor's internal model
            x_pred = x_hat @ mT(Aa) + u @ mT(Ba)
            x_hat = x_pred + (y - x_pred @ mT(Fa)) @ mT(K[t])
            out.append((x, x_hat, y, u))

        xs, xhats, ys, us = (torch.stack(z, dim=1) for z in zip(*out))
        x = torch.cat([x_init[:, None], xs], dim=1)
        x_hat = torch.cat([xhat_init[:, None], xhats], dim=1)
        if return_all:
            return x, x_hat, ys, us
        return x

    # --- likelihood machinery ---
    def _check_obs(self, x):
        if x.shape[-1] > self.xdim:
            raise ValueError(
                f"observed data has {x.shape[-1]} dims but the dynamics "
                f"state has only {self.xdim}; the observed dims must be a "
                f"prefix of the state")
        if x.shape[-2] != self.horizon + 1:
            raise ValueError(
                f"data has {x.shape[-2]} time steps but the system horizon "
                f"is T={self.horizon} (expected T+1={self.horizon + 1} steps "
                f"including the initial state)")

    def _joint(self, Sigma0=None) -> gaussian.JointSystem:
        gains, K = self.gains(Sigma0)
        return gaussian.joint_system(self.dynamics, self.actor, gains.L, K,
                                     self.horizon)

    def conditional_moments(self, x, Sigma0=None):
        """Conditional moments for a single trial ``x (T+1, d)``: ``mu (T,
        j)`` and ``Sigma (T, j, j)`` over the joint (state, belief) space."""
        joint = self._joint(Sigma0)
        d = x.shape[-1]
        kernel = gaussian.conditional_kernel(joint, d)
        mu = gaussian.conditional_mean(kernel, x[None])[0]
        Sigma = gaussian.conditional_sigma(joint, d)
        return mu, Sigma

    def conditional_distribution(self, x, Sigma0=None) -> GaussianSequence:
        """``p(x_{t+1} | x_{1:t})`` over the observed dims, per trial
        (``x (n, T+1, d)``)."""
        n, Tp1, d = x.shape
        self._check_obs(x)
        joint = self._joint(Sigma0)
        kernel = gaussian.conditional_kernel(joint, d)
        mu = gaussian.conditional_mean(kernel, x)  # (n, T, j)
        Sigma = gaussian.conditional_sigma(joint, d)  # (T, j, j)
        Sigma = Sigma[None, :, :d, :d].expand(n, Tp1 - 1, d, d)
        return GaussianSequence(mu[..., :d], Sigma)

    def log_likelihood(self, x, Sigma0=None, method: str = "auto"):
        """Per-trial log likelihood ``(n,)`` of ``x[:, 1:]`` given the model;
        ``(P, n)`` for a System of ``P`` parameter sets, whose trajectories
        ``x (P, n, T+1, d)`` may broadcast along ``P``.  Differentiable on
        every path.

        Args:
            method: ``"auto"`` (K3 where it applies, else the scan),
                ``"fused"`` (K3; its plain version on the CPU) or ``"scan"``
                (:func:`gaussian.conditional_kernel` and
                :func:`gaussian.trial_log_likelihood`).  ``"blocked"`` and
                ``"pscan"`` are not ported yet.
        """
        d = x.shape[-1]
        self._check_obs(x)
        if method == "blocked":
            raise _not_ported(method, "item 9, kernel K5")
        if method == "pscan":
            raise _not_ported(method, "item 14")
        # trajectories shared by the parameter sets: autograd sums along P
        x = x.expand(torch.broadcast_shapes(self.batch_shape, x.shape[:-3])
                     + x.shape[-3:])
        joint = self._joint(Sigma0)
        if method == "auto":
            method = "fused" if self._fused_ll_ok(joint.F, x) else "scan"
        if method == "fused":
            one = joint.F.dim() == 3  # unbatched: a batch of one
            F = joint.F[:, None] if one else joint.F
            G = joint.G[:, None] if one else joint.G
            F, Q = (torch.movedim(M, 0, 1) for M in (F, G @ mT(G)))
            ll = conditioned_log_likelihood_fused(F, Q, x[None] if one else x)
            return ll[0] if one else ll
        if method != "scan":
            raise ValueError(
                f"method must be auto|fused|scan, got {method!r}")
        kernel = gaussian.conditional_kernel(joint, d)
        return gaussian.trial_log_likelihood(kernel, x)

    def belief_tracking_distribution(self, x, Sigma0=None) -> MultivariateNormal:
        """Posterior over the agent's belief given observed states
        (reference ``system.py:250-257``)."""
        n, Tp1, obs_d = x.shape
        d = self.xdim
        joint = self._joint(Sigma0)
        kernel = gaussian.conditional_kernel(joint, obs_d)
        mu = gaussian.conditional_mean(kernel, x)  # (n, T, j)
        Sigma = gaussian.conditional_sigma(joint, obs_d)  # (T, j, j)
        Sigma = Sigma[None, :, d:, d:].expand(n, Tp1 - 1, self.bdim, self.bdim)
        return MultivariateNormal(mu[..., d:], Sigma)

    def to_distribution(self, Sigma0=None, xdim=None):
        return LQGDistribution(self, Sigma0=Sigma0, xdim=xdim)

    def _repr_latex_(self) -> str:
        """The system matrices as LaTeX for notebooks (reference
        ``system.py:262-328``)."""

        def first(x):
            x = x.detach().cpu().numpy()
            return x if x.ndim == 2 else x[(0,) * (x.ndim - 2)]

        def bmatrix(arr) -> str:
            rows = [" & ".join(f"{v:.4g}" for v in row) for row in arr]
            return "\\begin{bmatrix}" + "\\\\".join(rows) + "\\end{bmatrix}"

        names = ["A", "B", "F", "V", "W", "Q", "R"]
        dyn = [self.dynamics.A, self.dynamics.B, self.dynamics.F,
               self.dynamics.V, self.dynamics.W]
        act = [self.actor.A, self.actor.B, self.actor.F, self.actor.V,
               self.actor.W, self.actor.Q, self.actor.R]

        out = "\\begin{align*} \\text{Dynamics:}"
        for mat, name in zip(dyn, names):
            out += f" &&{name} = {bmatrix(first(mat))}"
        out += "\\\\\\text{Actor:}"
        for mat, name in zip(act, names):
            out += f" &&{name} = {bmatrix(first(mat))}"
        out += "\\end{align*}"
        return out


def Dynamics(A, B, F, V, W, T=1000, *, device=None,
             dtype=torch.float32) -> LQGSpec:
    """Reference-compatible stacked dynamics spec (``system.py:331-344``)."""
    (A, B, F, V, W), device = as_tensors((A, B, F, V, W), device, dtype)
    xdim, udim = A.shape[0], B.shape[1]
    return time_stack_spec(A=A, B=B, F=F, V=V, W=W,
                           Q=A.new_zeros((xdim, xdim)),
                           R=A.new_zeros((udim, udim)), T=T)


def Actor(A, B, F, V, W, Q, R, T=1000, *, device=None,
          dtype=torch.float32) -> LQGSpec:
    """Reference-compatible stacked actor spec (``system.py:347-348``)."""
    mats, _ = as_tensors((A, B, F, V, W, Q, R), device, dtype)
    return time_stack_spec(*mats, T=T)


class LQG(System):
    """Plain LQG: actor and dynamics share one spec (``system.py:351-355``)."""

    def __init__(self, A, B, F, V, W, Q, R, T=1000, *, device=None,
                 dtype=torch.float32):
        mats, _ = as_tensors((A, B, F, V, W, Q, R), device, dtype)
        spec = stationary_spec(*mats)
        super().__init__(actor=spec, dynamics=spec, horizon=T)


class LQGDistribution:
    """Trajectory distribution adapter: ``log_prob`` scores observed
    trajectories, ``sample`` simulates (reference ``system.py:358-376``)."""

    def __init__(self, system: System, xdim=None, Sigma0=None):
        self.system = system
        self.Sigma0 = Sigma0
        self.xdim = system.xdim if xdim is None else xdim
        self.event_shape = (system.T + 1, self.xdim)
        self.batch_shape = ()

    def log_prob(self, x):
        return self.system.log_likelihood(x, Sigma0=self.Sigma0)

    def sample(self, generator: Optional[torch.Generator] = None,
               sample_shape=()):
        if len(sample_shape) == 0:
            return self.system.simulate(generator, n=1, Sigma0=self.Sigma0)[0]
        n = 1
        for s in sample_shape:
            n *= int(s)
        x = self.system.simulate(generator, n=n, Sigma0=self.Sigma0)
        return x.reshape(tuple(sample_shape) + x.shape[1:])

    def __call__(self, generator: Optional[torch.Generator] = None):
        return self.sample(generator)
