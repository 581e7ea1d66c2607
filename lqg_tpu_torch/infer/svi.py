"""Point estimation and Gaussian variational guides (port of
:mod:`lqg_tpu.infer.svi`).

Point estimation (MLE/MAP) is Adam on the :class:`ProbModel` potential, and
:class:`AutoMVN` is a full-rank Gaussian guide for variational posteriors
and NeuTra preconditioning, as in the JAX package.  Where JAX runs the steps
as one ``lax.scan`` and vmaps the ELBO's particles, the port runs a Python
loop whose every step calls the potential's value and gradient once
(:meth:`ProbModel.value_and_grad`): on the card a replay of one captured
CUDA graph, the ELBO's particles folded into its chain axis
(:class:`~lqg_tpu_torch.infer.capture.GraphedPotential`).  Nothing in a
loop reads a value on the host; the loss trace stays on the device.

Adam (:func:`adam`) is written on tensors in ``optax.adam``'s order of
operations, so that a float64 trajectory equals optax's.

Under :func:`lqg_tpu_torch.utils.profiling.tracing` every step of
:func:`optimize` and of the ELBO fits records a span ``svi.step``, its card
side marked by CUDA events, inside one span ``svi.optimize`` or ``svi.fit``
a call, and counts ``svi.steps``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from lqg_tpu_torch.infer.capture import GraphedPotential
from lqg_tpu_torch.infer.mcmc import Draws
from lqg_tpu_torch.infer.models import ProbModel
from lqg_tpu_torch.utils import profiling


class GradientTransformation(NamedTuple):
    """An optimizer as optax shapes one: ``state = init(params)``,
    ``updates, state = update(grads, state)``, on lists of tensors."""

    init: Callable
    update: Callable


class AdamState(NamedTuple):
    count: torch.Tensor  # () steps taken, in the parameters' dtype
    mu: tuple
    nu: tuple


def adam(step_size: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    """``optax.adam(step_size)`` on a list of tensors, in optax's order of
    operations: the moments ``(1 - b) g^k + b m``, the bias corrections
    ``1 - b^count``, then ``mu_hat / (sqrt(nu_hat) + eps)`` scaled by
    ``-step_size``.  The step count is a tensor on the parameters' device,
    so that an update reads nothing on the host."""

    def init(params):
        p = params[0]
        return AdamState(count=torch.zeros((), dtype=p.dtype, device=p.device),
                         mu=tuple(torch.zeros_like(x) for x in params),
                         nu=tuple(torch.zeros_like(x) for x in params))

    def update(grads, state):
        mu = tuple((1 - b1) * g + b1 * m for g, m in zip(grads, state.mu))
        nu = tuple((1 - b2) * (g * g) + b2 * v
                   for g, v in zip(grads, state.nu))
        count = state.count + 1
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        updates = tuple(-step_size * ((m / c1) / (torch.sqrt(v / c2) + eps))
                        for m, v in zip(mu, nu))
        return updates, AdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def apply_updates(params, updates) -> list:
    return [p + u for p, u in zip(params, updates)]


class GuideDraws(Draws):
    """The random numbers of a guide fit, on ``device``: a flow's initial
    weights from a generator seeded by ``(seed, 0)``, step ``i``'s ELBO
    particles from one seeded by ``(seed, 1, i)``, so that they depend on
    the step alone.

    A test may hand the fits another object with the methods ``init_iaf``
    and ``eps`` (the JAX package's key schedule, replayed)."""

    def init_iaf(self, dim, hidden, num_layers, loc, init_log_scale):
        from lqg_tpu_torch.infer.flows import make_auto_iaf

        return make_auto_iaf(self._seeded(0), dim, hidden=hidden,
                             num_layers=num_layers, loc=loc,
                             init_log_scale=init_log_scale)

    def eps(self, step: int, P: int, D: int, dtype) -> torch.Tensor:
        """Step ``step``'s standard normals ``(P, D)``."""
        g = self._seeded(1, step)
        return torch.randn((P, D), generator=g, dtype=dtype, device=g.device)


def guide_draws(rng_key, device):
    """A :class:`GuideDraws` for an integer seed; any other draw source as
    it is."""
    if isinstance(rng_key, (int, np.integer)):
        return GuideDraws(rng_key, device)
    return rng_key


def optimize(model: ProbModel, steps: int = 2000, step_size: float = 0.01,
             optimizer=None, return_unconstrained: bool = False,
             chunk_steps: int = 500):
    """Minimize the model's potential from its initial point; returns
    ``(constrained params, losses)``.

    With priors this is MAP estimation, without them MLE (the reference's
    ``max_likelihood``).  With ``return_unconstrained=True`` the raw optimum
    in the model's sampling space is appended (NeuTra callers need it: the
    flow's ``eps`` has no per-parameter transforms to invert).

    Args:
        optimizer: a :class:`GradientTransformation` (default
            ``adam(step_size)``).
        chunk_steps: accepted for the JAX package's signature, where it
            bounds a TPU launch; here it changes nothing.

    Each step calls the potential's value and gradient at ``u (1, D)``: on
    the card a replay of the graph captured at the first step.  The losses
    ``(steps,)`` stay on the model's device.
    """
    del chunk_steps
    if optimizer is None:
        optimizer = adam(step_size)
    u = model.init_unconstrained().detach()[None]
    state = optimizer.init([u])
    losses = []
    with profiling.span("svi.optimize"):
        for _ in range(steps):
            with profiling.span("svi.step", device=True):
                profiling.count("svi.steps")
                pe, grad = model.value_and_grad(u)
                updates, state = optimizer.update([grad], state)
                (u,) = apply_updates([u], updates)
                losses.append(pe[0])
    losses = torch.stack(losses) if losses else u.new_zeros(0)
    u = u[0]
    if return_unconstrained:
        return model.constrain(u), losses, u
    return model.constrain(u), losses


class AutoMVN(NamedTuple):
    """Full-rank Gaussian guide in unconstrained space:
    ``u = loc + scale_tril @ eps``, for ``eps (..., D)``."""

    loc: torch.Tensor
    scale_tril: torch.Tensor

    def sample(self, generator: torch.Generator, sample_shape=()):
        eps = torch.randn(tuple(sample_shape) + self.loc.shape,
                          generator=generator, dtype=self.loc.dtype,
                          device=self.loc.device)
        return self.transform(eps)

    def transform(self, eps):
        return self.loc + eps @ self.scale_tril.mT

    def transform_and_logdet(self, eps):
        return self.transform(eps), self.log_det()

    def log_det(self):
        return torch.log(torch.diagonal(self.scale_tril).abs()).sum()


def _mvn(loc, log_diag, off) -> AutoMVN:
    """JAX's parametrization (``lqg_tpu/infer/svi.py:106-109``)."""
    return AutoMVN(loc=loc, scale_tril=torch.tril(off, -1)
                   + torch.diag(torch.exp(log_diag)))


def fit_auto_mvn(model: ProbModel, rng_key, steps: int = 5000,
                 step_size: float = 0.003, num_particles: int = 8,
                 chunk_steps: int = 200):
    """Fit a full-rank Gaussian guide by maximizing the ELBO; returns
    ``(AutoMVN, losses)``.

    ``rng_key``: an integer seed or a draw source (:class:`GuideDraws`).
    Each step draws ``eps (num_particles, D)`` and evaluates the potential
    of all particles at once, ``u = guide.transform(eps)`` folded into the
    chain axis: the loss is ``mean(potential(u)) - log_det``, the JAX
    package's ``-(mean(log_joint(u)) + log_det)``.  ``chunk_steps`` is
    accepted for the JAX signature and changes nothing.
    """
    del chunk_steps
    loc0 = model.init_unconstrained().detach()
    D, like = loc0.shape[0], dict(dtype=loc0.dtype, device=loc0.device)
    draws = guide_draws(rng_key, loc0.device)
    params = [loc0.clone(), torch.full((D,), -1.0, **like),
              torch.zeros((D, D), **like)]

    def neg_elbo(leaves, eps):
        guide = _mvn(*leaves)
        logp = -GraphedPotential.apply(guide.transform(eps), model)
        return -(torch.mean(logp) + guide.log_det())

    params, losses = _fit(neg_elbo, params, adam(step_size), draws, steps,
                          num_particles, D, skip_nonfinite=False)
    return _mvn(*params), losses


def _fit(neg_elbo, params, optimizer, draws, steps, num_particles, D,
         skip_nonfinite):
    """``steps`` Adam steps on ``neg_elbo(params, eps)``; returns the final
    parameters and the loss trace, on the device.  With ``skip_nonfinite``
    a step whose loss or gradient is not finite updates with zero
    gradients (the moments and the count still advance, as optax's do)."""
    state = optimizer.init(params)
    losses = []
    with profiling.span("svi.fit"):
        for i in range(steps):
            with profiling.span("svi.step", device=True):
                profiling.count("svi.steps")
                eps = draws.eps(i, num_particles, D, params[0].dtype)
                with torch.enable_grad():
                    leaves = [p.detach().requires_grad_() for p in params]
                    loss = neg_elbo(leaves, eps)
                    grads = torch.autograd.grad(loss, leaves)
                if skip_nonfinite:
                    ok = torch.isfinite(loss)
                    for g in grads:
                        ok = ok & torch.isfinite(g).all()
                    grads = [torch.where(ok, g, torch.zeros_like(g))
                             for g in grads]
                updates, state = optimizer.update(grads, state)
                params = apply_updates(params, updates)
                losses.append(loss.detach())
    losses = torch.stack(losses) if losses else params[0].new_zeros(0)
    return [p.detach() for p in params], losses


def _hessian(potential, u0: torch.Tensor) -> torch.Tensor:
    """``H[i, j] = d^2 potential / du_i du_j`` at ``u0 (D,)``: one gradient
    with its graph kept, then one backward pass per row."""
    with torch.enable_grad():
        u = u0.detach().requires_grad_()
        (grad,) = torch.autograd.grad(potential(u), u, create_graph=True)
        rows = [torch.autograd.grad(grad[i], u, retain_graph=True)[0]
                for i in range(u.shape[0])]
    return torch.stack(rows)


def laplace_guide(model: ProbModel, eig_floor: float = 1e-6):
    """Laplace (inverse-Hessian) affine guide at the model's init point.

    The exact Hessian of the unconstrained-space potential at
    ``model.init_unconstrained()`` (run a MAP fit first so that point is the
    mode); returns ``(AutoMVN(loc=mode, scale_tril=chol(H^-1)), w)`` with
    ``w`` the Hessian's eigenvalues, those below ``eig_floor`` times the
    largest clamped to it (``lqg_tpu/infer/svi.py:140-172``).

    The kernels' autograd Functions are once differentiable, so the model
    runs on the scans for the Hessian (``model.method = "scan"``, restored
    afterwards), as ``lqg_tpu`` forces its scans: eager, seconds on the
    card at the data's size.  A potential through ``make_psd`` (the point
    mass) takes its second derivative through ``ops.linalg._Eigh``.
    """
    u0 = model.init_unconstrained().detach()
    method = model.method
    model.method = "scan"
    try:
        hess = _hessian(model.potential, u0)
    finally:
        model.method = method
    hess = 0.5 * (hess + hess.mT)
    # a one-off eigendecomposition of a D x D matrix, outside any graph:
    # torch.linalg.eigh reads its error code on the host, which waits here
    w, v = torch.linalg.eigh(hess)
    w = torch.maximum(w, eig_floor * w.max())
    hinv = (v / w) @ v.mT
    scale_tril = torch.linalg.cholesky(0.5 * (hinv + hinv.mT))
    return AutoMVN(loc=u0, scale_tril=scale_tril), w
