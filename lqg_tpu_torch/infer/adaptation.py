"""Stan-style warmup adaptation: dual-averaging step size and inverse mass
(port of :mod:`lqg_tpu.infer.adaptation`).

Companions to :mod:`lqg_tpu_torch.infer.hmc`, batch-first over chains:

* :func:`find_reasonable_step_size` - double or halve each chain's step
  until its one-step acceptance probability crosses 0.5;
* dual averaging (Nesterov / Hoffman-Gelman) towards a target acceptance;
* a Welford accumulator of the posterior variance (diagonal) or covariance
  (dense) -> the inverse mass;
* :func:`build_schedule` - the Stan warmup window schedule as numpy
  boolean arrays (the JAX package's own numpy code, copied).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from lqg_tpu_torch.infer.hmc import (IntegratorState, kinetic, leapfrog,
                                     sample_momentum)
from lqg_tpu_torch.ops.linalg import cholesky


# --- dual averaging ---
class DualAveragingState(NamedTuple):
    log_step: torch.Tensor
    log_step_avg: torch.Tensor
    grad_avg: torch.Tensor
    t: torch.Tensor
    mu: torch.Tensor


def da_init(step_size):
    log_step = torch.log(step_size)
    zeros = torch.zeros_like(log_step)
    return DualAveragingState(log_step=log_step, log_step_avg=zeros,
                              grad_avg=zeros, t=zeros,
                              mu=math.log(10.0) + log_step)


def da_update(state: DualAveragingState, accept_prob,
              target=0.8, gamma=0.05, t0=10.0, kappa=0.75):
    t = state.t + 1.0
    g = target - accept_prob
    grad_avg = (1 - 1 / (t + t0)) * state.grad_avg + g / (t + t0)
    log_step = state.mu - torch.sqrt(t) / gamma * grad_avg
    eta = t ** -kappa
    log_step_avg = eta * log_step + (1 - eta) * state.log_step_avg
    return DualAveragingState(log_step=log_step, log_step_avg=log_step_avg,
                              grad_avg=grad_avg, t=t, mu=state.mu)


# --- Welford variance / covariance ---
class WelfordState(NamedTuple):
    mean: torch.Tensor   # (C, D)
    m2: torch.Tensor     # (C, D) running variance or (C, D, D) covariance
    count: torch.Tensor  # (C,)


def welford_init(C: int, D: int, dense: bool = False, dtype=torch.float64,
                 device=None):
    kw = dict(dtype=dtype, device=device)
    m2 = torch.zeros((C, D, D) if dense else (C, D), **kw)
    return WelfordState(mean=torch.zeros((C, D), **kw), m2=m2,
                        count=torch.zeros(C, **kw))


def welford_update(state: WelfordState, x):
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count[:, None]
    if state.m2.dim() == 3:
        m2 = state.m2 + delta[:, :, None] * (x - mean)[:, None, :]
    else:
        m2 = state.m2 + delta * (x - mean)
    return WelfordState(mean=mean, m2=m2, count=count)


def _count(state: WelfordState, dims: int):
    return state.count.reshape(state.count.shape + (1,) * dims)


def welford_variance(state: WelfordState, regularize: bool = True):
    n = _count(state, state.m2.dim() - 1)
    var = state.m2 / torch.clamp(n - 1.0, min=1.0)
    if regularize:
        # Stan's shrinkage toward unit variance
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return var


def welford_mass(state: WelfordState, regularize: bool = True):
    """Inverse-mass estimate in the representation :mod:`hmc` expects: the
    posterior-variance vector from a diagonal accumulator, the
    lower-Cholesky factor of the (shrunk) posterior covariance from a dense
    one (NaN, not an exception, where it is not positive-definite)."""
    if state.m2.dim() == 2:
        return welford_variance(state, regularize)
    n = _count(state, 2)
    cov = state.m2 / torch.clamp(n - 1.0, min=1.0)
    if regularize:
        eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
        cov = (n / (n + 5.0)) * cov + 1e-3 * (5.0 / (n + 5.0)) * eye
    return cholesky(cov)


# --- step-size search ---
def find_reasonable_step_size(value_and_grad, inv_mass, z, pe, grad, eps,
                              init_step=1.0, target=0.5, max_iter=60):
    """Heuristic of Hoffman & Gelman (2014), Algorithm 4, for every chain:
    its step doubles (or halves) until the one-step log acceptance crosses
    ``log(target)``, at most ``max_iter`` times.  ``eps (C, D)`` are the
    momentum normals (JAX's draw from ``key_ss``)."""
    r = sample_momentum(eps, inv_mass)
    energy0 = pe + kinetic(inv_mass, r)
    state0 = IntegratorState(z=z, r=r, pe=pe, grad=grad)

    def log_accept(step):
        s = leapfrog(value_and_grad, inv_mass, step, state0)
        delta = energy0 - (s.pe + kinetic(inv_mass, s.r))
        return torch.where(torch.isnan(delta), -math.inf, delta)

    log_target = math.log(target)
    step = torch.full_like(pe, init_step)
    delta = log_accept(step)
    up = delta > log_target
    it = torch.zeros(pe.shape, dtype=torch.int32, device=pe.device)
    while True:
        # the first test reads delta at init_step, as the JAX loop's first
        # cond recomputes it
        crossed = torch.where(up, delta <= log_target, delta >= log_target)
        going = ~crossed & (it < max_iter)
        if not bool(going.any()):
            return step
        step = torch.where(going, torch.where(up, step * 2.0, step * 0.5),
                           step)
        it = it + going.int()
        delta = log_accept(step)


# --- warmup schedule ---
def build_schedule(num_warmup, init_buffer=75, term_buffer=50, window=25):
    """Stan's three-phase schedule.

    Returns numpy bool arrays of length ``num_warmup``:
    ``(in_window, window_end)`` - whether step i is inside a slow
    (mass-estimation) window, and whether it closes one.
    """
    in_window = np.zeros(num_warmup, dtype=bool)
    window_end = np.zeros(num_warmup, dtype=bool)

    if num_warmup < 20:
        return in_window, window_end

    if init_buffer + window + term_buffer > num_warmup:
        init_buffer = int(0.15 * num_warmup)
        term_buffer = int(0.1 * num_warmup)
        window = num_warmup - init_buffer - term_buffer

    start = init_buffer
    size = window
    while start < num_warmup - term_buffer:
        end = min(start + size, num_warmup - term_buffer)
        # expand the last window to absorb the remainder
        if end + 2 * size > num_warmup - term_buffer:
            end = num_warmup - term_buffer
        in_window[start:end] = True
        window_end[end - 1] = True
        start = end
        size *= 2

    return in_window, window_end
