"""No-U-Turn Sampler over a batch of chains (port of :mod:`lqg_tpu.infer.hmc`).

Iterative NUTS with multinomial (biased progressive) sampling and the
generalized no-U-turn criterion, as in the JAX package and Stan/NumPyro:

* the trajectory doubles up to ``max_depth`` times, each new half-tree
  built leaf by leaf;
* internal (balanced-subtree) U-turn checks use the checkpoint stack: even
  leaves store (momentum, running momentum sum) in the slot keyed by the
  popcount of the leaf index, odd leaves close every subtree ending at them
  and test each for a U-turn;
* a leaf diverges at ``delta_energy > max_delta_energy`` (1000), and a NaN
  energy counts as a divergence.

Batch-first: every state tensor has the chains as its leading axis ``C``,
and the potential is evaluated for all chains in one call.  JAX vmaps its
``while_loop``/``fori_loop`` over chains, so they run to the deepest chain
with the finished chains' carries held; here the loops over depth and leaf
are host loops that run to the deepest chain, and each chain's control flow
is a mask applied with ``torch.where``.  No chain reads another's energy or
decisions, so a NaN in one chain stays in that chain.  The leaf loop also
stops once every chain's half-tree has stopped, which changes no result: the
JAX loop runs those leaves and discards them.

Randomness is drawn before a transition into :class:`NUTSDraws`, one field
for each of JAX's draws, so that no generator is called inside the tree (or
inside a captured CUDA graph) and a test can hand the port exactly the draws
JAX's key schedule makes.

``value_and_grad(z)`` gives the potential and its gradient, ``(C,)`` and
``(C, D)``, as new tensors: on the card a replay of one captured CUDA graph
(:mod:`lqg_tpu_torch.infer.capture`).

Under :func:`lqg_tpu_torch.utils.profiling.tracing` a transition records the
spans ``nuts.transition`` > ``nuts.leaf`` > ``nuts.sync`` (the two host
reads, :func:`_any_on_host`) and the counters ``nuts.leaves``,
``nuts.host_syncs`` and, on the device, ``nuts.chain_leaves_useful`` (the
chain-leaves of chains still growing their half-tree).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from lqg_tpu_torch.ops.linalg import mT
from lqg_tpu_torch.utils import profiling

ValueAndGrad = Callable[[torch.Tensor], tuple]


class IntegratorState(NamedTuple):
    z: torch.Tensor     # (C, D) position
    r: torch.Tensor     # (C, D) momentum
    pe: torch.Tensor    # (C,) potential energy at z
    grad: torch.Tensor  # (C, D) d pe / d z


class NUTSDraws(NamedTuple):
    """The random numbers of one transition, each standing for one JAX draw
    (``lqg_tpu/infer/hmc.py``)."""

    eps: torch.Tensor      # (C, D) momentum normals (:60)
    forward: torch.Tensor  # (C, max_depth) bool, doubling d goes forward (:265-266)
    accept: torch.Tensor   # (C, max_depth) half-tree acceptance uniforms (:282)
    leaf: torch.Tensor     # (C, max_depth, 2**(max_depth-1)) leaf uniforms (:124)


def draw_nuts(generator: torch.Generator, C: int, D: int, max_depth: int,
              dtype) -> NUTSDraws:
    """One transition's :class:`NUTSDraws` from ``generator``, on its
    device.  ``random.bernoulli`` is ``uniform < 0.5``, as in JAX."""
    kw = dict(generator=generator, dtype=dtype, device=generator.device)
    return NUTSDraws(
        eps=torch.randn((C, D), **kw),
        forward=torch.rand((C, max_depth), **kw) < 0.5,
        accept=torch.rand((C, max_depth), **kw),
        leaf=torch.rand((C, max_depth, 1 << (max_depth - 1)), **kw))


def _dense(inv_mass: torch.Tensor, r: torch.Tensor) -> bool:
    return inv_mass.dim() > r.dim()


def velocity(inv_mass, r):
    """dz/dt = M^-1 r.  ``inv_mass`` is the diagonal of M^-1 per chain,
    ``(C, D)``, or, for a dense metric, the lower-Cholesky factor ``L`` of
    M^-1 = L L^T per chain, ``(C, D, D)``."""
    if not _dense(inv_mass, r):
        return inv_mass * r
    return (inv_mass @ (mT(inv_mass) @ r[..., None]))[..., 0]


def kinetic(inv_mass, r):
    """0.5 r^T M^-1 r per chain, for either mass representation."""
    if not _dense(inv_mass, r):
        return 0.5 * torch.sum(inv_mass * r * r, -1)
    w = (mT(inv_mass) @ r[..., None])[..., 0]
    return 0.5 * torch.sum(w * w, -1)


def sample_momentum(eps, inv_mass):
    """r ~ N(0, M) from standard normals ``eps (C, D)``.  Dense: M = (L
    L^T)^-1, so r = L^-T eps."""
    if not _dense(inv_mass, eps):
        return eps / torch.sqrt(inv_mass)
    return torch.linalg.solve_triangular(mT(inv_mass), eps[..., None],
                                         upper=True)[..., 0]


def leapfrog(value_and_grad: ValueAndGrad, inv_mass, step_size,
             state: IntegratorState) -> IntegratorState:
    """One velocity-Verlet step per chain, ``step_size (C,)`` signed."""
    half = (0.5 * step_size)[:, None]
    r = state.r - half * state.grad
    z = state.z + step_size[:, None] * velocity(inv_mass, r)
    pe, grad = value_and_grad(z)
    r = r - half * grad
    return IntegratorState(z=z, r=r, pe=pe, grad=grad)


def _uturn(inv_mass, r_left, r_right, rho):
    """Generalized U-turn criterion on a trajectory span, per chain."""
    v_left = velocity(inv_mass, r_left)
    v_right = velocity(inv_mass, r_right)
    return (torch.sum(v_left * rho, -1) <= 0) | (torch.sum(v_right * rho, -1)
                                                  <= 0)


def _pick(mask, new, old):
    """``new`` where ``mask (C,)`` holds, else ``old``: tensors, or tuples
    of them field by field."""
    if isinstance(new, tuple):
        fields = [_pick(mask, a, b) for a, b in zip(new, old)]
        return type(new)(*fields) if hasattr(new, "_fields") else tuple(fields)
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)),
                       new, old)


class _TreeState(NamedTuple):
    right: IntegratorState  # the far end of the half-tree
    z_prop: torch.Tensor
    pe_prop: torch.Tensor
    grad_prop: torch.Tensor
    log_weight: torch.Tensor  # logsumexp(-energy + energy0) over leaves
    rho: torch.Tensor         # sum of momenta over the leaves
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_accept: torch.Tensor  # sum of min(1, exp(-delta_energy))
    num_leaves: torch.Tensor


def _any_on_host(mask: torch.Tensor) -> bool:
    """``mask.any()`` read on the host: the sampler's only waits for the
    card."""
    with profiling.span("nuts.sync"):
        profiling.count("nuts.host_syncs")
        return bool(mask.any())


def _popcount(n: int) -> int:
    return bin(n).count("1")


def _trailing_ones(n: int) -> int:
    return len(bin(n)) - len(bin(n).rstrip("1"))


def _build_subtree(value_and_grad, inv_mass, step_size, forward, depth,
                   edge: IntegratorState, energy0, leaf_u, max_delta_energy,
                   active):
    """Extend the trajectory by ``2**depth`` leapfrog steps from ``edge``
    for the ``active`` chains (``lqg_tpu/infer/hmc.py:100``); the others'
    results are discarded by the caller.  ``leaf_u (C, >= 2**depth)`` are
    the leaves' pick uniforms.  Returns the half-tree's
    :class:`_TreeState`; its ``right`` is the far end whatever the
    direction."""
    eps = torch.where(forward, step_size, -step_size)
    zeros = torch.zeros_like(edge.pe)
    tree = _TreeState(
        right=edge, z_prop=edge.z, pe_prop=edge.pe, grad_prop=edge.grad,
        log_weight=torch.full_like(edge.pe, -math.inf),
        rho=torch.zeros_like(edge.r), turning=zeros.bool(),
        diverging=zeros.bool(), sum_accept=zeros, num_leaves=zeros)
    r_ckpts, rho_ckpts = {}, {}
    state = edge
    for i in range(1 << depth):
        with profiling.span("nuts.leaf"):
            # a half-tree freezes once it turns or diverges: its later leaves
            # are computed by the JAX loop and discarded
            stop = tree.turning | tree.diverging
            # at the first leaf no chain has stopped
            growing = active & ~stop if i else active
            if i and not _any_on_host(growing):
                break
            profiling.count("nuts.leaves")
            profiling.count_device("nuts.chain_leaves_useful", growing)
            new = leapfrog(value_and_grad, inv_mass, eps, state)
            delta = new.pe + kinetic(inv_mass, new.r) - energy0
            delta = torch.where(torch.isnan(delta), math.inf, delta)
            log_w = -delta
            # multinomial progressive sampling within the half-tree
            log_weight = torch.logaddexp(tree.log_weight, log_w)
            take = leaf_u[:, i] < torch.exp(log_w - log_weight)
            rho = tree.rho + new.r
            if i % 2 == 0:  # checkpoint store
                k = _popcount(i)
                r_ckpts[k], rho_ckpts[k] = new.r, tree.rho
                turning = tree.turning
            else:  # close every subtree that ends at this leaf
                idx_max = _popcount(i >> 1)
                turning = tree.turning
                for k in range(idx_max - _trailing_ones(i) + 1, idx_max + 1):
                    turning = turning | _uturn(inv_mass, r_ckpts[k], new.r,
                                               rho - rho_ckpts[k])
            grown = _TreeState(
                right=new,
                z_prop=_pick(take, new.z, tree.z_prop),
                pe_prop=_pick(take, new.pe, tree.pe_prop),
                grad_prop=_pick(take, new.grad, tree.grad_prop),
                log_weight=log_weight, rho=rho, turning=turning,
                diverging=tree.diverging | (delta > max_delta_energy),
                sum_accept=tree.sum_accept + torch.clamp(torch.exp(-delta),
                                                         max=1.0),
                num_leaves=tree.num_leaves + 1)
            tree = _pick(stop, tree, grown)
            state = _pick(stop, state, new)
    return tree


class NUTSInfo(NamedTuple):
    accept_prob: torch.Tensor
    num_steps: torch.Tensor
    diverging: torch.Tensor
    energy: torch.Tensor
    tree_depth: torch.Tensor


def nuts_step(value_and_grad: ValueAndGrad, draws: NUTSDraws, z, pe, grad,
              step_size, inv_mass, max_depth: int = 10,
              max_delta_energy: float = 1000.0,
              depth_cap: Optional[int] = None):
    """One NUTS transition of every chain (``lqg_tpu/infer/hmc.py:229``).

    Args:
        value_and_grad: ``z (C, D) -> (pe (C,), grad (C, D))``.
        draws: the transition's :class:`NUTSDraws`, ``max_depth`` wide.
        z, pe, grad: the chains' positions, potentials and gradients.
        step_size: ``(C,)``; inv_mass: ``(C, D)`` or ``(C, D, D)``.
        depth_cap: stop doubling at this depth (``<= max_depth``), the
            early-warmup cap of :class:`MCMC`.

    Returns ``(z', pe', grad', NUTSInfo)``, each per chain.
    """
    cap = max_depth if depth_cap is None else min(int(depth_cap), max_depth)
    with profiling.span("nuts.transition"):
        r0 = sample_momentum(draws.eps, inv_mass)
        energy0 = pe + kinetic(inv_mass, r0)
        start = IntegratorState(z=z, r=r0, pe=pe, grad=grad)
        zeros = torch.zeros_like(pe)
        left, right = start, start
        prop = (z, pe, grad)
        log_weight, rho = zeros, r0
        turning, diverging = zeros.bool(), zeros.bool()
        sum_accept, num_leaves = zeros, zeros
        depth = torch.zeros(pe.shape, dtype=torch.int32, device=pe.device)
        for d in range(cap):
            # every chain still doubling is at depth d
            active = ~(turning | diverging)
            if not _any_on_host(active):
                break
            forward = draws.forward[:, d]
            edge = _pick(forward, right, left)
            sub = _build_subtree(value_and_grad, inv_mass, step_size,
                                 forward, d, edge, energy0, draws.leaf[:, d],
                                 max_delta_energy, active)
            ok = ~(sub.turning | sub.diverging)
            # biased progressive sampling: move to the new half with
            # probability min(1, W_new / W_old)
            accept = torch.exp(torch.clamp(sub.log_weight - log_weight,
                                           max=0.0))
            take = (draws.accept[:, d] < accept) & ok
            new_prop = _pick(take, (sub.z_prop, sub.pe_prop, sub.grad_prop),
                             prop)
            new_left = _pick(ok & ~forward, sub.right, left)
            new_right = _pick(ok & forward, sub.right, right)
            new_rho = torch.where(ok[:, None], rho + sub.rho, rho)
            turning_total = _uturn(inv_mass, new_left.r, new_right.r, new_rho)
            new = (new_left, new_right, new_prop,
                   torch.where(ok, torch.logaddexp(log_weight, sub.log_weight),
                               log_weight),
                   new_rho, sub.turning | (ok & turning_total), sub.diverging,
                   sum_accept + sub.sum_accept, num_leaves + sub.num_leaves,
                   depth + 1)
            old = (left, right, prop, log_weight, rho, turning, diverging,
                   sum_accept, num_leaves, depth)
            (left, right, prop, log_weight, rho, turning, diverging,
             sum_accept, num_leaves, depth) = _pick(active, new, old)

        info = NUTSInfo(
            accept_prob=sum_accept / torch.clamp(num_leaves, min=1.0),
            num_steps=num_leaves, diverging=diverging, energy=prop[1],
            tree_depth=depth)
    return prop[0], prop[1], prop[2], info
