"""Sharded inference: the trial-parallel likelihood, the horizon-parallel
likelihood and rank-parallel chains (port of
:mod:`lqg_tpu.parallel.sharding`).

Each rank holds its block of the batch and computes on it; the results
meet in all-reduces over one mesh axis (:class:`~lqg_tpu_torch.parallel.
mesh.Mesh`), so that every rank ends with the global value, where JAX
partitions one program and reduces with ``psum``.
"""

from __future__ import annotations

from typing import Callable

import torch

from lqg_tpu_torch.ops.gaussian import JointSystem
from lqg_tpu_torch.parallel.mesh import AxisSharding, Mesh, replicate, \
    shard_batch
from lqg_tpu_torch.parallel.pscan import (FilterElement, _compose_filter,
                                          _scan_filter, filter_pieces,
                                          identity_filter, step_scores)


class _Broadcast(torch.autograd.Function):
    """Identity forward; backward, the gradients summed over the axis, in
    one all-reduce a dtype: one node, so that every rank runs the same
    collectives in the same order."""

    @staticmethod
    def forward(ctx, mesh, axis, *xs):
        ctx.mesh, ctx.axis = mesh, axis
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        out = list(gs)
        for dtype in sorted({g.dtype for g in gs}, key=str):
            at = [j for j, g in enumerate(gs) if g.dtype == dtype]
            summed = ctx.mesh.psum(torch.cat([gs[j].reshape(-1) for j in at]),
                                   ctx.axis)
            for j, part in zip(at, summed.split([gs[j].numel() for j in at])):
                out[j] = part.reshape(gs[j].shape).to(gs[j].device)
        return (None, None, *out)


class _Reduce(torch.autograd.Function):
    """The sum over the axis forward; the identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.psum(x, axis).to(x.device)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Tie(torch.autograd.Function):
    """``x`` unchanged, with ``deps`` in its graph at a zero gradient: a
    rank whose value reads none of ``deps`` still reaches their
    collectives in its backward, so that the ranks' collectives pair up."""

    @staticmethod
    def forward(ctx, x, *deps):
        ctx.like = [(d.shape, d.dtype, d.device) for d in deps]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=dt, device=dv) if need else None
                     for (s, dt, dv), need in zip(ctx.like,
                                                  ctx.needs_input_grad[1:])))


def _leaves(params) -> list:
    if torch.is_tensor(params):
        return [params]
    if isinstance(params, dict):
        return [leaf for v in params.values() for leaf in _leaves(v)]
    return []


def _rebuild(params, leaves):
    if torch.is_tensor(params):
        return next(leaves)
    if isinstance(params, dict):
        return {k: _rebuild(v, leaves) for k, v in params.items()}
    return params


def _broadcast(params, mesh: Mesh, axis: str):
    """The tensors of ``params`` (a tensor or a dict of them) through one
    :class:`_Broadcast`."""
    leaves = _leaves(params)
    if not leaves:
        return params
    return _rebuild(params, iter(_Broadcast.apply(mesh, axis, *leaves)))


def sharded_log_likelihood(model_builder: Callable, x, mesh: Mesh,
                           axis: str = "dp"):
    """Build a trial-sharded total-log-likelihood function.

    Args:
        model_builder: params (a dict of tensors, or a tensor) ->
            ``System``.
        x: trials ``(n, T+1, d)``; ``n`` must divide by the mesh axis size.
        mesh: rank mesh with axis ``axis``.

    Returns ``total_ll(params)``: the sum over all trials, on every rank.
    Each rank scores its block of trials; the sum over the axis is an
    all-reduce whose backward is the identity, and the parameters enter
    through an identity whose backward all-reduces, so that autograd leaves
    the global gradient on every rank, as ``jax.grad`` of a ``psum`` under
    ``shard_map`` does.
    """
    x_shard = shard_batch(x, mesh, axis)

    def total_ll(params):
        system = model_builder(_broadcast(params, mesh, axis))
        return _Reduce.apply(system.log_likelihood(x_shard).sum(), mesh,
                             axis)

    return total_ll


def sharded_chains_run(mcmc, rng, mesh: Mesh, axis: str = "chains",
                       checkpoint_path=None, **run_kwargs):
    """Run an :class:`lqg_tpu_torch.infer.mcmc.MCMC` with its chains split
    over a mesh axis: each rank runs its block of ``mcmc.num_chains /
    size`` chains (the draws of the unsharded run, chain for chain), and
    every rank ends with all chains' draws.  ``checkpoint_path`` forwards
    to :meth:`MCMC.run` (rank 0 writes, every rank reads)."""
    axis_size = mesh.shape[axis]
    if mcmc.num_chains % axis_size:
        raise ValueError(
            f"num_chains={mcmc.num_chains} must divide by mesh axis "
            f"{axis!r} of size {axis_size}")
    return mcmc.run(rng, chain_sharding=AxisSharding(mesh, axis),
                    checkpoint_path=checkpoint_path, **run_kwargs)


def sequence_parallel_log_likelihood(system, x, mesh: Mesh,
                                     axis: str = "sp") -> torch.Tensor:
    """Likelihood with the HORIZON split over a mesh axis.

    The filter elements of the associative-scan likelihood
    (:func:`lqg_tpu_torch.parallel.pscan.trial_log_likelihood_assoc`) are
    split into contiguous blocks of steps, one a rank (``torch.tensor_split``
    sizes, so any T works).  Each rank builds and scans its block, the
    ranks share their blocks' totals, each composes the earlier ranks'
    totals in rank order and applies them to its local prefixes, scores its
    steps, and the per-trial sums are all-reduced.  The gather of the
    totals and the sum are collectives that autograd sees, and the joint
    system enters through an identity whose backward all-reduces, so that
    every rank's gradient is the global one, as ``jax.grad`` of JAX's
    single sharded program gives.

    Args:
        system: a :class:`lqg_tpu_torch.system.System`.
        x: trials ``(n, T+1, d)``, whole on every rank.
        mesh: rank mesh with axis ``axis``.

    Returns ``(n,)`` per-trial log likelihoods (``(P, n)`` for ``P``
    parameter sets), the same on every rank.
    """
    x = replicate(x, mesh)
    system._check_obs(x)
    x = x.expand(torch.broadcast_shapes(system.batch_shape, x.shape[:-3])
                 + x.shape[-3:])
    # the whole joint system on every rank; each rank's gradient in it
    # covers its own steps, and the backward sums them over the axis
    F, G, x = _Broadcast.apply(mesh, axis, *system._joint(), x)
    joint = JointSystem(F, G)
    T = F.shape[0]
    k, i = mesh.shape[axis], mesh.index(axis)
    lo = i * (T // k) + min(i, T % k)
    hi = lo + T // k + (i < T % k)

    pieces = filter_pieces(joint, x, steps=slice(lo, hi))
    if pieces.elems is None:  # an empty block
        local, total = None, identity_filter(filter_pieces(
            joint, x, steps=slice(0, 1)).elems)
        total = total._replace(A=_Tie.apply(total.A, F))
    else:
        local = _scan_filter(pieces.elems)
        total = FilterElement(*(leaf[-1:] for leaf in local))
    totals = FilterElement(*mesh.gather(list(total), axis))

    # the earlier ranks' blocks composed in rank order: the prefix up to
    # this block, applied to the local prefixes
    before = None
    for r in range(i):
        t_r = FilterElement(*(leaf[r:r + 1] for leaf in totals))
        before = t_r if before is None else _compose_filter(first=before,
                                                             second=t_r)
    ll = torch.zeros_like(pieces.ll1)
    if local is not None:
        if before is not None:
            local = _compose_filter(
                first=FilterElement(*(b.expand(l.shape)
                                      for b, l in zip(before, local))),
                second=local)
            # the step after a prefix is scored from it: the first step of
            # the block from the prefix before the block
            local = FilterElement(*(torch.cat([b, l]) for b, l in
                                    zip(before, local)))
        if pieces.F.shape[0]:
            ll = step_scores(pieces, local.b[:-1], local.C[:-1])
    if i == 0:  # x_1's score, once
        ll = ll + pieces.ll1
    # rank 0 and an empty block read none of the totals: tied to them,
    # every rank's backward runs the gather's collective
    return _Reduce.apply(_Tie.apply(ll, *totals), mesh, axis)
