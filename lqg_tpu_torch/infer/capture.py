"""The potential's value and gradient as NUTS calls them: the port's
counterpart of JAX's ``jit(value_and_grad(potential))``.

JAX compiles a whole NUTS transition into one program
(``lqg_tpu/infer/mcmc.py:1-25``).  Eager PyTorch would instead spend host
time on every small op of the potential and of autograd at each leapfrog
(~550 of them for the bounded actor's hierarchical potential).  So on the
card the potential of all chains, ``potential(u)`` and one
``torch.autograd.grad``, is captured once into a CUDA graph with static
buffers ``u (C, D)``, ``pe (C,)`` and ``grad (C, D)``, and each leapfrog
copies its position into ``u`` and replays the graph.  On the card that is
the only path: a capture or replay that fails raises.  On the CPU the same
call runs eagerly.

The graph holds the kernels' launches (K1-K4 on the bounded actor's fused
route) as nodes, so a replay does not advance the wrappers' launch counters:
count a replay's kernels with ``torch.profiler``.

The optimizers and the ELBO of :mod:`lqg_tpu_torch.infer.svi` and
:mod:`~lqg_tpu_torch.infer.flows` differentiate with respect to other
parameters through ``u``: :class:`GraphedPotential` puts the replayed value
and gradient into their autograd graph.

Under :func:`lqg_tpu_torch.utils.profiling.tracing` a construction records
the spans ``graph.warmup``, ``graph.capture`` and ``graph.instantiate`` and
counts ``graph.captures``; a call records the span ``graph.replay``, its
card side marked by CUDA events around ``graph.replay()`` itself, and
counts ``graph.replays``.  Nothing is recorded inside the capture: a replay
runs none of the potential's host code.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from lqg_tpu_torch.utils import profiling


def eager_value_and_grad(potential: Callable) -> Callable:
    """``z (C, D) -> (pe (C,), grad (C, D))`` by autograd, each call."""

    def value_and_grad(z):
        with torch.enable_grad():
            u = z.detach().requires_grad_()
            pe = potential(u)
            (grad,) = torch.autograd.grad(pe.sum(), u)
        return pe.detach(), grad

    return value_and_grad


class GraphedValueAndGrad:
    """The value and gradient of ``potential`` for ``C`` chains, replayed
    from one CUDA graph.

    Construction warms the potential up on a side stream (building and
    loading the kernels, setting their attributes, filling the caches of
    the models' constants and of the launch plans), then captures one
    ``potential(u)`` + ``autograd.grad`` and instantiates the graph.
    ``capture_s`` and ``instantiate_s`` keep the host time of the two;
    ``replays`` counts the calls.

    Args:
        potential: ``u (C, D) -> (C,)`` on the card.
        u0: ``(C, D)``, a point where the potential is finite, used for the
            warm-up and the capture.
    """

    def __init__(self, potential: Callable, u0: torch.Tensor):
        if u0.device.type != "cuda":
            raise ValueError("a CUDA graph needs a tensor on the card")
        self.u = u0.detach().clone()
        eager = eager_value_and_grad(potential)
        t0 = time.perf_counter_ns()
        side = torch.cuda.Stream(device=u0.device)
        side.wait_stream(torch.cuda.current_stream(u0.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                eager(self.u)
        torch.cuda.current_stream(u0.device).wait_stream(side)
        torch.cuda.synchronize(u0.device)
        profiling.span_since("graph.warmup", t0)

        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter_ns()
        with torch.enable_grad(), torch.cuda.graph(self.graph):
            u = self.u.detach().requires_grad_()
            pe = potential(u)
            (grad,) = torch.autograd.grad(pe.sum(), u)
        self.capture_s = profiling.span_since("graph.capture", t0)
        self.pe, self.grad = pe.detach(), grad
        t0 = time.perf_counter_ns()
        self.graph.instantiate()
        torch.cuda.synchronize(u0.device)
        self.instantiate_s = profiling.span_since("graph.instantiate", t0)
        profiling.count("graph.captures")
        self.replays = 0

    def __call__(self, z: torch.Tensor):
        with profiling.span("graph.replay") as span:
            self.u.copy_(z)
            span.card_start()
            self.graph.replay()
            span.card_end()
            self.replays += 1
            profiling.count("graph.replays")
            # the next replay overwrites the static outputs
            return self.pe.clone(), self.grad.clone()


def value_and_grad_fn(potential: Callable, u0: torch.Tensor) -> Callable:
    """The value and gradient NUTS calls for chains at ``u0 (C, D)``: a
    replayed CUDA graph on the card, eager autograd on the CPU."""
    if u0.device.type == "cuda":
        return GraphedValueAndGrad(potential, u0)
    if u0.device.type != "cpu":
        raise ValueError(f"unsupported device {u0.device}")
    return eager_value_and_grad(potential)


class GraphedPotential(torch.autograd.Function):
    """``pe (C,)`` of a model's potential at ``u (C, D)``, as a node of an
    outer autograd graph (a guide's parameters -> ``u`` -> ``pe``).

    The forward calls :meth:`ProbModel.value_and_grad
    <lqg_tpu_torch.infer.models.ProbModel.value_and_grad>`: on the card one
    replay of the graph captured for this ``C`` (the first call captures
    it), eagerly on the CPU.  It keeps the gradient, and the backward
    returns ``gpe[:, None] * grad``: no second evaluation of the
    potential.  Call it as ``GraphedPotential.apply(u, model)``.
    """

    @staticmethod
    def forward(ctx, u, model):
        pe, grad = model.value_and_grad(u.detach())
        ctx.save_for_backward(grad)
        return pe

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gpe):
        (grad,) = ctx.saved_tensors
        return gpe[:, None] * grad, None
