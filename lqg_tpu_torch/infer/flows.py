"""Autoregressive normalizing flows for variational guides and NeuTra (port
of :mod:`lqg_tpu.infer.flows`).

An inverse-autoregressive-flow (IAF) guide built from MADE-masked MLPs: the
forward transform ``eps -> u`` and its log-determinant in one pass
(triangular Jacobian with gate diagonals), the direction ELBO fitting and
NeuTra need.  Batch-first: ``transform_and_logdet`` takes ``eps (..., D)``,
where JAX vmaps one vector at a time, so an ELBO step's particles are one
batch of the potential.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from lqg_tpu_torch.config import resolve_device
from lqg_tpu_torch.infer.capture import GraphedPotential
from lqg_tpu_torch.infer.svi import _fit, adam, guide_draws


def _made_degrees(dim: int, hidden: int, reverse: bool):
    """MADE connectivity degrees: inputs 1..D (or reversed), hidden cycling
    1..D-1 so every hidden unit can feed at least one output."""
    d_in = torch.arange(1, dim + 1)
    if reverse:
        d_in = d_in.flip(0)
    if dim == 1:
        d_hid = torch.zeros(hidden, dtype=torch.int64)
    else:
        d_hid = 1 + torch.arange(hidden) % (dim - 1)
    return d_in, d_hid


def _made_masks(dim: int, hidden: int, reverse: bool):
    """Binary float32 masks (input->hidden, hidden->hidden, hidden->output)
    enforcing that output ``i`` depends only on inputs strictly before
    ``i`` in the layer's ordering."""
    d_in, d_hid = _made_degrees(dim, hidden, reverse)
    m1 = (d_hid[:, None] >= d_in[None, :]).to(torch.float32)
    m2 = (d_hid[:, None] >= d_hid[None, :]).to(torch.float32)
    m3 = (d_in[:, None] > d_hid[None, :]).to(torch.float32)
    return m1, m2, m3


class IAFLayerParams(NamedTuple):
    W1: torch.Tensor
    b1: torch.Tensor
    W2: torch.Tensor
    b2: torch.Tensor
    Wm: torch.Tensor
    bm: torch.Tensor
    Ws: torch.Tensor
    bs: torch.Tensor


def _init_iaf_layer(generator, dim: int, hidden: int, like: dict,
                    scale: float = 1e-3) -> IAFLayerParams:
    """Near-identity initialization: shift/gate heads start tiny so the flow
    begins as (almost) the identity map."""

    def normal(*shape):
        return torch.randn(shape, generator=generator, **like)

    he = math.sqrt(2.0 / max(dim, 1))
    return IAFLayerParams(
        W1=he * normal(hidden, dim), b1=torch.zeros(hidden, **like),
        W2=math.sqrt(2.0 / hidden) * normal(hidden, hidden),
        b2=torch.zeros(hidden, **like),
        Wm=scale * normal(dim, hidden), bm=torch.zeros(dim, **like),
        Ws=scale * normal(dim, hidden), bs=torch.zeros(dim, **like))


def _iaf_layer_apply(p: IAFLayerParams, masks, z):
    """One gated IAF layer on ``z (..., D)``: ``z' = sigma(s) z + (1 -
    sigma(s)) m`` with ``(m, s)`` autoregressive in ``z``.  Returns ``(z',
    logdet (...))``."""
    m1, m2, m3 = masks
    h = torch.tanh(z @ (p.W1 * m1).mT + p.b1)
    h = torch.tanh(h @ (p.W2 * m2).mT + p.b2)
    m = h @ (p.Wm * m3).mT + p.bm
    s = h @ (p.Ws * m3).mT + p.bs
    # +2 bias: gates open near 1 at init, keeping the flow near-identity
    gate = torch.sigmoid(s + 2.0)
    z_new = gate * z + (1.0 - gate) * m
    return z_new, F.logsigmoid(s + 2.0).sum(-1)


class AutoIAF(NamedTuple):
    """IAF guide: base affine ``z0 = loc + exp(log_scale) * eps`` followed by
    ``K`` masked autoregressive layers with alternating variable order.

    Duck-compatible with :class:`lqg_tpu_torch.infer.svi.AutoMVN`
    (``sample`` / ``transform`` / ``transform_and_logdet``).
    """

    loc: torch.Tensor
    log_scale: torch.Tensor
    layers: tuple          # tuple of IAFLayerParams
    masks: tuple           # tuple of (m1, m2, m3) per layer

    @property
    def dim(self) -> int:
        return self.loc.shape[0]

    def transform_and_logdet(self, eps):
        """``eps (..., D)`` -> ``(u (..., D), logdet (...))``."""
        z = self.loc + torch.exp(self.log_scale) * eps
        logdet = self.log_scale.sum()
        for p, masks in zip(self.layers, self.masks):
            z, ld = _iaf_layer_apply(p, masks, z)
            logdet = logdet + ld
        return z, logdet

    def transform(self, eps):
        return self.transform_and_logdet(eps)[0]

    def sample(self, generator: torch.Generator, sample_shape=()):
        eps = torch.randn(tuple(sample_shape) + self.loc.shape,
                          generator=generator, dtype=self.loc.dtype,
                          device=self.loc.device)
        return self.transform(eps)


def make_auto_iaf(key, dim: int, hidden: int = 32, num_layers: int = 2,
                  loc=None, init_log_scale: float = 0.0, *, device=None,
                  dtype=None) -> AutoIAF:
    """Construct a near-identity IAF guide over a ``dim``-dimensional space.

    ``key``: an integer seed or a ``torch.Generator`` (whose device the
    guide takes).  The guide takes ``loc``'s device and dtype where ``loc``
    is a tensor, else ``device`` (the card unless named) and ``dtype``
    (float32 unless named).  ``init_log_scale`` sets the base-scale start;
    for sharply concentrated posteriors (~1e5 observations) start small.
    """
    if torch.is_tensor(loc):
        device, dtype = loc.device, loc.dtype
    elif isinstance(key, torch.Generator):
        device = key.device
    device = resolve_device(device)
    like = dict(dtype=dtype or torch.float32, device=device)
    generator = (key if isinstance(key, torch.Generator)
                 else torch.Generator(device=device).manual_seed(int(key)))
    layers = tuple(_init_iaf_layer(generator, dim, hidden, like)
                   for _ in range(num_layers))
    masks = tuple(tuple(m.to(**like) for m in
                        _made_masks(dim, hidden, reverse=bool(i % 2)))
                  for i in range(num_layers))
    loc = (torch.zeros(dim, **like) if loc is None
           else torch.as_tensor(loc, **like))
    return AutoIAF(loc=loc, log_scale=torch.full((dim,), init_log_scale,
                                                 **like),
                   layers=layers, masks=masks)


def fit_auto_iaf(model, rng_key, steps: int = 5000, step_size: float = 5e-3,
                 num_particles: int = 16, hidden: int = 32,
                 num_layers: int = 2, chunk_steps: int = 200,
                 init_log_scale: float = -2.0):
    """Fit an IAF guide to ``model``'s posterior by stochastic ELBO ascent;
    returns ``(AutoIAF, losses)``.

    ``rng_key``: an integer seed or a draw source
    (:class:`~lqg_tpu_torch.infer.svi.GuideDraws`), whose init part makes
    the initial guide and whose fit part the particles of each step.  Each
    step evaluates the potential of its ``num_particles`` particles as one
    batch (:class:`~lqg_tpu_torch.infer.capture.GraphedPotential`: on the
    card one replay).  A step whose loss or gradient is not finite is
    skipped: its gradients are zeroed on the device, and Adam still
    advances, as optax does on a zero update.  ``chunk_steps`` is accepted
    for the JAX signature and changes nothing.
    """
    del chunk_steps
    u0 = model.init_unconstrained().detach()
    dim = u0.shape[0]
    draws = guide_draws(rng_key, u0.device)
    guide0 = draws.init_iaf(dim, hidden, num_layers, u0, init_log_scale)
    masks = guide0.masks

    def as_guide(leaves) -> AutoIAF:
        layers = tuple(IAFLayerParams(*leaves[k:k + 8])
                       for k in range(2, len(leaves), 8))
        return AutoIAF(loc=leaves[0], log_scale=leaves[1], layers=layers,
                       masks=masks)

    def neg_elbo(leaves, eps):
        # ELBO = E_eps[log p(f(eps)) + logdet] + H[N(0, I)] (constant)
        u, logdet = as_guide(leaves).transform_and_logdet(eps)
        return -torch.mean(-GraphedPotential.apply(u, model) + logdet)

    params = [guide0.loc, guide0.log_scale,
              *(x for layer in guide0.layers for x in layer)]
    params, losses = _fit(neg_elbo, params, adam(step_size), draws, steps,
                          num_particles, dim, skip_nonfinite=True)
    return as_guide(params), losses
