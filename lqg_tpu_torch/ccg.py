"""Cross-correlogram (CCG) analysis of tracking trajectories (port of
:mod:`lqg_tpu.ccg`).

The correlation is a batched rFFT on the device (``torch.fft``, arbitrary
leading axes), on the JAX package's power-of-two grid with its lag window
and normalization.  The parametric CCG shapes (difference of Gaussians,
skewed Gabor) are defined once over numpy and torch; they are fitted either
on the host by ``scipy.optimize.curve_fit`` or on the device by a batched
multi-start Levenberg-Marquardt, every (correlogram x restart) at once.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch
from scipy.optimize import curve_fit

from lqg_tpu_torch.infer.utils import as_data


# --- cross-correlation ------------------------------------------------------

def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _windowed_xcorr(x, y, n_lags: int, normed: bool):
    """Linear cross-correlation restricted to lags ``[-n_lags, n_lags]``.

    ``corr[k] = sum_t x[t + k] y[t]`` computed as a circular convolution of
    ``x`` with time-reversed ``y`` on a zero-padded power-of-two grid.
    """
    n = x.shape[-1]
    grid = _next_pow2(2 * n - 1)
    spec = (torch.fft.rfft(x, n=grid)
            * torch.fft.rfft(torch.flip(y, (-1,)), n=grid))
    full = torch.fft.irfft(spec, n=grid)
    # index n-1 of the full correlation is lag zero
    window = full[..., n - 1 - n_lags: n + n_lags]
    if normed:
        energy = (torch.linalg.vector_norm(x, dim=-1)
                  * torch.linalg.vector_norm(y, dim=-1))
        window = window / energy[..., None]
    return window


def xcorr(x, y, maxlags: int = 60, normed: bool = True, device=None):
    """Batched cross-correlation of ``x`` against ``y`` along the last axis.

    Returns ``(lags, correls)``: numpy integer lags spanning ``[-maxlags,
    maxlags]`` (the reference ``xcorr``'s contract) and a tensor of
    correlograms.  Leading axes broadcast, so ``(conditions, trials, T)``
    inputs produce ``(conditions, trials, 2 * maxlags + 1)`` correlograms in
    one call.  Tensors keep their device and dtype; arrays become float32
    on ``device`` (the card unless named), as the entry points take data
    (:func:`~lqg_tpu_torch.infer.utils.as_data`).
    """
    x, y = as_data(x, device), as_data(y, device)
    n = x.shape[-1]
    if maxlags is None:
        maxlags = n - 1
    if not 0 < maxlags < n:
        raise ValueError(
            f"maxlags must be None or strictly positive < {n}")
    return np.arange(-maxlags, maxlags + 1), _windowed_xcorr(
        x, y, n_lags=int(maxlags), normed=bool(normed))


# --- parametric CCG shapes ---------------------------------------------------
#
# Each shape is defined once over an array namespace so that the same
# formula serves both fit engines: numpy for scipy's curve_fit and torch for
# the batched Levenberg-Marquardt fitter on the device.

def _make_shapes(xp):
    def bell(x, center, width):
        z = (x - center) / width
        return xp.exp(-0.5 * z * z)

    def dog(x, a1, a2, mu1, mu2, sigma1, sigma2):
        """Difference of two normalized Gaussians."""
        scale1 = a1 / (sigma1 * xp.sqrt(2.0 * xp.pi))
        scale2 = a2 / (sigma2 * xp.sqrt(2.0 * xp.pi))
        return scale1 * bell(x, mu1, sigma1) - scale2 * bell(x, mu2, sigma2)

    def skewed_gabor(x, a, mu, sigma1, sigma2, w):
        """Sine carrier under a Gaussian envelope whose width differs on
        either side of the peak ``mu`` (skewed Gabor)."""
        carrier = a * xp.sin(2.0 * xp.pi * w * (x - mu))
        width = xp.where(x >= mu, sigma1, sigma2)
        return carrier * bell(x, mu, width)

    return {"dog": dog, "skewed_gabor": skewed_gabor}


_TORCH = SimpleNamespace(exp=torch.exp, sin=torch.sin, where=torch.where,
                         sqrt=math.sqrt, pi=math.pi)
_SHAPES_NP = _make_shapes(np)
_SHAPES_TORCH = _make_shapes(_TORCH)
dog = _SHAPES_NP["dog"]
skewed_gabor = _SHAPES_NP["skewed_gabor"]

# shape registry: name -> (parameter names, p0, (lo, hi) bounds or None)
_SHAPE_META = {
    "dog": (("a1", "a2", "mu1", "mu2", "sigma1", "sigma2"),
            [1.0] * 6, None),
    "skewed_gabor": (("a", "mu", "sigma1", "sigma2", "w"),
                     [0.5, 1.0, 5.0, 2.0, 1.0],
                     ([0.0, 0.0, 0.1, 0.1, 0.1],
                      [1.0, 50.0, 50.0, 50.0, 5.0])),
}


def fit_ccg_shape(shape: str, lags, correls) -> dict:
    """Least-squares fit of a registered CCG shape to one correlogram
    (scipy ``curve_fit``).  Returns fitted values keyed by parameter name.
    """
    names, p0, bounds = _SHAPE_META[shape]
    kwargs = dict(p0=p0)
    if bounds is not None:
        kwargs.update(bounds=bounds, method="trf", max_nfev=5000)
    popt, _ = curve_fit(_SHAPES_NP[shape], np.asarray(lags, dtype=float),
                        np.asarray(correls, dtype=float), **kwargs)
    return dict(zip(names, popt))


def _bounds(shape: str, like: torch.Tensor):
    bounds = _SHAPE_META[shape][2]
    if bounds is None:
        return None
    return tuple(torch.tensor(b, dtype=like.dtype, device=like.device)
                 for b in bounds)


def restart_inits(shape: str, restarts: int,
                  generator: torch.Generator) -> torch.Tensor:
    """The LM fit's restart inits ``(restarts, nparams)`` on the
    generator's device: the registry's ``p0``, then ``p0`` times factors
    uniform in ``[0.25, 4)``, clipped to the shape's bounds (the JAX
    package draws the factors from a threefry key)."""
    p0 = torch.tensor(_SHAPE_META[shape][1], device=generator.device)
    jitter = 0.25 + 3.75 * torch.rand((restarts - 1, p0.shape[0]),
                                      generator=generator,
                                      device=generator.device)
    p0s = torch.cat([p0[None], p0[None] * jitter])
    bounds = _bounds(shape, p0s)
    return p0s if bounds is None else torch.clamp(p0s, *bounds)


def lm_fit_batch(shape: str, lags, correls, p0s, steps: int = 60):
    """Multi-start Levenberg-Marquardt over a batch of correlograms from
    given restart inits (the loop of ``lqg_tpu.ccg._lm_fit_batch``).

    ``correls (N, L)`` at ``lags (L,)``, ``p0s (R, nparams)``: every
    (correlogram x restart) runs at once, each step a batch of tiny normal
    equations (``torch.linalg.solve_ex``: nothing read on the host), the
    Jacobian from ``torch.func.jacfwd`` under ``vmap``.  A step is kept
    where it lowers the loss (NaN never does), bounds are enforced by
    projection, and the damping halves on acceptance and quadruples
    otherwise.  Returns the best restart's ``(params (N, nparams), loss
    (N,))``.
    """
    fn = _SHAPES_TORCH[shape]
    N, L = correls.shape
    R, K = p0s.shape
    bounds = _bounds(shape, correls)
    y = correls[:, None].expand(N, R, L).reshape(N * R, L)
    p = p0s.to(correls)[None].expand(N, R, K).reshape(N * R, K)

    def residual(q, yy):
        return fn(lags, *q.unbind(-1)) - yy

    jacobian = torch.func.vmap(torch.func.jacfwd(residual))
    batched = torch.func.vmap(residual)
    eye = torch.eye(K, dtype=correls.dtype, device=correls.device)

    loss = (batched(p, y) ** 2).sum(-1)
    lam = torch.full_like(loss, 1e-2)
    for _ in range(steps):
        r = batched(p, y)
        J = jacobian(p, y)  # (N R, L, K)
        JtJ = J.mT @ J
        diag = torch.diagonal(JtJ, dim1=-2, dim2=-1)
        step_mat = JtJ + lam[:, None, None] * (eye * (diag + 1e-12)[:, None])
        delta = torch.linalg.solve_ex(step_mat, -(J.mT @ r[..., None]))[0]
        p_new = p + delta[..., 0]
        if bounds is not None:
            p_new = torch.clamp(p_new, *bounds)
        loss_new = (batched(p_new, y) ** 2).sum(-1)
        accept = loss_new < loss
        p = torch.where(accept[:, None], p_new, p)
        loss = torch.where(accept, loss_new, loss)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                          1e-9, 1e9)
    loss = loss.reshape(N, R)
    best = loss.argmin(-1)
    p = p.reshape(N, R, K)
    return (p.gather(1, best[:, None, None].expand(N, 1, K))[:, 0],
            loss.gather(1, best[:, None])[:, 0])


def fit_ccg_shape_batch(shape: str, lags, correls, engine: str = "scipy",
                        device=None):
    """Fit a CCG shape to each correlogram in a batch ``(..., n_lags)``.

    Args:
        engine: ``"scipy"`` loops ``curve_fit`` on the host (returns a flat
            row-major list of parameter dicts, with ``None`` where a fit
            fails to converge).  ``"torch"`` (the JAX package's ``"jax"``)
            runs every fit at once on the device by :func:`lm_fit_batch`
            in float32 (60 steps, 8 restart inits from a generator seeded
            by 0, :func:`restart_inits`; JAX's defaults), and returns
            ``(params,
            losses)`` tensors with the batch shape preserved: ``params
            (..., nparams)``, ``losses (...)``.  A tensor ``correls`` keeps
            its device; an array goes to ``device`` (the card unless
            named).
    """
    if engine == "torch":
        y = as_data(correls, device).to(torch.float32)
        batch_shape = y.shape[:-1]
        flat = y.reshape(-1, y.shape[-1])
        lags_t = torch.as_tensor(np.asarray(lags), dtype=torch.float32,
                                 device=flat.device)
        generator = torch.Generator(device=flat.device).manual_seed(0)
        p, loss = lm_fit_batch(shape, lags_t, flat,
                               restart_inits(shape, 8, generator))
        return (p.reshape(batch_shape + (p.shape[-1],)),
                loss.reshape(batch_shape))
    if engine != "scipy":
        raise ValueError(
            f"engine must be 'scipy' or 'torch', got {engine!r}")
    if torch.is_tensor(correls):
        correls = correls.detach().cpu().numpy()
    flat = np.asarray(correls, dtype=float).reshape(-1, np.shape(correls)[-1])
    out = []
    for row in flat:
        try:
            out.append(fit_ccg_shape(shape, lags, row))
        except RuntimeError:
            out.append(None)
    return out


def fit_dog(x, y) -> dict:
    """Difference-of-Gaussians fit (named-shape shorthand)."""
    return fit_ccg_shape("dog", x, y)


def fit_skewed_gabor(x, y) -> dict:
    """Skewed-Gabor fit (named-shape shorthand)."""
    return fit_ccg_shape("skewed_gabor", x, y)
