"""scipy.optimize bridge for PyTorch objectives (port of
:mod:`lqg_tpu.optim`).

Wraps ``scipy.optimize.minimize`` for objectives of a structured argument
(a tensor, or a dict, tuple or list of them, nested): the argument is
flattened into one vector in the JAX package's ``ravel_pytree`` order (dict
keys sorted), ``torch.autograd.grad`` supplies the Jacobian, scipy gets
float64 numpy copies, and the callback and ``res.x`` receive structured
iterates.
"""

from __future__ import annotations

import numpy as np
import scipy.optimize
import torch


def _leaves(tree) -> list:
    """The tensors of ``tree`` in flattening order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    if isinstance(tree, (int, float)):
        return [torch.tensor(float(tree), dtype=torch.float64)]
    return [torch.as_tensor(tree)]


def _rebuild(tree, leaves):
    """``tree``'s structure around ``leaves`` (an iterator)."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        items = [_rebuild(t, leaves) for t in tree]
        if hasattr(tree, "_fields"):  # a NamedTuple
            return type(tree)(*items)
        return type(tree)(items)
    return next(leaves)


def _flatten(tree):
    """``(x float64 vector, unflatten)``: ``unflatten(x, requires_grad)``
    rebuilds ``tree`` from a vector, each leaf in its dtype and device."""
    template = _leaves(tree)
    sizes = [t.numel() for t in template]
    flat = np.concatenate([t.detach().cpu().numpy().astype(np.float64)
                           .reshape(-1) for t in template])

    def unflatten(x, requires_grad=False):
        parts = np.split(np.asarray(x, dtype=np.float64),
                         np.cumsum(sizes)[:-1])
        leaves = [torch.tensor(p.reshape(t.shape), dtype=t.dtype,
                               device=t.device, requires_grad=requires_grad)
                  for p, t in zip(parts, template)]
        return _rebuild(tree, iter(leaves)), leaves

    return flat, unflatten


def minimize(fun, x0, method=None, args=(), bounds=None, constraints=(),
             tol=None, callback=None, options=None):
    """Minimize a scalar PyTorch function of a structured argument.

    Args:
        fun: objective ``fun(x, *args)`` returning a scalar tensor.
        x0: initial guess: a tensor, or a dict, tuple or list of them.
        method/bounds/constraints/tol/options: forwarded to
            ``scipy.optimize.minimize`` (bounds/constraints must be given in
            the flattened coordinate order).
        callback: receives the structured iterate.

    Returns:
        ``scipy.optimize.OptimizeResult`` with ``res.x`` restructured.
    """
    x0_flat, unflatten = _flatten(x0)

    def fun_wrapper(x_flat, *args):
        with torch.no_grad():
            return float(fun(unflatten(x_flat)[0], *args))

    def jac_wrapper(x_flat, *args):
        x, leaves = unflatten(x_flat, requires_grad=True)
        with torch.enable_grad():
            grads = torch.autograd.grad(fun(x, *args), leaves,
                                        allow_unused=True)
        return np.concatenate([
            np.zeros(t.numel()) if g is None
            else g.detach().cpu().numpy().astype(np.float64).reshape(-1)
            for g, t in zip(grads, leaves)])

    def callback_wrapper(x_flat, *cb_args):
        return callback(unflatten(x_flat)[0], *cb_args)

    results = scipy.optimize.minimize(
        fun_wrapper, x0_flat, args=args, method=method, jac=jac_wrapper,
        bounds=bounds, constraints=constraints, tol=tol,
        callback=None if callback is None else callback_wrapper,
        options=options)
    results["x"] = unflatten(results["x"])[0]
    return results
