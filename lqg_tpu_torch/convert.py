"""Carry parameters from the JAX package across to the port.

Specs cross as mappings of numpy arrays, e.g.
``{k: np.asarray(v) for k, v in jax_spec._asdict().items()}``, and guides
as the JAX guide with numpy leaves, ``jax.tree.map(np.asarray, guide)``:
numpy is the common ground, so nothing here imports JAX.  The
``zero_affine`` flag is set from the arrays' values.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from lqg_tpu_torch.config import resolve_device
from lqg_tpu_torch.spec import LQGSpec, _AFFINE
from lqg_tpu_torch.system import System

_FIELDS = LQGSpec._fields[:12]


def spec_from_numpy(fields: Mapping[str, np.ndarray], device=None,
                    dtype=torch.float32) -> LQGSpec:
    """An :class:`LQGSpec` from the 12 named arrays, with ``zero_affine``
    set exactly when ``q, qf, P, r`` are all zero."""
    missing = [k for k in _FIELDS if k not in fields]
    if missing:
        raise ValueError(f"spec fields missing: {missing}")
    device = resolve_device(device)
    arrays = {k: np.asarray(fields[k]) for k in _FIELDS}
    return LQGSpec(**{k: torch.tensor(a, dtype=dtype, device=device)
                      for k, a in arrays.items()},
                   zero_affine=not any(arrays[k].any() for k in _AFFINE))


def system_from_numpy(actor: Mapping[str, np.ndarray],
                      dynamics: Mapping[str, np.ndarray],
                      horizon: Optional[int] = None, device=None,
                      dtype=torch.float32,
                      control_noise: Optional[np.ndarray] = None) -> System:
    """A :class:`System` from the actor's and the dynamics' arrays, and the
    control-noise scales ``(k, n, m)`` of a system that has them."""
    device = resolve_device(device)
    return System(actor=spec_from_numpy(actor, device, dtype),
                  dynamics=spec_from_numpy(dynamics, device, dtype),
                  horizon=horizon,
                  control_noise=None if control_noise is None else
                  torch.tensor(np.asarray(control_noise), dtype=dtype,
                               device=device))


def guide_from_numpy(guide, device=None, dtype=torch.float32):
    """The port's guide from a JAX ``AutoMVN`` (fields ``loc``,
    ``scale_tril``) or ``AutoIAF`` (``loc``, ``log_scale``, ``layers`` of
    eight arrays each, ``masks`` of three each) whose leaves are numpy
    arrays; the masks are carried as they are, in ``dtype``."""
    from lqg_tpu_torch.infer.flows import AutoIAF, IAFLayerParams
    from lqg_tpu_torch.infer.svi import AutoMVN

    device = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    if hasattr(guide, "scale_tril"):
        return AutoMVN(loc=t(guide.loc), scale_tril=t(guide.scale_tril))
    return AutoIAF(
        loc=t(guide.loc), log_scale=t(guide.log_scale),
        layers=tuple(IAFLayerParams(*(t(a) for a in layer))
                     for layer in guide.layers),
        masks=tuple(tuple(t(m) for m in masks) for masks in guide.masks))
