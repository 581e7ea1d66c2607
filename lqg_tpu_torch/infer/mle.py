"""Maximum-likelihood estimation of LQG model parameters (port of
:mod:`lqg_tpu.infer.mle`).

API parity with reference ``lqg/infer/mle.py``: Adam for ``steps`` steps on
the trajectory likelihood, returning ``(params, losses)``.
"""

from __future__ import annotations

from lqg_tpu_torch.infer.models import lqg_model
from lqg_tpu_torch.infer.svi import optimize
from lqg_tpu_torch.infer.utils import as_data


def max_likelihood(x, model=None, model_fn=lqg_model, process_noise=1.0,
                   dt=1.0 / 60, steps=2000, step_size=0.01, device=None,
                   **fixed):
    """MLE via gradient descent on the potential (reference ``mle.py:14-25``).

    Args:
        x: observed trajectories ``(n, T+1, d)``: a tensor, whose device
            and dtype the model keeps, or an array, made a float32 tensor on
            ``device`` (the card unless named).
        model: model class (defaults to ``BoundedActor``).
        model_fn: model builder (``lqg_model`` or compatible).
        **fixed: parameters to fix instead of estimating.

    Returns:
        ``(params, losses)``: constrained parameter estimates and the loss
        trace (on the model's device).
    """
    if model is None:
        from lqg_tpu_torch.models import BoundedActor as model

    prob_model = model_fn(as_data(x, device), model,
                          process_noise=process_noise, dt=dt, **fixed)
    return optimize(prob_model, steps=steps, step_size=step_size)
