"""``BoundedActor`` (Straub & Rothkopf 2022, the bounded actor of the
tracking task): per tracked dimension the state is (target, cursor); the
target is a random walk of standard deviation ``process_noise``, the cursor
integrates the control with motor noise ``action_variability``, both are
seen through sensory noises ``sigma_target`` and ``sigma_cursor``, and the
cost is the squared tracking error plus ``action_cost`` times the squared
control.  Actor and true dynamics share the one model."""

import torch


def specs(params, config, dtype, device):
    """``(actor, dynamics)``: dicts of the matrices ``A, B, F, V, W, Q,
    R``, each ``(P, ., .)`` over the parameter sets of ``params`` (``(P,)``
    tensors by name).  One tracked dimension."""
    kw = dict(dtype=dtype, device=device)
    c = params["action_cost"].to(dtype)
    P = c.shape[0]
    dt, pn = config["dt"], config["process_noise"]
    eye = torch.eye(2, **kw).expand(P, 2, 2)
    B = torch.tensor([[0.0], [dt]], **kw).expand(P, 2, 1)
    V = torch.diag_embed(torch.stack(
        [torch.full_like(c, pn), params["action_variability"].to(dtype)], -1))
    W = torch.diag_embed(torch.stack(
        [params["sigma_target"].to(dtype), params["sigma_cursor"].to(dtype)],
        -1))
    Q = torch.tensor([[1.0, -1.0], [-1.0, 1.0]], **kw).expand(P, 2, 2)
    spec = dict(A=eye, B=B, F=eye, V=V, W=W, Q=Q, R=c[:, None, None])
    return spec, spec
