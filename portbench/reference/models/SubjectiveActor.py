"""``SubjectiveActor`` (Straub & Rothkopf 2022, the subjective actor of the
tracking task, without the delay).  The truth per tracked dimension is
(target, cursor) with a random-walk target; the actor believes the target
also has a velocity, (target, cursor, velocity), with subjective noises
``subj_noise`` and ``subj_vel_noise`` on target and velocity, and
``action_cost`` is its action cost.  Both see the truth through the sensory
noises ``sigma_target`` and ``sigma_cursor``; the cost is the squared
tracking error plus ``action_cost`` times the squared control."""

import torch


def specs(params, config, dtype, device):
    """``(actor, dynamics)``, each a dict of ``A, B, F, V, W, Q, R`` of
    ``(P, ., .)`` tensors, the actor with 3 states and the truth with 2.
    One tracked dimension."""
    kw = dict(dtype=dtype, device=device)
    p = {k: v.to(dtype) for k, v in params.items()}
    c = p["action_cost"]
    P = c.shape[0]
    dt, pn = config["dt"], config["process_noise"]
    ex = lambda M: M.expand((P,) + M.shape)
    W = torch.diag_embed(torch.stack([p["sigma_target"], p["sigma_cursor"]],
                                     -1))
    V = torch.diag_embed(torch.stack(
        [torch.full_like(c, pn), p["action_variability"]], -1))
    dyn = dict(A=ex(torch.eye(2, **kw)), B=ex(torch.tensor([[0.0], [dt]], **kw)),
               F=ex(torch.eye(2, **kw)), V=V, W=W,
               Q=ex(torch.zeros(2, 2, **kw)), R=c.new_zeros(P, 1, 1))
    Va = torch.diag_embed(torch.stack(
        [p["subj_noise"], p["action_variability"], p["subj_vel_noise"]], -1))
    act = dict(
        A=ex(torch.tensor([[1.0, 0.0, dt], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
                          **kw)),
        B=ex(torch.tensor([[0.0], [dt], [0.0]], **kw)),
        F=ex(torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], **kw)),
        V=Va, W=W,
        Q=ex(torch.tensor([[1.0, -1.0, 0.0], [-1.0, 1.0, 0.0],
                           [0.0, 0.0, 0.0]], **kw)),
        R=c[:, None, None])
    return act, dyn
