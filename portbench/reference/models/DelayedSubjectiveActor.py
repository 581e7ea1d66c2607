"""``DelayedSubjectiveActor`` (Straub & Rothkopf 2022, the subjective actor
with a 12-step visuomotor delay).  The truth per tracked dimension is
(target, cursor) with a random-walk target; the actor believes the target
also has a velocity, (target, cursor, velocity), with subjective noises
``subj_noise`` and ``subj_vel_noise`` on target and velocity, and ``c`` is
its action cost.  Both state vectors are extended by a 12-step shift
register: the newest block is the state, each step copies every block one
slot on, and the observation reads the oldest block, so the actor sees
12-step-old information.  The noise enters the newest block; costs are on
it alone."""

import torch

DELAY = 12


def _delayed(A, B, F, V, Q, delay=DELAY):
    """The spec with the shift register: ``A (P, n, n)`` etc. to ``n (delay
    + 1)`` states."""
    P, n = A.shape[0], A.shape[-1]
    N = n * (delay + 1)
    z = lambda *s: A.new_zeros((P,) + s)
    A2 = z(N, N)
    A2[:, :n, :n] = A
    A2[:, n:, :-n] += torch.eye(n * delay, dtype=A.dtype, device=A.device)
    B2 = z(N, B.shape[-1])
    B2[:, :n] = B
    F2 = z(F.shape[-2], N)
    F2[:, :, -n:] = F
    V2 = z(N, N)
    V2[:, :n, :V.shape[-1]] = V
    Q2 = z(N, N)
    Q2[:, :n, :n] = Q
    return A2, B2, F2, V2, Q2


def specs(params, config, dtype, device):
    """``(actor, dynamics)``, each a dict of ``A, B, F, V, W, Q, R`` of
    ``(P, ., .)`` tensors, the actor with 39 states and the truth with 26.
    One tracked dimension."""
    kw = dict(dtype=dtype, device=device)
    p = {k: v.to(dtype) for k, v in params.items()}
    c = p["c"]
    P = c.shape[0]
    dt, pn = config["dt"], config["process_noise"]
    ex = lambda M: M.expand((P,) + M.shape)
    W = torch.diag_embed(torch.stack([p["sigma_target"], p["sigma_cursor"]],
                                     -1))
    # truth: (target, cursor)
    A = ex(torch.eye(2, **kw))
    B = ex(torch.tensor([[0.0], [dt]], **kw))
    V = torch.diag_embed(torch.stack(
        [torch.full_like(c, pn), p["action_variability"]], -1))
    A, B, F, V, Q = _delayed(A, B, ex(torch.eye(2, **kw)), V,
                             ex(torch.zeros(2, 2, **kw)))
    dyn = dict(A=A, B=B, F=F, V=V, W=W, Q=Q, R=c.new_zeros(P, 1, 1))
    # actor: (target, cursor, target velocity)
    Aa = ex(torch.tensor([[1.0, 0.0, dt], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
                         **kw))
    Ba = ex(torch.tensor([[0.0], [dt], [0.0]], **kw))
    Fa = ex(torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], **kw))
    Va = torch.diag_embed(torch.stack(
        [p["subj_noise"], p["action_variability"], p["subj_vel_noise"]], -1))
    Qa = ex(torch.tensor([[1.0, -1.0, 0.0], [-1.0, 1.0, 0.0],
                          [0.0, 0.0, 0.0]], **kw))
    Aa, Ba, Fa, Va, Qa = _delayed(Aa, Ba, Fa, Va, Qa)
    act = dict(A=Aa, B=Ba, F=Fa, V=Va, W=W, Q=Qa, R=c[:, None, None])
    return act, dyn
