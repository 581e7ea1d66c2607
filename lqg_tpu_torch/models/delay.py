"""Temporal delay models: augment the state with a shift register (port of
:mod:`lqg_tpu.models.delay`).

The state is extended with a ``delay``-deep shift register (sub-diagonal
identity blocks in ``A``); the observation reads the oldest register slot,
so the agent acts on ``delay``-steps-old information.  Every matrix keeps
its leading axes (parameter sets, and time for a stacked spec): the
augmentation only pads the trailing two.
"""

from __future__ import annotations

import torch
import torch.nn.functional as nnf

from lqg_tpu_torch.spec import LQGSpec
from lqg_tpu_torch.system import System
from lqg_tpu_torch.models.subjective import SubjectiveActor


def _delay_static(A, B, F, V, Q, d: int, delay: int):
    """Delay-augment matrices ``(..., ., .)`` (reference ``delay.py:9-33``)."""
    n_aug = d * (delay + 1)
    grow = n_aug - d
    # shift register: sub-diagonal identity, delay blocks deep
    shift = torch.diag(torch.ones(d * delay, dtype=A.dtype, device=A.device),
                       diagonal=-d)
    A_aug = nnf.pad(A, (0, grow, 0, grow)) + shift
    B_aug = nnf.pad(B, (0, 0, 0, grow))
    F_aug = nnf.pad(F, (F.shape[-1] * delay, 0))
    V_aug = nnf.pad(V, (0, n_aug - V.shape[-1], 0, grow))
    Q_aug = nnf.pad(Q, (0, grow, 0, grow))
    return A_aug, B_aug, F_aug, V_aug, Q_aug


def delay_system(spec: LQGSpec, delay: int) -> LQGSpec:
    """Delay-augmented spec.  Accepts stationary or stacked specs, with or
    without leading parameter-set axes; a stacked spec is augmented
    slice-wise like the reference (``delay.py:9-33``)."""
    stacked = spec.A.dim() > spec.Qf.dim()
    d = spec.A.shape[-1]
    A, B, F, V, Q = _delay_static(spec.A, spec.B, spec.F, spec.V, spec.Q, d,
                                  delay)
    n_aug, m = A.shape[-1], spec.R.shape[-1]
    lead = Q.shape[:-2]  # parameter sets and, when stacked, time
    sets = lead[:-1] if stacked else lead
    zeros = lambda *shape: Q.new_zeros(shape)
    return LQGSpec(
        A=A, B=B, F=F, V=V, W=spec.W, Q=Q, R=spec.R,
        q=zeros(*lead, n_aug),
        Qf=Q[..., -1, :, :] if stacked else Q,
        qf=zeros(*sets, n_aug),
        P=zeros(*lead, m, n_aug),
        r=zeros(*lead, m),
        zero_affine=True,
    )


class TemporalDelayModel(System):
    """Wrap an existing system with a temporal delay
    (reference ``delay.py:36-41``)."""

    def __init__(self, system: System, delay: int):
        dyn = delay_system(system.dynamics, delay=delay)
        act = delay_system(system.actor, delay=delay)
        super().__init__(actor=act, dynamics=dyn, horizon=system.horizon)


class DelayedSubjectiveActor(TemporalDelayModel):
    """Subjective actor with a 12-step visuomotor delay
    (reference ``delay.py:44-51``)."""

    def __init__(self, process_noise=1.0, c=0.5, action_variability=0.5,
                 subj_noise=1.0, subj_vel_noise=10.0, sigma_target=6.0,
                 sigma_cursor=3.0, dt=1.0 / 60, T=1000, *, device=None,
                 dtype=torch.float32):
        system = SubjectiveActor(
            process_noise=process_noise, action_cost=c,
            action_variability=action_variability, subj_noise=subj_noise,
            subj_vel_noise=subj_vel_noise, sigma_target=sigma_target,
            sigma_cursor=sigma_cursor, dt=dt, T=T, device=device, dtype=dtype)
        super().__init__(system=system, delay=12)
