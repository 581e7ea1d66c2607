"""Model zoo of the port (counterpart of :mod:`lqg_tpu.models`): the
dim-per-axis tracking models, the subjective actor, the delay-register
family, the point-mass and hand-motion models and the signal-dependent
noise actor."""

from lqg_tpu_torch.models.basic import (
    TrackingTask,
    BoundedActor,
    OptimalActor,
    RelativeObservationBoundedActor,
)
from lqg_tpu_torch.models.subjective import SubjectiveActor, swap_dims
from lqg_tpu_torch.models.delay import (
    DelayedSubjectiveActor,
    TemporalDelayModel,
    delay_system,
)
from lqg_tpu_torch.models.point_mass import PointMassBoundedActor
from lqg_tpu_torch.models.hand import HandMotionModelTrackingTask
from lqg_tpu_torch.models.signal_dep import SignalDependentNoiseActor

__all__ = [
    "TrackingTask",
    "BoundedActor",
    "OptimalActor",
    "RelativeObservationBoundedActor",
    "SubjectiveActor",
    "swap_dims",
    "TemporalDelayModel",
    "DelayedSubjectiveActor",
    "delay_system",
    "PointMassBoundedActor",
    "HandMotionModelTrackingTask",
    "SignalDependentNoiseActor",
]
