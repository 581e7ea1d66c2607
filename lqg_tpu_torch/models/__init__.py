"""Model zoo of the port: the dim-per-axis tracking models, the subjective
actor and the delay-register family (counterpart of :mod:`lqg_tpu.models`;
the other models come with later slices)."""

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
]
