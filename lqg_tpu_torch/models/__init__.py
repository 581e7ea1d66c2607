"""Model zoo of the port: the dim-per-axis tracking models
(counterpart of :mod:`lqg_tpu.models`; the other models come with later
slices)."""

from lqg_tpu_torch.models.basic import (
    TrackingTask,
    BoundedActor,
    OptimalActor,
    RelativeObservationBoundedActor,
)

__all__ = [
    "TrackingTask",
    "BoundedActor",
    "OptimalActor",
    "RelativeObservationBoundedActor",
]
