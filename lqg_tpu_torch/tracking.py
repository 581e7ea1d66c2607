"""Compatibility alias: ``lqg_tpu_torch.tracking`` re-exports the model zoo
(port of :mod:`lqg_tpu.tracking`).

The reference exposes its models under ``lqg.tracking``; this module lets
reference-shaped code (``getattr(tracking, model_name)``, the scripts'
``--model``) work unchanged against :mod:`lqg_tpu_torch.models`.
"""

from lqg_tpu_torch.models import (  # noqa: F401
    TrackingTask,
    BoundedActor,
    OptimalActor,
    RelativeObservationBoundedActor,
    SubjectiveActor,
    TemporalDelayModel,
    DelayedSubjectiveActor,
    delay_system,
    PointMassBoundedActor,
    HandMotionModelTrackingTask,
    SignalDependentNoiseActor,
)

__all__ = [
    "TrackingTask",
    "BoundedActor",
    "OptimalActor",
    "RelativeObservationBoundedActor",
    "SubjectiveActor",
    "TemporalDelayModel",
    "DelayedSubjectiveActor",
    "delay_system",
    "PointMassBoundedActor",
    "HandMotionModelTrackingTask",
    "SignalDependentNoiseActor",
]
