"""lqg_tpu_torch: the PyTorch and CUDA port of :mod:`lqg_tpu`.

Each module mirrors the module of the same path under ``lqg_tpu/`` and is
tested against it; the JAX package stays the reference.  Hot loops run as
hand-written CUDA kernels for Hopper (``lqg_tpu_torch/csrc``), each with a
plain PyTorch version beside it.  Entry points work on the card unless the
caller names another device.

The slices so far cover the main path of the tracking models:
``BoundedActor(...)`` -> ``simulate`` -> ``log_likelihood``, and its
gradient up to the potential of the (hierarchical) inference models in
:mod:`lqg_tpu_torch.infer` (``shared_params_lqg_model(...).potential``);
and the same path for the subjective actor and the delay-register family
(``SubjectiveActor``, ``TemporalDelayModel``, ``DelayedSubjectiveActor``),
whose large joint state goes through the blocked likelihood kernels, and for
the rest of the model zoo (``PointMassBoundedActor``,
``HandMotionModelTrackingTask``, ``SignalDependentNoiseActor``), all in
:mod:`lqg_tpu_torch.models`.  NUTS (:func:`lqg_tpu_torch.infer.infer`),
point estimation, the variational guides and NeuTra
(:mod:`lqg_tpu_torch.infer.svi`, :mod:`lqg_tpu_torch.infer.flows`) replay
the potential's value and gradient from CUDA graphs.  The data and analysis
tools are the JAX package's: the dataset loader (:mod:`lqg_tpu_torch.io`),
posterior files (:mod:`lqg_tpu_torch.results`), cross-correlograms
(:func:`xcorr`, :mod:`lqg_tpu_torch.ccg`), the alternate gains
(``System.gains(method="sqrt"|"steady")``) and the fit scripts
(``scripts/torch_*.py``).  The parallel layer (:mod:`lqg_tpu_torch.parallel`)
has the associative scans (``System.log_likelihood(method="pscan")``) and
a mesh over ``torch.distributed`` ranks, one process per device, over which
the likelihood shards its trials or its horizon and NUTS its chains
(``MCMC.run(chain_sharding=)``).
"""

__version__ = "0.1.0"

from lqg_tpu_torch.spec import LQGSpec
from lqg_tpu_torch.system import LQG, Actor, Dynamics, System, LQGDistribution
from lqg_tpu_torch import infer, models
from lqg_tpu_torch.ccg import xcorr

__all__ = [
    "LQG",
    "Actor",
    "Dynamics",
    "System",
    "LQGSpec",
    "LQGDistribution",
    "infer",
    "models",
    "xcorr",
    "__version__",
]
