"""lqg_tpu_torch: the PyTorch and CUDA port of :mod:`lqg_tpu`.

Each module mirrors the module of the same path under ``lqg_tpu/`` and is
tested against it; the JAX package stays the reference.  Hot loops run as
hand-written CUDA kernels for Hopper (``lqg_tpu_torch/csrc``), each with a
plain PyTorch version beside it.  Entry points work on the card unless the
caller names another device.

The slices so far cover the main path of the tracking models:
``BoundedActor(...)`` -> ``simulate`` -> ``log_likelihood``, and its
gradient up to the potential of the (hierarchical) inference models in
:mod:`lqg_tpu_torch.infer` (``shared_params_lqg_model(...).potential``).
"""

__version__ = "0.1.0"

from lqg_tpu_torch.spec import LQGSpec
from lqg_tpu_torch.system import LQG, Actor, Dynamics, System, LQGDistribution
from lqg_tpu_torch import infer

__all__ = [
    "LQG",
    "Actor",
    "Dynamics",
    "System",
    "LQGSpec",
    "LQGDistribution",
    "infer",
    "__version__",
]
