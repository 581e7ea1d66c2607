"""The parallel layer (port of :mod:`lqg_tpu.parallel`): associative
(parallel-in-time) scans, rank meshes over ``torch.distributed``, and the
trial-, horizon- and chain-sharded inference built on them."""

from lqg_tpu_torch.parallel.mesh import make_mesh, local_mesh, distributed_init
from lqg_tpu_torch.parallel import pscan, sharding

__all__ = ["make_mesh", "local_mesh", "distributed_init", "pscan",
           "sharding"]
