from lqg_tpu_torch.utils.stacking import (time_stack, time_stack_spec,
                                          stationary_spec)
from lqg_tpu_torch.utils.numerics import kahan_sum

__all__ = ["time_stack", "time_stack_spec", "stationary_spec", "kahan_sum"]
