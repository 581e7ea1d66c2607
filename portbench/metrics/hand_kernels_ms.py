"""``hand_kernels_ms``: device ms a call of the hand-written kernels K1-K6,
from the traced slice; nothing where none ran."""

from portbench.trace import per_call


def read(run):
    return per_call(run, lambda t: t.device_s(hand=True) if t.kernel_s()
                    else None)
