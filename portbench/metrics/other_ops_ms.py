"""``other_ops_ms``: device ms a call of every operation other than the
hand-written kernels K1-K6, from the traced slice."""

from portbench.trace import per_call


def read(run):
    return per_call(run, lambda t: t.device_s(hand=False))
