"""``hand_kernels_roofline``: the hand-written kernels' least time (the
bounds of the frozen work counts, ``portbench/work.py``, of the kernels
that ran in the traced slice) over their device time, in %."""

from portbench.trace import traced
from portbench.work import bound_ms


def read(run):
    if not traced(run):
        return None
    seen = run.trace.kernel_s()
    if not seen:
        return None
    least = sum(bound_ms(run.work[k]) for k in seen)
    spent = sum(seen.values()) * 1e3 / run.traced_calls
    return 100.0 * least / spent
