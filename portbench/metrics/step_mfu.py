"""``step_mfu``: the counted operations of a call's value+grad (the same
count whatever implements them; the delay model's gains by K1/K2's counts
at n=39) over the measured window's time a call at the fp32 peak, in %."""

from portbench.work import FP32_FLOPS_PER_S


def read(run):
    w = run.window
    if run.device.type != "cuda" or not w["calls"]:
        return None
    ops = sum(o for _, o in run.work.values())
    return 100.0 * ops / (w["seconds"] / w["calls"] * FP32_FLOPS_PER_S)
