"""``sync_wait_ms``: host ms a leapfrog spends in the sampler's host reads
(spans ``nuts.sync``: the depth's and the leaf's ``any``), waiting for the
card."""

from portbench.recorded import leaves, recorder


def read(run):
    rec = recorder(run)
    n = leaves(rec)
    if not n:
        return None
    return sum(s.duration_ns for s in rec.named("nuts.sync")) * 1e-6 / n
