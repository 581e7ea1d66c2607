"""``sampler_self_ms``: host ms a leapfrog spends in the program's NUTS
transitions outside their ``graph.replay`` and ``nuts.sync`` spans (self
time, the sampler's own flow: nothing waits for the card but its reads)."""

from portbench.recorded import leaves, recorder


def read(run):
    rec = recorder(run)
    n = leaves(rec)
    if not n:
        return None
    ns = sum(rec.self_ns(t, ("graph.replay", "nuts.sync"))
             for t in rec.named("nuts.transition"))
    return ns * 1e-6 / n
