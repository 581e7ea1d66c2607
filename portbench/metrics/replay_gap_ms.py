"""``replay_gap_ms``: ms a leapfrog from the host end of the last
``nuts.sync`` before a replay to that replay's start on the card, on the
recorder's one clock: the card, idle after the read, waits for the sampler
to enqueue the leaf (its small ops run in this gap too)."""

from portbench.recorded import gaps_ms, leaves, recorder


def read(run):
    rec = recorder(run)
    n = leaves(rec)
    gaps = gaps_ms(rec) if n else []
    return sum(gaps) / n if gaps else None
