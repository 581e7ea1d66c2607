"""``useful_leaves_pct``: of the chain-leaves the batch computes (chains x
replays), the share of chains still growing their half-tree (the device
counter ``nuts.chain_leaves_useful``), in %."""

from portbench.recorded import recorder


def read(run):
    rec = recorder(run)
    if rec is None:
        return None
    replays = rec.counts.get("graph.replays", 0)
    useful = rec.counts.get("nuts.chain_leaves_useful")
    if not replays or useful is None:
        return None
    return 100.0 * useful / (run.cell.traffic["chains"] * replays)
