"""``replay_device_ms``: device ms a call of the program's graph replay,
between the CUDA events the program records around ``graph.replay()`` (span
``graph.replay``), over the program recorder's slice."""

from portbench.recorded import recorder, replay_ms


def read(run):
    rec = recorder(run)
    ms = replay_ms(rec) if rec is not None else []
    return sum(ms) / len(ms) if ms else None
