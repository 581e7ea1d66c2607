"""``step_device_ms``: device ms from one Adam step's start on the card to
the next's (span ``svi.step``, CUDA events), over the program recorder's
slice: one ``optimize`` call."""

from portbench.recorded import recorder, step_ms


def read(run):
    rec = recorder(run)
    ms = step_ms(rec) if rec is not None else []
    return sum(ms) / len(ms) if ms else None
