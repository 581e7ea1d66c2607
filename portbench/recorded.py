"""One more slice of a traced run, under the program's own recorder
(``lqg_tpu_torch.utils.profiling.tracing``) and without the profiler:
``trace_calls`` calls of the cell's entry, as in the traced slice, on a twin
of the run's set-up (the same seed).  It is made when the first of its
readers asks, after the run's check, so that the window, the span and
traced slices, the answers and the check see what they see without it.

A program without the recorder gives nothing to read: the readers then
return nothing.
"""

from __future__ import annotations

import bisect
import statistics
import sys
import time

import torch

_UNSET = object()


def recorder(run):
    """The recorder of the run's slice, made once a run; nothing without a
    card or where the program has no recorder."""
    rec = getattr(run, "program_recorder", _UNSET)
    if rec is _UNSET:
        rec = run.program_recorder = _record(run)
    return rec


def _record(run):
    if run.device.type != "cuda":
        return None
    from lqg_tpu_torch.utils import profiling

    if not hasattr(profiling, "tracing"):
        return None
    return record_slice(run)


def record_slice(run):
    """Set up a twin of ``run`` and run its entry's ``trace_calls`` calls
    under the recorder; returns the recorder."""
    from lqg_tpu_torch.utils import profiling
    from portbench import harness

    t = time.perf_counter()
    twin = harness.Run(cell=run.cell, seed=run.seed, device=run.device)
    harness.set_up(twin, t)
    t1 = time.perf_counter()
    with profiling.tracing() as rec:
        twin.entry.traced_slice()
    t2 = time.perf_counter()
    twin.entry.release()
    twin.model = None
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    _log(run, rec, t1 - t, t2 - t1)
    return rec


def _quartiles(xs) -> str:
    if len(xs) < 2:
        return "-"
    return " / ".join(f"{q:.4f}" for q in statistics.quantiles(xs, n=4))


def _log(run, rec, setup_s: float, slice_s: float):
    lead = [(s.card_start_ns - s.start_ns) * 1e-3
            for s in rec.named("graph.replay") if s.card_start_ns is not None]
    print(f"[portbench] recorder slice: set-up {setup_s:.3f} s, slice "
          f"{slice_s:.3f} s, {len(rec.spans)} spans, counts {rec.counts}, "
          f"events dropped {rec.events_dropped}, clock scale "
          f"{rec.clock_scale:.9f}; quartiles of replay_device_ms "
          f"{_quartiles(replay_ms(rec))}, of step_device_ms "
          f"{_quartiles(step_ms(rec))}; a replay's card start less its "
          f"span's host start: least {min(lead, default=float('nan')):.1f}"
          f" us", file=sys.stderr, flush=True)


def replay_ms(rec) -> list:
    """Device ms of each replay, between the events around
    ``graph.replay()``."""
    return [(s.card_end_ns - s.card_start_ns) * 1e-6
            for s in rec.named("graph.replay")
            if s.card_start_ns is not None and s.card_end_ns is not None]


def step_ms(rec) -> list:
    """Device ms from one ``svi.step``'s start on the card to the next's
    in the same ``optimize`` call (the same root span)."""
    steps = [s for s in rec.named("svi.step") if s.card_start_ns is not None]
    return [(b.card_start_ns - a.card_start_ns) * 1e-6
            for a, b in zip(steps, steps[1:]) if a.root == b.root]


def leaves(rec) -> int:
    return rec.counts.get("nuts.leaves", 0) if rec is not None else 0


def gaps_ms(rec) -> list:
    """For each replay inside a transition, ms from the host end of the
    last ``nuts.sync`` before it to its start on the card."""
    syncs = sorted(s.end_ns for s in rec.named("nuts.sync"))
    out = []
    for s in rec.named("graph.replay"):
        i = bisect.bisect_right(syncs, s.start_ns) - 1
        if i >= 0 and s.card_start_ns is not None:
            out.append((s.card_start_ns - syncs[i]) * 1e-6)
    return out
