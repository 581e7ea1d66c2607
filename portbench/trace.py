"""One traced slice of a run: ``torch.profiler`` over the host and the card,
read into intervals.

The slice is marked by a ``record_function`` span, so that the device's
activity and the host's calls are read against the same clock.  Reading
takes the profiler's raw records, not its summaries, and only the fields
the readers use.
"""

from __future__ import annotations

import bisect
import re
from typing import Callable, List, Optional, Tuple

import torch

WINDOW = "portbench.window"
# the hand-written kernels by the names they carry in the trace
HAND = re.compile(r"\b(gains_fwd_block|gains_fwd|gains_bwd|ll_blocked_fwd|"
                  r"ll_blocked_bwd|ll_fwd|ll_bwd)\b")
LABEL = {"gains_fwd": "K1", "gains_fwd_block": "K1", "gains_bwd": "K2",
         "ll_fwd": "K3", "ll_bwd": "K4", "ll_blocked_fwd": "K5",
         "ll_blocked_bwd": "K6"}
# the profiler's own buffer handling: the card idles in these gaps only
# because it is traced, so they are no part of the traced window
PROFILER = ("Buffer Flush", "Activity Buffer Request")

Interval = Tuple[int, int, str]


def _union(intervals: List[Interval]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e, _ in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class Trace:
    """The slice's device records and host calls, clipped to its window,
    in nanoseconds of the profiler's clock."""

    def __init__(self, device: List[Interval], host: List[Interval],
                 window: Tuple[int, int]):
        lo, hi = window
        self.window = window
        self.device = [(max(s, lo), min(e, hi), n) for s, e, n in device
                       if e > lo and s < hi]
        self.host = [(s, e, n) for s, e, n in host if e > lo and s < hi
                     and n != WINDOW]
        self.busy = _union(self.device)
        self.gaps = self._gaps()

    @property
    def window_s(self) -> float:
        """The slice's length less the device's idle gaps that the
        profiler's own buffer handling caused."""
        own = sum(s for n, s in self.gaps.items() if n in PROFILER)
        return (self.window[1] - self.window[0]) * 1e-9 - own

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-9

    def device_s(self, hand: Optional[bool] = None) -> float:
        """Seconds of device records: all, the hand-written kernels' or the
        others'."""
        return sum(e - s for s, e, n in self.device
                   if hand is None or bool(HAND.search(n)) == hand) * 1e-9

    def kernel_s(self) -> dict:
        """Seconds of each hand-written kernel, by its label (K1 ... K6)."""
        out: dict = {}
        for s, e, n in self.device:
            m = HAND.search(n)
            if m:
                k = LABEL[m.group(1)]
                out[k] = out.get(k, 0.0) + (e - s) * 1e-9
        return out

    def top_ops(self, k: int = 10) -> list:
        """The ``k`` device operations that took most time: ``[name,
        seconds]``."""
        tot: dict = {}
        for s, e, n in self.device:
            tot[n] = tot.get(n, 0) + (e - s)
        return [[n, t * 1e-9] for n, t in
                sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """The ``k`` largest of :meth:`gaps`: ``[name, seconds]``."""
        return [[n, t] for n, t in
                sorted(self.gaps.items(), key=lambda kv: -kv[1])[:k]]

    def _gaps(self) -> dict:
        """The device's idle seconds in the slice, by what the host was
        doing: each gap goes to the innermost host call running at its
        middle (``python`` where none is)."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy for x in iv] + [hi]
        host = sorted(self.host)
        starts = [s for s, _, _ in host]
        tot: dict = {}
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            label, i = "python", bisect.bisect_right(starts, mid) - 1
            # the innermost call at ``mid``: the latest-starting one that
            # still runs (calls nest, so a short scan back suffices)
            for i in range(i, max(i - 256, -1), -1):
                if host[i][1] >= mid:
                    label = host[i][2]
                    break
            tot[label] = tot.get(label, 0) + (b - a)
        return {n: t * 1e-9 for n, t in tot.items()}


def traced(run) -> bool:
    """Is there a traced slice of the card to read in ``run``?"""
    return (run.device.type == "cuda" and run.trace is not None
            and bool(run.trace.device) and run.traced_calls > 0)


def per_call(run, seconds: Callable) -> Optional[float]:
    """``seconds(trace)`` in ms a call of the traced slice; nothing where
    there is no slice or ``seconds`` gives nothing."""
    if not traced(run):
        return None
    s = seconds(run.trace)
    return None if s is None else s * 1e3 / run.traced_calls


def record(fn: Callable[[], None], device: torch.device) -> Trace:
    """Run ``fn`` under the profiler, the card's work waited for inside
    the window, and read the trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    dev, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        iv = (s, s + e.duration_ns(), e.name())
        if e.device_type() == DeviceType.CUDA:
            if iv[2] != WINDOW:  # the span's own mark on the device
                dev.append(iv)
        elif iv[2] == WINDOW:
            window = iv[:2]
        else:
            host.append(iv)
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    return Trace(dev, host, window)
