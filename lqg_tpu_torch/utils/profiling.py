"""Profiling and structured timing of solves (port of
:mod:`lqg_tpu.utils.profiling`).

:func:`trace` records a ``torch.profiler`` trace of the enclosed block and
writes it as a Chrome trace (Perfetto, ``chrome://tracing``); :func:`timeit`
gives the steady-state time of a callable with the card's work included;
:func:`kernel_counts` counts the kernels a callable runs on the card.
``torch.profiler`` now and then drops a kernel's record, so the counts are
taken over several profiled sessions.

:func:`tracing` turns on the program's own recorder for a block: spans and
counters at the boundaries of the sampler (``infer.hmc``), the graph replay
(``infer.capture``) and the Adam loops (``infer.svi``), with CUDA events
for the card's side of a span, all on the host's clock and without the
profiler.  Off (the default), a span or counter site costs one check of a
module-level variable.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Record a ``torch.profiler`` trace of the enclosed block (the host's
    operators and, with a card, its kernels) and write it to
    ``log_dir/trace.json`` (a directory under the temporary directory when
    not named).  Yields the directory."""
    from torch.profiler import profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "lqg_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield log_dir
        _synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _synchronize():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclass
class Timing:
    """Steady-state timing of one callable."""

    name: str
    mean_s: float
    min_s: float
    iters: int

    @property
    def per_s(self) -> float:
        return 1.0 / self.mean_s if self.mean_s > 0 else float("inf")

    def __str__(self) -> str:
        return (f"{self.name:<40s} {self.mean_s * 1e3:10.3f} ms/call "
                f"(min {self.min_s * 1e3:.3f} ms, {self.iters} iters)")


def timeit(fn: Callable, *args, iters: int = 10, warmup: int = 2,
           name: str | None = None, **kwargs) -> Timing:
    """Time a callable: ``warmup`` calls (building kernels, capturing
    graphs), then ``iters`` calls on the host clock, each between two
    ``torch.cuda.synchronize()`` where the card is in use, so that its work
    is included and the host running ahead is not misread as speed."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    _synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _synchronize()
        times.append(time.perf_counter() - t0)
    return Timing(name=name or getattr(fn, "__name__", "fn"),
                  mean_s=sum(times) / len(times), min_s=min(times),
                  iters=iters)


def device_events(fn: Callable) -> Tuple[float, list]:
    """One call of ``fn`` under ``torch.profiler``: its host-clock time (ms)
    and the card's events as ``(start ns, end ns, name)`` in order of their
    start; no events without a card."""
    from torch.autograd import DeviceType
    from torch.profiler import profile

    with profile(activities=_activities()) as prof:
        t0 = time.perf_counter()
        fn()
        _synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, sorted((e.start_ns(), e.end_ns(), e.name())
                        for e in prof.profiler.kineto_results.events()
                        if e.device_type() == DeviceType.CUDA)


# profiled sessions that :func:`kernel_counts` takes its counts over
SESSIONS = 3


def kernel_counts(fn: Callable, names: Iterable[str]) -> Dict[str, int]:
    """How many kernels whose name contains each of ``names`` one call of
    ``fn`` runs on the card: the largest count over ``SESSIONS`` profiled
    calls, each in a session of its own, since the profiler now and then
    drops a record."""
    names = list(names)
    best = dict.fromkeys(names, 0)
    for _ in range(SESSIONS):
        seen = [name for _, _, name in device_events(fn)[1]]
        for k in names:
            best[k] = max(best[k], sum(k in n for n in seen))
    return best


# ---------------------------------------------------------------------------
# The program's recorder

# the recorder of the open :func:`tracing` block; ``None``: off
_active: Optional["Recorder"] = None


class _Off:
    """What :func:`span` gives while the recorder is off: nothing to do."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def card_start(self):
        pass

    def card_end(self):
        pass


_OFF = _Off()


class Span:
    """One span: its name, host start and end (``time.perf_counter_ns``),
    the index of its parent in :attr:`Recorder.spans` (-1 at the top) and
    of its root (the outermost span around it, its own where it is the
    top: the id that the spans of one NUTS transition or one ``optimize``
    call share).  ``card_start_ns`` and ``card_end_ns`` are the card's
    side, on the same clock, where CUDA events were recorded."""

    __slots__ = ("name", "index", "parent", "root", "start_ns", "end_ns",
                 "card_start_ns", "card_end_ns", "_rec", "_device",
                 "_events", "_rf")

    def __init__(self, rec: "Recorder", name: str, device: bool):
        self._rec, self.name, self._device = rec, name, device
        self.index = len(rec.spans)
        top = rec._stack[-1] if rec._stack else None
        self.parent = -1 if top is None else top.index
        self.root = self.index if top is None else top.root
        self.start_ns = self.end_ns = 0
        self.card_start_ns = self.card_end_ns = None
        self._events = [None, None]
        self._rf = None
        rec.spans.append(self)

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def __enter__(self):
        rec = self._rec
        rec._stack.append(self)
        if torch.autograd._profiler_enabled():
            from torch.profiler import record_function

            self._rf = record_function(self.name)
            self._rf.__enter__()
        self.start_ns = time.perf_counter_ns()
        if self._device:
            self.card_start()
        return self

    def __exit__(self, *exc):
        if self._device:
            self.card_end()
        self.end_ns = time.perf_counter_ns()
        self._rec._stack.pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        return False

    def card_start(self):
        """Record the card's start of this span here, on the current
        stream (``span(..., device=True)`` does so on entry)."""
        self._events[0] = self._rec._event()

    def card_end(self):
        """Record the card's end of this span here (on exit where
        ``device=True``)."""
        self._events[1] = self._rec._event()


class Recorder:
    """The spans (:class:`Span`, in order of opening) and counters of one
    :func:`tracing` block.  ``counts`` are integers; those counted on the
    card (:func:`count_device`) are read into them once, when the block
    ends.  ``events_dropped`` counts the card marks that found the event
    pool empty; ``clock_scale`` is the card's nanoseconds per host
    nanosecond between the block's two anchors."""

    def __init__(self, events: int = 4096):
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = {}
        self.events_dropped = 0
        self.clock_scale = 1.0
        self._stack: List[Span] = []
        self._device_counts: Dict[str, torch.Tensor] = {}
        self._cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        self._pool: list = []
        self._used = 0
        if self._cuda:
            self._pool = [torch.cuda.Event(enable_timing=True)
                          for _ in range(events)]
            for e in self._pool:  # creates each event before the block
                e.record()

    # -- recording --------------------------------------------------------

    def _event(self) -> Optional[int]:
        """The pool index of an event recorded now on the current stream;
        none without a card, while the stream is capturing a graph (the
        event would become a node of the graph) or when the pool is
        spent."""
        if not self._cuda or torch.cuda.is_current_stream_capturing():
            return None
        if self._used == len(self._pool):
            self.events_dropped += 1
            return None
        i = self._used
        self._used += 1
        self._pool[i].record()
        return i

    def _anchor(self) -> Tuple[torch.cuda.Event, int]:
        """An event recorded on the idle card and the host's time of it:
        the middle of the record call, of three tries the one the host
        took least time over (a try the host was held in is no anchor)."""
        tries = []
        for _ in range(3):
            torch.cuda.synchronize()
            e = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter_ns()
            e.record()
            t1 = time.perf_counter_ns()
            tries.append((t1 - t0, (t0 + t1) // 2, e))
        torch.cuda.synchronize()
        _, host, e = min(tries, key=lambda t: t[0])
        return e, host

    def _begin(self):
        if self._cuda:
            self._a0, self._h0 = self._anchor()

    def _end(self):
        """Wait for the card once, read the device counts and put every
        event on the host's clock: ``h0 + elapsed(anchor, event)``, the
        card's time scaled to the host's between the two anchors."""
        if self._cuda:
            a1, h1 = self._anchor()
            card = self._a0.elapsed_time(a1) * 1e6
            self.clock_scale = card / (h1 - self._h0) if h1 > self._h0 \
                else 1.0
            to_host = lambda i: None if i is None else self._h0 + round(
                self._a0.elapsed_time(self._pool[i]) * 1e6
                / self.clock_scale)
            for s in self.spans:
                s.card_start_ns = to_host(s._events[0])
                s.card_end_ns = to_host(s._events[1])
        for name, t in self._device_counts.items():
            self.counts[name] = self.counts.get(name, 0) + int(t)
        self._device_counts = {}
        self._pool = []

    # -- reading ----------------------------------------------------------

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def descendants(self, span: Span) -> List[Span]:
        """The spans opened inside ``span``, at any depth: those that
        follow it in :attr:`spans` up to the first that does not nest in
        it."""
        inside = {span.index}
        out = []
        for s in self.spans[span.index + 1:]:
            if s.parent not in inside:
                break
            inside.add(s.index)
            out.append(s)
        return out

    def self_ns(self, span: Span, names: Optional[Iterable[str]] = None
                ) -> int:
        """``span``'s duration less the part of it that its children cover
        or, with ``names``, that its descendants of those names cover."""
        inner = self.descendants(span)
        if names is None:
            inner = [s for s in inner if s.parent == span.index]
        else:
            names = set(names)
            inner = [s for s in inner if s.name in names]
        covered, reach = 0, span.start_ns
        for s in sorted(inner, key=lambda s: s.start_ns):
            lo, hi = max(s.start_ns, reach), min(s.end_ns, span.end_ns)
            if hi > lo:
                covered += hi - lo
                reach = hi
        return span.duration_ns - covered

    def export_chrome_trace(self, path: str) -> None:
        """Write the host spans and the card's intervals as two tracks of
        one Chrome trace (``chrome://tracing``, Perfetto), with the counts
        in its metadata."""
        pid = os.getpid()
        events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                   "args": {"name": label}}
                  for tid, label in ((0, "host"), (1, "card"))]
        for s in self.spans:
            events.append({"ph": "X", "name": s.name, "pid": pid, "tid": 0,
                           "ts": s.start_ns / 1e3,
                           "dur": s.duration_ns / 1e3,
                           "args": {"root": s.root}})
            if s.card_start_ns is not None and s.card_end_ns is not None:
                events.append({"ph": "X", "name": s.name, "pid": pid,
                               "tid": 1, "ts": s.card_start_ns / 1e3,
                               "dur": (s.card_end_ns - s.card_start_ns)
                               / 1e3, "args": {"root": s.root}})
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ns",
                       "otherData": {"counts": self.counts}}, f)


@contextlib.contextmanager
def tracing(events: int = 4096):
    """Turn the recorder on for the enclosed block and yield its
    :class:`Recorder`.  On entry it waits for the card and records the
    anchor event; at the end it waits once more and puts the card's
    events on the host's clock.  ``events``: the card marks the block may
    record (two a device span); those beyond are dropped and counted.
    Blocks do not nest."""
    global _active
    if _active is not None:
        raise RuntimeError("a tracing() block is already open")
    rec = Recorder(events)
    rec._begin()
    _active = rec
    try:
        yield rec
    finally:
        _active = None
        rec._end()


def span(name: str, device: bool = False):
    """A span around the enclosed block, nested in the span open around
    it.  ``device``: also mark the card's start and end with CUDA events
    on the current stream (or mark them where the block calls
    ``card_start()`` / ``card_end()``).  Off, a shared no-op object."""
    rec = _active
    if rec is None:
        return _OFF
    return Span(rec, name, device)


def span_since(name: str, start_ns: int) -> float:
    """Read the clock once and record a host span from ``start_ns`` (the
    caller's own ``time.perf_counter_ns``) to now, nested in the open
    span; returns its seconds, recorder on or off."""
    end_ns = time.perf_counter_ns()
    rec = _active
    if rec is not None:
        s = Span(rec, name, False)
        s.start_ns, s.end_ns = start_ns, end_ns
    return (end_ns - start_ns) * 1e-9


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    rec = _active
    if rec is not None:
        rec.counts[name] = rec.counts.get(name, 0) + n


def count_device(name: str, mask: torch.Tensor) -> None:
    """Add ``mask.sum()`` to the counter ``name`` on ``mask``'s device,
    without waiting for it; read when the block ends."""
    rec = _active
    if rec is not None:
        acc = rec._device_counts.get(name)
        n = mask.sum()
        rec._device_counts[name] = n if acc is None else acc + n
