"""Profiling and structured timing of solves (port of
:mod:`lqg_tpu.utils.profiling`).

:func:`trace` records a ``torch.profiler`` trace of the enclosed block and
writes it as a Chrome trace (Perfetto, ``chrome://tracing``); :func:`timeit`
gives the steady-state time of a callable with the card's work included;
:func:`kernel_counts` counts the kernels a callable runs on the card.
``torch.profiler`` now and then drops a kernel's record, so the counts are
taken over several profiled sessions.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Tuple

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
