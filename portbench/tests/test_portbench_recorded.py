"""The readers of the program's recorder (``portbench/recorded.py``): nothing
from a CPU run or from a program without the recorder, and, on a slice
recorded on the CPU, the host spans and counts they read."""

import time
import types

import pytest
import torch

from portbench import harness, recorded
from portbench.tests.test_portbench_runs import SEED, SMALL, WIDE

NEW = {"replay_device_ms", "sampler_self_ms", "sync_wait_ms",
       "replay_gap_ms", "useful_leaves_pct", "step_device_ms"}
CELLS = ["bounded_fit.nuts4", "subjective_fit.map", "bounded_fit.vg16",
         "bounded_fit.vg1"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(name, trace=True):
    overrides = dict(SMALL, **(WIDE if name.endswith("nuts4") else {}))
    return harness.execute(name, SEED, 0.3, trace, time.perf_counter(),
                           device="cpu", overrides=overrides)


def test_every_new_metric_has_its_reader_in_its_cells():
    found = set()
    for name in CELLS:
        for m in harness.Cell.load(name).per_layer:
            base = m["name"].split(".")[0]
            if base in NEW:
                assert callable(harness.reader(m["name"]))
                found.add(base)
    assert found == NEW


@pytest.mark.parametrize("name", CELLS)
def test_new_readers_read_nothing_on_the_cpu(name):
    line, run = _run(name)
    assert not set(line["metrics"])
    for m in run.cell.per_layer:
        if m["name"].split(".")[0] in NEW:
            assert harness.reader(m["name"])(run) is None
    assert run.program_recorder is None  # no twin set up without a card


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    from lqg_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "tracing")
    run = types.SimpleNamespace(device=torch.device("cuda"))
    assert recorded.recorder(run) is None


def test_a_cpu_slice_gives_the_sampler_its_host_spans():
    _, run = _run("bounded_fit.nuts4", trace=False)
    rec = recorded.record_slice(run)
    n = recorded.leaves(rec)
    assert n >= SMALL["trace_calls"]
    run.program_recorder = rec
    self_ms = harness.reader("sampler_self_ms.nuts")(run)
    sync_ms = harness.reader("sync_wait_ms.nuts")(run)
    assert self_ms > 0 and sync_ms > 0
    # no replay on the CPU: a transition is its self time and its reads
    whole = sum(t.duration_ns for t in rec.named("nuts.transition"))
    assert (self_ms + sync_ms) * n == pytest.approx(whole * 1e-6, rel=1e-12)
    # eager on the CPU: no replay, no card
    for metric in ("replay_device_ms.nuts", "replay_gap_ms.nuts",
                   "useful_leaves_pct.nuts"):
        assert harness.reader(metric)(run) is None


def test_a_cpu_slice_of_the_map_has_its_steps():
    _, run = _run("subjective_fit.map", trace=False)
    rec = recorded.record_slice(run)
    assert rec.counts["svi.steps"] == SMALL["trace_calls"]
    assert recorded.step_ms(rec) == []  # no card events on the CPU
