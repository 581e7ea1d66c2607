"""The benchmark's files: every cell of ``BENCHMARK.json`` resolves to its
pieces by name, and the frozen work counts give the figures the port's
kernel table was built on."""

import json
import os
import re

import pytest

from portbench import harness, work

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in BENCH["end_to_end"])
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = harness.Cell.load(name)
    assert os.path.exists(os.path.join(
        harness.HERE, "reference", "models", f"{cell.config['model']}.py"))
    assert cell.traffic["entry"] in harness.entries.ENTRIES
    assert cell.limits
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.reader(m["name"]))
        assert m["moves"] in reported


def test_per_layer_metrics_name_their_layer_and_metric():
    moves = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in moves
        assert set(m["workloads"]) <= set(CELLS)
        base = m["name"].split(".")[0]
        assert os.path.exists(os.path.join(harness.HERE, "metrics",
                                           f"{base}.py"))


@pytest.mark.parametrize("fn, args, gflop, mb", [
    # the port's kernel table (PERF.md section 6): K5 and K6 at the delay
    # fit's 24 sets x 20 trials, T=1008, j=65, d=2
    (work.ll_blocked_work, (24, 20, 65, 2, 1008), 31.19, 821.6),
    (work.ll_blocked_bwd_work, (24, 20, 65, 2, 1008), 62.86, 1769.5),
])
def test_work_counts_reproduce_the_kernel_table(fn, args, gflop, mb):
    nbytes, ops = fn(*args)
    assert round(ops / 1e9, 2) == gflop
    assert round(nbytes / 1e6, 1) == mb


def test_bounds_reproduce_the_kernel_table():
    # K1 at (2, 1, 2), B=16,384, T=1000: 0.1375 ms by its bytes; K5 0.4655
    # ms by its operations
    assert round(work.bound_ms(work.gains_work(16384, 2, 1, 2, 1000)),
                 4) == 0.1375
    assert round(work.bound_ms(work.ll_blocked_work(24, 20, 65, 2, 1008)),
                 4) == 0.4655


def test_value_and_grad_work_counts_the_delay_gains_at_their_shape():
    sizes = dict(n=39, m=1, p=2, j=65, d=2, T=1008, trials=20)
    w = work.value_and_grad_work(sizes, 6)
    assert set(w) == {"K1", "K2", "K5", "K6"}
    assert w["K1"] == work.gains_work(6, 39, 1, 2, 1008, stores=True)
    small = work.value_and_grad_work(dict(sizes, n=2, j=4), 6)
    assert set(small) == {"K1", "K2", "K3", "K4"}
