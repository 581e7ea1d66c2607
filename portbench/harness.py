"""One run of one cell: set-up, the measured window, the traced slice, the
check against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, cell or metric
sits in a file of its own that is found by the name ``BENCHMARK.json``
gives it:

* ``configs/<config>.json``: the deployment (model, sizes, priors, truth);
  its plain reference is ``reference/models/<model>.py``;
* ``traffic/<traffic>.json``: the mix, read by :mod:`portbench.entries`;
* ``limits/<workload>.json``: the limit of each number the check compares;
* ``metrics/<metric>.py``: a per-layer metric's reader, named by the
  metric without its traffic suffix (``step_mfu.vg`` reads with
  ``metrics/step_mfu.py``).

:func:`execute` takes the device and size overrides, so that the tests can
drive a whole run on the CPU at a small size; the command line
(:mod:`portbench.run`) runs on the card only.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from portbench import check, entries
from portbench.reference import lqg
from portbench.trace import record

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "lqg_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its pieces read."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @classmethod
    def load(cls, name: str) -> "Cell":
        bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
        (w,) = [w for w in bench["workloads"] if w["name"] == name]
        (c,) = [c for c in bench["configs"] if c["name"] == w["config"]]

        def mine(m):
            return name in m.get("workloads", [name])

        return cls(
            name=name,
            config=load_json(os.path.join(ROOT, c["file"])),
            traffic=load_json(os.path.join(HERE, "traffic",
                                           f"{w['traffic']}.json")),
            limits=load_json(os.path.join(HERE, "limits", f"{name}.json")),
            end_to_end=[m for m in bench["end_to_end"] if mine(m)],
            per_layer=[m for m in bench["per_layer"] if mine(m)])


def reader(metric: str):
    """The reader of a per-layer metric: ``metrics/<base>.py``, ``base``
    its name up to the first dot."""
    base = metric.split(".")[0]
    path = os.path.join(HERE, "metrics", f"{base}.py")
    spec = importlib.util.spec_from_file_location(
        "_portbench_metric_" + base, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules(names=None) -> list:
    """Of the loaded modules (or ``names``), the top-level names that are
    JAX's or the JAX package's, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_state() -> str:
    """The card's name and power limit, and its clocks, power, temperature
    and clock-event reasons now, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.mem,power.draw,temperature.gpu,"
             "clocks_event_reasons.active", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


@dataclass
class Run:
    """The state of one run, handed to the entries and the readers."""

    cell: Cell
    seed: int
    device: torch.device
    setup: dict = field(default_factory=dict)
    x: Optional[torch.Tensor] = None
    model: object = None
    fit: object = None
    entry: object = None
    window: dict = field(default_factory=dict)
    trace: object = None
    span: Optional[tuple] = None
    traced_calls: int = 0
    work: dict = field(default_factory=dict)

    def seeded(self, *key) -> torch.Generator:
        """A generator on the device seeded by ``(seed, *key)``."""
        a, b = np.random.SeedSequence([self.seed, *key]).generate_state(
            2, np.uint32)
        return torch.Generator(device=self.device).manual_seed(
            (int(a) << 31) ^ int(b))

    def rng(self, *key) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence([self.seed,
                                                             *key]))


def set_up(run: Run, t_start: float):
    """Load the kernels, make the trials from the seed, build the model,
    set its baseline, then the entry's capture and warm-up; each phase's
    host seconds go into ``run.setup``."""
    cfg, dev = run.cell.config, run.device
    t = time.perf_counter()
    run.setup["start_s"] = t - t_start  # interpreter, torch, the context
    from lqg_tpu_torch import models
    from lqg_tpu_torch.infer.models import shared_params_lqg_model
    run.setup["import_s"] = time.perf_counter() - t

    t = time.perf_counter()
    if dev.type == "cuda":
        from lqg_tpu_torch.ops.kernels import nvcc
        nvcc.build_all(cfg["kernels"])
        for name in cfg["kernels"]:
            for part in range(nvcc.PARTS.get(name, 1)):
                nvcc.load(name, part)
    run.setup["load_s"] = time.perf_counter() - t

    t = time.perf_counter()
    run.x = lqg.simulate(cfg, run.seeded(1), dev).to(torch.float32)
    _sync(dev)
    run.setup["data_s"] = time.perf_counter() - t

    t = time.perf_counter()
    run.model = shared_params_lqg_model(
        run.x, getattr(models, cfg["model"]),
        process_noise=cfg["process_noise"], dt=cfg["dt"],
        shared_params=cfg["shared_params"])
    run.fit = lqg.Fit(cfg, run.x)
    if run.model.names != run.fit.names:
        raise RuntimeError(f"the program's coordinates {run.model.names} "
                           f"are not the reference's {run.fit.names}")
    run.entry = entries.ENTRIES[run.cell.traffic["entry"]](run)
    run.setup["model_s"] = time.perf_counter() - t

    t = time.perf_counter()
    run.model.set_baseline()
    _sync(dev)
    run.setup["baseline_s"] = time.perf_counter() - t

    t = time.perf_counter()
    run.entry.warm_up()
    _sync(dev)
    run.setup["capture_warmup_s"] = time.perf_counter() - t
    run.setup["setup_s"] = time.perf_counter() - t_start


def _work(run: Run) -> dict:
    """Bytes and operations of one value+grad of the window's batch."""
    from portbench.work import value_and_grad_work

    cfg = run.cell.config
    sizes = dict(cfg["sizes"], T=cfg["T"], trials=cfg["trials"])
    return value_and_grad_work(sizes, run.entry.sets)


def result_line(run: Run, trace: bool, checks: dict, correct: bool,
                peak: int) -> dict:
    dev = run.device
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": kind, "count": 1, "memory_peak_bytes": peak}
    metrics = {}
    if trace:
        for m in run.cell.per_layer:
            value = reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if run.trace is not None and run.trace.device:
            device["busy_s"] = run.trace.busy_s
            device["window_s"] = run.trace.window_s
    else:
        found = dict(run.entry.end_to_end(), setup_s=run.setup["setup_s"])
        for m in run.cell.end_to_end:
            metrics[m["name"]] = {"value": found[m["name"]],
                                  "unit": m["unit"]}
    out = {"correct": correct, "attempted": run.window["calls"],
           "failed": run.window["failed"], "metrics": metrics,
           "device": device}
    if trace and run.trace is not None and run.trace.device:
        out["breakdown"] = {"device_ops": run.trace.top_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["checks"] = checks
    return out


def execute(name: str, seed: int, seconds: float, trace: bool,
            t_start: float, device="cuda", overrides: Optional[dict] = None,
            control: bool = False):
    """One run; returns ``(result line, run)``.  ``overrides`` replace
    configuration and traffic entries (the tests' small sizes);
    ``control`` also computes the control's numbers (``run.control``)."""
    cell = Cell.load(name)
    for key, value in (overrides or {}).items():
        (cell.traffic if key in cell.traffic else cell.config)[key] = value
    run = Run(cell=cell, seed=int(seed), device=torch.device(device))
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    set_up(run, t_start)
    log = lambda msg: print(f"[portbench] {msg}", file=sys.stderr, flush=True)
    log("set-up " + ", ".join(f"{k} {v:.3f}" for k, v in run.setup.items()))

    run.window = run.entry.window(seconds)
    log(run.entry.describe())
    if run.device.type == "cuda":
        log(f"card after the window: {card_state()}")
    if trace and hasattr(run.entry, "span_slice"):
        run.span = run.entry.span_slice()
        log("span slice: {:.3f} s, {} calls, {:.3f} s inside, {:.3f} s "
            "waiting".format(*run.span))
    if trace:
        before = run.entry.calls()
        t = time.perf_counter()
        run.trace = record(run.entry.traced_slice, run.device)
        log(f"traced slice and its reading {time.perf_counter() - t:.3f} s")
        run.traced_calls = run.entry.calls() - before
    run.work = _work(run)
    _sync(run.device)
    peak = (torch.cuda.max_memory_allocated(run.device)
            if run.device.type == "cuda" else 0)

    answers = run.entry.answers()
    run.entry.release()
    run.model = None
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = check.reference(run, answers)
    found = check.numbers(answers, ref)
    log(f"reference {time.perf_counter() - t:.3f} s")
    if control:
        t = time.perf_counter()
        run.control = check.numbers(check.control(run, answers), ref)
        log(f"control {time.perf_counter() - t:.3f} s: {run.control}")
    checks, correct = check.judge(found, cell.limits)
    loaded = forbidden_modules()
    if loaded:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: "
                         f"{loaded}")
    for key, c in checks.items():
        log(f"check {key} {c['value']!r} limit {c['side']} {c['limit']!r}")
    return result_line(run, trace, checks, correct, peak), run


def main(name: str, seed: int, seconds: float, trace: bool,
         t_start: float) -> int:
    """The command line's run: on the card, or an error."""
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    chips = [w for w in load_json(os.path.join(ROOT, "BENCHMARK.json"))
             ["workloads"] if w["name"] == name]
    if not chips:
        print(f"portbench: no workload {name!r}", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips[0]["chips"]:
        print(f"portbench: {name} needs {chips[0]['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    line, _ = execute(name, seed, seconds, trace, t_start)
    print(json.dumps(line, allow_nan=True), flush=True)
    return 0

