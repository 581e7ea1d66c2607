#!/usr/bin/env python3
"""Capture the delay model's potential value+grad in a CUDA graph, once.

The 4-chain hierarchical potential of ``DelayedSubjectiveActor`` (6
conditions x 20 simulated trials, 5 shared parameters, D=11: the shape of
``chip_smoke.py`` phase 10) makes ~213,000 small ops per value and gradient,
most of them the n=39 gains scans.  This script measures what capturing it
costs and what a replay takes, against eager:

    python3 scripts/torch_delay_graph.py [--T 64 1008]

For each horizon it prints the eager host wall (warm, median), the capture
and instantiate seconds of :class:`lqg_tpu_torch.infer.capture.
GraphedValueAndGrad`, the replay time (host wall and CUDA events), the
device's busy share of one replay (``torch.profiler``), and the replay
against eager.  A capture the card refuses raises, with the op in its
traceback.  Needs one CUDA card.
"""

import argparse
import statistics
import subprocess
import sys
import time
import os

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONDITIONS, CHAINS, TRIALS = 6, 4, 20
SHARED = ["c", "subj_noise", "subj_vel_noise", "sigma_cursor",
          "action_variability"]


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def busy_ms(fn):
    """Host wall (ms) of one call of ``fn`` under ``torch.profiler``, the
    union of the device's busy intervals (ms) and the device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    busy, reach = 0, 0
    for start, end in spans:
        busy += max(0, end - max(start, reach))
        reach = max(reach, end)
    return wall, busy / 1e6, len(spans)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--T", type=int, nargs="+", default=[1008])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from lqg_tpu_torch.infer import shared_params_lqg_model
    from lqg_tpu_torch.infer.capture import (GraphedValueAndGrad,
                                             eager_value_and_grad)
    from lqg_tpu_torch.models import DelayedSubjectiveActor
    from lqg_tpu_torch.ops.kernels import nvcc

    dev = torch.device("cuda")
    card = card_line()
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; {card}", flush=True)
    nvcc.build_all(["gains", "likelihood", "likelihood_blocked"])
    g = torch.Generator(device=dev).manual_seed(0)
    for T in args.T:
        x = torch.stack([
            DelayedSubjectiveActor(T=T, sigma_target=3.0 + 5.0 * c,
                                   device=dev).simulate(g, n=TRIALS)[..., :2]
            for c in range(CONDITIONS)])
        pm = shared_params_lqg_model(x, DelayedSubjectiveActor,
                                     shared_params=SHARED)
        u0 = pm.init_unconstrained()
        u = u0 + 0.1 * torch.randn((CHAINS,) + u0.shape, generator=g,
                                   device=dev)
        eager = eager_value_and_grad(pm.potential)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            pe_e, grad_e = eager(u)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        e_wall, e_busy, e_events = busy_ms(lambda: eager(u))
        print(f"[{card}] T={T}: eager value+grad host wall median "
              f"{statistics.median(walls):.4f} s of "
              f"{[round(w, 4) for w in walls]}; profiled {e_wall:.1f} ms, "
              f"device busy {e_busy:.2f} ms over {e_events} events",
              flush=True)
        t0 = time.perf_counter()
        graphed = GraphedValueAndGrad(pm.potential, u)
        built = time.perf_counter() - t0
        print(f"[{card}] T={T}: capture {graphed.capture_s:.3f} s, "
              f"instantiate {graphed.instantiate_s:.3f} s (warm-up, capture "
              f"and instantiate {built:.3f} s)", flush=True)
        pe_g, grad_g = graphed(u)
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            graphed(u)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            graphed(u)
        stop.record()
        stop.synchronize()
        r_wall, r_busy, r_events = busy_ms(lambda: graphed(u))
        d_pe = float(((pe_g - pe_e) / pe_e).abs().max())
        d_grad = float((grad_g - grad_e).abs().max()
                       / grad_e.abs().max())
        print(f"[{card}] T={T}: replay host wall median "
              f"{statistics.median(walls) * 1e3:.3f} ms of "
              f"{[round(w * 1e3, 3) for w in walls]}; CUDA events "
              f"{start.elapsed_time(stop) / 5:.3f} ms a replay; profiled "
              f"{r_wall:.2f} ms, device busy {r_busy:.3f} ms "
              f"({100 * r_busy / r_wall:.2f}%) over {r_events} events; "
              f"replay vs eager: value rel {d_pe:.3e}, gradient err / "
              f"max|grad| {d_grad:.3e}", flush=True)
        del graphed, pm, x
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
