#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``lqg_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It exits
non-zero, printing no result, without a CUDA device or without the package
beside it.  Phases, each fatal on failure:

1. the card's name and power limit;
2. build every kernel from ``lqg_tpu_torch/csrc`` (one ``nvcc`` per source,
   started together) and print the ``-Xptxas -v`` report;
3. K1 (fused gains) against its plain PyTorch version at the bench shape,
   16,384 BoundedActor specs at T=1000;
4. K3 (fused likelihood) against its plain version at 24 parameter sets
   x 20 trials at T=1000;
5. the main path, ``BoundedActor(T=1000)`` -> ``simulate(n=20)`` ->
   ``log_likelihood(method="auto")``, with the kernels' launch counters
   zeroed just before and read just after; the result against the float64
   scan on the card, and the golden trajectories against their recorded
   log likelihood; its warm host-clock time, and the device's busy share
   of one call under ``torch.profiler``;
6. times from CUDA events (warmed, median of 7 runs of 20 launches; 3
   launches for the plain versions, which take ~0.5 s each) beside each
   kernel's bound.

The line before the last is one JSON object describing every kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

T = 1000
GAINS_BATCH = 16384  # bench.py's batch
LL_SETS, LL_TRIALS = 24, 20  # 6 conditions x 4 chains, 20 trials each
GAINS_ATOL = 2e-5  # as tests/test_pallas.py holds the Pallas gains kernel
LL_RTOL, LL_ATOL = 2e-4, 2e-3  # as tests/test_pallas.py:177
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS_PER_S = 67e12  # H100 SXM, outside the tensor cores
ROOT = os.path.dirname(os.path.abspath(__file__))


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs=7, launches=20):
    """Median over ``runs`` of the mean time of ``launches`` calls, from
    CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / launches)
    return statistics.median(times)


def profile_ms(fn, names):
    """One call of ``fn`` under ``torch.profiler``: its host-clock time, the
    union of the device's busy intervals, the number of device events and
    the device time of the kernels named in ``names`` (all in ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.start_ns(), e.end_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    busy, reach = 0, 0
    for start, end, _ in spans:
        busy += max(0, end - max(start, reach))
        reach = max(reach, end)
    named = {k: sum(e - s for s, e, n in spans if k in n) / 1e6 for k in names}
    return wall, busy / 1e6, len(spans), named


def mm(r, k, c):
    """Operations of an (r, k) @ (k, c) product."""
    return r * c * (2 * k - 1)


INV_OPS = {1: 2, 2: 11}  # closed-form symmetric inverse, eps included


def gains_work(B, n, m, p):
    """(bytes, operations) of K1 for B particles over T steps: inputs read
    once, outputs written once."""
    riccati = (mm(n, n, m) + mm(n, n, n) + mm(m, n, m) + m * m + mm(m, n, n)
               + INV_OPS[m] + mm(m, m, n) + m * n + mm(m, m, n) + mm(n, n, n)
               + 3 * mm(n, m, n) + 3 * n * n)
    kalman = (2 * mm(n, n, n) + n * n + mm(n, n, p) + mm(p, n, p) + p * p
              + INV_OPS[p] + mm(n, p, p) + mm(n, p, n) + n * n)
    inputs = B * (5 * n * n + n * m + m * m + p * n + p * p) * 4
    outputs = T * B * (m * n + m * m + n * p) * 4
    return inputs + outputs, T * B * (riccati + kalman)


def ll_work(P, n, j, d):
    """(bytes, operations) of K3 for P sets x n trials over T steps."""
    score = INV_OPS[d] + d + mm(d, d, 1) + (2 * d - 1)
    neumaier = 6
    step = (score + 2 * (1 + neumaier) + 1 + mm(j, j, j) + mm(j, d, d)
            + mm(j, j, 1) + mm(j, d, 1) + j + mm(j, j, j) + mm(j, d, j)
            + 2 * j * j + 2 * j * j)
    final = score + 7
    inputs = (2 * P * T * j * j + P * n * (T + 1) * d) * 4
    return inputs + P * n * 4, P * n * (T * step + final)


def bound(work):
    nbytes, ops = work
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def require(ok, message):
    if not ok:
        raise RuntimeError(message)


def within(a, b, rtol, atol):
    return bool(torch.all((a - b).abs() <= atol + rtol * b.abs()))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from lqg_tpu_torch.models import BoundedActor
    from lqg_tpu_torch.models.basic import tracking_spec
    from lqg_tpu_torch.ops.kernels import nvcc
    from lqg_tpu_torch.ops.kernels.gains import (fused_gains,
                                                 fused_gains_reference)
    from lqg_tpu_torch.ops.kernels.likelihood import (
        conditioned_log_likelihood_fused,
        conditioned_log_likelihood_reference)
    from lqg_tpu_torch.ops.linalg import mT

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. the card
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device: {kind}; count {torch.cuda.device_count()}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(card)

    # 2. build
    t0 = time.perf_counter()
    reports = nvcc.build_all(["gains", "likelihood"])
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "ptxas" in line:
                log(f"  {name}: {line.strip()}")

    # 3. K1 against its plain version, bench.py's sweep
    B = GAINS_BATCH
    sweep = [torch.tensor(v, dtype=torch.float32) for v in (
        np.logspace(-2, 1, B), np.linspace(0.1, 1.0, B),
        np.linspace(2.0, 40.0, B), np.linspace(0.5, 10.0, B))]
    c, av, st, sc = (v.to(dev) for v in sweep)
    spec = tracking_spec(1, 1.0, av, st, sc, c, 1.0 / 60.0, device=dev)
    S0 = spec.V @ mT(spec.V)
    out = fused_gains(spec, S0, T)
    ref = fused_gains_reference(spec, S0, T)
    torch.cuda.synchronize()
    k1_err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    require(all(bool(torch.isfinite(a).all()) for a in out), "K1 not finite")
    require(k1_err <= GAINS_ATOL, f"K1 vs plain: {k1_err} > {GAINS_ATOL}")
    log(f"K1 vs plain at B={B}, T={T}: max abs err {k1_err:.3e} "
        f"(atol {GAINS_ATOL})")
    del out, ref

    # 4. K3 against its plain version: 6 conditions x 4 chains
    g = torch.Generator(device=dev).manual_seed(0)
    Fs, Qs, Xs = [], [], []
    for k in range(LL_SETS):
        m = BoundedActor(T=T, sigma_target=3.0 + 5.0 * (k % 6),
                         action_cost=0.25 * (1 + k // 6), device=dev)
        joint = m._joint()
        Fs.append(joint.F)
        Qs.append(joint.G @ mT(joint.G))
        Xs.append(m.simulate(g, n=LL_TRIALS))
    F, Q, X = torch.stack(Fs), torch.stack(Qs), torch.stack(Xs)
    ll = conditioned_log_likelihood_fused(F, Q, X)
    ll_ref = conditioned_log_likelihood_reference(F, Q, X)
    torch.cuda.synchronize()
    k3_err = float((ll - ll_ref).abs().max())
    require(bool(torch.isfinite(ll).all()), "K3 not finite")
    require(within(ll, ll_ref, LL_RTOL, LL_ATOL), f"K3 vs plain: {k3_err}")
    log(f"K3 vs plain at P={LL_SETS}, n={LL_TRIALS}, T={T}: max abs err "
        f"{k3_err:.3e} (rtol {LL_RTOL}, atol {LL_ATOL})")

    # 5. the main path, through the entry points a user calls
    fused_gains.launches = 0
    conditioned_log_likelihood_fused.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = BoundedActor(T=T, device=dev)
    x = model.simulate(torch.Generator(device=dev).manual_seed(1),
                       n=LL_TRIALS)
    ll_main = model.log_likelihood(x, method="auto")
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"gains_fwd": fused_gains.launches,
                "ll_fwd": conditioned_log_likelihood_fused.launches}
    log(f"main path: simulate(n={LL_TRIALS}) + log_likelihood at T={T} in "
        f"{main_s:.3f} s (first call, host clock); launches {launches}")
    require(all(v > 0 for v in launches.values()),
            f"main path bypassed a kernel: {launches}")
    require(x.shape == (LL_TRIALS, T + 1, 2)
            and ll_main.shape == (LL_TRIALS,), "main path: wrong shapes")
    require(bool(torch.isfinite(x).all() and torch.isfinite(ll_main).all()),
            "main path: values not finite")
    model64 = BoundedActor(T=T, device=dev, dtype=torch.float64)
    ll64 = model64.log_likelihood(x.double(), method="scan")
    main_err = float((ll_main.double() - ll64).abs().max())
    require(within(ll_main.double(), ll64, LL_RTOL, LL_ATOL),
            f"main path vs float64 scan: {main_err}")
    log(f"main path vs float64 scan on the card: max abs err {main_err:.3e} "
        f"of |ll| ~ {float(ll64.abs().mean()):.1f}")

    def main_path():
        model.log_likelihood(model.simulate(g, n=LL_TRIALS))

    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        main_path()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    log(f"main path warm, host clock: median {statistics.median(warm):.4f} s "
        f"of {[round(w, 4) for w in warm]}")
    wall, busy, n_events, named = profile_ms(main_path, ("gains_fwd",
                                                         "ll_fwd"))
    if n_events:
        log(f"main path under torch.profiler: wall {wall:.1f} ms, device busy "
            f"{busy:.2f} ms ({100 * busy / wall:.2f}% of wall) over "
            f"{n_events} device events; gains_fwd {named['gains_fwd']:.3f} "
            f"ms, ll_fwd {named['ll_fwd']:.3f} ms")
    else:
        log("main path under torch.profiler: no device events recorded; "
            "device busy share not measured")

    golden = np.load(os.path.join(ROOT, "tests", "goldens",
                                  "bounded_actor.npz"))
    meta = json.loads(str(golden["params"]))
    gm = BoundedActor(**{k: v for k, v in meta.items()
                         if k not in ("class", "n")}, device=dev)
    before = conditioned_log_likelihood_fused.launches
    ll_g = gm.log_likelihood(torch.tensor(golden["x"], dtype=torch.float32,
                                          device=dev))
    require(conditioned_log_likelihood_fused.launches == before + 1,
            "golden: the fused likelihood was not taken")
    want = torch.tensor(golden["log_likelihood"], device=dev)
    golden_err = float((ll_g.double() - want).abs().max())
    require(within(ll_g.double(), want, LL_RTOL, LL_ATOL),
            f"golden: {golden_err}")
    log(f"golden bounded_actor (T={meta['T']}) on the fused path: max abs "
        f"err {golden_err:.3e}")

    # 6. times
    k1_ms = cuda_ms(lambda: fused_gains(spec, S0, T))
    k1_plain = cuda_ms(lambda: fused_gains_reference(spec, S0, T),
                       launches=3)
    k3_ms = cuda_ms(lambda: conditioned_log_likelihood_fused(F, Q, X))
    k3_plain = cuda_ms(
        lambda: conditioned_log_likelihood_reference(F, Q, X), launches=3)
    k1_bound, k1_by = bound(gains_work(B, 2, 1, 2))
    k3_bound, k3_by = bound(ll_work(LL_SETS, LL_TRIALS, 4, 2))
    log(f"[{card}] K1 gains_fwd B={B} T={T}: {k1_ms:.4f} ms "
        f"({B / (k1_ms / 1e3):.1f} solves/s); plain {k1_plain:.2f} ms; "
        f"bound {k1_bound:.4f} ms ({k1_by})")
    log(f"[{card}] K3 ll_fwd P={LL_SETS} n={LL_TRIALS} T={T}: {k3_ms:.4f} ms;"
        f" plain {k3_plain:.2f} ms; bound {k3_bound:.5f} ms ({k3_by})")

    kernels = [
        {"name": "gains_fwd", "route": "cuda",
         "source": "lqg_tpu_torch/csrc/gains.cu",
         "replaces": "lqg_tpu/ops/pallas/gains.py:149",
         "launches": launches["gains_fwd"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "ll_fwd", "route": "cuda",
         "source": "lqg_tpu_torch/csrc/likelihood.cu",
         "replaces": "lqg_tpu/ops/pallas/likelihood.py:160",
         "launches": launches["ll_fwd"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain, "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": None},
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
