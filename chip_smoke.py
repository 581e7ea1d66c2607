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
6. K1's stores and K2 (gains adjoint) against their plain versions at the
   potential's 24 specs at T=1008 and at 2,048 specs at T=719 (prime), on
   random cotangents; K3's stores and K4 (likelihood adjoint) at 24 sets x
   20 trials at T=1008;
7. the gradient path: the hierarchical potential
   ``shared_params_lqg_model(x, BoundedActor, ...)`` of 6 conditions x 20
   simulated trials at T=1008 (the data.mat shape), value and gradient for
   4 chains at once, with the counters zeroed just before and read just
   after (K1-K4 once each); against the float64 model on the card (the
   scans); its warm host-clock time and the device's busy share;
8. times from CUDA events (warmed, median of 7 runs of 20 launches; fewer
   for the plain versions, which take ~0.5-1 s a call) beside each
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
# the adjoints, at tests/test_pallas.py's CPU tolerances: the gains adjoint
# (:370-371), the likelihood adjoint's F and Q (:206-210) and data (:228-229)
K2_RTOL, K2_ATOL = 1e-3, 1e-4
# K2's cotangents are sums over T steps; one that cancels to a small value
# keeps the rounding of its terms, and the kernel's fused multiply-adds
# round otherwise than the plain version's cuBLAS products.  So its absolute
# error scales with the output's largest entries: each output is also
# allowed K2_SCALE x its max |plain| (measured on an H100: <= 3e-6 at
# T=1008 and T=719).
K2_SCALE = 1e-5
K4_RTOL, K4_FQ_ATOL, K4_X_ATOL = 1e-2, 1e-3, 1e-4
# the gradient path against float64: the value at the likelihood's rtol,
# the gradient at the on-chip rtol of test_gains_kernel_vjp_end_to_end
# (tests/test_pallas.py:411)
POT_RTOL, POT_GRAD_RTOL = 2e-4, 5e-3
T_FIT = 1008  # the data.mat fit's horizon
CONDITIONS, CHAINS = 6, 4
SHARED = ["action_cost", "action_variability", "sigma_cursor"]
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


def gains_bwd_work(B, n, m, p, T):
    """(bytes, operations) of K2 for B particles over T steps: K1's inputs
    (A, B, R, F, VV, WW) and stores (S, P) and the cotangents of L, H, K
    read once, the nine cotangents written once."""
    riccati = (mm(n, n, m) + mm(n, n, n) + mm(m, n, m) + m * m + mm(m, n, n)
               + INV_OPS[m] + 2 * mm(m, m, n) + m * n
               + 4 * mm(m, n, n) + mm(m, m, n) + 4 * m * n
               + mm(n, n, m) + mm(m, n, m) + m * m + mm(m, m, n)
               + mm(n, m, m) + mm(m, n, m) + m * m + mm(m, n, n) + 2 * m * n
               + m * m + n * n + mm(n, m, m) + mm(n, n, n) + mm(n, m, n)
               + n * n + 2 * mm(n, n, n) + 2 * n * n + mm(n, n, m)
               + mm(n, m, m) + mm(n, n, m) + 3 * n * m + mm(n, m, n)
               + mm(n, n, n) + n * n)
    kalman = (2 * n * n + 2 * mm(n, n, n) + n * n + mm(n, n, p)
              + mm(p, n, p) + p * p + INV_OPS[p] + mm(n, p, p)
              + 2 * mm(n, n, p) + mm(n, p, p) + 3 * n * p + mm(p, n, p)
              + mm(p, p, p) + 2 * p * p + mm(p, p, n) + 2 * p * n
              + mm(n, p, p) + n * p + mm(n, p, n) + mm(p, n, n)
              + 4 * n * n + 4 * mm(n, n, n) + n * n)
    spec = 2 * n * n + n * m + m * m + p * n + p * p
    inputs = B * spec + T * B * (2 * n * n + m * n + m * m + n * p)
    outputs = B * (5 * n * n + n * m + m * m + p * n + p * p)
    return (inputs + outputs) * 4, T * B * (riccati + kalman)


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


def ll_bwd_work(P, n, j, d):
    """(bytes, operations) of K4 for P sets x n trials over T_FIT steps: F,
    the data, the cotangent and K3's stores read once, F-bar and Q-bar
    (summed over trials) and the data cotangent written once."""
    T = T_FIT
    step = (INV_OPS[d] + d + mm(j, j, j) + mm(j, d, d) + 2 * j * j
            + 2 * mm(j, j, j) + 2 * j * j + 2 * mm(j, j, d) + 5 * j * d
            + mm(j, d, d) + mm(d, j, d) + mm(d, j, 1) + 3 + mm(d, d, 1)
            + 2 * d + 3 * d * d + 2 * mm(d, d, d) + 3 * d * d
            + mm(j, j, 1) + 3 * d + j * d + 2 * mm(j, j, j) + j * j
            + 3 * d * d + 4 * j * j)
    seed = INV_OPS[d] + d + mm(d, d, 1) + 2 * d + 4 * d * d
    inputs = (P * T * j * j + P * n * (T + 1) * d + P * n
              + P * n * (T + 1) * (j * j + j))
    outputs = 2 * P * T * j * j + P * n * (T + 1) * d
    return (inputs + outputs) * 4, P * n * (T * step + seed)


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
    from lqg_tpu_torch.infer import shared_params_lqg_model
    from lqg_tpu_torch.models import BoundedActor
    from lqg_tpu_torch.models.basic import tracking_spec
    from lqg_tpu_torch.ops.kernels import nvcc
    from lqg_tpu_torch.ops.kernels.gains import (fused_gains,
                                                 fused_gains_reference,
                                                 fused_gains_vjp,
                                                 fused_gains_vjp_reference,
                                                 gains_fwd)
    from lqg_tpu_torch.ops.kernels.likelihood import (
        conditioned_log_likelihood_fused,
        conditioned_log_likelihood_reference,
        conditioned_log_likelihood_vjp,
        conditioned_log_likelihood_vjp_reference, ll_fwd)
    from lqg_tpu_torch.ops.linalg import mT

    counters = (fused_gains, fused_gains_vjp, conditioned_log_likelihood_fused,
                conditioned_log_likelihood_vjp)
    names = ("gains_fwd", "gains_bwd", "ll_fwd", "ll_bwd")

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
            if "ptxas" in line or "spill" in line:
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

    # 6. K1's stores and K2, K3's stores and K4, against their plain versions
    def sweep_spec(B):
        c, av, st, sc = (torch.tensor(v, dtype=torch.float32, device=dev)
                         for v in (np.logspace(-2, 1, B),
                                   np.linspace(0.1, 1.0, B),
                                   np.linspace(2.0, 40.0, B),
                                   np.linspace(0.5, 10.0, B)))
        sp = tracking_spec(1, 1.0, av, st, sc, c, 1.0 / 60.0, device=dev)
        VV = sp.V @ mT(sp.V)
        ins = [x.expand((B,) + x.shape[-2:]).contiguous() for x in (
            sp.A, sp.B, sp.Q, sp.R, sp.Qf, sp.F, VV, sp.W @ mT(sp.W), VV)]
        return sp, ins

    def rel_err(a, b):
        """max |a - b| over max |b|, per output."""
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    g2 = torch.Generator(device=dev).manual_seed(2)
    k2_err, k2_inputs = 0.0, None
    for B2, T2 in ((CHAINS * CONDITIONS, T_FIT), (2048, 719)):
        sp, ins = sweep_spec(B2)
        out = gains_fwd(*ins, T2, stores=True)
        ref = fused_gains_reference(sp, ins[-1], T2, stores=True)
        torch.cuda.synchronize()
        st_err = max(float((a - b).abs().max())
                     for a, b in zip(out[3:], ref[3:]))
        require(all(within(a, b, K2_RTOL, K2_ATOL)
                    for a, b in zip(out[3:], ref[3:])),
                f"K1 stores vs plain carries at B={B2}: {st_err}")
        cots = [0.3 * torch.randn(x.shape, generator=g2, device=dev)
                for x in out[:3]]
        A2, Bm2, _, R2, _, F2, VV2, WW2, _ = ins
        args = (A2, Bm2, R2, F2, VV2, WW2, *out[3:], *cots)
        got = fused_gains_vjp(*args)
        want = fused_gains_vjp_reference(*args)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        rel = max(rel_err(a, b) for a, b in zip(got, want))
        log(f"K1 stores vs plain at B={B2}, T={T2}: max abs err {st_err:.3e};"
            f" K2 vs plain: max abs err {err:.3e}, max err / max|plain| "
            f"{rel:.3e} (rtol {K2_RTOL}, atol {K2_ATOL} + {K2_SCALE} max|plain|);"
            f" max|plain| "
            f"{max(float(b.abs().max()) for b in want):.4g}")
        require(all(bool(torch.isfinite(a).all()) for a in got),
                "K2 not finite")
        require(all(within(a, b, K2_RTOL,
                           K2_ATOL + K2_SCALE * float(b.abs().max()))
                    for a, b in zip(got, want)), f"K2 vs plain at B={B2}")
        if k2_inputs is None:  # the potential's shape, timed in phase 8
            k2_inputs, k2_err = args, err

    # K3's stores and K4 at the potential's 24 parameter sets (4 chains x
    # 6 conditions) and its simulated data (phase 7 makes both)
    def fit_data():
        xs = [BoundedActor(T=T_FIT, sigma_target=3.0 + 5.0 * c,
                           device=dev).simulate(g2, n=LL_TRIALS)
              for c in range(CONDITIONS)]
        return torch.stack(xs)  # (6, 20, T+1, 2)

    x_fit = fit_data()
    sets = BoundedActor(
        T=T_FIT, device=dev,
        sigma_target=torch.tensor([3.0 + 5.0 * c for c in range(CONDITIONS)]
                                  * CHAINS, device=dev),
        action_cost=torch.tensor([0.25 * (1 + k) for k in range(CHAINS)
                                  for _ in range(CONDITIONS)], device=dev))
    joint = sets._joint()
    F4, Q4 = (torch.movedim(M, 0, 1).contiguous()
              for M in (joint.F, joint.G @ mT(joint.G)))
    X4 = x_fit.repeat(CHAINS, 1, 1, 1)  # (24, 20, T+1, 2)
    ll4, *st4 = ll_fwd(F4, Q4, X4, stores=True)
    ll4_ref, *st4_ref = conditioned_log_likelihood_reference(F4, Q4, X4,
                                                             stores=True)
    torch.cuda.synchronize()
    st_err = max(float((a - b).abs().max()) for a, b in zip(st4, st4_ref))
    require(within(ll4, ll4_ref, LL_RTOL, LL_ATOL)
            and all(within(a, b, LL_RTOL, LL_ATOL)
                    for a, b in zip(st4, st4_ref)),
            f"K3 stores vs plain: {st_err}")
    w4 = torch.randn(ll4.shape, generator=g2, device=dev)
    k4_args = (F4, X4, w4, *st4)
    got = conditioned_log_likelihood_vjp(*k4_args)
    want = conditioned_log_likelihood_vjp_reference(*k4_args)
    torch.cuda.synchronize()
    k4_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    log(f"K3 stores vs plain at P={F4.shape[0]}, n={LL_TRIALS}, T={T_FIT}: "
        f"max abs err {st_err:.3e}; K4 vs plain: max abs err "
        + ", ".join(f"{k} {float((a - b).abs().max()):.3e} (of max "
                    f"{float(b.abs().max()):.4g})"
                    for k, a, b in zip(("Fbar", "Qbar", "Xbar"), got, want))
        + f" (rtol {K4_RTOL}, atol {K4_FQ_ATOL} / {K4_X_ATOL})")
    require(all(bool(torch.isfinite(a).all()) for a in got), "K4 not finite")
    require(all(within(a, b, K4_RTOL, atol) for a, b, atol in zip(
        got, want, (K4_FQ_ATOL, K4_FQ_ATOL, K4_X_ATOL))), "K4 vs plain")

    # 7. the gradient path, through the entry points a user calls
    pmodel = shared_params_lqg_model(x_fit, BoundedActor, shared_params=SHARED)
    u0 = pmodel.init_unconstrained()
    u = (u0 + 0.1 * torch.randn((CHAINS,) + u0.shape, generator=g2,
                                device=dev)).requires_grad_()

    def value_and_grad(m, uu):
        pot = m.potential(uu)
        return pot, torch.autograd.grad(pot.sum(), uu)[0]

    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pot, grad = value_and_grad(pmodel, u)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    grad_launches = {k: fn.launches for k, fn in zip(names, counters)}
    log(f"gradient path: {CHAINS} chains x {CONDITIONS} conditions x "
        f"{LL_TRIALS} trials at T={T_FIT}, D={u.shape[-1]}: value+grad in "
        f"{grad_s:.3f} s (first call, host clock); launches {grad_launches}")
    require(all(v == 1 for v in grad_launches.values()),
            f"gradient path: each kernel once, got {grad_launches}")
    require(pot.shape == (CHAINS,) and grad.shape == u.shape,
            "gradient path: wrong shapes")
    require(bool(torch.isfinite(pot).all() and torch.isfinite(grad).all()),
            "gradient path: values not finite")
    model64 = shared_params_lqg_model(x_fit.double(), BoundedActor,
                                      shared_params=SHARED)
    pot64, grad64 = value_and_grad(model64,
                                   u.detach().double().requires_grad_())
    pot, pot64 = pot.detach(), pot64.detach()
    pot_err = float(((pot.double() - pot64) / pot64).abs().max())
    grad_rel = ((grad.double() - grad64).abs() / grad64.abs())
    log(f"gradient path vs float64 scan on the card: value rel err "
        f"{pot_err:.3e} (rtol {POT_RTOL}) of |U| ~ "
        f"{float(pot64.abs().mean()):.1f}; gradient rel err max "
        f"{float(grad_rel.max()):.3e}, median {float(grad_rel.median()):.3e}"
        f" (rtol {POT_GRAD_RTOL}); |grad| from "
        f"{float(grad64.abs().min()):.4g} to {float(grad64.abs().max()):.4g}")
    require(within(pot.double(), pot64, POT_RTOL, 0.0),
            f"gradient path value vs float64: {pot_err}")
    require(within(grad.double(), grad64, POT_GRAD_RTOL, 0.0),
            f"gradient path gradient vs float64: {float(grad_rel.max())}")

    def grad_path():
        value_and_grad(pmodel, u)

    warm = []
    for _ in range(7):
        t0 = time.perf_counter()
        grad_path()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    log(f"gradient path warm, host clock: median "
        f"{statistics.median(warm) * 1e3:.3f} ms of "
        f"{[round(w * 1e3, 3) for w in warm]}")
    wall, busy, n_events, named = profile_ms(grad_path, names)
    if n_events:
        log(f"gradient path under torch.profiler: wall {wall:.2f} ms, device "
            f"busy {busy:.3f} ms ({100 * busy / wall:.2f}% of wall) over "
            f"{n_events} device events; "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in named.items()))
    else:
        log("gradient path under torch.profiler: no device events recorded; "
            "device busy share not measured")

    # 8. times
    # each kernel timed through its launching function on prepared inputs
    # (the public wrappers add host work: K1's is host-bound at this shape)
    VV1 = spec.V @ mT(spec.V)
    k1_ins = [x.expand((B,) + x.shape[-2:]).contiguous() for x in (
        spec.A, spec.B, spec.Q, spec.R, spec.Qf, spec.F, VV1,
        spec.W @ mT(spec.W), S0)]
    k1_ms = cuda_ms(lambda: gains_fwd(*k1_ins, T))
    k1_wrapper_ms = cuda_ms(lambda: fused_gains(spec, S0, T))
    k1_plain = cuda_ms(lambda: fused_gains_reference(spec, S0, T),
                       launches=3)
    k3_ms = cuda_ms(lambda: ll_fwd(F, Q, X))
    k3_plain = cuda_ms(
        lambda: conditioned_log_likelihood_reference(F, Q, X), launches=3)
    k1_bound, k1_by = bound(gains_work(B, 2, 1, 2))
    k3_bound, k3_by = bound(ll_work(LL_SETS, LL_TRIALS, 4, 2))
    k2_ms = cuda_ms(lambda: fused_gains_vjp(*k2_inputs))
    k2_plain = cuda_ms(lambda: fused_gains_vjp_reference(*k2_inputs), runs=3,
                       launches=1)
    k4_ms = cuda_ms(lambda: conditioned_log_likelihood_vjp(*k4_args))
    k4_plain = cuda_ms(
        lambda: conditioned_log_likelihood_vjp_reference(*k4_args), runs=3,
        launches=1)
    k2_bound, k2_by = bound(gains_bwd_work(CHAINS * CONDITIONS, 2, 1, 2,
                                           T_FIT))
    k4_bound, k4_by = bound(ll_bwd_work(F4.shape[0], LL_TRIALS, 4, 2))
    log(f"[{card}] K1 gains_fwd B={B} T={T}: {k1_ms:.4f} ms "
        f"({B / (k1_ms / 1e3):.1f} solves/s); through fused_gains "
        f"{k1_wrapper_ms:.4f} ms; plain {k1_plain:.2f} ms; bound "
        f"{k1_bound:.4f} ms ({k1_by})")
    log(f"[{card}] K3 ll_fwd P={LL_SETS} n={LL_TRIALS} T={T}: {k3_ms:.4f} ms;"
        f" plain {k3_plain:.2f} ms; bound {k3_bound:.5f} ms ({k3_by})")
    log(f"[{card}] K2 gains_bwd B={CHAINS * CONDITIONS} T={T_FIT}: "
        f"{k2_ms:.4f} ms; plain {k2_plain:.2f} ms; bound {k2_bound:.6f} ms "
        f"({k2_by}); launches per value+grad {grad_launches['gains_bwd']}")
    log(f"[{card}] K4 ll_bwd P={F4.shape[0]} n={LL_TRIALS} T={T_FIT}: "
        f"{k4_ms:.4f} ms (with the wrapper's sum over trials); plain "
        f"{k4_plain:.2f} ms; bound {k4_bound:.5f} ms ({k4_by}); launches per "
        f"value+grad {grad_launches['ll_bwd']}")

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
        {"name": "gains_bwd", "route": "cuda",
         "source": "lqg_tpu_torch/csrc/gains.cu",
         "replaces": "lqg_tpu/ops/pallas/gains.py:237",
         "launches": grad_launches["gains_bwd"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
        {"name": "ll_bwd", "route": "cuda",
         "source": "lqg_tpu_torch/csrc/likelihood.cu",
         "replaces": "lqg_tpu/ops/pallas/likelihood.py:270",
         "launches": grad_launches["ll_bwd"], "max_abs_err": k4_err,
         "ms": k4_ms, "plain_ms": k4_plain, "bound_ms": k4_bound,
         "bound_by": k4_by, "library_ms": None},
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
