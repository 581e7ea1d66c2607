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
   zeroed just before and read just after (K1, K3 and ``joint_fwd``, which
   assembles the joint system, see phase 21); the result against the float64
   scan on the card, and the golden trajectories against their recorded
   log likelihood; its warm host-clock time, and the device's busy share
   of one call under ``torch.profiler``;
6. K1's stores and K2 (gains adjoint) against their plain versions at the
   potential's 24 specs at T=1008 and at 2,048 specs at T=719 (prime), on
   random cotangents, and two K2 launches bit for bit; K3's stores (per
   set) and K4 (likelihood adjoint) at 24 sets x 20 trials at T=1008, and
   two K4 launches bit for bit;
7. the gradient path: the hierarchical potential
   ``shared_params_lqg_model(x, BoundedActor, ...)`` of 6 conditions x 20
   simulated trials at T=1008 (the data.mat shape), value and gradient for
   4 chains at once, with the counters zeroed just before and read just
   after (K1-K4 and the joint kernels once each, K5/K6 not at all); against the float64 model on the card (the
   scans); its warm host-clock time and the device's busy share, the
   kernels' device time in the path (``torch.profiler``), and the SM clock
   and power draw (``nvidia-smi``) sampled while it repeats;
8. K5 (blocked large-j likelihood) and its stores, and K6 (its adjoint) on
   a random cotangent, against their plain versions at every cluster size
   (1, 2, 4, 8 blocks a parameter set), K5 the same bits at every size and
   two K6 launches the same bits, at the delay fit's shape: 24 sets of
   ``DelayedSubjectiveActor`` (j=65, d=2) x 20 trials at T=1008; and at the
   edge of the scope, ``TemporalDelayModel(SubjectiveActor(dim=2),
   delay=11)`` (j=120, d=4) at T=40; then one short n=39 gains scan
   (``riccati.backward``, ``kalman.forward``, T=8) under
   ``torch.cuda.set_sync_debug_mode("error")``: the scans wait on nothing;
9. the forward delay path, ``DelayedSubjectiveActor(T=1008)`` ->
   ``simulate(n=20)`` -> ``log_likelihood(x[..., :2], method="auto")``, K5's
   counter zeroed just before and read just after; against the float64
   scan on the card; warm host-clock time and the device's busy share;
10. the gradient delay path: ``shared_params_lqg_model(x,
    DelayedSubjectiveActor, ...)`` of 6 conditions x 20 simulated trials at
    T=1008, value and gradient for 4 chains at once, all counters zeroed
    just before (K5 and K6 once each, K1-K4 not at all: the gains at n=39
    are the scans, and the joint system at j=65 the old assembly); against
    the float64 model on the card; warm host-clock
    time and the device's busy share;
11. the (3, 1, 2) instances of K1/K2 and the (5, 2) instances of K3/K4
    against their plain versions through ``SubjectiveActor``, and its value
    and gradient through the entry points (K1-K4 and the joint kernels
    once each); K3 (both
    variants) and K4 timed at (5, 2);
12. times from CUDA events (warmed, median of 7 runs of 20 launches; fewer
    for K5, K6 and the plain versions, which take ~0.5-3 s a call) beside
    each kernel's bound; K2 at 24 specs, T=1008 and at 2,048 specs, T=719,
    also its device time a launch from ``torch.profiler``, with the SM
    clock and power draw sampled while it repeats; K5 and K6 at P=24 and
    at P=1, at one block a set (C=1) and at the wrapper's cluster size,
    timed in turns, with the SMs they use, TFLOP/s, the whole card's bound
    and the bound on those SMs;
13. the potential's value+grad replayed from a CUDA graph
    (``infer.capture.GraphedValueAndGrad``) on two bounded-actor
    potentials: ``scripts/recover.py``'s (``lifted_model``, parameters from
    ``sample_from_prior``, 20 simulated trials at T=720, 4 chains) and
    phase 7's fit; one eager value+grad of each under
    ``torch.cuda.set_sync_debug_mode("error")`` (no copy from host memory,
    no synchronization inside the potential); the replay against eager at
    three points; capture and instantiate seconds, replay and eager times,
    the device's busy share of a replay and the kernels it runs (K1-K4,
    ``torch.profiler``);
14. the NUTS recovery at that shape through ``infer(..., method="nuts")``
    (``max_depth=10``, 4 chains, warmup and samples sized to the time
    limit), every leapfrog a replay: the counters zeroed just before and
    read just after (K1-K4 launched by the warm-up and the capture; the
    replays do not count), transitions/s, leapfrogs/s, ms per leapfrog,
    ESS/s, divergences and split R-hat; each true parameter within 4
    posterior standard deviations of the posterior mean; and one profiled
    transition: its host time per leapfrog against a replay's;
15. the rest of the model zoo, ``PointMassBoundedActor``,
    ``HandMotionModelTrackingTask`` and ``SignalDependentNoiseActor``, and
    ``RelativeObservationBoundedActor(dim=2)`` for K1/K2 at (4, 2, 2):
    first whether ``torch.linalg.matrix_exp`` and ``torch.linalg.eigh``
    synchronize the host (why the port has its own ``expm`` and eigenvalue
    clip); then for each model the forward path (``T=1000``, 20 trials,
    positions scored) and the gradient path (6 conditions x 20 trials at
    T=1008, 4 chains, the mechanical parameters free per chain), each with
    all counters zeroed just before and read just after (K1-K4 for the point
    mass, the hand and the relative-observation actor; K3/K4 and no K1 for
    the signal-dependent actor, whose gains are the multiplicative scans),
    against the float64 model on the card, warm host
    wall and device busy share, one eager value+grad under
    ``set_sync_debug_mode("error")``; the point-mass potential captured in a
    CUDA graph and replayed against eager at three points;
16. the zoo's instances against their plain versions: K1 (with stores) and
    K2 at (4, 1, 3), (5, 1, 2) and (4, 2, 2), each at 24 specs, T=1008 and
    2,048 specs, T=719, two K2 launches the same bits; K3 (both variants,
    the stores) and K4 at (8, 2), (8, 4), (10, 2) and (10, 4), 24 sets x 20
    simulated trials at T=1008, two K4 launches the same bits; each
    instance's time beside its bound (and the plain version's at 24 sets),
    added to the kernels line under ``ms_by_shape`` and ``zoo_shapes``;
17. ``scripts/fit_data.py``'s pipeline on phase 7's data (6 conditions x 20
    trials at T=1008, D=9), through the entry points: first K1 (with the
    stores) and K2, K3 (with the stores) and K4 against their plain
    versions at the parameter sets the pipeline launches them at (1, 8 and
    16 points x 6 conditions = 6, 48, 96), two K2 and two K4 launches the
    same bits, each timed beside its bound (``fit_shapes`` in the kernels
    line); then, with the counters zeroed just before and read just after
    (K1-K4 launched by the warm-ups and the captures): the MAP,
    ``optimize`` for 300 steps at step size 0.05, each step a replay of the
    graph captured by a first call, under ``set_sync_debug_mode("error")``;
    ``fit_auto_iaf`` for 1,500 steps of 16 particles (``fit_data.py``
    takes 3,000), the graphed ELBO (float32) against eager float64 on one
    ``eps``; ``fit_auto_mvn`` for 300 steps of 8 particles;
    ``laplace_guide`` at the MAP (the scans, cut to T=120: 124.76 s at
    T=1008);
    ``neutra_reparam`` with the IAF, a 200-step polish in the warped space
    and ``MCMC`` on 4 chains, 100 warmup + 100 samples, ``max_depth=8``,
    each leapfrog one replay of the flow, the potential and autograd.  It
    prints ms a step (CUDA events or the host clock) beside a replay alone
    and Adam alone, the potential's decrease, the final ELBO, the laplace
    time, ms a NeuTra leapfrog against a replay alone, divergences and
    split R-hat;
18. the data and fit tools: a ``data.mat`` simulated by ``BoundedActor``
    at the data's raw shape (6 blob widths x 20 trials x 1201 steps) read by
    ``io.load_tracking_data`` (against the same preprocessing in numpy);
    ``scripts/torch_fit_data.py``'s ``main`` on it (MAP, NUTS on 4 chains,
    100 + 100 transitions, ``max_depth=8``), the counters zeroed just
    before and read just after (K1-K4 launched by the warm-ups and the
    captures): ``ll_baseline`` set after the MAP and before NUTS captures,
    the potential at the MAP below 1e3, a replay against eager float64 with
    the same baseline, ms a MAP step and a leapfrog, the netcdf read back;
    ``xcorr`` of the 120 trials against ``numpy.correlate`` and its time,
    the CCG fit engines (``"torch"`` against ``"scipy"``, median losses);
    ``System.gains(method="sqrt"|"steady")`` at T=1000 in float32 against
    the float64 scan, whether each synchronizes, their host time beside
    K1's, and ``log_likelihood(gains_method="sqrt")`` through K3; and
    ``profiling.timeit`` of the fit's replay beside phase 13's reading;
19. the parallel layer: ``log_likelihood(method="pscan")`` of the bounded
    actor (20 trials) at T=1008 and T=10^4, value and value+grad (K1 and K2
    once each, no K3/K4), with TF32 off and no host synchronization,
    against float64 and K3; pscan timed beside K3 and K3+K4 on the same
    joint system; where a chain's float32 value+grad comes to depend on the
    batch of chains (``batch_bits``); then two ranks started by
    ``torch.multiprocessing`` (gloo sharing one card, nccl one card each
    where there are two), the kernels already built: the trial-sharded
    value+grad of the fit's 120 trials against one process, the
    horizon-sharded value+grad at T=10^4 against one-device pscan, and
    chain-sharded NUTS (4 chains, 2 a rank, graphs replayed): its captured
    value+grad and its first transition against the unsharded ones, its
    posterior means against the unsharded run's within standard errors, a
    stopped and resumed run and a run with a binding leapfrog budget the
    same bits, and in float64 the sharded draws against the unsharded
    run's; K1-K4's launches per rank and path, ms a leapfrog sharded (with
    and without the budget) and unsharded; and a one-rank nccl group
    through the trial-sharded value+grad;
20. K1-K4 over lqg_tpu's whole kernel scope (n <= 8, m <= 2, p <= 3; j <=
    12, d <= 4): K1 (both designs, the same bits, with the stores) and K2 at
    every gains instance added for ``TemporalDelayModel`` at delays 1-3,
    (4, 6, 8 states at m = 1, p = 1-2), at the envelopes (8, 1, 3), (8, 2,
    1-3) and at (3, 2, 3) and (7, 1, 3), padded onto them, 24 specs at
    T=1008; K3 (both variants) and K4 at (12, 1-4) and at (6, 3) and (3,
    1), padded, 24 sets x 20 trials at T=1008; each against its plain
    version at the true shape (K2 the plain version in float64 on the same
    float32 stores), two K2 and two K4 launches the same bits,
    each timed beside its bound at the true shape's work, with its
    registers and spills (``scope_shapes`` in the kernels line); then the
    gradient path of ``TemporalDelayModel(BoundedActor, delay=1)`` (K1/K2
    at (4, 1, 2), K3/K4 at (8, 2)), ``delay=2`` ((6, 1, 2), (12, 2)) and
    ``TemporalDelayModel(RelativeObservationBoundedActor, delay=3)`` ((8,
    1, 1), K5/K6 at j=16), 4 chains x 6 conditions x 20 trials at T=1008:
    one eager value+grad with the counters and a counter on the scans
    zeroed just before and read just after (each kernel once, no scan),
    against eager float64, replayed from a CUDA graph against eager, and
    its replay and eager times beside the scan route's
    (``method="scan"``), which ``auto`` took at these shapes before.

21. the joint-system kernels (``csrc/joint.cu``: ``joint_fwd`` writes ``F``
    and ``Q = G G^T`` in K3's layout from the gains, ``joint_bwd`` is its
    adjoint), at the bounded actor's 6, 24 and 96 parameter sets (the
    benchmark's MAP and vg1, NUTS and vg16 batches) and the subjective
    actor's 6, T=1008, with the gains K1 gives: through ``joint_fq`` and
    autograd, F, Q and the gradients of the gains and of the eight spec
    matrices against the plain version (``gaussian.joint_system``, ``G
    G^T``, the time axis moved) and its autograd in float64, within
    JOINT_ULPS x (j + 8) float32 ulps of the largest entry of the same
    computation on the terms' magnitudes; two launches the same bits; each
    kernel's time (a CUDA graph of 20 calls between CUDA events) beside its
    byte bound, and forward + backward through autograd beside the plain
    version's.  The zoo's paths (phase 15) and the scope paths (phase 20)
    count the joint kernels where an instance holds the model's dims.

The line before the last is one JSON object describing every kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

import inspect
import json
import math
import os
import re
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
# K5 as tests/test_pallas.py:481 holds the Pallas blocked kernel; its stores
# and K6's cotangents, which the JAX test scales by each output's largest
# entry (:504-507), within BLK_SCALED of max |plain|
BLK_RTOL, BLK_ATOL, BLK_SCALED = 2e-3, 0.2, 2e-3
DELAY_SHARED = ["c", "subj_noise", "subj_vel_noise", "sigma_cursor",
                "action_variability"]
# the delay paths against float64: the value at the blocked kernel's rtol;
# the gradient's components differ by four orders of magnitude, so each is
# held to DELAY_GRAD_RTOL of itself (the gradient path's rtol) plus
# DELAY_GRAD_SCALED of the largest (measured on an H100: 5.1e-4 and 9.9e-7)
DELAY_POT_RTOL, DELAY_GRAD_RTOL, DELAY_GRAD_SCALED = 2e-3, 5e-3, 1e-5
# scripts/recover.py's recovery: its seed, trials, horizon and chains; the
# run's warmup and samples sized to the time limit (300 + 300 until phase 18
# came)
RECOVER_SEED, RECOVER_TRIALS, RECOVER_T = 7432, 20, 720
RECOVER_WARMUP, RECOVER_SAMPLES, RECOVER_SDS = 200, 200, 4.0
EDGE_DELAY, EDGE_T, EDGE_SETS = 11, 40, 2  # j = 2 * (2 + 3) * 12 = 120, d = 4
# phases 15-16, the rest of the zoo: each path's model class, its keyword
# arguments, the parameter that differs between conditions, and the shared
# parameters of its gradient path; the mechanical parameters, which the
# default prior lacks, get log-normal priors (scale 0.5) centred on the
# models' defaults, so that they are free per chain.  The relative-
# observation actor at dim=2 runs K1 and K2 at (4, 2, 2), the instance at
# which K1 projects its Riccati carry and K2 applies that projection's
# adjoint.
ZOO_PATHS = {
    "PointMassBoundedActor": (
        "PointMassBoundedActor", {}, "sigma_target",
        ["action_cost", "action_variability", "sigma_cursor", "damping", "m",
         "tau"]),
    "HandMotionModelTrackingTask": (
        "HandMotionModelTrackingTask", {}, "sigma_target",
        ["action_cost", "action_variability", "sigma_cursor", "m", "tau"]),
    "SignalDependentNoiseActor": (
        "SignalDependentNoiseActor", {}, "sigma_target",
        ["action_cost", "action_variability", "sigma_cursor",
         "signal_dep_noise"]),
    "RelativeObservationBoundedActor(dim=2)": (
        "RelativeObservationBoundedActor", {"dim": 2}, "sigma",
        ["action_cost", "action_variability"]),
}
ZOO_MECHANICAL = ("damping", "m", "tau")
# phase 20, K1-K4 over lqg_tpu's whole kernel scope: the instances added for
# TemporalDelayModel at delays 1-3 and the envelopes at n = 8 and j = 12,
# two padded shapes of each pair, and the delay models' gradient paths.
# Each gains instance's model (base model, delay; the point mass at delay 1
# is (8, 1, 3)), None for a random spec whose open loop is stable; each likelihood instance's model (a callable
# of the per-condition parameter and the keywords), the parameter and the
# dims observed, None for a random stable joint system
SCOPE_GAINS = {(4, 1, 2): ("BoundedActor", 1), (6, 1, 2): ("BoundedActor", 2),
               (8, 1, 2): ("BoundedActor", 3),
               (4, 1, 1): ("RelativeObservationBoundedActor", 1),
               (6, 1, 1): ("RelativeObservationBoundedActor", 2),
               (8, 1, 1): ("RelativeObservationBoundedActor", 3),
               (8, 1, 3): ("PointMassBoundedActor", 1), (8, 2, 1): None,
               (8, 2, 2): None, (8, 2, 3): None, (3, 2, 3): None,
               (7, 1, 3): None}
SCOPE_LL = {(12, 2): ("delay", "BoundedActor", 2),
            (12, 1): ("delay", "RelativeObservationBoundedActor", 2),
            (12, 3): ("dim", "RelativeObservationBoundedActor", 3),
            (12, 4): ("dim", "BoundedActor", 3),
            (6, 3): None, (3, 1): None}
# the gradient paths: the wrapped model, its delay, the parameter that
# differs between conditions, the shared parameters, the kernels a
# value+grad launches (each once) and the gains and likelihood instances
SCOPE_PATHS = {
    "TemporalDelayModel(BoundedActor, delay=1)": (
        "BoundedActor", 1, "sigma_target", SHARED,
        ("gains_fwd", "gains_bwd", "ll_fwd", "ll_bwd", "joint_fwd",
         "joint_bwd"), (4, 1, 2), (8, 2)),
    "TemporalDelayModel(BoundedActor, delay=2)": (
        "BoundedActor", 2, "sigma_target", SHARED,
        ("gains_fwd", "gains_bwd", "ll_fwd", "ll_bwd", "joint_fwd",
         "joint_bwd"), (6, 1, 2), (12, 2)),
    "TemporalDelayModel(RelativeObservationBoundedActor, delay=3)": (
        "RelativeObservationBoundedActor", 3, "sigma",
        ["action_cost", "action_variability"],
        ("gains_fwd", "gains_bwd", "ll_blocked_fwd", "ll_blocked_bwd"),
        (8, 1, 1), (16, 2)),
}
# phase 21, the joint-system kernels (csrc/joint.cu): the bounded actor at
# the benchmark's parameter sets (6: the MAP and vg1 cells, 24: NUTS, 96:
# vg16) and the subjective actor at 6, T=1008; each output held to
# JOINT_ULPS x (j + 8) float32 ulps of the largest entry of the same
# computation on its terms' magnitudes (tests/test_torch_joint_kernel.py);
# the adjoint timed with the outputs the fits need (L, K, V_d, W_d)
JOINT_SHAPES = (("BoundedActor", 6), ("BoundedActor", 24),
                ("BoundedActor", 96), ("SubjectiveActor", 6))
JOINT_ULPS = 4
JOINT_NEEDS = (True, True, False, False, False, True, True, False, False,
               False)
# K1 at the zoo's instances, as tests/test_pallas.py:60 holds the Pallas
# kernel at n = 3-4 (PointMass's |L| reaches ~70)
ZOO_GAINS_ATOL = 5e-4
# K3's stores at the zoo's instances: each entry is also allowed
# K3_STORE_SCALE x the largest |plain| of its row, one state's covariances
# or means over every set, step and trial (the point mass's hidden-state
# means reach ~1e2-1e4 and keep float32 rounding of that scale, while its
# activation's stay near 1); phase 16 prints each store's worst row
K3_STORE_SCALE = 1e-3
# phase 17, scripts/fit_data.py's pipeline at the data's shape: the MAP's
# Adam steps at step size 0.05, the IAF guide fit (16 particles; fit_data.py
# takes 3,000 steps, cut to 1,500 when phase 18 came), the Gaussian guide's 300 steps of 8 particles, the
# warped-space polish (step size 0.02) and NeuTra NUTS on 4 chains; K1-K4
# held against their plain versions at the parameter sets those steps
# launch them at (1, 8 and 16 points x 6 conditions); the ELBO's gradient
# with respect to each guide parameter against float64 within
# POT_GRAD_RTOL of itself plus ELBO_GRAD_SCALED of its leaf's largest entry
# (a mean over particles of J^T grad, whose small entries cancel)
MAP_STEPS, MAP_STEP_SIZE, IAF_STEPS, MVN_STEPS = 300, 0.05, 1500, 300
POLISH_STEPS, POLISH_STEP_SIZE = 200, 0.02
NEUTRA_WARMUP, NEUTRA_SAMPLES, NEUTRA_DEPTH = 100, 100, 8
# laplace_guide runs the scans eagerly, with a double-backward graph: at
# T=1008 it took 124.76 s on an H100, 46.94-55.58 s at T=360 and 27.5-29.1
# s at T=180, so its horizon is cut to keep it near 20 s (the other steps
# keep T=1008)
LAPLACE_T = 120
FIT_BATCHES = (1, 8, 16)  # points of the potential: MAP, MVN, IAF
ELBO_GRAD_SCALED = 1e-3
# phase 18, the data and fit tools: the synthetic data.mat at the data's
# raw shape (6 blob widths x 20 trials x 1201 steps; the loader's delay and
# clip leave 1009), scripts/torch_fit_data.py's arguments, xcorr's lags and
# tolerance (of the largest entry), the CCG engines' median losses
DATA_RAW_T, DATA_DELAY, DATA_CLIP = 1201, 12, 180
DATA_SIGMAS = (5.0, 8.0, 11.0, 14.0, 17.0, 20.0)  # x 1.32 -> 6 blob widths
FIT_MAP_STEPS, FIT_SAMPLES, FIT_DEPTH = 300, 100, 8
FIT_ARGS = ["--init", "map", "--map-steps", str(FIT_MAP_STEPS), "--nsamp",
            str(FIT_SAMPLES), "--nburnin", str(FIT_SAMPLES), "--nchain",
            str(CHAINS), "--max-depth", str(FIT_DEPTH)]
XCORR_LAGS, XCORR_SCALED, CCG_LOSS_RATIO = 60, 1e-5, 1.05
# the sqrt gains against the float64 scan, the steady gains at t=100 (L)
# and at the last step (K): the bounds of lqg_tpu's tests/test_sqrt.py and
# tests/test_dare.py
SQRT_ATOL, STEADY_L_ATOL, STEADY_K_ATOL = 1e-4, 1e-2, 1e-4
# phase 19, the parallel layer: method="pscan" at the fit's horizon and at
# T=10^4 (20 trials, the bounded actor), held against float64 (the scan at
# the fit's horizon; at 10^4 pscan on the associative gains, where the
# scans' host loop and its backward would take tens of seconds) and timed
# beside K3/K4 on the same inputs; then PAR_RANKS ranks of
# torch.multiprocessing (gloo sharing one card, nccl on two or more): the
# trial-sharded likelihood of the fit's 120 trials, the horizon-sharded
# likelihood at T=10^4, and chain-sharded NUTS on phase 13's recovery
# potential (float32, graphs replayed; 4 chains, PAR_WARMUP + PAR_SAMPLES
# transitions, max_depth PAR_DEPTH, chunks of PAR_CHUNK), uninterrupted and
# stopped after a chunk and resumed; a one-rank nccl group through the
# trial-sharded likelihood.  In float32 the potential's gradient at 2 chains
# differs from that at 4 in its last bits (measured up to 4.9e-4 absolute on
# an H100: autograd's sums over time of time-broadcast matrices round
# otherwise at another batch, as batch_bits shows), and
# NUTS, which is chaotic, then leaves the unsharded run's draws within a
# few transitions (0.55 apart after 20 + 20).  So in float32 a rank's
# captured value+grad at its chains is held to the unsharded one at the same
# points (POT_RTOL, POT_GRAD_RTOL), the first transition's draws to the
# unsharded ones (within PAR_FIRST_SDS of the unsharded posterior sds: the
# rounding, amplified over a tree's leapfrogs, against a step's size for a
# chain mixed up), and the posterior means after
# PAR_WARMUP + PAR_SAMPLES to the unsharded run's within PAR_SES standard
# errors of their difference (sd sqrt(1/ESS + 1/ESS'), each ESS at most the
# number of draws); the draw-for-draw check runs in float64 (PAR_EXACT_T
# steps, PAR_EXACT_TRIALS trials, PAR_EXACT_DRAWS + PAR_EXACT_DRAWS
# transitions, max_depth 4, within PAR_EXACT_ATOL of the unsharded run).
PSCAN_TS = (T_FIT, 10_000)
PAR_RANKS, PAR_JOIN_S = 2, 300
PAR_PARAMS = dict(action_cost=0.5, action_variability=0.6, sigma_cursor=2.0)
PAR_WARMUP, PAR_SAMPLES, PAR_DEPTH, PAR_CHUNK, PAR_SEED = 20, 20, 5, 10, 19
PAR_SES, PAR_FIRST_SDS = 4.0, 1e-2
# batch_bits: a tensor's difference to its counterpart's rows, relative to
# its largest entry, counts as rounding up to this (beyond it the two are
# not the same rows)
ROUNDING, SOURCES_SHOWN = 1e-3, 12
# the sharded chains' leapfrog budget that can end a chunk (so that each
# transition reads its trees' sizes, across the ranks), timed beside the
# default that cannot
PAR_BUDGET = (PAR_CHUNK - 1) * 2 ** PAR_DEPTH
PAR_EXACT_T, PAR_EXACT_TRIALS, PAR_EXACT_DRAWS, PAR_EXACT_ATOL = 60, 5, 6, 1e-8
EXACT_KW = dict(num_warmup=PAR_EXACT_DRAWS, num_samples=PAR_EXACT_DRAWS,
                num_chains=4, max_depth=4)
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


def smi_during(fn, seconds=1.5):
    """Calls ``fn`` and synchronizes, again and again for ``seconds``, while
    ``nvidia-smi`` samples the SM clock (MHz) and the power draw (W) every
    20 ms; returns the calls made and each quantity's (min, median, max)
    over the samples, or None where no sample came."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "20"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        calls, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
            calls += 1
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    rows = []
    for line in out.splitlines():
        try:
            rows.append([float(v) for v in line.split(",")])
        except ValueError:
            continue
    if not rows:
        return calls, None

    def spread(values):
        return (min(values), statistics.median(values), max(values))

    return calls, {"samples": len(rows), "sm_mhz": spread([r[0] for r in rows]),
                   "power_w": spread([r[1] for r in rows])}


def smi_text(sampled):
    calls, stats = sampled
    if stats is None:
        return f"{calls} calls; SM clock and power not measured (no sample)"
    return (f"{calls} calls; {stats['samples']} nvidia-smi samples: SM clock "
            f"min/median/max {stats['sm_mhz'][0]:.0f}/{stats['sm_mhz'][1]:.0f}"
            f"/{stats['sm_mhz'][2]:.0f} MHz, power draw "
            f"{stats['power_w'][0]:.2f}/{stats['power_w'][1]:.2f}/"
            f"{stats['power_w'][2]:.2f} W")


def ptxas_summary(report: str):
    """One line per kernel of an ``-Xptxas -v`` report: its name and
    template arguments, registers, stack frame and spills."""
    rows, name = [], "?"
    for line in report.splitlines():
        entry = re.search(r"Function properties for \S*?_cu_[0-9a-f]{8}(\d+)"
                          r"(\w+)", line)
        if entry:
            length, rest = int(entry.group(1)), entry.group(2)
            args = re.findall(r"L[ib](\d+)E", rest[length:])
            name = f"{rest[:length]}<{', '.join(args)}>"
        spills = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                           r"stores, (\d+) bytes spill loads", line)
        if spills:
            stack = spills.groups()
        used = re.search(r"Used (\d+) registers", line)
        if used:
            rows.append(f"{name}: {used.group(1)} registers, stack {stack[0]} "
                        f"B, spill stores {stack[1]} B, loads {stack[2]} B")
    return rows


def cuda_ms(fn, runs=7, launches=20, graph=False):
    """Median over ``runs`` of the mean time of ``launches`` calls, from
    CUDA events, after one warm-up call.  With ``graph`` the calls are
    captured in one CUDA graph, which each run replays: the host's launches
    are then out of the time (for kernels of microseconds)."""
    fn()
    torch.cuda.synchronize()
    calls = lambda: [fn() for _ in range(launches)]
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            calls()
        calls = captured.replay
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        calls()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / launches)
    return statistics.median(times)


def paired_ms(fn_a, fn_b, rounds=6, launches=5):
    """Medians over ``rounds`` of the mean time of ``launches`` calls of
    two functions timed in turns (a b, b a, ...), from CUDA events, after
    one warm-up call of each."""
    fn_a()
    fn_b()
    torch.cuda.synchronize()
    times = ([], [])
    for r in range(rounds):
        for k in ((0, 1) if r % 2 == 0 else (1, 0)):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(launches):
                (fn_a, fn_b)[k]()
            stop.record()
            stop.synchronize()
            times[k].append(start.elapsed_time(stop) / launches)
    return statistics.median(times[0]), statistics.median(times[1])


def kernel_device_ms(fn, name):
    """The device time of each kernel named ``name`` that one call of ``fn``
    launches, under ``torch.profiler``: (their mean in ms, their count), or
    (None, 0) where none was recorded."""
    from lqg_tpu_torch.utils.profiling import device_events

    times = [(e - s) / 1e6 for s, e, n in device_events(fn)[1] if name in n]
    return (statistics.mean(times) if times else None), len(times)


def profile_ms(fn, names):
    """One call of ``fn`` under ``torch.profiler``: its host-clock time, the
    union of the device's busy intervals, the number of device events and
    the device time of the kernels named in ``names`` (all in ms)."""
    from lqg_tpu_torch.utils.profiling import device_events

    wall, spans = device_events(fn)
    busy, reach = 0, 0
    for start, end, _ in spans:
        busy += max(0, end - max(start, reach))
        reach = max(reach, end)
    named = {k: sum(e - s for s, e, n in spans if k in n) / 1e6 for k in names}
    return wall, busy / 1e6, len(spans), named


def mm(r, k, c):
    """Operations of an (r, k) @ (k, c) product."""
    return r * c * (2 * k - 1)


# closed-form symmetric inverse, eps included (3: cofactors; 4: Schur
# complement on 2 x 2 blocks)
INV_OPS = {1: 2, 2: 11, 3: 34, 4: 102}


def gains_work(B, n, m, p, steps=T):
    """(bytes, operations) of K1 for B particles over ``steps`` steps:
    inputs read once, outputs written once."""
    riccati = (mm(n, n, m) + mm(n, n, n) + mm(m, n, m) + m * m + mm(m, n, n)
               + INV_OPS[m] + mm(m, m, n) + m * n + mm(m, m, n) + mm(n, n, n)
               + 3 * mm(n, m, n) + 3 * n * n
               + (2 * n * n if m > 1 else 0))  # sym(S) at m > 1
    kalman = (2 * mm(n, n, n) + n * n + mm(n, n, p) + mm(p, n, p) + p * p
              + INV_OPS[p] + mm(n, p, p) + mm(n, p, n) + n * n)
    inputs = B * (5 * n * n + n * m + m * m + p * n + p * p) * 4
    outputs = steps * B * (m * n + m * m + n * p) * 4
    return inputs + outputs, steps * B * (riccati + kalman)


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
               + mm(n, n, n) + n * n
               + (2 * n * n if m > 1 else 0))  # sym(Sb) at m > 1
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


def ll_work(P, n, j, d, T, stores=False):
    """(bytes, operations) of K3 for P sets x n trials over T steps: F, Q
    and the data read once, ll written once (with ``stores``, also Sigma_t
    once per set and mu_t per trial); the covariance recursion counted once
    per set, the mean and the quadratic form per trial."""
    neumaier = 7
    cov = (INV_OPS[d] + 1 + neumaier + 2 * mm(j, j, j) + mm(j, d, d)
           + mm(j, d, j) + 4 * j * j)
    trial = (d + mm(d, d, 1) + (2 * d - 1) + neumaier + mm(j, j, 1)
             + mm(j, d, 1) + j)
    final = P * (INV_OPS[d] + 1) + P * n * (d + mm(d, d, 1) + 2 * d + 5)
    nbytes = 2 * P * T * j * j + P * n * (T + 1) * d + P * n
    if stores:
        nbytes += P * (T + 1) * (j * j + j * n)
    return nbytes * 4, T * (P * cov + P * n * trial) + final


def ll_bwd_work(P, n, j, d, T):
    """(bytes, operations) of K4 for P sets x n trials over T steps: F, the
    data, the cotangent and K3's per-set stores read once, F-bar and Q-bar
    (per set) and the data cotangent written once; the recomputed
    covariance pieces and the Sigma-bar chain counted once per set, the
    mean's cotangent and each trial's share of the four sums per trial."""
    sums = j * j + j * d + 2 * d * d + 1  # products, then as many adds
    cov = (INV_OPS[d] + mm(j, j, j) + mm(j, d, d)  # S^-1, FS, J
           + 2 * j * j + 3 * mm(j, j, j) + j * j + j * d  # Sbn, Sbn F, Sbn FS
           + mm(j, j, d) + mm(j, d, d) + 2 * j * d  # P-bar
           + mm(j, j, j) + j * j + mm(j, j, j)  # FS-bar Sigma, F^T FS-bar
           + mm(d, j, d) + 2 * d * d + 2 * mm(d, d, d) + 3 * d * d
           + 3 * d * d)
    trial = (d + mm(d, d, 1) + 1 + 2 * sums + mm(d, j, 1) + 2 * d
             + mm(j, j, 1) + d)
    seed = (P * (INV_OPS[d] + 2 * d * d)
            + P * n * (d + mm(d, d, 1) + 2 * d * d + 3 * d))
    nbytes = (P * T * j * j + P * n * (T + 1) * d + P * n
              + P * (T + 1) * (j * j + j * n)
              + 2 * P * T * j * j + P * n * (T + 1) * d)
    return nbytes * 4, T * (P * cov + P * n * trial) + seed


def _blocked_common(n, j, d):
    """Operations of what K5 and K6 share in a step: the score of n trials,
    Kc, the rank-d conditioning of Sig and MU, and F Sc."""
    score = INV_OPS[d] + 1 + n * (d + mm(d, d, 1) + 2 * d - 1 + 14)
    return (score + mm(j, d, d) + j * j * (2 * d + 1) + 2 * j * n * d
            + mm(j, j, j))


def ll_blocked_work(P, n, j, d, T):
    """(bytes, operations) of K5 (store-free) for P sets x n trials over T
    steps at the true j: F, Q and the data read once, ll written once."""
    step = _blocked_common(n, j, d) + mm(j, j, j) + j * j + mm(j, j, n)
    final = INV_OPS[d] + 1 + n * (d + mm(d, d, 1) + 2 * d + 6)
    nbytes = 2 * P * T * j * j + P * n * (T + 1) * d + P * n
    return nbytes * 4, P * (T * step + final)


def ll_blocked_bwd_work(P, n, j, d, T):
    """(bytes, operations) of K6: F, the data, the cotangent and K5's stores
    read once, F-bar, Q-bar and the data cotangent written once."""
    step = (_blocked_common(n, j, d) + mm(j, d, d) + j * j
            + mm(j, j, j) + j * j + mm(j, n, j) + j * j  # Fbar
            + 2 * mm(j, j, j) + mm(j, j, n)  # Scrb, MUc_bar
            + mm(j, j, d) + mm(j, n, d) + j * d  # Kcbar
            + mm(d, j, n) + 2 * d * n + mm(d, j, j)  # Ebar, row correction
            + mm(d, j, d) + d * d * 3 * n + 2 * mm(d, d, d) + 5 * d * d
            + j * d * 2 * d + 2 * d * j + d * n)
    seed = INV_OPS[d] + n * (d + mm(d, d, 1) + 2 * d) + d * d * (2 * n + 2)
    inputs = (P * T * j * j + P * n * (T + 1) * d + P * n
              + P * (T + 1) * (j * j + j * n))
    outputs = 2 * P * T * j * j + P * n * (T + 1) * d
    return (inputs + outputs) * 4, P * (T * step + seed)


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


def row_scale(b):
    """The largest |b| of each row of a store ``(P, T+1, j, .)``: one
    state's entries over every set, step and column."""
    return b.abs().amax(dim=(0, 1, 3), keepdim=True)


def without_sync(fn):
    """Calls ``fn`` with ``torch.cuda.set_sync_debug_mode("error")``: a copy
    from host memory or a host synchronization inside it raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def host_ms(fn, calls):
    """Median host-clock time (ms) of ``calls`` calls of ``fn``, each ended
    by a synchronization."""
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# K1's two designs: the instances and the batches of the
# crossover sweep (the table in ops/kernels/gains.py:THREAD_FROM), and the
# shapes at which both designs are timed beside their bounds: (2, 1, 2) at
# the forward path's B=1, the NUTS recovery's B=4 (4 chains, T=720), the
# potential's B=24, the zoo's B=2,048 and bench.py's B=16,384
K1_INSTANCES = ((2, 1, 2), (2, 1, 1), (3, 1, 2), (4, 1, 3), (5, 1, 2),
                (4, 2, 2))
K1_SWEEP_B, K1_SWEEP_T = (1, 4, 24, 132, 264, 528, 1056, 2048, 16384), 1000
K1_SHAPES = {(2, 1, 2): ((1, 1000), (4, 720), (24, 1008), (2048, 719),
                         (16384, 1000))}
K1_ZOO_SHAPES = ((24, 1008), (2048, 719))
# the instances added for the delay wrapper whose thread design does not
# spill (n <= 6; -Xptxas -v): their crossover is measured too
K1_SCOPE_SWEEP = ((4, 1, 2), (4, 1, 1), (6, 1, 2), (6, 1, 1))
K1_BITS_B, K1_BITS_T = (1, 4, 24, 33), (1, 37, 1008)
# the chain bound's latencies, estimated for Hopper: a dependent fp32 add,
# multiply or fused multiply-add, and __frcp_rn (MUFU.RCP, two Newton FMAs
# and the fix-up test)
FP_CYCLES, RCP_CYCLES = 4, 30


def k1_inputs(nmp, B, T_, dev):
    """The actor spec of B parameter sets of instance ``nmp``'s model, its
    parameters spread over the batch (bench.py's sweep at (2, 1, 2)), and
    K1's nine inputs from it, each ``(B, ., .)``."""
    from lqg_tpu_torch import models
    from lqg_tpu_torch.models.basic import tracking_spec
    from lqg_tpu_torch.ops.linalg import mT

    def spread(lo, hi, log_=False):
        v = np.logspace(lo, hi, B) if log_ else np.linspace(lo, hi, B)
        return torch.tensor(v, dtype=torch.float32, device=dev)

    if nmp in SCOPE_GAINS:
        return scope_gains_inputs(nmp, B, T_, dev)
    if nmp == (2, 1, 2):
        sp = tracking_spec(1, 1.0, spread(0.1, 1.0), spread(2.0, 40.0),
                           spread(0.5, 10.0), spread(-2.0, 1.0, True),
                           1.0 / 60.0, device=dev)
    elif nmp == (2, 1, 1):
        sp = models.RelativeObservationBoundedActor(
            T=T_, action_cost=spread(-2.0, 1.0, True),
            sigma=spread(2.0, 40.0), device=dev).actor
    elif nmp == (3, 1, 2):
        sp = models.SubjectiveActor(
            T=T_, action_cost=spread(-2.0, 1.0, True),
            subj_vel_noise=spread(0.3, 4.0), device=dev).actor
    elif nmp == (4, 1, 3):
        sp = models.PointMassBoundedActor(
            T=T_, action_cost=spread(-2.5, -0.5, True),
            action_variability=spread(5e-4, 5e-3),
            sigma_target=spread(2.0, 40.0), device=dev).actor
    elif nmp == (5, 1, 2):
        sp = models.HandMotionModelTrackingTask(
            T=T_, action_cost=spread(-1.0, 1.0, True),
            action_variability=spread(0.1, 1.0),
            sigma_target=spread(2.0, 40.0), device=dev).actor
    else:
        sp = models.RelativeObservationBoundedActor(
            dim=2, T=T_, action_cost=spread(-2.0, 1.0, True),
            action_variability=spread(0.1, 1.0), sigma=spread(2.0, 40.0),
            device=dev).actor
    VV = sp.V @ mT(sp.V)
    return sp, [x.expand((B,) + x.shape[-2:]).contiguous() for x in (
        sp.A, sp.B, sp.Q, sp.R, sp.Qf, sp.F, VV, sp.W @ mT(sp.W), VV)]


def k1_chain_cycles(n, m, p):
    """The critical path of one K1 step in cycles, (Riccati, Kalman): the
    depth of the step's operation graph from the carry to the next carry,
    in K1's order (csrc/rn_algebra.cuh), each dependent operation
    ``FP_CYCLES`` and a reciprocal ``RCP_CYCLES``; loads, exchanges and
    stores not counted.  A design can overlap the two recursions, not the
    steps of one."""
    fp = FP_CYCLES

    def dot_depth(a, b):  # acc = a0 b0, then acc = fma(a_t, b_t, acc)
        acc = max(a[0], b[0]) + fp
        for x, y in zip(a[1:], b[1:]):
            acc = max(x, y, acc) + fp
        return acc

    def mm(a, b):
        cols = list(zip(*b))
        return [[dot_depth(row, col) for col in cols] for row in a]

    def tr(a):
        return [list(r) for r in zip(*a)]

    def ew(a, b):  # an elementwise add or subtract
        return [[max(x, y) + fp for x, y in zip(ra, rb)]
                for ra, rb in zip(a, b)]

    def inv(a, k):  # sym_inv<k>: determinant, + eps, reciprocal, product
        det = max(max(r) for r in a) + fp * {1: 0, 2: 2, 3: 5}[k]
        out = det + fp + RCP_CYCLES + fp
        return [[out] * k for _ in range(k)]

    z = lambda r, c: [[0] * c for _ in range(r)]
    A, Bm, Q, R, F, VV, WW = (z(n, n), z(n, m), z(n, n), z(m, m), z(p, n),
                              z(n, n), z(p, p))
    S = z(n, n)
    SB, SA = mm(S, Bm), mm(S, A)
    H = ew(R, mm(tr(Bm), SB))
    G = mm(tr(Bm), SA)
    L = mm(inv(H, m), G)
    HL = mm(H, L)
    X = ew(ew(Q, mm(tr(A), SA)), ew(mm(tr(L), HL),
                                     ew(mm(tr(L), G), mm(tr(G), L))))
    if m > 1:
        X = [[x + 2 * fp for x in r] for r in X]
    Pc = z(n, n)
    Pp = ew(mm(A, mm(Pc, tr(A))), VV)
    PFt = mm(Pp, tr(F))
    K = mm(PFt, inv(ew(mm(F, PFt), WW), p))
    Pn = ew(Pp, mm(K, tr(PFt)))
    return max(map(max, X)), max(map(max, Pn))


def sm_clock_mhz():
    """The card's maximum SM clock (MHz), from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def k1_bounds(nmp, B, T_, stores, mhz):
    """K1's byte-or-operation bound (ms, by) at B particles and T_ steps,
    the stores' bytes counted where taken, and its chain bound (ms): the
    longer recursion's critical path x T_ at the SM clock."""
    n, m, p = nmp
    nbytes, ops = gains_work(B, n, m, p, T_)
    if stores:
        nbytes += 2 * T_ * B * n * n * 4
    chain = max(k1_chain_cycles(n, m, p)) * T_ / (mhz * 1e3)
    return (*bound((nbytes, ops)), chain)


def k1_designs_bits(dev, card, instances):
    """K1's block design against its thread design, bit for bit, at each of
    ``instances``, B in K1_BITS_B and T in K1_BITS_T, store-free and with
    the stores; and K2 fed the block design's stores against K2 fed the
    thread design's, at B=24, T=1008.  Raises on any difference; returns
    the number of cases."""
    from lqg_tpu_torch.ops.kernels.gains import fused_gains_vjp, gains_fwd

    g = torch.Generator(device=dev).manual_seed(10)
    checked = 0
    for nmp in instances:
        for B in K1_BITS_B:
            for T_ in K1_BITS_T:
                ins = k1_inputs(nmp, B, T_, dev)[1]
                for stores in (False, True):
                    th = gains_fwd(*ins, T_, stores=stores, design="thread")
                    bl = gains_fwd(*ins, T_, stores=stores, design="block")
                    torch.cuda.synchronize()
                    require(all(bool(torch.isfinite(a).all()) for a in th),
                            f"K1 {nmp} B={B} T={T_}: not finite")
                    diff = [i for i, (a, b) in enumerate(zip(th, bl))
                            if not torch.equal(a, b)]
                    errs = [float((th[i] - bl[i]).abs().max()) for i in diff]
                    require(not diff, f"K1 {nmp} B={B} T={T_} stores="
                            f"{stores}: block vs thread differ in outputs "
                            f"{diff}, max abs {errs}")
                    checked += 1
        ins = k1_inputs(nmp, CHAINS * CONDITIONS, T_FIT, dev)[1]
        th = gains_fwd(*ins, T_FIT, stores=True, design="thread")
        bl = gains_fwd(*ins, T_FIT, stores=True, design="block")
        cots = [0.3 * torch.randn(x.shape, generator=g, device=dev)
                for x in th[:3]]
        A_, Bm_, _, R_, _, F_, VV_, WW_, _ = ins
        k2_th = fused_gains_vjp(A_, Bm_, R_, F_, VV_, WW_, *th[3:], *cots)
        k2_bl = fused_gains_vjp(A_, Bm_, R_, F_, VV_, WW_, *bl[3:], *cots)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(k2_th, k2_bl)),
                f"K2 {nmp}: fed the block design's stores, not the thread "
                f"design's bits")
    log(f"[{card}] K1 block design vs thread design: the same bits in "
        f"{checked} cases (instances {list(instances)}, B in "
        f"{list(K1_BITS_B)}, T in {list(K1_BITS_T)}, store-free and with the "
        f"stores); K2 fed either design's stores the same bits at B="
        f"{CHAINS * CONDITIONS}, T={T_FIT}, every instance")
    return checked


def k1_crossover(dev, card, layouts=None, instances=K1_INSTANCES):
    """Both K1 designs timed in turns (paired_ms) at each of ``instances``
    and B in K1_SWEEP_B, T=K1_SWEEP_T, store-free and with the stores,
    beside ``design="auto"``'s pick.  ``layouts`` ({instance: launching
    function}) replaces the block design by another launch
    (scripts/k1_designs.py).  Returns {(instance, B, stores): (thread ms,
    block ms, auto's pick)}."""
    from lqg_tpu_torch.ops.kernels.gains import design_for, gains_fwd

    out = {}
    for nmp in instances:
        for B in K1_SWEEP_B:
            ins = k1_inputs(nmp, B, K1_SWEEP_T, dev)[1]
            block = (layouts or {}).get(nmp)
            for stores in (False, True):
                t_th, t_bl = paired_ms(
                    lambda: gains_fwd(*ins, K1_SWEEP_T, stores=stores,
                                      design="thread"),
                    (lambda: block(ins, K1_SWEEP_T, stores)) if block else
                    (lambda: gains_fwd(*ins, K1_SWEEP_T, stores=stores,
                                       design="block")))
                out[(nmp, B, stores)] = (t_th, t_bl,
                                         design_for(*nmp, B, stores))
        log(f"[{card}] K1 crossover {nmp} T={K1_SWEEP_T}, thread / block ms "
            f"(store-free; with the stores) and auto's pick: " + "; ".join(
                f"B={B} {out[(nmp, B, False)][0]:.4f} / "
                f"{out[(nmp, B, False)][1]:.4f} -> {out[(nmp, B, False)][2]}"
                f", {out[(nmp, B, True)][0]:.4f} / "
                f"{out[(nmp, B, True)][1]:.4f} -> {out[(nmp, B, True)][2]}"
                for B in K1_SWEEP_B))
    return out


def k1_times(dev, card, mhz):
    """Both K1 designs and both variants timed in turns through gains_fwd
    at K1_SHAPES / K1_ZOO_SHAPES, beside the byte bound and the chain
    bound.  Returns {shape: {...}}."""
    from lqg_tpu_torch.ops.kernels.gains import design_for, gains_fwd

    out = {}
    for nmp in K1_INSTANCES:
        for B, T_ in K1_SHAPES.get(nmp, K1_ZOO_SHAPES):
            ins = k1_inputs(nmp, B, T_, dev)[1]
            row = {"auto": [design_for(*nmp, B, st) for st in (False, True)]}
            for stores in (False, True):
                t_th, t_bl = paired_ms(
                    lambda: gains_fwd(*ins, T_, stores=stores,
                                      design="thread"),
                    lambda: gains_fwd(*ins, T_, stores=stores,
                                      design="block"))
                b_ms, b_by, chain = k1_bounds(nmp, B, T_, stores, mhz)
                key = "stores" if stores else "free"
                row[key] = {"thread_ms": t_th, "block_ms": t_bl,
                            "bound_ms": b_ms, "bound_by": b_by,
                            "chain_ms": chain}
            shape = f"{nmp} B={B} T={T_}"
            out[shape] = row
            log(f"[{card}] K1 {shape}: store-free thread "
                f"{row['free']['thread_ms']:.4f} / block "
                f"{row['free']['block_ms']:.4f} ms, with the stores "
                f"{row['stores']['thread_ms']:.4f} / "
                f"{row['stores']['block_ms']:.4f} ms; bound "
                f"{row['free']['bound_ms']:.6f} / "
                f"{row['stores']['bound_ms']:.6f}"
                f" ms ({row['free']['bound_by']}), chain bound "
                f"{row['free']['chain_ms']:.4f} ms "
                f"({max(k1_chain_cycles(*nmp))} cycles a step at {mhz:.0f} "
                f"MHz); auto (store-free, stores): {row['auto']}")
    return out


def zoo_paths(dev, card, names, all_counters, all_names):
    """Phase 15: PointMassBoundedActor, HandMotionModelTrackingTask and
    SignalDependentNoiseActor through the entry points at full width.
    Returns the launches of each path."""
    from lqg_tpu_torch import models
    from lqg_tpu_torch.ops.kernels import joint as kj
    from lqg_tpu_torch.infer import shared_params_lqg_model
    from lqg_tpu_torch.infer.capture import (GraphedValueAndGrad,
                                             eager_value_and_grad)
    from lqg_tpu_torch.infer.dists import LogNormal
    from lqg_tpu_torch.infer.priors import DEFAULT_PRIOR

    # the card's own linear algebra waits on the host: why the port has its
    # own expm and eigenvalue clip
    M = torch.randn((24, 3, 3), device=dev) / 3.0
    for what, fn in (("torch.linalg.matrix_exp",
                      lambda: torch.linalg.matrix_exp(M)),
                     ("torch.linalg.eigh", lambda: torch.linalg.eigh(M @ M.mT))):
        fn()
        try:
            without_sync(fn)
            log(f"{what} at (24, 3, 3): no synchronization")
        except RuntimeError:
            log(f"{what} at (24, 3, 3): synchronizes the host "
                f"(set_sync_debug_mode('error') raised)")

    g = torch.Generator(device=dev).manual_seed(15)
    launches = {}
    for name, (cls_name, extra, per_cond, shared) in ZOO_PATHS.items():
        cls = getattr(models, cls_name)
        dim = extra.get("dim", 1)
        d = 2 * dim  # target and cursor positions
        k1 = name != "SignalDependentNoiseActor"  # control noise: the scans
        # the forward path
        for fn in all_counters:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = cls(T=T, device=dev, **extra)
        x = model.simulate(torch.Generator(device=dev).manual_seed(16),
                           n=LL_TRIALS)[..., :d]
        ll = model.log_likelihood(x, method="auto")
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        fwd = {k: fn.launches for k, fn in zip(all_names, all_counters)}
        # the joint system by its kernels where an instance holds the dims
        jn = int(kj.joint_fq_available(
            kj.spec_dims(model.dynamics, model.actor), torch.float32))
        log(f"zoo forward path, {name}: simulate(n={LL_TRIALS}) + "
            f"log_likelihood at T={T} in {fwd_s:.3f} s (first call, host "
            f"clock); launches {fwd}")
        require(fwd["ll_fwd"] > 0 and (fwd["gains_fwd"] > 0) == k1
                and not fwd["ll_blocked_fwd"] and fwd["joint_fwd"] == jn
                and not fwd["joint_bwd"],
                f"zoo forward path, {name}: launches {fwd}")
        require(x.shape == (LL_TRIALS, T + 1, d) and ll.shape == (LL_TRIALS,)
                and bool(torch.isfinite(x).all() and torch.isfinite(ll).all()),
                f"zoo forward path, {name}: shapes or values")
        ll64 = cls(T=T, device=dev, dtype=torch.float64,
                   **extra).log_likelihood(
            x.double(), method="scan")
        err = float((ll.double() - ll64).abs().max())
        rel = float(((ll.double() - ll64) / ll64).abs().max())
        log(f"zoo forward path, {name}, vs float64 scan on the card: max abs "
            f"err {err:.3e}, max rel err {rel:.3e} of |ll| ~ "
            f"{float(ll64.abs().mean()):.1f} (rtol {LL_RTOL}, atol {LL_ATOL})")
        require(within(ll.double(), ll64, LL_RTOL, LL_ATOL),
                f"zoo forward path, {name}, vs float64: {err}")

        def forward():
            model.log_likelihood(model.simulate(g, n=LL_TRIALS)[..., :d])

        warm = host_ms(forward, 1)
        wall, busy, n_events, named = profile_ms(forward, names)
        log(f"[{card}] zoo forward path, {name}: warm host wall {warm:.1f} ms "
            f"(one call); under torch.profiler wall {wall:.1f} ms, device "
            f"busy {busy:.3f} ms ({100 * busy / wall:.2f}%) over {n_events} "
            f"events; " + ", ".join(f"{k} {v:.3f} ms"
                                    for k, v in named.items()))

        # the gradient path: 6 conditions x 20 trials at T=1008, 4 chains
        x_fit = torch.stack([
            cls(T=T_FIT, device=dev, **extra,
                **{per_cond: 3.0 + 5.0 * c}).simulate(
                g, n=LL_TRIALS)[..., :d] for c in range(CONDITIONS)])
        defaults = inspect.signature(cls.__init__).parameters

        def priors():
            out = dict(DEFAULT_PRIOR)
            for p_ in set(shared) & set(ZOO_MECHANICAL):
                out[p_] = LogNormal(math.log(defaults[p_].default), 0.5)
            return out

        pm = shared_params_lqg_model(x_fit, cls, shared_params=shared,
                                     priors=priors(), dim=dim)
        u0 = pm.init_unconstrained()
        u = u0 + 0.1 * torch.randn((CHAINS,) + u0.shape, generator=g,
                                   device=dev)
        eager = eager_value_and_grad(pm.potential)
        for fn in all_counters:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pot, grad = eager(u)
        torch.cuda.synchronize()
        grad_s = time.perf_counter() - t0
        bwd = {k: fn.launches for k, fn in zip(all_names, all_counters)}
        launches[name] = {"forward": fwd, "gradient": bwd}
        log(f"zoo gradient path, {name}: {CHAINS} chains x {CONDITIONS} "
            f"conditions x {LL_TRIALS} trials at T={T_FIT}, D={u.shape[-1]}: "
            f"value+grad in {grad_s:.3f} s (first call, host clock); "
            f"launches {bwd}")
        want = {"gains_fwd": int(k1), "gains_bwd": int(k1), "ll_fwd": 1,
                "ll_bwd": 1, "ll_blocked_fwd": 0, "ll_blocked_bwd": 0,
                "joint_fwd": jn, "joint_bwd": jn}
        require(bwd == want, f"zoo gradient path, {name}: launches {bwd}, "
                             f"expected {want}")
        require(pot.shape == (CHAINS,) and grad.shape == u.shape
                and bool(torch.isfinite(pot).all()
                         and torch.isfinite(grad).all()),
                f"zoo gradient path, {name}: shapes or values")
        pm64 = shared_params_lqg_model(x_fit.double(), cls,
                                       shared_params=shared,
                                       priors=priors(), dim=dim)
        pot64, grad64 = eager_value_and_grad(pm64.potential)(u.double())
        del pm64
        pot_err = float(((pot.double() - pot64) / pot64).abs().max())
        grad_rel = (grad.double() - grad64).abs() / grad64.abs()
        log(f"zoo gradient path, {name}, vs float64 scan on the card: value "
            f"rel err {pot_err:.3e} (rtol {POT_RTOL}) of |U| ~ "
            f"{float(pot64.abs().mean()):.1f}; gradient rel err max "
            f"{float(grad_rel.max()):.3e}, median "
            f"{float(grad_rel.median()):.3e} (rtol {POT_GRAD_RTOL}); |grad| "
            f"from {float(grad64.abs().min()):.4g} to "
            f"{float(grad64.abs().max()):.4g}")
        require(within(pot.double(), pot64, POT_RTOL, 0.0),
                f"zoo gradient path, {name}, value vs float64: {pot_err}")
        require(within(grad.double(), grad64, POT_GRAD_RTOL, 0.0),
                f"zoo gradient path, {name}, gradient vs float64: "
                f"{float(grad_rel.max())}")
        without_sync(lambda: eager(u))
        warm = host_ms(lambda: eager(u), 1)
        wall, busy, n_events, named = profile_ms(lambda: eager(u), names)
        log(f"[{card}] zoo gradient path, {name}: warm host wall {warm:.1f} "
            f"ms (one call); under torch.profiler wall {wall:.1f} ms, "
            f"device busy {busy:.3f} ms ({100 * busy / wall:.2f}%) over "
            f"{n_events} events; " + ", ".join(f"{k} {v:.3f} ms"
                                               for k, v in named.items())
            + "; one eager value+grad under set_sync_debug_mode('error'): no "
            "copy from host memory, no host synchronization")

        if name == "PointMassBoundedActor":
            # the potential, expm and eigenvalue clip included, replayed
            # from a CUDA graph
            t0 = time.perf_counter()
            graphed = GraphedValueAndGrad(pm.potential, u)
            built_s = time.perf_counter() - t0
            errs = []
            for k in range(3):
                uk = u + 0.05 * k * torch.randn(u.shape, generator=g,
                                                device=dev)
                (pe_g, grad_g), (pe_e, grad_e) = graphed(uk), eager(uk)
                torch.cuda.synchronize()
                require(bool(torch.isfinite(pe_g).all()
                             and torch.isfinite(grad_g).all())
                        and within(pe_g, pe_e, POT_RTOL, 0.0)
                        and within(grad_g, grad_e, POT_GRAD_RTOL,
                                   1e-6 * float(grad_e.abs().max())),
                        f"zoo graph replay vs eager, {name}, point {k}")
                errs.append((float(((pe_g - pe_e) / pe_e).abs().max()),
                             float(((grad_g - grad_e).abs()
                                    / grad_e.abs()).max())))
            replay = cuda_ms(lambda: graphed(u))
            log(f"[{card}] zoo graph, {name}: capture {graphed.capture_s:.3f} "
                f"s, instantiate {graphed.instantiate_s:.3f} s (with the "
                f"warm-up {built_s:.3f} s); replay {replay:.4f} ms (CUDA "
                f"events) against {warm:.1f} ms eager; replay vs eager at 3 "
                f"points: value rel err max {max(e[0] for e in errs):.3e}, "
                f"gradient {max(e[1] for e in errs):.3e}")
            del graphed
        del pm, eager, pot, grad, pot64, grad64
        torch.cuda.empty_cache()
    return launches


def zoo_instances(dev, card):
    """Phase 16: K1 (with stores) and K2 at (4, 1, 3), (5, 1, 2), (4, 2, 2);
    K3 (both variants) and K4 at (8, 2), (8, 4), (10, 2), (10, 4), each
    against its plain version, two K2 and two K4 launches the same bits, and
    each instance's time and bound.  Returns {kernel: {shape: (ms, bound
    ms, bound_by, max abs err, plain ms)}}."""
    from lqg_tpu_torch import models
    from lqg_tpu_torch.ops.kernels.gains import (
        fused_gains_reference, fused_gains_vjp, fused_gains_vjp_reference,
        gains_fwd)
    from lqg_tpu_torch.ops.kernels.likelihood import (
        conditioned_log_likelihood_reference, conditioned_log_likelihood_vjp,
        conditioned_log_likelihood_vjp_reference, ll_fwd)
    from lqg_tpu_torch.ops.linalg import mT

    g = torch.Generator(device=dev).manual_seed(17)
    out = {k: {} for k in ("gains_fwd", "gains_bwd", "ll_fwd", "ll_bwd")}

    for n, m, p in K1_INSTANCES[3:]:
        for B, T_ in ((CHAINS * CONDITIONS, T_FIT), (2048, 719)):
            sp, ins = k1_inputs((n, m, p), B, T_, dev)
            res = gains_fwd(*ins, T_, stores=True, design="thread")
            ref = fused_gains_reference(sp, ins[-1], T_, stores=True)
            torch.cuda.synchronize()
            e1 = max(float((a - b).abs().max()) for a, b in zip(res[:3],
                                                                ref[:3]))
            st_err = max(float((a - b).abs().max())
                         for a, b in zip(res[3:], ref[3:]))
            require(all(bool(torch.isfinite(a).all()) for a in res)
                    and all(within(a, b, 0.0, ZOO_GAINS_ATOL)
                            for a, b in zip(res[:3], ref[:3]))
                    and all(within(a, b, K2_RTOL, K2_ATOL)
                            for a, b in zip(res[3:], ref[3:])),
                    f"K1 ({n}, {m}, {p}) B={B} vs plain: {e1}, stores "
                    f"{st_err}")
            cots = [0.3 * torch.randn(x.shape, generator=g, device=dev)
                    for x in res[:3]]
            A_, Bm_, _, R_, _, F_, VV_, WW_, _ = ins
            args = (A_, Bm_, R_, F_, VV_, WW_, *res[3:], *cots)
            got = fused_gains_vjp(*args)
            again = fused_gains_vjp(*args)
            want = fused_gains_vjp_reference(*args)
            torch.cuda.synchronize()
            require(all(torch.equal(a, b) for a, b in zip(got, again)),
                    f"K2 ({n}, {m}, {p}) B={B}: two launches differ")
            e2 = max(float((a - b).abs().max()) for a, b in zip(got, want))
            scaled = max(float((a - b).abs().max() / b.abs().max())
                         for a, b in zip(got, want))
            require(all(bool(torch.isfinite(a).all()) for a in got)
                    and all(within(a, b, K2_RTOL,
                                   K2_ATOL + K2_SCALE * float(b.abs().max()))
                            for a, b in zip(got, want)),
                    f"K2 ({n}, {m}, {p}) B={B} vs plain: {e2}")
            shape = f"({n}, {m}, {p}) B={B} T={T_}"
            k1_ms = cuda_ms(lambda: gains_fwd(*ins, T_, design="thread"))
            k2_ms = cuda_ms(lambda: fused_gains_vjp(*args))
            plain = ((cuda_ms(lambda: fused_gains_reference(sp, ins[-1], T_),
                              runs=1, launches=1),
                      cuda_ms(lambda: fused_gains_vjp_reference(*args),
                              runs=1, launches=1))
                     if B == CHAINS * CONDITIONS else (None, None))
            b1 = bound(gains_work(B, n, m, p, T_))
            b2 = bound(gains_bwd_work(B, n, m, p, T_))
            out["gains_fwd"][shape] = (k1_ms, *b1, e1, plain[0])
            out["gains_bwd"][shape] = (k2_ms, *b2, e2, plain[1])
            log(f"[{card}] K1 (thread design) {shape}: {k1_ms:.4f} ms (bound "
                f"{b1[0]:.6f}, "
                f"{b1[1]}), max abs err vs plain {e1:.3e} (atol "
                f"{ZOO_GAINS_ATOL}), stores {st_err:.3e}; K2 {k2_ms:.4f} ms "
                f"(bound {b2[0]:.6f}, {b2[1]}), two launches the same bits, "
                f"max abs err {e2:.3e}, max err / max|plain| {scaled:.3e}; "
                f"plain K1 / K2 "
                + ("not timed" if plain[0] is None else
                   f"{plain[0]:.2f} / {plain[1]:.2f} ms"))
            del res, ref, got, again, want, args, ins, sp
        torch.cuda.empty_cache()

    ll_models = {
        (8, 2): models.PointMassBoundedActor,
        (8, 4): lambda **kw: models.BoundedActor(dim=2, **kw),
        (10, 2): models.HandMotionModelTrackingTask,
        (10, 4): lambda **kw: models.SubjectiveActor(dim=2, **kw),
    }
    P_ = CHAINS * CONDITIONS
    for (j, d), make in ll_models.items():
        x = torch.stack([make(T=T_FIT, sigma_target=3.0 + 5.0 * c,
                              device=dev).simulate(g, n=LL_TRIALS)[..., :d]
                         for c in range(CONDITIONS)])
        sets = make(T=T_FIT, device=dev, sigma_target=torch.tensor(
            [3.0 + 5.0 * c for c in range(CONDITIONS)] * CHAINS, device=dev),
            action_cost=torch.tensor([0.25 * (1 + k) for k in range(CHAINS)
                                      for _ in range(CONDITIONS)],
                                     device=dev))
        joint = sets._joint()
        F_, Q_ = (torch.movedim(M_, 0, 1).contiguous()
                  for M_ in (joint.F, joint.G @ mT(joint.G)))
        require(F_.shape[-1] == j, f"(j, d) = ({j}, {d}): joint dim "
                                   f"{F_.shape[-1]}")
        X = x.repeat(CHAINS, 1, 1, 1)
        free = ll_fwd(F_, Q_, X)
        ll, *st = ll_fwd(F_, Q_, X, stores=True)
        ref, *st_ref = conditioned_log_likelihood_reference(F_, Q_, X,
                                                            stores=True)
        torch.cuda.synchronize()
        e3 = float((ll - ref).abs().max())
        # each store's worst row (max err / max |plain| of that row) and
        # its largest error as a share of the error allowed there
        st_err = [float(((a - b).abs().amax(dim=(0, 1, 3), keepdim=True)
                         / row_scale(b)).max()) for a, b in zip(st, st_ref)]
        st_share = [float(((a - b).abs() / (
            LL_ATOL + LL_RTOL * b.abs() + K3_STORE_SCALE * row_scale(b)))
            .max()) for a, b in zip(st, st_ref)]
        require(bool(torch.isfinite(ll).all()) and torch.equal(free, ll)
                and within(ll, ref, LL_RTOL, LL_ATOL)
                and max(st_share) <= 1.0,
                f"K3 ({j}, {d}) vs plain: {e3}, stores' worst rows "
                f"{st_err}, shares of the allowed error {st_share}")
        w = torch.randn(ll.shape, generator=g, device=dev)
        args = (F_, X, w, *st)
        got = conditioned_log_likelihood_vjp(*args)
        again = conditioned_log_likelihood_vjp(*args)
        want = conditioned_log_likelihood_vjp_reference(*args)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"K4 ({j}, {d}): two launches differ")
        e4 = max(float((a - b).abs().max()) for a, b in zip(got, want))
        require(all(bool(torch.isfinite(a).all()) for a in got)
                and all(within(a, b, K4_RTOL,
                               atol + K2_SCALE * float(b.abs().max()))
                        for a, b, atol in zip(got, want, (K4_FQ_ATOL,
                                                          K4_FQ_ATOL,
                                                          K4_X_ATOL))),
                f"K4 ({j}, {d}) vs plain: {e4}")
        shape = f"({j}, {d}) P={P_} n={LL_TRIALS} T={T_FIT}"
        k3_ms = cuda_ms(lambda: ll_fwd(F_, Q_, X))
        k3_st_ms = cuda_ms(lambda: ll_fwd(F_, Q_, X, stores=True))
        k4_ms = cuda_ms(lambda: conditioned_log_likelihood_vjp(*args))
        k3_plain = cuda_ms(
            lambda: conditioned_log_likelihood_reference(F_, Q_, X), runs=1,
            launches=1)
        k4_plain = cuda_ms(
            lambda: conditioned_log_likelihood_vjp_reference(*args), runs=1,
            launches=1)
        b3 = bound(ll_work(P_, LL_TRIALS, j, d, T_FIT))
        b3s = bound(ll_work(P_, LL_TRIALS, j, d, T_FIT, stores=True))
        b4 = bound(ll_bwd_work(P_, LL_TRIALS, j, d, T_FIT))
        out["ll_fwd"][shape] = (k3_ms, *b3, e3, k3_plain)
        out["ll_fwd"][shape + " stores"] = (k3_st_ms, *b3s, e3, None)
        out["ll_bwd"][shape] = (k4_ms, *b4, e4, k4_plain)
        log(f"[{card}] K3 {shape}: {k3_ms:.4f} ms (bound {b3[0]:.5f}, "
            f"{b3[1]}), with the stores {k3_st_ms:.4f} ms (bound "
            f"{b3s[0]:.5f}), max abs err vs plain {e3:.3e}, max rel err "
            f"{float(((ll - ref) / ref).abs().max()):.3e} of |ll| ~ "
            f"{float(ref.abs().mean()):.1f} (rtol {LL_RTOL}, atol "
            f"{LL_ATOL}), covariance / mean stores' worst row max err / max "
            f"|plain| {st_err[0]:.3e} / {st_err[1]:.3e}, largest share of "
            f"the allowed error {st_share[0]:.3f} / {st_share[1]:.3f} "
            f"(within {LL_RTOL}, {LL_ATOL} + {K3_STORE_SCALE} x the row's "
            f"max |plain|); K4 "
            f"{k4_ms:.4f} ms (bound {b4[0]:.5f}, {b4[1]}), "
            f"two launches the same bits, max abs err {e4:.3e}; plain K3 / K4 "
            f"{k3_plain:.2f} / {k4_plain:.2f} ms")
        del x, sets, joint, F_, Q_, X, st, st_ref, got, again, want, args
        torch.cuda.empty_cache()
    return out


def delayed(base_name, delay):
    """``TemporalDelayModel(base(**kw), delay)`` as a model class with the
    base model's constructor signature, which ``shared_params_lqg_model``
    reads for the free parameters."""
    from lqg_tpu_torch import models

    base = getattr(models, base_name)

    class Delayed(models.TemporalDelayModel):
        def __init__(self, *args, **kw):
            super().__init__(base(*args, **kw), delay=delay)

    Delayed.__init__.__signature__ = inspect.signature(base.__init__)
    Delayed.__name__ = f"Delayed{delay}{base_name}"
    return Delayed


def stable_spec(nmp, B, dev, seed):
    """B random stationary specs at ``nmp`` whose open loop is stable (A =
    0.9 I + noise; tests/test_pallas.py's ``_random_spec`` otherwise),
    float32 on ``dev``."""
    from lqg_tpu_torch.utils import stationary_spec

    n, m, p = nmp
    rng = np.random.default_rng(seed)
    rnd = lambda *sh: 0.3 * rng.normal(size=sh)
    sym = lambda M: 0.5 * (M + np.swapaxes(M, -1, -2))
    f = dict(A=0.9 * np.eye(n) + 0.1 * rnd(B, n, n), B=rnd(B, n, m) + 0.5,
             Q=sym(np.eye(n) + 0.05 * rnd(B, n, n)),
             R=sym(0.8 * np.eye(m) + 0.01 * np.abs(rnd(B, m, m))),
             F=rnd(B, p, n) + np.eye(p, n),
             V=0.7 * np.eye(n) + 0.05 * rnd(B, n, n),
             W=0.9 * np.eye(p) + 0.05 * rnd(B, p, p))
    t = {k: torch.tensor(v, dtype=torch.float32, device=dev)
         for k, v in f.items()}
    Qf = torch.tensor(sym(1.5 * np.eye(n) + 0.05 * rnd(B, n, n)),
                      dtype=torch.float32, device=dev)
    return stationary_spec(**t)._replace(Qf=Qf)


def scope_gains_inputs(nmp, B, T_, dev):
    """The actor spec of B parameter sets at ``nmp`` (the delay wrapper's
    model, its action cost and target noise spread over the batch, or a
    stable random spec) and K1's nine inputs from it, each ``(B, ., .)``."""
    from lqg_tpu_torch.ops.linalg import mT

    model = SCOPE_GAINS[nmp]
    if model is None:
        sp = stable_spec(nmp, B, dev, seed=sum(nmp))
    else:
        base, delay = model
        noise = "sigma" if base.startswith("Relative") else "sigma_target"
        sp = delayed(base, delay)(T=T_, device=dev, **{
            "action_cost": torch.logspace(-1.0, 0.5, B, device=dev),
            noise: torch.linspace(2.0, 40.0, B, device=dev)}).actor
    VV = sp.V @ mT(sp.V)
    return sp, [x.expand((B,) + x.shape[-2:]).contiguous() for x in (
        sp.A, sp.B, sp.Q, sp.R, sp.Qf, sp.F, VV, sp.W @ mT(sp.W), VV)]


def scope_ll_inputs(jd, dev, g):
    """F, Q ``(P, T, j, j)`` and X ``(P, n, T+1, d)`` at ``jd`` for P = 4
    chains x 6 conditions, 20 trials, T=1008: the model's joint systems
    (its action cost per chain, its noise per condition) and trajectories it
    simulates (with its default parameters, the same trials for every
    set), or a stable random joint system (orthogonal transitions x 0.97)
    with random-walk data."""
    from lqg_tpu_torch import models
    from lqg_tpu_torch.ops.linalg import mT

    j, d = jd
    P_ = CHAINS * CONDITIONS
    if SCOPE_LL[jd] is None:
        rng = np.random.default_rng(j + 10 * d)
        A = np.stack([np.linalg.qr(rng.normal(size=(j, j)))[0] * 0.97
                      for _ in range(P_)])
        G = 0.3 * rng.normal(size=(P_, j, j)) + 0.5 * np.eye(j)
        X = 0.3 * np.cumsum(rng.normal(size=(P_, LL_TRIALS, T_FIT + 1, d)),
                            axis=2)
        as_t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
        F_ = as_t(A)[:, None].expand(P_, T_FIT, j, j).contiguous()
        G_ = as_t(G)
        Q_ = (G_ @ mT(G_))[:, None].expand(P_, T_FIT, j, j).contiguous()
        return F_, Q_, as_t(X)
    kind, base, k = SCOPE_LL[jd]
    noise = "sigma" if base.startswith("Relative") else "sigma_target"
    make = (delayed(base, k) if kind == "delay"
            else lambda **kw: getattr(models, base)(dim=k, **kw))
    # one simulation for every set: the sets differ in their parameters
    x = make(T=T_FIT, device=dev).simulate(g, n=LL_TRIALS)[..., :d]
    sets = make(T=T_FIT, device=dev, **{
        noise: torch.tensor([3.0 + 5.0 * c for c in range(CONDITIONS)]
                            * CHAINS, device=dev),
        "action_cost": torch.tensor([0.25 * (1 + c) for c in range(CHAINS)
                                     for _ in range(CONDITIONS)],
                                    device=dev)})
    joint = sets._joint()
    F_, Q_ = (torch.movedim(M_, 0, 1).contiguous()
              for M_ in (joint.F, joint.G @ mT(joint.G)))
    require(F_.shape[-1] == j, f"(j, d) = {jd}: joint dim {F_.shape[-1]}")
    return F_, Q_, x.expand((P_,) + x.shape).contiguous()


def ptxas_table(reports):
    """{kernel<template arguments>: (registers, spill stores B, spill loads
    B)} of the ``-Xptxas -v`` reports."""
    out = {}
    for report in reports.values():
        for row in ptxas_summary(report):
            hit = re.match(r"(.*): (\d+) registers, stack \d+ B, spill stores "
                           r"(\d+) B, loads (\d+) B", row)
            if hit:
                out[hit.group(1)] = tuple(int(v) for v in hit.groups()[1:])
    return out


def one_ms(fn):
    """(result, ms) of one call of ``fn``, from CUDA events: for the plain
    versions, whose one call is the comparison and the time at once."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def scope_instances(dev, card, reports):
    """Phase 20, the kernels: K1 (both designs, with the stores) and K2 at
    every gains instance of the delay wrapper and the envelopes
    (SCOPE_GAINS) and at two padded shapes, 24 specs at T=1008; K3 (both
    variants) and K4 at the instances at j = 12 (SCOPE_LL) and two padded
    shapes, 24 sets x 20 trials at T=1008; each against its plain version
    at the true shape (K2's in float64 on the same float32 stores and
    cotangents), K1's designs the same bits, two K2 and two K4 launches the
    same bits; each timed beside its bound at the true shape's work
    (padding shows as lost time), with its registers and spills.  Returns
    {kernel: {shape: row}}."""
    from lqg_tpu_torch.ops.kernels import gains as kg
    from lqg_tpu_torch.ops.kernels import likelihood as kl

    regs = ptxas_table(reports)
    g = torch.Generator(device=dev).manual_seed(20)
    out = {k: {} for k in ("gains_fwd_block", "gains_bwd", "ll_fwd",
                           "ll_bwd")}
    B, T_ = CHAINS * CONDITIONS, T_FIT
    for nmp in SCOPE_GAINS:
        t_shape = time.perf_counter()
        n, m, p = nmp
        N, _, _ = kg.instance_for(*nmp)
        sp, ins = scope_gains_inputs(nmp, B, T_, dev)
        th = kg.gains_fwd(*ins, T_, stores=True, design="thread")
        bl = kg.gains_fwd(*ins, T_, stores=True, design="block")
        ref, plain1 = one_ms(lambda: kg.fused_gains_reference(
            sp, ins[-1], T_, stores=True))
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(th, bl)),
                f"K1 {nmp}: block vs thread design differ")
        e1 = max(float((a - b).abs().max()) for a, b in zip(bl[:3], ref[:3]))
        st_err = max(float((a - b).abs().max())
                     for a, b in zip(bl[3:], ref[3:]))
        require(all(bool(torch.isfinite(a).all()) for a in bl)
                and all(within(a, b, 0.0, ZOO_GAINS_ATOL)
                        for a, b in zip(bl[:3], ref[:3]))
                and all(within(a, b, K2_RTOL, K2_ATOL)
                        for a, b in zip(bl[3:], ref[3:])),
                f"K1 {nmp} vs plain: {e1}, stores {st_err}")
        cots = [0.3 * torch.randn(x.shape, generator=g, device=dev)
                for x in bl[:3]]
        A_, Bm_, _, R_, _, F_, VV_, WW_, _ = ins
        args = (A_, Bm_, R_, F_, VV_, WW_, *bl[3:], *cots)
        got = kg.fused_gains_vjp(*args)
        again = kg.fused_gains_vjp(*args)
        want32, plain2 = one_ms(lambda: kg.fused_gains_vjp_reference(*args))
        # K2 is held to the plain version in float64 on the same float32
        # stores and cotangents: at n = 8 the float32 plain version's sums
        # round about as far from float64 as the kernel's, and can lie on
        # the other side, so that the two float32 results end further apart
        # than K2_SCALE while each is within it of float64; the log prints
        # the kernel's distance to both
        want = kg.fused_gains_vjp_reference(*(x.double() for x in args))
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"K2 {nmp}: two launches differ")
        e2 = max(float((a - b).abs().max()) for a, b in zip(got, want))
        scaled = max(float((a - b).abs().max() / b.abs().max())
                     for a, b in zip(got, want))
        scaled32 = max(float((a - b).abs().max() / b.abs().max())
                       for a, b in zip(got, want32))
        require(all(bool(torch.isfinite(a).all()) for a in got)
                and all(within(a.double(), b, K2_RTOL,
                               K2_ATOL + K2_SCALE * float(b.abs().max()))
                        for a, b in zip(got, want)),
                f"K2 {nmp} vs plain in float64: {e2}, max err / max|plain| "
                f"{scaled}")
        k1_ms = cuda_ms(lambda: kg.gains_fwd(*ins, T_, stores=True))
        k1_free = cuda_ms(lambda: kg.gains_fwd(*ins, T_))
        k2_ms = cuda_ms(lambda: kg.fused_gains_vjp(*args))
        inst = kg.instance_for(*nmp)
        st_bytes = 2 * T_ * B * n * n * 4
        w1 = gains_work(B, n, m, p, T_)
        b1 = bound((w1[0] + st_bytes, w1[1]))
        b2 = bound(gains_bwd_work(B, n, m, p, T_))
        shape = f"{nmp} B={B} T={T_}" + (f" padded to {inst}" if N != n
                                          else "")
        design = kg.design_for(*nmp, B, True)
        r1 = regs.get(f"gains_fwd_block<{N}, {m}, {p}, 1, 0, 0>")
        r2 = regs.get(f"gains_bwd<{N}, {m}, {p}>")
        out["gains_fwd_block"][shape] = {
            "ms": k1_ms, "ms_store_free": k1_free, "bound_ms": b1[0],
            "bound_by": b1[1], "max_abs_err": e1, "plain_ms": plain1,
            "design": design, "registers_spills": r1}
        out["gains_bwd"][shape] = {
            "ms": k2_ms, "bound_ms": b2[0], "bound_by": b2[1],
            "max_abs_err": e2, "plain_ms": plain2, "registers_spills": r2}
        log(f"[{card}] K1 {shape} ({design} design, with the stores): "
            f"{k1_ms:.4f} ms, store-free {k1_free:.4f} ms (bound "
            f"{b1[0]:.6f}, {b1[1]}, at the true shape's work), thread and "
            f"block designs the same bits, max abs err vs plain {e1:.3e} "
            f"(atol {ZOO_GAINS_ATOL}), stores {st_err:.3e}; K2 {k2_ms:.4f} "
            f"ms (bound {b2[0]:.6f}, {b2[1]}), two launches the same bits, "
            f"vs the plain version in float64 max abs err {e2:.3e}, max err "
            f"/ max|plain| {scaled:.3e} (vs the float32 plain version "
            f"{scaled32:.3e}); plain "
            f"K1 / K2 {plain1:.2f} / {plain2:.2f} ms; registers, spill "
            f"stores B, loads B: K1 {r1}, K2 {r2}; "
            f"{time.perf_counter() - t_shape:.1f} s")
        del th, bl, ref, got, again, want, want32, args, ins, sp
        torch.cuda.empty_cache()

    P_ = CHAINS * CONDITIONS
    for jd in SCOPE_LL:
        t_shape = time.perf_counter()
        j, d = jd
        J, _ = kl.instance_for(*jd)
        F_, Q_, X = scope_ll_inputs(jd, dev, g)
        free = kl.ll_fwd(F_, Q_, X)
        ll, *st = kl.ll_fwd(F_, Q_, X, stores=True)
        (ref, *st_ref), plain3 = one_ms(
            lambda: kl.conditioned_log_likelihood_reference(F_, Q_, X,
                                                            stores=True))
        torch.cuda.synchronize()
        e3 = float((ll - ref).abs().max())
        st_share = [float(((a - b).abs() / (
            LL_ATOL + LL_RTOL * b.abs() + K3_STORE_SCALE * row_scale(b)))
            .max()) for a, b in zip(st, st_ref)]
        require(bool(torch.isfinite(ll).all()) and torch.equal(free, ll)
                and within(ll, ref, LL_RTOL, LL_ATOL)
                and max(st_share) <= 1.0,
                f"K3 {jd} vs plain: {e3}, shares of the stores' allowed "
                f"error {st_share}")
        w = torch.randn(ll.shape, generator=g, device=dev)
        args = (F_, X, w, *st)
        got = kl.conditioned_log_likelihood_vjp(*args)
        again = kl.conditioned_log_likelihood_vjp(*args)
        want, plain4 = one_ms(
            lambda: kl.conditioned_log_likelihood_vjp_reference(*args))
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"K4 {jd}: two launches differ")
        e4 = max(float((a - b).abs().max()) for a, b in zip(got, want))
        require(all(bool(torch.isfinite(a).all()) for a in got)
                and all(within(a, b, K4_RTOL,
                               atol + K2_SCALE * float(b.abs().max()))
                        for a, b, atol in zip(got, want, (K4_FQ_ATOL,
                                                          K4_FQ_ATOL,
                                                          K4_X_ATOL))),
                f"K4 {jd} vs plain: {e4}")
        k3_ms = cuda_ms(lambda: kl.ll_fwd(F_, Q_, X))
        k3_st_ms = cuda_ms(lambda: kl.ll_fwd(F_, Q_, X, stores=True))
        k4_ms = cuda_ms(lambda: kl.conditioned_log_likelihood_vjp(*args))
        b3 = bound(ll_work(P_, LL_TRIALS, j, d, T_FIT))
        b4 = bound(ll_bwd_work(P_, LL_TRIALS, j, d, T_FIT))
        shape = (f"{jd} P={P_} n={LL_TRIALS} T={T_FIT}"
                 + (f" padded to {(J, d)}" if J != j else ""))
        r3 = regs.get(f"ll_fwd<{J}, {d}, 0>")
        r4 = regs.get(f"ll_bwd<{J}, {d}>")
        out["ll_fwd"][shape] = {
            "ms": k3_ms, "ms_stores": k3_st_ms, "bound_ms": b3[0],
            "bound_by": b3[1], "max_abs_err": e3, "plain_ms": plain3,
            "registers_spills": r3}
        out["ll_bwd"][shape] = {
            "ms": k4_ms, "bound_ms": b4[0], "bound_by": b4[1],
            "max_abs_err": e4, "plain_ms": plain4, "registers_spills": r4}
        log(f"[{card}] K3 {shape}: {k3_ms:.4f} ms (bound {b3[0]:.5f}, "
            f"{b3[1]}, at the true shape's work), with the stores "
            f"{k3_st_ms:.4f} ms, max abs err vs plain {e3:.3e}, max rel err "
            f"{float(((ll - ref) / ref).abs().max()):.3e} (rtol {LL_RTOL}, "
            f"atol {LL_ATOL}), stores' largest share of the allowed error "
            f"{st_share[0]:.3f} / {st_share[1]:.3f}; K4 {k4_ms:.4f} ms "
            f"(bound {b4[0]:.5f}, {b4[1]}), two launches the same bits, max "
            f"abs err {e4:.3e}; plain K3 / K4 (one call each, with the "
            f"stores) {plain3:.2f} / {plain4:.2f} ms; registers, spill "
            f"stores B, loads B: K3 {r3}, K4 {r4}; "
            f"{time.perf_counter() - t_shape:.1f} s")
        del F_, Q_, X, st, st_ref, got, again, want, args
        torch.cuda.empty_cache()
    return out


def scope_paths(dev, card, all_counters, all_names):
    """Phase 20, the paths: the gradient path of each of SCOPE_PATHS, 4
    chains x 6 conditions x 20 trials at T=1008, through
    ``shared_params_lqg_model`` (``System.gains`` and
    ``System.log_likelihood(method="auto")`` with autograd): one eager
    value+grad with every launch counter and a counter on the scans
    (``riccati.backward``, ``kalman.forward``) zeroed just before and read
    just after, each kernel of the path once and no scan; against eager
    float64 on the card; the value+grad replayed from a CUDA graph against
    eager; the replay and eager times beside the eager time of the scan
    route (``method="scan"``: ``gains_method="scan"`` too), what ``auto``
    took at these shapes before K1-K4 covered them.  Returns {path:
    readings}."""
    from lqg_tpu_torch.infer import shared_params_lqg_model
    from lqg_tpu_torch.infer.capture import (GraphedValueAndGrad,
                                             eager_value_and_grad)
    from lqg_tpu_torch.ops import kalman, riccati

    scans = {"calls": 0}

    def counting(fn):
        def wrapped(*args, **kw):
            scans["calls"] += 1
            return fn(*args, **kw)
        return wrapped

    g = torch.Generator(device=dev).manual_seed(21)
    readings = {}
    for name, (base, delay, per_cond, shared, kernels, nmp,
               jd) in SCOPE_PATHS.items():
        t_path = time.perf_counter()
        cls = delayed(base, delay)
        x_fit = torch.stack([cls(T=T_FIT, device=dev,
                                 **{per_cond: 3.0 + 5.0 * c}).simulate(
            g, n=LL_TRIALS)[..., :2] for c in range(CONDITIONS)])
        pm = shared_params_lqg_model(x_fit, cls, shared_params=shared)
        u0 = pm.init_unconstrained()
        u = u0 + 0.1 * torch.randn((CHAINS,) + u0.shape, generator=g,
                                   device=dev)
        eager = eager_value_and_grad(pm.potential)
        eager(u)  # the first call fills the models' caches
        saved = (riccati.backward, kalman.forward)
        riccati.backward, kalman.forward = (counting(f) for f in saved)
        try:
            for fn in all_counters:
                fn.launches = 0
            scans["calls"] = 0
            torch.cuda.synchronize()
            pot, grad = eager(u)
            torch.cuda.synchronize()
            counts = {k: fn.launches for k, fn in zip(all_names,
                                                       all_counters)}
            scan_calls = scans["calls"]
        finally:
            riccati.backward, kalman.forward = saved
        want = {k: int(k in kernels) for k in all_names}
        log(f"scope path {name}: {CHAINS} chains x {CONDITIONS} conditions x "
            f"{LL_TRIALS} trials at T={T_FIT}, D={u.shape[-1]}; one eager "
            f"value+grad launches {counts} (K1/K2 at {nmp}, the likelihood "
            f"at {jd}), scan calls {scan_calls}")
        require(counts == want and scan_calls == 0,
                f"scope path {name}: launches {counts}, scans {scan_calls}, "
                f"expected {want} and none")
        require(pot.shape == (CHAINS,) and grad.shape == u.shape
                and bool(torch.isfinite(pot).all()
                         and torch.isfinite(grad).all()),
                f"scope path {name}: shapes or values")
        pm64 = shared_params_lqg_model(x_fit.double(), cls,
                                       shared_params=shared)
        pot64, grad64 = eager_value_and_grad(pm64.potential)(u.double())
        del pm64
        pot_err = float(((pot.double() - pot64) / pot64).abs().max())
        grad_rel = float(((grad.double() - grad64).abs()
                          / grad64.abs()).max())
        log(f"scope path {name} vs eager float64 on the card: value rel err "
            f"{pot_err:.3e} (rtol {POT_RTOL}) of |U| ~ "
            f"{float(pot64.abs().mean()):.1f}; gradient rel err max "
            f"{grad_rel:.3e} (rtol {POT_GRAD_RTOL})")
        require(within(pot.double(), pot64, POT_RTOL, 0.0),
                f"scope path {name}, value vs float64: {pot_err}")
        require(within(grad.double(), grad64, POT_GRAD_RTOL, 0.0),
                f"scope path {name}, gradient vs float64: {grad_rel}")
        graphed = GraphedValueAndGrad(pm.potential, u)
        pe_g, grad_g = graphed(u)
        pe_e, grad_e = eager(u)
        torch.cuda.synchronize()
        require(within(pe_g, pe_e, POT_RTOL, 0.0)
                and within(grad_g, grad_e, POT_GRAD_RTOL,
                           1e-6 * float(grad_e.abs().max())),
                f"scope path {name}: replay vs eager")
        replay = cuda_ms(lambda: graphed(u))
        eager_ms = host_ms(lambda: eager(u), 3)
        del graphed
        # the scan route, what auto took here before (float64 runs it too)
        pm.method = "scan"
        scan_eager = eager_value_and_grad(pm.potential)
        scan_eager_ms = host_ms(lambda: scan_eager(u), 1)
        pm.method = "auto"
        readings[name] = {
            "launches": counts, "scan_calls": scan_calls, "gains": str(nmp),
            "likelihood": str(jd), "value_rel_err": pot_err,
            "grad_rel_err": grad_rel, "replay_ms": replay,
            "eager_ms": eager_ms, "scan_eager_ms": scan_eager_ms,
            "seconds": time.perf_counter() - t_path}
        log(f"[{card}] scope path {name}: value+grad replay {replay:.4f} ms "
            f"(CUDA events), eager {eager_ms:.1f} ms (host clock, median of "
            f"3); the scan route (method='scan', gains_method='scan') eager "
            f"{scan_eager_ms:.1f} ms (host clock, one call): "
            f"{scan_eager_ms / eager_ms:.1f} x the kernels' eager, "
            f"{scan_eager_ms / replay:.0f} x their replay; "
            f"{readings[name]['seconds']:.1f} s")
        del pm, eager, scan_eager, pot, grad, pot64, grad64
        torch.cuda.empty_cache()
    return readings


def joint_grads(fn, m, L, K, Fbar, Qbar, cast=lambda k, x: x):
    """F, Q of ``fn`` (``joint_fq`` or its plain version) and the gradients
    of ``<F, F-bar> + <Q, Q-bar>`` with respect to L, K and the eight spec
    matrices, each input ``cast(name, x)`` and made a leaf of its own."""
    leaf = lambda k, x: cast(k, x).detach().clone().requires_grad_()
    dyn = m.dynamics._replace(**{k: leaf("d" + k, getattr(m.dynamics, k))
                                 for k in "ABFVW"})
    act = m.actor._replace(**{k: leaf("a" + k, getattr(m.actor, k))
                              for k in "ABF"})
    L, K = leaf("L", L), leaf("K", K)
    leaves = [L, K, dyn.A, dyn.B, dyn.F, dyn.V, dyn.W, act.A, act.B, act.F]
    F, Q = fn(dyn, act, L, K, L.shape[0])
    grads = torch.autograd.grad(
        (F * cast("F", Fbar)).sum() + (Q * cast("Q", Qbar)).sum(), leaves)
    return [F.detach(), Q.detach(), *grads]


def joint_magnitudes(k, x):
    """The inputs of the tolerance's bound: absolute values, the actor's F
    negated (it enters the joint system only with a minus sign, so that
    every term of each output and gradient then adds with one sign)."""
    return -x.double().abs() if k == "aF" else x.double().abs()


def joint_kernels(dev, card):
    """Phase 21: ``joint_fwd`` and ``joint_bwd`` through ``joint_fq`` and
    autograd against the plain version (the assembly they replace:
    ``gaussian.joint_system``, ``G G^T``, the time axis moved) and its
    autograd in float64 at JOINT_SHAPES, with the gains K1 gives; two
    launches the same bits; each kernel timed (20 calls in a CUDA graph,
    CUDA events) beside its byte bound and the plain version's forward and
    forward + backward on the card.  Returns {shape: readings}."""
    from lqg_tpu_torch import models
    from lqg_tpu_torch.ops.kernels import joint as kj

    rows = {}
    for cls_name, P_ in JOINT_SHAPES:
        g = torch.Generator().manual_seed(P_)
        cost = torch.exp(torch.randn(P_, generator=g) * 0.5).to(dev)
        noise = (6.0 * torch.exp(torch.randn(P_, generator=g) * 0.3)).to(dev)
        m = getattr(models, cls_name)(T=T_FIT, device=dev, action_cost=cost,
                                      sigma_cursor=noise)
        gains, K = m.gains()
        L, K = gains.L.contiguous(), K.contiguous()
        j = m.xdim + m.bdim
        Fbar, Qbar = (torch.randn((P_, T_FIT, j, j), generator=g).to(dev)
                      for _ in range(2))
        got = joint_grads(kj.joint_fq, m, L, K, Fbar, Qbar)
        want = joint_grads(kj.joint_fq_reference, m, L, K, Fbar, Qbar,
                           lambda k, x: x.double())
        bound_ = joint_grads(kj.joint_fq_reference, m, L, K, Fbar, Qbar,
                             joint_magnitudes)
        ulps = JOINT_ULPS * (j + 8) * float(np.finfo(np.float32).eps)
        errs = [float((a.double() - w).abs().max()) / float(b.abs().max())
                for a, w, b in zip(got, want, bound_)]
        shape = f"{cls_name} (j={j}) P={P_} T={T_FIT}"
        require(max(errs) <= ulps and bool(torch.equal(got[1], got[1].mT)),
                f"joint kernels at {shape} vs plain float64: errors "
                f"{errs} of the bound's largest entry > {ulps:.3e}")
        mats = kj._spec_mats(m.dynamics, m.actor)
        runs = [kj.joint_fwd(mats, L, K) + kj.joint_fq_vjp(
            mats, L, K, Fbar, Qbar) for _ in range(2)]
        same = all(bool(torch.equal(a, b)) for a, b in zip(*runs))
        require(same, f"joint kernels at {shape}: two launches differ")
        del runs
        # the benchmark's fits differentiate through V_d and W_d alone
        VW = [x.detach().clone().requires_grad_()
              for x in (m.dynamics.V, m.dynamics.W)]
        dyn = m.dynamics._replace(V=VW[0], W=VW[1])

        def both(fn):
            Lg, Kg = L.clone().requires_grad_(), K.clone().requires_grad_()
            F, Q = fn(dyn, m.actor, Lg, Kg, T_FIT)
            torch.autograd.grad((F * Fbar).sum() + (Q * Qbar).sum(),
                                [Lg, Kg] + VW)

        row = {
            "fwd_ms": cuda_ms(lambda: kj.joint_fwd(mats, L, K), graph=True),
            "bwd_ms": cuda_ms(lambda: kj.joint_fq_vjp(
                mats, L, K, Fbar, Qbar, JOINT_NEEDS), graph=True),
            "fwd_bwd_ms": cuda_ms(lambda: both(kj.joint_fq), graph=True),
            "plain_fwd_ms": cuda_ms(lambda: kj.joint_fq_reference(
                m.dynamics, m.actor, L, K, T_FIT), graph=True),
            "plain_fwd_bwd_ms": cuda_ms(lambda: both(kj.joint_fq_reference),
                                        graph=True)}
        gains_bytes = 4 * (L.numel() + K.numel())
        out_bytes = 4 * 2 * P_ * T_FIT * j * j
        row["fwd_bound_ms"] = (gains_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        row["bwd_bound_ms"] = ((2 * gains_bytes + out_bytes)
                               / HBM_BYTES_PER_S * 1e3)
        row["max_err_of_bound"] = max(errs)
        row["same_bits"] = same
        rows[shape] = row
        log(f"[{card}] joint kernels at {shape}: vs plain float64 errors "
            f"{max(errs):.3e} of the bound's largest entry (tolerance "
            f"{ulps:.3e}), two launches the same bits; joint_fwd "
            f"{row['fwd_ms'] * 1e3:.1f} us (bound {row['fwd_bound_ms'] * 1e3:.1f}"
            f"), joint_bwd {row['bwd_ms'] * 1e3:.1f} us (bound "
            f"{row['bwd_bound_ms'] * 1e3:.1f}); through autograd forward + "
            f"backward {row['fwd_bwd_ms'] * 1e3:.1f} us against the plain "
            f"version's {row['plain_fwd_bwd_ms'] * 1e3:.1f} us (forward "
            f"{row['plain_fwd_ms'] * 1e3:.1f} us); CUDA events over a graph "
            f"of 20 calls")
        del got, want, bound_
        torch.cuda.empty_cache()
    return rows


def fit_batches(dev, card, x_fit):
    """Phase 17, kernels: K1 (with the stores, design by ``design_for``) and
    K2 at (2, 1, 2), K3 (with the stores) and K4 at (4, 2), each at the
    parameter sets the pipeline's steps launch them at (``FIT_BATCHES``
    points x 6 conditions) at T=1008, against their plain versions; two K2
    and two K4 launches the same bits; each timed beside its bound.
    Returns {kernel: {shape: (ms, bound ms, bound_by, max abs err)}}."""
    from lqg_tpu_torch.models import BoundedActor
    from lqg_tpu_torch.ops.kernels.gains import (
        fused_gains, fused_gains_reference, fused_gains_vjp,
        fused_gains_vjp_reference, gains_fwd)
    from lqg_tpu_torch.ops.kernels.likelihood import (
        conditioned_log_likelihood_reference, conditioned_log_likelihood_vjp,
        conditioned_log_likelihood_vjp_reference, ll_fwd)
    from lqg_tpu_torch.ops.linalg import mT

    g = torch.Generator(device=dev).manual_seed(23)
    out = {k: {} for k in ("gains_fwd_block", "gains_bwd", "ll_fwd",
                           "ll_bwd")}
    for points in FIT_BATCHES:
        B = points * CONDITIONS
        sp, ins = k1_inputs((2, 1, 2), B, T_FIT, dev)
        res = gains_fwd(*ins, T_FIT, stores=True)
        design = fused_gains.design
        ref = fused_gains_reference(sp, ins[-1], T_FIT, stores=True)
        torch.cuda.synchronize()
        e1 = max(float((a - b).abs().max()) for a, b in zip(res[:3], ref[:3]))
        require(all(bool(torch.isfinite(a).all()) for a in res)
                and e1 <= GAINS_ATOL
                and all(within(a, b, K2_RTOL, K2_ATOL)
                        for a, b in zip(res[3:], ref[3:])),
                f"K1 at B={B} vs plain: {e1}")
        cots = [0.3 * torch.randn(x.shape, generator=g, device=dev)
                for x in res[:3]]
        A_, Bm_, _, R_, _, F_, VV_, WW_, _ = ins
        args = (A_, Bm_, R_, F_, VV_, WW_, *res[3:], *cots)
        got = fused_gains_vjp(*args)
        again = fused_gains_vjp(*args)
        want = fused_gains_vjp_reference(*args)
        torch.cuda.synchronize()
        e2 = max(float((a - b).abs().max()) for a, b in zip(got, want))
        require(all(torch.equal(a, b) for a, b in zip(got, again))
                and all(bool(torch.isfinite(a).all()) for a in got)
                and all(within(a, b, K2_RTOL,
                               K2_ATOL + K2_SCALE * float(b.abs().max()))
                        for a, b in zip(got, want)),
                f"K2 at B={B} vs plain: {e2}")
        shape = f"(2, 1, 2) B={B} T={T_FIT}"
        k1_ms = cuda_ms(lambda: gains_fwd(*ins, T_FIT, stores=True))
        k2_ms = cuda_ms(lambda: fused_gains_vjp(*args))
        b1 = k1_bounds((2, 1, 2), B, T_FIT, True, sm_clock_mhz())
        b2 = bound(gains_bwd_work(B, 2, 1, 2, T_FIT))
        out["gains_fwd_block"][shape + " stores"] = (k1_ms, *b1[:2], e1)
        out["gains_bwd"][shape] = (k2_ms, *b2, e2)
        log(f"[{card}] fit batch {points} x {CONDITIONS}: K1 ({design} "
            f"design) {shape} with the stores {k1_ms:.4f} ms (bound "
            f"{b1[0]:.6f}, {b1[1]}; chain {b1[2]:.4f}), max abs err vs plain "
            f"{e1:.3e} (atol {GAINS_ATOL}); K2 {k2_ms:.4f} ms (bound "
            f"{b2[0]:.6f}, {b2[1]}), two launches the same bits, max abs err "
            f"{e2:.3e}")
        del res, ref, got, again, want, args, ins, sp

        sets = BoundedActor(
            T=T_FIT, device=dev,
            sigma_target=torch.tensor([3.0 + 5.0 * c
                                       for c in range(CONDITIONS)] * points,
                                      device=dev),
            action_cost=torch.tensor([0.25 * (1 + k) for k in range(points)
                                      for _ in range(CONDITIONS)],
                                     device=dev))
        joint = sets._joint()
        F4, Q4 = (torch.movedim(M, 0, 1).contiguous()
                  for M in (joint.F, joint.G @ mT(joint.G)))
        X4 = x_fit.repeat(points, 1, 1, 1)
        ll, *st = ll_fwd(F4, Q4, X4, stores=True)
        ll_ref, *st_ref = conditioned_log_likelihood_reference(F4, Q4, X4,
                                                               stores=True)
        torch.cuda.synchronize()
        e3 = float((ll - ll_ref).abs().max())
        require(bool(torch.isfinite(ll).all())
                and within(ll, ll_ref, LL_RTOL, LL_ATOL)
                and all(within(a, b, LL_RTOL, LL_ATOL)
                        for a, b in zip(st, st_ref)),
                f"K3 at P={B} vs plain: {e3}")
        w = torch.randn(ll.shape, generator=g, device=dev)
        args = (F4, X4, w, *st)
        got = conditioned_log_likelihood_vjp(*args)
        again = conditioned_log_likelihood_vjp(*args)
        want = conditioned_log_likelihood_vjp_reference(*args)
        torch.cuda.synchronize()
        e4 = max(float((a - b).abs().max()) for a, b in zip(got, want))
        require(all(torch.equal(a, b) for a, b in zip(got, again))
                and all(bool(torch.isfinite(a).all()) for a in got)
                and all(within(a, b, K4_RTOL, atol) for a, b, atol in zip(
                    got, want, (K4_FQ_ATOL, K4_FQ_ATOL, K4_X_ATOL))),
                f"K4 at P={B} vs plain: {e4}")
        shape = f"(4, 2) P={B} n={LL_TRIALS} T={T_FIT}"
        k3_ms = cuda_ms(lambda: ll_fwd(F4, Q4, X4, stores=True))
        k4_ms = cuda_ms(lambda: conditioned_log_likelihood_vjp(*args))
        b3 = bound(ll_work(B, LL_TRIALS, 4, 2, T_FIT, stores=True))
        b4 = bound(ll_bwd_work(B, LL_TRIALS, 4, 2, T_FIT))
        out["ll_fwd"][shape + " stores"] = (k3_ms, *b3, e3)
        out["ll_bwd"][shape] = (k4_ms, *b4, e4)
        log(f"[{card}] fit batch {points} x {CONDITIONS}: K3 {shape} with "
            f"the stores {k3_ms:.4f} ms (bound {b3[0]:.5f}, {b3[1]}), max abs "
            f"err vs plain {e3:.3e} of |ll| ~ {float(ll_ref.abs().mean()):.1f}"
            f" (rtol {LL_RTOL}, atol {LL_ATOL}); K4 {k4_ms:.4f} ms (bound "
            f"{b4[0]:.5f}, {b4[1]}), two launches the same bits, max abs err "
            f"{e4:.3e}")
        del sets, joint, F4, Q4, X4, st, st_ref, got, again, want, args
        torch.cuda.empty_cache()
    return out


def loop_ms(fn):
    """``fn()``'s result and its time in ms from CUDA events, the host
    waiting only after the second event (``fn`` may run under
    ``set_sync_debug_mode("error")``)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    result = fn()
    stop.record()
    stop.synchronize()
    return result, start.elapsed_time(stop)


def fit_pipeline(dev, card, counters, names, x_fit):
    """Phase 17: ``scripts/fit_data.py``'s pipeline on the card at the data's
    shape, through the entry points: ``optimize`` (the MAP), ``fit_auto_iaf``,
    ``fit_auto_mvn``, ``laplace_guide``, ``neutra_reparam``, the warped-space
    polish and ``MCMC``.  Returns the launches of K1-K4 (every step but
    laplace's replays a captured graph, so they count the warm-ups and the
    captures) and the step times."""
    from lqg_tpu_torch.infer import MCMC, shared_params_lqg_model, split_rhat
    from lqg_tpu_torch.infer.capture import (GraphedPotential,
                                             GraphedValueAndGrad)
    from lqg_tpu_torch.infer.flows import fit_auto_iaf
    from lqg_tpu_torch.infer.svi import (adam, fit_auto_mvn, laplace_guide,
                                         optimize)
    from lqg_tpu_torch.infer.utils import neutra_reparam
    from lqg_tpu_torch.models import BoundedActor

    times = {}

    def graph_of(model, C):
        """The captured value+grad of ``model`` at ``C`` points."""
        fns = [f for key, f in model.value_and_grad_fns.items()
               if key[0][0] == C]
        require(len(fns) == 1 and isinstance(fns[0], GraphedValueAndGrad),
                f"no captured graph at C={C}: {model.value_and_grad_fns}")
        return fns[0]

    def split(what, steps_fn, steps, vg, u, params):
        """Device busy ms a step of ``steps_fn`` (``steps`` steps under
        ``torch.profiler``, the graph already captured), of one replay of
        ``vg`` at ``u`` and of one Adam update of ``params``; and a replay
        and an Adam update alone from CUDA events (the host runs ahead of
        the card, so within a step they overlap)."""
        opt = adam(0.01)
        grads = [torch.ones_like(p) for p in params]
        state = opt.init(params)
        busy = profile_ms(steps_fn, ())[1] / steps
        replay_busy = profile_ms(lambda: vg(u), ())[1]
        adam_busy = profile_ms(lambda: opt.update(grads, state), ())[1]
        replay = cuda_ms(lambda: vg(u))
        adam_ms = cuda_ms(lambda: opt.update(grads, state))
        log(f"  {what}: device busy {busy:.4f} ms a step: a replay "
            f"{replay_busy:.4f}, Adam over {len(params)} tensors "
            f"{adam_busy:.4f}, the rest (the guide's forward and backward, "
            f"the draws, the losses) {busy - replay_busy - adam_busy:.4f} "
            f"ms; alone, CUDA events: a replay {replay:.4f} ms, an Adam "
            f"update {adam_ms:.4f} ms")
        return busy, replay_busy, adam_busy, replay, adam_ms

    for fn in counters:
        fn.launches = 0
    counters[0].design_launches = {"thread": 0, "block": 0}
    t_all = time.perf_counter()
    pm = shared_params_lqg_model(x_fit, BoundedActor, shared_params=SHARED)
    D = len(pm.names)

    # the MAP: a first call captures the value+grad at one point; the timed
    # call replays it at every step, with no host synchronization
    optimize(pm, steps=2, step_size=MAP_STEP_SIZE)
    (map_params, losses), ms = loop_ms(lambda: without_sync(
        lambda: optimize(pm, steps=MAP_STEPS, step_size=MAP_STEP_SIZE)))
    losses = losses.cpu()
    require(losses.shape == (MAP_STEPS,) and bool(torch.isfinite(
        losses).all()) and float(losses[-1]) < float(losses[0]),
        f"MAP: losses {losses[:3]} ... {losses[-3:]}")
    log(f"[{card}] MAP, optimize({MAP_STEPS} steps, step size "
        f"{MAP_STEP_SIZE}) on {CONDITIONS} conditions x {LL_TRIALS} trials at "
        f"T={T_FIT}, D={D}, under set_sync_debug_mode('error'): "
        f"{ms / MAP_STEPS:.4f} ms a step (CUDA events); potential "
        f"{float(losses[0]):.2f} -> {float(losses[-1]):.2f} (decrease "
        f"{float(losses[0] - losses[-1]):.2f})")
    u1 = pm.init_unconstrained()[None]
    times["map"] = (ms / MAP_STEPS,) + split(
        "MAP", lambda: optimize(pm, steps=5, step_size=MAP_STEP_SIZE), 5,
        graph_of(pm, 1), u1, [u1])
    pm.init = dict(map_params)

    # the IAF guide: every step one replay at 16 points (96 parameter sets)
    t0 = time.perf_counter()
    iaf, iaf_losses = fit_auto_iaf(pm, 1, steps=IAF_STEPS)
    torch.cuda.synchronize()
    iaf_s = time.perf_counter() - t0
    iaf_losses = iaf_losses.cpu()
    finite = torch.isfinite(iaf_losses)
    leaves = [iaf.loc, iaf.log_scale, *(x for l in iaf.layers for x in l)]
    require(all(bool(torch.isfinite(x).all()) for x in leaves)
            and int(finite.sum()) > IAF_STEPS // 2,
            f"IAF fit: {int(finite.sum())} finite losses of {IAF_STEPS}")
    step_ms = iaf_s * 1e3 / IAF_STEPS
    tail = iaf_losses[-100:][torch.isfinite(iaf_losses[-100:])]
    log(f"[{card}] IAF guide, fit_auto_iaf({IAF_STEPS} steps, 16 particles "
        f"= 96 parameter sets): {iaf_s:.2f} s, {step_ms:.4f} ms a step (host "
        f"clock, the capture included); {IAF_STEPS - int(finite.sum())}"
        f" steps skipped (not finite); loss {float(iaf_losses[0]):.2f} -> "
        f"mean of the last 100 {float(tail.mean()):.2f}, final ELBO "
        f"{-float(tail[-1]):.2f}")
    times["iaf"] = (step_ms,) + split(
        "IAF", lambda: fit_auto_iaf(pm, 1, steps=5), 5, graph_of(pm, 16),
        pm.init_unconstrained().expand(16, D).contiguous(), leaves)

    # the ELBO through the graph (float32) against eager float64 on one eps
    eps = torch.randn((16, D), generator=torch.Generator(
        device=dev).manual_seed(3), device=dev)

    def elbo(model, guide, potential):
        params = [x.detach().requires_grad_() for x in
                  (guide.loc, guide.log_scale,
                   *(x for l in guide.layers for x in l))]
        layers = tuple(type(guide.layers[0])(*params[k:k + 8])
                       for k in range(2, len(params), 8))
        g = guide._replace(loc=params[0], log_scale=params[1], layers=layers)
        u, ld = g.transform_and_logdet(eps.to(params[0].dtype))
        loss = -torch.mean(-potential(model, u) + ld)
        return loss.detach(), torch.autograd.grad(loss, params)

    lg, gg = elbo(pm, iaf, lambda m, u: GraphedPotential.apply(u, m))
    pm64 = shared_params_lqg_model(x_fit.double(), BoundedActor,
                                   shared_params=SHARED)
    pm64.init = {k: v.double() for k, v in pm.init.items()}
    iaf64 = type(iaf)(
        loc=iaf.loc.double(), log_scale=iaf.log_scale.double(),
        layers=tuple(type(l)(*(x.double() for x in l)) for l in iaf.layers),
        masks=tuple(tuple(m.double() for m in ms) for ms in iaf.masks))
    le, ge = elbo(pm64, iaf64, lambda m, u: m.potential(u))
    val_err = float(abs(lg.double() - le) / abs(le))
    grad_err = max(float(((a.double() - b).abs() / (
        POT_GRAD_RTOL * b.abs() + ELBO_GRAD_SCALED * b.abs().max())).max())
        for a, b in zip(gg, ge))
    log(f"graphed ELBO (float32) vs eager float64 on one eps, 16 particles: "
        f"value rel err {val_err:.3e} (rtol {POT_RTOL}) of |ELBO| "
        f"{float(le):.2f}; gradient, largest share of the allowed error "
        f"{grad_err:.3f} (rtol {POT_GRAD_RTOL} + {ELBO_GRAD_SCALED} x each "
        f"leaf's max)")
    require(val_err <= POT_RTOL and grad_err <= 1.0,
            f"graphed ELBO vs float64: value {val_err}, gradient {grad_err}")
    del pm64, iaf64, ge, gg

    # the Gaussian guide: 8 particles (48 parameter sets)
    t0 = time.perf_counter()
    mvn, mvn_losses = fit_auto_mvn(pm, 2, steps=MVN_STEPS)
    torch.cuda.synchronize()
    mvn_s = time.perf_counter() - t0
    mvn_losses = mvn_losses.cpu()
    require(bool(torch.isfinite(mvn_losses).all()
                 and torch.isfinite(mvn.scale_tril).all()),
            "MVN fit: not finite")
    step_ms = mvn_s * 1e3 / MVN_STEPS
    log(f"[{card}] MVN guide, fit_auto_mvn({MVN_STEPS} steps, 8 particles = "
        f"48 parameter sets): {mvn_s:.2f} s, {step_ms:.4f} ms a step (host "
        f"clock, the capture included); loss {float(mvn_losses[0]):.2f} -> "
        f"{float(mvn_losses[-1]):.2f}, final ELBO "
        f"{-float(mvn_losses[-1]):.2f}")
    times["mvn"] = (step_ms,) + split(
        "MVN", lambda: fit_auto_mvn(pm, 2, steps=5), 5, graph_of(pm, 8),
        pm.init_unconstrained().expand(8, D).contiguous(),
        [mvn.loc, mvn.loc, mvn.scale_tril])

    # the Laplace guide at the MAP: the Hessian on the scans
    lm = pm
    if LAPLACE_T != T_FIT:
        lm = shared_params_lqg_model(x_fit[:, :, :LAPLACE_T + 1],
                                     BoundedActor, shared_params=SHARED)
        lm.init = dict(pm.init)
    t0 = time.perf_counter()
    lap, w = laplace_guide(lm)
    torch.cuda.synchronize()
    lap_s = time.perf_counter() - t0
    times["laplace_s"] = lap_s
    require(bool(torch.isfinite(w).all() and (w > 0).all()
                 and torch.isfinite(lap.scale_tril).all())
            and lm.method == "auto", f"laplace: eigenvalues {w}")
    sds = torch.sqrt(torch.diagonal(lap.scale_tril @ lap.scale_tril.mT))
    log(f"[{card}] laplace_guide at the MAP ({CONDITIONS} x {LL_TRIALS} "
        f"trials at T={LAPLACE_T}, the scans, {D} backward passes through "
        f"the double-backward graph): {lap_s:.2f} s (host clock); "
        f"eigenvalues {float(w[0]):.4g} to {float(w[-1]):.4g}; posterior sds "
        f"{[round(float(v), 5) for v in sds]}")
    del lm, lap

    # NeuTra: the IAF's warped space, a polish there, then NUTS on 4 chains
    reparam = neutra_reparam(pm, iaf)
    t0 = time.perf_counter()
    _, pol_losses, eps_map = optimize(reparam, steps=POLISH_STEPS,
                                      step_size=POLISH_STEP_SIZE,
                                      return_unconstrained=True)
    torch.cuda.synchronize()
    pol_s = time.perf_counter() - t0
    reparam.init_eps = eps_map
    vgp = graph_of(reparam, 1)
    replay_p = cuda_ms(lambda: vgp(eps_map[None]))
    pol_losses = pol_losses.cpu()
    require(bool(torch.isfinite(pol_losses).all()
                 and torch.isfinite(eps_map).all()), "polish: not finite")
    times["polish"] = (pol_s * 1e3 / POLISH_STEPS, replay_p, None)
    log(f"[{card}] warped-space polish, optimize({POLISH_STEPS} steps) on "
        f"the reparametrized model: {pol_s:.2f} s with the capture, "
        f"{pol_s * 1e3 / POLISH_STEPS:.4f} ms a step; a replay of the flow "
        f"and the potential {replay_p:.4f} ms; potential "
        f"{float(pol_losses[0]):.2f} -> {float(pol_losses[-1]):.2f}, "
        f"|eps_map| {float(eps_map.norm()):.3f}")

    t0 = time.perf_counter()
    mcmc = MCMC(reparam, num_warmup=NEUTRA_WARMUP, num_samples=NEUTRA_SAMPLES,
                num_chains=CHAINS, max_depth=NEUTRA_DEPTH).run(4)
    torch.cuda.synchronize()
    nuts_s = time.perf_counter() - t0
    vg = mcmc.value_and_grad
    require(isinstance(vg, GraphedValueAndGrad) and vg.replays > 0,
            "NeuTra NUTS: the leapfrogs did not replay the captured graph")
    z = mcmc._samples_u[:, -1].to(dev)
    replay = cuda_ms(lambda: vg(z))
    samples = mcmc.get_samples(group_by_chain=True)
    rhat = {}
    for name, v in samples.items():
        v = v.double().numpy()
        require(v.shape == (CHAINS, NEUTRA_SAMPLES)
                and bool(np.isfinite(v).all()) and bool((v > 0).all()),
                f"NeuTra NUTS: {name} samples {v.shape}, not finite or "
                f"positive")
        rhat[name] = round(split_rhat(v), 4)
    depth = mcmc.get_extra_fields()["tree_depth"]
    times["leapfrog"] = (nuts_s * 1e3 / vg.replays, replay, None)
    log(f"[{card}] NeuTra NUTS, {CHAINS} chains, {NEUTRA_WARMUP} warmup + "
        f"{NEUTRA_SAMPLES} samples, max_depth={NEUTRA_DEPTH}: {nuts_s:.2f} s "
        f"with the capture, {vg.replays} leapfrogs (replays), "
        f"{nuts_s * 1e3 / vg.replays:.4f} ms a leapfrog against "
        f"{replay:.4f} ms a replay alone (the flow, the potential and "
        f"autograd in one graph); divergences {mcmc.divergences}; kept "
        f"draws' tree depth mean {float(depth.mean()):.2f}, max "
        f"{int(depth.max())}; split R-hat {rhat}")
    launches = {k: fn.launches for k, fn in zip(names, counters)}
    designs = dict(counters[0].design_launches)
    log(f"phase 17: {time.perf_counter() - t_all:.1f} s; launches (warm-ups "
        f"and captures) {launches}, K1 by design {designs}")
    require(all(v > 0 for v in launches.values()),
            f"the fit pipeline bypassed a kernel: {launches}")
    launches["gains_fwd"] = designs["thread"]
    launches["gains_fwd_block"] = designs["block"]
    return launches, times


def write_data_mat(dev, directory):
    """Simulate the tracking experiment with ``BoundedActor`` at the data's
    raw shape and write it as ``directory/data.mat`` (fields ``sigma``,
    ``target``, ``response``: the response lags the cursor by the loader's
    delay).  Returns the fields."""
    import scipy.io as spio
    from lqg_tpu_torch.models import BoundedActor

    g = torch.Generator(device=dev).manual_seed(18)
    sigma = np.repeat(np.asarray(DATA_SIGMAS), LL_TRIALS)
    xs = torch.cat([BoundedActor(
        T=DATA_RAW_T - 1, sigma_target=round(s * 1.32), device=dev).simulate(
            g, n=LL_TRIALS) for s in DATA_SIGMAS]).double().cpu().numpy()
    response = np.concatenate([np.repeat(xs[:, :1, 1], DATA_DELAY, 1),
                               xs[:, :-DATA_DELAY, 1]], 1)
    fields = dict(sigma=sigma, target=xs[:, :, 0], response=response)
    spio.savemat(os.path.join(directory, "data.mat"), fields)
    return fields


def preprocess(fields):
    """``load_tracking_data(delay, clip, subtract_mean=False)`` written out
    in numpy."""
    sigma = (fields["sigma"] * 1.32).round()
    widths = np.unique(sigma)
    target = fields["target"].astype(np.float32)[:, DATA_CLIP:-DATA_DELAY]
    mouse = fields["response"].astype(np.float32)[:, DATA_CLIP + DATA_DELAY:]
    data = np.stack([np.stack([target[sigma == w], mouse[sigma == w]], -1)
                     for w in widths])
    return data - data[:, :, :1, :1], widths


def data_tools(dev, card, counters, names, replay_fit_ms):
    """Phase 18: the data and fit tools on the card.  The synthetic data
    file through ``io.load_tracking_data``; ``scripts/torch_fit_data.py``'s
    ``main`` on it (the baseline set before any capture, a replay against
    eager float64, K1-K4 launched, the netcdf read back); ``xcorr`` and the
    CCG fit engines on its 120 trials; the sqrt and steady gains; and
    ``profiling.timeit`` of the fit's replay.  Returns K1-K4's launches in
    the fit script and the phase's readings."""
    import tempfile

    from lqg_tpu_torch import ccg, xcorr
    from lqg_tpu_torch.infer import mcmc as mcmc_module
    from lqg_tpu_torch.infer import models as models_module
    from lqg_tpu_torch.infer.capture import GraphedValueAndGrad
    from lqg_tpu_torch.infer.models import shared_params_lqg_model
    from lqg_tpu_torch.io import load_tracking_data
    from lqg_tpu_torch.models import BoundedActor
    from lqg_tpu_torch.ops.kernels.likelihood import (
        conditioned_log_likelihood_fused)
    from lqg_tpu_torch.results import load_netcdf
    from lqg_tpu_torch.utils.profiling import timeit

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch_fit_data

    readings = {}
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # 1. the data file, read back as the loader reads it
        fields = write_data_mat(dev, tmp)
        data, widths = load_tracking_data(
            delay=DATA_DELAY, clip=DATA_CLIP, subtract_mean=False,
            data_path=tmp)
        want, want_widths = preprocess(fields)
        require(data.shape == (len(DATA_SIGMAS), LL_TRIALS,
                               DATA_RAW_T - DATA_CLIP - DATA_DELAY, 2)
                and np.array_equal(data, want)
                and np.array_equal(widths, want_widths),
                f"load_tracking_data: {data.shape} vs the inline numpy")
        log(f"data.mat ({len(DATA_SIGMAS)} widths x {LL_TRIALS} trials x "
            f"{DATA_RAW_T} raw steps, simulated) -> load_tracking_data "
            f"{data.shape}, blob widths {widths.tolist()}: equal to the "
            f"inline numpy preprocessing")

        # 2. the port's fit script, in process; the captures' baselines
        captures = []

        def recording(module, what):
            inner = module.value_and_grad_fn

            def wrapper(potential, u0):
                captures.append((what, tuple(u0.shape),
                                 potential.__self__.ll_baseline))
                return inner(potential, u0)
            return inner, wrapper

        originals = []
        for module, what in ((models_module, "value_and_grad"),
                             (mcmc_module, "MCMC.run")):
            inner, wrapper = recording(module, what)
            originals.append((module, inner))
            module.value_and_grad_fn = wrapper
        for fn in counters:
            fn.launches = 0
        try:
            out = torch_fit_data.main(["--data", tmp, "--out", tmp]
                                      + FIT_ARGS)
        finally:
            for module, inner in originals:
                module.value_and_grad_fn = inner
        torch.cuda.synchronize()
        fit_launches = {k: fn.launches for k, fn in zip(names, counters)}
        pm, mcmc, baseline = out["model"], out["mcmc"], out["ll_baseline"]
        vg = mcmc.value_and_grad
        log(f"captures (what, u shape, ll_baseline at capture): {captures}")
        require(captures and captures[-1][0] == "MCMC.run"
                and captures[-1][2] == baseline != 0.0
                and all(c[2] == 0.0 for c in captures[:-1]),
                "ll_baseline: the MAP captures at 0, NUTS after it is set")
        require(abs(out["potential"]) < 1e3,
                f"potential at the MAP {out['potential']}")
        require(isinstance(vg, GraphedValueAndGrad) and vg.replays > 0,
                "fit script: NUTS did not replay a captured graph")
        require(all(v > 0 for v in fit_launches.values()),
                f"fit script bypassed a kernel: {fit_launches}")
        # a replay against eager float64 with the same baseline: the value
        # within POT_RTOL of the likelihood's own magnitude (the baseline
        # is subtracted after the float32 terms are formed)
        z = mcmc._samples_u[:, -1].to(dev)
        pe, grad = vg(z)
        x64 = torch.as_tensor(data, dtype=torch.float64, device=dev)
        pm64 = shared_params_lqg_model(x64, BoundedActor,
                                       shared_params=SHARED)
        pm64.ll_baseline = baseline
        with torch.enable_grad():
            u = z.double().requires_grad_()
            pe64 = pm64.potential(u)
            (grad64,) = torch.autograd.grad(pe64.sum(), u)
        pe64 = pe64.detach()
        val_err = float(((pe.double() - pe64).abs()
                         / (pe64.abs() + abs(baseline))).max())
        require(within(grad.double(), grad64, POT_GRAD_RTOL,
                       1e-6 * float(grad64.abs().max()))
                and val_err <= POT_RTOL,
                f"fit replay vs float64: value {val_err}, gradient")
        samples = load_netcdf(out["out_path"])
        require(sorted(samples) == pm.names and all(
            v.shape == (CHAINS, FIT_SAMPLES) and np.isfinite(v).all()
            for v in samples.values()), f"netcdf: {list(samples)}")
        map_ms = out["times"]["map_s"] * 1e3 / FIT_MAP_STEPS
        leap_ms = out["times"]["mcmc_s"] * 1e3 / vg.replays
        readings["fit"] = dict(map_ms=map_ms, leapfrog_ms=leap_ms,
                               leapfrogs=vg.replays,
                               potential=out["potential"],
                               potential_baseline0=out["potential_baseline0"],
                               ll_baseline=baseline)
        log(f"[{card}] torch_fit_data.main({' '.join(FIT_ARGS)}) at "
            f"{CONDITIONS} x {LL_TRIALS} x T={data.shape[2] - 1}: "
            f"ll_baseline {baseline:.8g}; potential at the MAP "
            f"{out['potential']:.6g} (at baseline 0: "
            f"{out['potential_baseline0']:.8g}); MAP {map_ms:.4f} ms a step, "
            f"NUTS {vg.replays} leapfrogs, {leap_ms:.4f} ms a leapfrog "
            f"(host clock, the capture included); divergences "
            f"{mcmc.divergences}; replay vs eager float64: value rel err "
            f"{val_err:.3e} of the likelihood's magnitude (rtol {POT_RTOL}), "
            f"gradient within rtol {POT_GRAD_RTOL}; launches (warm-ups and "
            f"captures) {fit_launches}; {out['out_path']} read back with "
            f"the model's {len(pm.names)} names")

    # 3. xcorr on the data's 120 trials, and the CCG fit engines
    flat = data.reshape(-1, data.shape[2], 2).astype(np.float64)
    tx = torch.as_tensor(flat[..., 0], dtype=torch.float32, device=dev)
    ty = torch.as_tensor(flat[..., 1], dtype=torch.float32, device=dev)
    lags, corr = without_sync(lambda: xcorr(tx, ty, maxlags=XCORR_LAGS))
    n = flat.shape[1]
    ref = np.stack([np.correlate(a, b, "full")[n - 1 - XCORR_LAGS:
                                              n + XCORR_LAGS]
                    / (np.linalg.norm(a) * np.linalg.norm(b))
                    for a, b in zip(flat[..., 0], flat[..., 1])])
    x_err = float(np.abs(corr.double().cpu().numpy() - ref).max())
    require(corr.shape == (flat.shape[0], 2 * XCORR_LAGS + 1)
            and x_err <= XCORR_SCALED * np.abs(ref).max(),
            f"xcorr vs numpy.correlate: {x_err}")
    x_ms = cuda_ms(lambda: xcorr(tx, ty, maxlags=XCORR_LAGS))
    t0 = time.perf_counter()
    params, losses = ccg.fit_ccg_shape_batch("dog", lags, corr,
                                             engine="torch")
    torch.cuda.synchronize()
    lm_ms = (time.perf_counter() - t0) * 1e3
    lt = torch.as_tensor(lags, dtype=torch.float32, device=dev)
    lm_again_ms = cuda_ms(lambda: ccg.lm_fit_batch(
        "dog", lt, corr, ccg.restart_inits(
            "dog", 8, torch.Generator(device=dev).manual_seed(0))),
        runs=3, launches=1)
    t0 = time.perf_counter()
    fits = ccg.fit_ccg_shape_batch("dog", lags, corr, engine="scipy")
    scipy_s = time.perf_counter() - t0
    # both medians over the correlograms that scipy fitted
    fitted = np.array([f is not None for f in fits])
    failed = int((~fitted).sum())
    scipy_losses = np.array([
        float(np.sum((ccg.dog(lags.astype(float), **f) - y) ** 2))
        for f, y in zip(fits, corr.double().cpu().numpy()) if f is not None])
    require(fitted.any(), "CCG scipy engine fitted no correlogram")
    med = float(np.median(losses.cpu().numpy()[fitted]))
    med_scipy = float(np.median(scipy_losses))
    require(params.shape == (flat.shape[0], 6)
            and med <= CCG_LOSS_RATIO * med_scipy,
            f"CCG torch engine median loss {med} vs scipy {med_scipy}, over "
            f"the {int(fitted.sum())} correlograms scipy fitted ({failed} "
            "failed)")
    readings["ccg"] = dict(xcorr_ms=x_ms, lm_ms=lm_ms,
                           lm_events_ms=lm_again_ms, scipy_s=scipy_s,
                           median_loss=med, scipy_median_loss=med_scipy,
                           scipy_failed=failed)
    log(f"[{card}] xcorr of {flat.shape[0]} trials of T={n}, maxlags="
        f"{XCORR_LAGS}, float32, under set_sync_debug_mode('error'): "
        f"{x_ms:.4f} ms (CUDA events); vs numpy.correlate float64 max abs "
        f"err {x_err:.3e} (of max {np.abs(ref).max():.4g}); CCG 'dog' fit "
        f"of the {flat.shape[0]} correlograms, engine 'torch' (8 restarts, "
        f"60 LM steps): {lm_ms:.1f} ms host clock, {lm_again_ms:.1f} ms CUDA "
        f"events; engine 'scipy': {scipy_s:.2f} s, {failed} of "
        f"{flat.shape[0]} fits failed; median loss over the "
        f"{int(fitted.sum())} that scipy fitted: 'torch' {med:.6g}, "
        f"'scipy' {med_scipy:.6g}")

    # 4. the sqrt and steady gains, float32 against the float64 scan
    m = BoundedActor(T=T, device=dev)
    m64 = BoundedActor(T=T, device=dev, dtype=torch.float64)
    g64, K64 = m64.gains(method="scan")
    gains = {}
    for method in ("sqrt", "steady", "auto"):
        g, K = m.gains(method=method)
        try:
            without_sync(lambda: m.gains(method=method))
            free = "no synchronization"
        except RuntimeError as e:
            free = f"synchronizes ({str(e)[:80]})"
        gains[method] = (host_ms(lambda: m.gains(method=method), 3), free,
                         g, K)
    g, K = gains["sqrt"][2:]
    sqrt_err = max(float((g.L - g64.L).abs().max()),
                   float((K - K64).abs().max()))
    g, K = gains["steady"][2:]
    steady_err = (float((g.L[100] - g64.L[100]).abs().max()),
                  float((K[-1] - K64[-1]).abs().max()))
    require(sqrt_err <= SQRT_ATOL, f"sqrt gains vs float64 scan {sqrt_err}")
    require(steady_err[0] <= STEADY_L_ATOL and steady_err[1] <= STEADY_K_ATOL,
            f"steady gains vs float64 scan {steady_err}")
    x = m.simulate(torch.Generator(device=dev).manual_seed(5), n=LL_TRIALS)
    conditioned_log_likelihood_fused.launches = 0
    ll = m.log_likelihood(x, gains_method="sqrt")
    torch.cuda.synchronize()
    k3 = conditioned_log_likelihood_fused.launches
    ll64 = m64.log_likelihood(x.double(), method="scan")
    require(k3 == 1 and within(ll.double(), ll64, LL_RTOL, LL_ATOL),
            f"log_likelihood(gains_method='sqrt'): K3 {k3}, "
            f"{float((ll.double() - ll64).abs().max())}")
    readings["gains_ms"] = {k: v[0] for k, v in gains.items()}
    log(f"[{card}] BoundedActor(T={T}) float32 gains, host ms (median of "
        f"3): " + ", ".join(f"{k} {v[0]:.3f} ({v[1]})"
                            for k, v in gains.items())
        + f" ['auto' is K1]; sqrt vs the float64 scan max abs err "
        f"{sqrt_err:.3e} (atol {SQRT_ATOL}); steady L at t=100 "
        f"{steady_err[0]:.3e} (atol {STEADY_L_ATOL}), K at t=T-1 "
        f"{steady_err[1]:.3e} (atol {STEADY_K_ATOL}); log_likelihood("
        f"gains_method='sqrt') launched K3 {k3}x, max abs err vs the "
        f"float64 scan {float((ll.double() - ll64).abs().max()):.3e}")

    # 5. profiling.timeit of the fit's replay
    timing = timeit(lambda: vg(z), iters=20, warmup=2, name="fit replay")
    readings["timeit_replay_ms"] = timing.mean_s * 1e3
    log(f"[{card}] profiling.timeit of the fit's replay ({CHAINS} chains): "
        f"{timing}; phase 13's replay of the same potential "
        f"{replay_fit_ms:.4f} ms (CUDA events)")
    log(f"phase 18: {time.perf_counter() - t_all:.1f} s")
    return fit_launches, readings


def pscan_paths(dev, card, counters, names):
    """Phase 19, first part: ``log_likelihood(method="pscan")`` of the
    bounded actor at each of ``PSCAN_TS`` (20 trials), value and value+grad
    through the entry points (K1 and K2 for the gains, no K3/K4), with no
    host synchronization, against float64 and against K3's value (an
    independent path: at T=10^4 the float64 reference is pscan too);
    pscan timed beside K3 and K3+K4 on the same joint system and trials.
    Returns the trials and the float32 values and gradient at the last
    horizon, each path's launches and the timings."""
    from lqg_tpu_torch.models import BoundedActor
    from lqg_tpu_torch.ops.gaussian import JointSystem, joint_system
    from lqg_tpu_torch.ops.kernels.likelihood import (
        conditioned_log_likelihood_fused)
    from lqg_tpu_torch.ops.linalg import mT
    from lqg_tpu_torch.parallel.pscan import (kalman_forward_assoc,
                                              lqr_backward_assoc,
                                              trial_log_likelihood_assoc)

    require(torch.get_float32_matmul_precision() == "highest"
            and not torch.backends.cuda.matmul.allow_tf32,
            "float32 products must not take TF32")
    g = torch.Generator(device=dev).manual_seed(PAR_SEED)
    launches, timings = {}, {}
    for T_ in PSCAN_TS:
        t0 = time.perf_counter()
        x = BoundedActor(T=T_, device=dev).simulate(g, n=LL_TRIALS)
        params = {k: torch.full((), v, device=dev, requires_grad=True)
                  for k, v in PAR_PARAMS.items()}

        def value(params=params, x=x, T_=T_):
            return BoundedActor(T=T_, device=dev, **params).log_likelihood(
                x, method="pscan")

        def value_and_grad(params=params, value=value):
            ll = value()
            return ll, torch.autograd.grad(ll.sum(), list(params.values()))

        for fn in counters:
            fn.launches = 0
        ll, grad = value_and_grad()
        torch.cuda.synchronize()
        launches[T_] = {k: fn.launches for k, fn in zip(names, counters)}
        require(launches[T_] == {"gains_fwd": 1, "gains_bwd": 1, "ll_fwd": 0,
                                 "ll_bwd": 0},
                f"pscan at T={T_}: K1 and K2 once, got {launches[T_]}")
        require(ll.shape == (LL_TRIALS,) and bool(torch.isfinite(ll).all())
                and all(bool(torch.isfinite(v).all()) for v in grad),
                f"pscan at T={T_}: shapes or values")
        without_sync(value)
        without_sync(value_and_grad)

        t_ref = time.perf_counter()
        p64 = {k: v.detach().double().requires_grad_()
               for k, v in params.items()}
        m64 = BoundedActor(T=T_, device=dev, dtype=torch.float64, **p64)
        if T_ == T_FIT:
            ref = "scan"
            ll64 = m64.log_likelihood(x.double(), method="scan")
        else:
            # the scans' gains at T=10^4, a host loop, and their backward
            # would take tens of seconds: the gains by associative scan too
            ref = "pscan with the associative gains"
            gains = lqr_backward_assoc(m64.actor, horizon=T_)
            K = kalman_forward_assoc(m64.actor, m64._default_Sigma0(),
                                     horizon=T_)
            ll64 = trial_log_likelihood_assoc(
                joint_system(m64.dynamics, m64.actor, gains.L, K, T_),
                x.double())
        grad64 = torch.autograd.grad(ll64.sum(), list(p64.values()))
        ll64 = ll64.detach()
        t_ref = time.perf_counter() - t_ref
        err = float((ll.detach().double() - ll64).abs().max())
        grad_rel = max(float(((a.double() - b) / b).abs())
                       for a, b in zip(grad, grad64))
        require(within(ll.detach().double(), ll64, LL_RTOL, LL_ATOL),
                f"pscan at T={T_} vs float64 {ref}: {err}")
        require(all(within(a.double(), b, POT_GRAD_RTOL, 0.0)
                    for a, b in zip(grad, grad64)),
                f"pscan gradient at T={T_} vs float64 {ref}: {grad_rel}")
        row = (f"pscan BoundedActor T={T_} n={LL_TRIALS}: value vs float64 "
               f"{ref} max abs err {err:.3e} of |ll| ~ "
               f"{float(ll64.abs().mean()):.1f} (rtol {LL_RTOL}, atol "
               f"{LL_ATOL}); gradient of {sorted(PAR_PARAMS)} rel err max "
               f"{grad_rel:.3e} (rtol {POT_GRAD_RTOL}); launches {launches[T_]}"
               f"; value and value+grad under set_sync_debug_mode('error'): "
               f"no synchronization; the float64 reference {t_ref:.1f} s")
        ll_k3 = BoundedActor(T=T_, device=dev, **params).log_likelihood(
            x, method="fused").detach()
        k3_err = float((ll.detach() - ll_k3).abs().max())
        require(within(ll.detach(), ll_k3, LL_RTOL, LL_ATOL),
                f"pscan vs K3 at T={T_}: {k3_err}")
        row += f"; vs K3 max abs err {k3_err:.3e}"
        log(row)

        # pscan and the kernels on the same joint system and trials
        joint = BoundedActor(T=T_, device=dev, **params)._joint()
        F = joint.F.detach().requires_grad_()
        G = joint.G.detach().requires_grad_()
        x1 = x[None]

        def k3(F=F, G=G, x1=x1):
            return conditioned_log_likelihood_fused(F[None], (G @ mT(G))[None],
                                                    x1)[0]

        def ps(F=F, G=G, x=x):
            return trial_log_likelihood_assoc(JointSystem(F, G), x)

        def grad_of(fn, F=F, G=G):
            return lambda: torch.autograd.grad(fn().sum(), (F, G))

        with torch.no_grad():
            p_ms, k_ms = paired_ms(ps, k3)
        pg_ms, kg_ms = paired_ms(grad_of(ps), grad_of(k3))
        timings[T_] = {"pscan_ms": p_ms, "k3_ms": k_ms,
                       "pscan_grad_ms": pg_ms, "k3_k4_ms": kg_ms}
        log(f"[{card}] pscan vs the kernels, T={T_}, {LL_TRIALS} trials, "
            f"one joint system (CUDA events, in turns): value pscan "
            f"{p_ms:.4f} ms, K3 {k_ms:.4f} ms (pscan / K3 {p_ms / k_ms:.3f});"
            f" value+grad (F, G) pscan {pg_ms:.4f} ms, K3+K4 {kg_ms:.4f} ms "
            f"(pscan / kernels {pg_ms / kg_ms:.3f}); "
            f"{time.perf_counter() - t0:.1f} s")
    return x, ll.detach(), [v.detach() for v in grad], launches, timings


def batch_bits(potential, z):
    """Where a chain's float32 value and gradient of the potential come to
    depend on the batch of chains.  The potential's eager value+grad (the
    operations a replay runs) at the first half of the chains ``z (C, D)``
    and at all of them, every operation recorded (the aten operations
    through a dispatch mode, K1-K4 through their launchers) with its inputs
    and outputs; the two runs' operations are paired in order and each
    tensor of the half batch held against the first rows of its
    counterpart along the axis that halves.  Returns the number of
    operations, the first whose outputs differ, those whose inputs agree
    and outputs differ (the operations that make the difference: the first
    SOURCES_SHOWN and their count), and the value's and the gradient's
    largest differences."""
    import lqg_tpu_torch.ops.kernels.gains as kg
    import lqg_tpu_torch.ops.kernels.likelihood as kl
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    launchers = ((kg, "gains_fwd", "K1"), (kg, "fused_gains_vjp", "K2"),
                 (kl, "ll_fwd", "K3"),
                 (kl, "conditioned_log_likelihood_vjp", "K4"))

    def tensors(tree):
        return [t.detach().clone() for t in tree_leaves(tree)
                if torch.is_tensor(t)]

    class Record(TorchDispatchMode):
        def __init__(self, calls):
            super().__init__()
            self.calls = calls

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ins = tensors((args, kwargs))
            out = func(*args, **(kwargs or {}))
            # factories hold no chain's rows (and empty ones, no values)
            if ins and "empty" not in str(func):
                self.calls.append((str(func), ins, tensors(out), [
                    a for a in tree_leaves((args, kwargs))
                    if not torch.is_tensor(a)]))
            return out

    def run(zz):
        calls, saved = [], [getattr(m, a) for m, a, _ in launchers]

        def recorded(fn, name):
            def launch(*args, **kwargs):
                out = fn(*args, **kwargs)
                calls.append((name, tensors((args, kwargs)), tensors(out),
                              []))
                return out
            launch.launches = 0  # the launchers count themselves by name
            return launch

        for (m, a, name), fn in zip(launchers, saved):
            setattr(m, a, recorded(fn, name))
        try:
            u = zz.detach().clone().requires_grad_()
            with Record(calls):
                pe = potential(u)
                grad, = torch.autograd.grad(pe, u, torch.ones_like(pe))
        finally:
            for (m, a, _), fn in zip(launchers, saved):
                setattr(m, a, fn)
        return calls, pe.detach(), grad

    def diff(a, b):
        """The largest difference of ``a`` and ``b``'s first rows along
        the axis where ``b`` is twice ``a``, relative to ``b``'s largest
        entry: 0 where the bits agree, None where the tensors do not pair
        (no such axis, or one merged into another, which shows as a
        difference beyond rounding, ROUNDING)."""
        if a.shape != b.shape:
            axes = [d for d in range(a.dim()) if a.dim() == b.dim()
                    and b.shape[d] == 2 * a.shape[d]
                    and a.shape[:d] + a.shape[d + 1:]
                    == b.shape[:d] + b.shape[d + 1:]]
            if not axes:
                return None
            b = b.narrow(axes[0], 0, a.shape[axes[0]])
        if torch.equal(a, b):
            return 0.0
        if not a.is_floating_point() or a.numel() == 0:
            return None
        a, b = a.double(), b.double()
        rel = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        return rel if rel <= ROUNDING else None

    def summary(k, name, ins, rest, d_in, d_out):
        return {"index": k, "op": name, "shapes": [list(t.shape) for t in ins],
                "args": [str(a) for a in rest], "in_rel_diff": d_in,
                "out_rel_diff": d_out}

    half, pe_h, g_h = run(z[:z.shape[0] // 2])
    full, pe_f, g_f = run(z)
    out = {"operations": [len(half), len(full)], "first_differing": None,
           "sources": [], "value_rel_diff": diff(pe_h, pe_f),
           "grad_rel_diff": diff(g_h, g_f)}
    for k, ((name, ins_h, outs_h, _), (name_f, ins_f, outs_f, rest)) in \
            enumerate(zip(half, full)):
        if name != name_f:
            out["unpaired_at"] = [k, name, name_f]
            break
        d_in = [diff(a, b) for a, b in zip(ins_h, ins_f)]
        d_out = [diff(a, b) for a, b in zip(outs_h, outs_f)]
        rounded = [d for d in d_out if d]
        if rounded and out["first_differing"] is None:
            out["first_differing"] = summary(k, name, ins_f, rest, d_in,
                                             d_out)
        # every input paired and the same bits, an output rounded otherwise
        if rounded and all(d == 0.0 for d in d_in):
            out["sources"].append(summary(k, name, ins_f, rest, d_in, d_out))
    out["n_sources"] = len(out["sources"])
    out["sources"] = out["sources"][:SOURCES_SHOWN]
    return out


def parallel_rank(rank, tmp, world, device_type):
    """One rank of phase 19 (a ``torch.multiprocessing`` spawn target):
    the trial-sharded likelihood's value+grad, the horizon-sharded
    likelihood's value+grad and chain-sharded NUTS (uninterrupted, stopped
    and resumed, its first transition, its captured value+grad at given
    points, and timed with a leapfrog budget that can bind), on meshes over
    the ``world`` ranks, on the rank's device of ``device_type``; K1-K4's
    launches on each path.  Results to ``rank{rank}.pt`` in ``tmp``."""
    import torch.distributed as dist

    from lqg_tpu_torch.infer.mcmc import MCMC
    from lqg_tpu_torch.infer.models import lifted_model
    from lqg_tpu_torch.models import BoundedActor
    from lqg_tpu_torch.ops.kernels.gains import fused_gains, fused_gains_vjp
    from lqg_tpu_torch.ops.kernels.likelihood import (
        conditioned_log_likelihood_fused, conditioned_log_likelihood_vjp)
    from lqg_tpu_torch.parallel import distributed_init, local_mesh
    from lqg_tpu_torch.parallel.mesh import AxisSharding
    from lqg_tpu_torch.parallel.sharding import (
        sequence_parallel_log_likelihood, sharded_chains_run,
        sharded_log_likelihood)

    counters = (fused_gains, fused_gains_vjp, conditioned_log_likelihood_fused,
                conditioned_log_likelihood_vjp)
    names = ("gains_fwd", "gains_bwd", "ll_fwd", "ll_bwd")

    def counted(fn):
        for c in counters:
            c.launches = 0
        result = fn()
        torch.cuda.synchronize()
        return result, {k: c.launches for k, c in zip(names, counters)}

    backend = distributed_init(f"file://{tmp}/store", world, rank)
    try:
        dev = torch.device(device_type)  # the rank's card is the current one
        data = torch.load(os.path.join(tmp, "inputs.pt"), map_location=dev)
        out = {"backend": backend, "world": dist.get_world_size(),
               "device": str(data["x_ll"].device)}
        total_ll = sharded_log_likelihood(
            lambda p: BoundedActor(T=T_FIT, device=dev, **p), data["x_ll"],
            local_mesh(device=dev))
        params = {k: torch.full((), v, device=dev, requires_grad=True)
                  for k, v in PAR_PARAMS.items()}

        def ll_grad():
            value = total_ll(params)
            return value, torch.autograd.grad(value, list(params.values()))

        (value, grad), n = counted(ll_grad)
        out["ll"] = (value.detach().cpu(), [v.cpu() for v in grad], n,
                     host_ms(ll_grad, 5))
        sp = local_mesh(name="sp", device=dev)

        def horizon_sharded():
            ll = sequence_parallel_log_likelihood(
                BoundedActor(T=PSCAN_TS[-1], device=dev, **params),
                data["x_sp"], sp)
            return ll, torch.autograd.grad(ll.sum(), list(params.values()))

        (ll_sp, g_sp), n = counted(horizon_sharded)
        out["sp"] = (ll_sp.detach().cpu(), [v.cpu() for v in g_sp], n,
                     host_ms(horizon_sharded, 3))

        chains = local_mesh(name="chains", device=dev)
        model = lifted_model(data["x_rec"], BoundedActor)
        kw = dict(num_warmup=PAR_WARMUP, num_samples=PAR_SAMPLES,
                  num_chains=CHAINS, max_depth=PAR_DEPTH,
                  chunk_steps=PAR_CHUNK)
        t0 = time.perf_counter()
        mc, n = counted(lambda: sharded_chains_run(MCMC(model, **kw),
                                                   PAR_SEED, chains))
        wall = time.perf_counter() - t0
        out["chains"] = (mc._samples_u, mc.get_extra_fields()["num_steps"], n,
                         wall, mc.value_and_grad.replays)
        # the captured value+grad at this rank's rows of the given points
        mine = AxisSharding(chains, "chains").block(CHAINS)
        out["rows"] = tuple(v.cpu() for v in mc.value_and_grad(
            data["z_rows"][mine]))
        out["first"] = sharded_chains_run(
            MCMC(model, num_warmup=0, num_samples=1, num_chains=CHAINS,
                 max_depth=PAR_DEPTH), PAR_SEED, chains)._samples_u[:, 0]
        t0 = time.perf_counter()
        mc = sharded_chains_run(
            MCMC(model, max_leapfrogs_per_launch=PAR_BUDGET, **kw),
            PAR_SEED, chains)
        out["budget"] = (time.perf_counter() - t0, mc.value_and_grad.replays,
                         torch.equal(mc._samples_u, out["chains"][0]))
        exact = lifted_model(data["x_exact"], BoundedActor)
        out["exact"] = sharded_chains_run(
            MCMC(exact, **EXACT_KW), PAR_SEED, chains)._samples_u
        path = os.path.join(tmp, "chains.npz")
        stopped = sharded_chains_run(
            MCMC(model, checkpoint_every=1, **kw), PAR_SEED, chains,
            checkpoint_path=path, _stop_after_launches=1)
        out["resumed"] = (stopped, sharded_chains_run(
            MCMC(model, **kw), PAR_SEED, chains,
            checkpoint_path=path)._samples_u)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def parallel_layer(dev, card, counters, names, x_fit, x_rec):
    """Phase 19: the parallel layer on the card.  :func:`pscan_paths`; then
    ``PAR_RANKS`` spawned ranks (:func:`parallel_rank`), built kernels
    loaded, each rank's results held against one process's (the
    trial-sharded value+grad, the horizon-sharded value+grad against
    one-device pscan, the captured value+grad at the rank's chains and the
    first transition against the unsharded ones, the sharded posterior
    against the unsharded run's, the resumed run's and the budgeted run's
    draws against the uninterrupted's); :func:`batch_bits` on the
    recovery potential; and a one-rank nccl group through the
    trial-sharded likelihood.  Returns K1-K4's launches on each path and
    the phase's readings."""
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as tmp_mp

    from lqg_tpu_torch.infer import ess
    from lqg_tpu_torch.infer.mcmc import MCMC
    from lqg_tpu_torch.infer.models import lifted_model
    from lqg_tpu_torch.models import BoundedActor
    from lqg_tpu_torch.parallel import local_mesh
    from lqg_tpu_torch.parallel.sharding import sharded_log_likelihood

    t_all = time.perf_counter()
    x_sp, ll_sp1, g_sp1, pscan_launches, timings = pscan_paths(
        dev, card, counters, names)
    readings = {"pscan": {str(k): v for k, v in timings.items()}}
    launches = {f"pscan T={k}": v for k, v in pscan_launches.items()}

    x_ll = x_fit.reshape(-1, T_FIT + 1, 2)
    params = {k: torch.full((), v, device=dev, requires_grad=True)
              for k, v in PAR_PARAMS.items()}

    def one_rank():
        value = BoundedActor(T=T_FIT, device=dev, **params).log_likelihood(
            x_ll).sum()
        return value, torch.autograd.grad(value, list(params.values()))

    value1, grad1 = one_rank()
    value1 = value1.detach()
    one_ms = host_ms(one_rank, 5)

    # the unsharded chains, the reference of the sharded run
    model = lifted_model(x_rec, BoundedActor)
    kw = dict(num_warmup=PAR_WARMUP, num_samples=PAR_SAMPLES,
              num_chains=CHAINS, max_depth=PAR_DEPTH, chunk_steps=PAR_CHUNK)
    t0 = time.perf_counter()
    mc1 = MCMC(model, **kw).run(PAR_SEED)
    torch.cuda.synchronize()
    mc1_s = time.perf_counter() - t0
    mc1_leap = mc1_s * 1e3 / mc1.value_and_grad.replays
    x_exact = BoundedActor(T=PAR_EXACT_T, device=dev,
                           dtype=torch.float64).simulate(
        torch.Generator(device=dev).manual_seed(PAR_SEED),
        n=PAR_EXACT_TRIALS)
    exact1 = MCMC(lifted_model(x_exact, BoundedActor), **EXACT_KW).run(
        PAR_SEED)._samples_u
    z1 = mc1._samples_u.double().flatten(0, 1)
    mean1, sd1 = z1.mean(0), z1.std(0)
    n_draws = mc1._samples_u.shape[0] * mc1._samples_u.shape[1]

    def ess_of(samples):  # each parameter's ESS, at most the draws
        return torch.tensor([min(ess(samples[..., k].numpy()), n_draws)
                             for k in range(samples.shape[-1])],
                            dtype=torch.float64)

    ess1 = ess_of(mc1._samples_u)
    # the captured value+grad at the unsharded run's last draws, the first
    # transition, and where the batch enters a chain's bits
    z_rows = mc1._samples_u[:, -1].to(dev)
    pe_rows, g_rows = (v.cpu() for v in mc1.value_and_grad(z_rows))
    first1 = MCMC(model, num_warmup=0, num_samples=1, num_chains=CHAINS,
                  max_depth=PAR_DEPTH).run(PAR_SEED)._samples_u[:, 0]
    bits = batch_bits(model.potential, z_rows)
    readings["batch_bits"] = bits
    log(f"[{card}] a chain's value+grad of the recovery potential, eager, "
        f"at {CHAINS // 2} chains against its rows at {CHAINS} (phase 19's "
        f"sharded NUTS): {json.dumps(bits)}")

    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"x_ll": x_ll, "x_sp": x_sp, "x_rec": x_rec,
                    "x_exact": x_exact, "z_rows": z_rows},
                   os.path.join(tmp, "inputs.pt"))
        t0 = time.perf_counter()
        ctx = tmp_mp.start_processes(parallel_rank,
                                     args=(tmp, PAR_RANKS, dev.type),
                                     nprocs=PAR_RANKS, join=False,
                                     start_method="spawn")
        deadline = time.monotonic() + PAR_JOIN_S
        try:
            while not ctx.join(timeout=5):
                require(time.monotonic() < deadline,
                        f"phase 19: the ranks did not end in {PAR_JOIN_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(30)
        ranks_s = time.perf_counter() - t0
        outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(PAR_RANKS)]

        backend = outs[0]["backend"]
        require(all(o["backend"] == backend and o["world"] == PAR_RANKS
                    for o in outs), "phase 19: the ranks' backends")
        require(backend == ("nccl" if torch.cuda.device_count() >= PAR_RANKS
                            else "gloo"),
                f"phase 19: backend {backend} with "
                f"{torch.cuda.device_count()} cards")
        for r, o in enumerate(outs):
            value, grad, n_ll, ll_ms = o["ll"]
            require(n_ll == dict.fromkeys(names, 1),
                    f"rank {r}: the trial-sharded value+grad runs K1-K4 "
                    f"once each, got {n_ll}")
            require(within(value.double(), value1.cpu().double(), POT_RTOL,
                           0.0)
                    and all(within(a.double(), b.cpu().double(),
                                   POT_GRAD_RTOL, 0.0)
                            for a, b in zip(grad, grad1)),
                    f"rank {r}: trial-sharded value {float(value)} vs "
                    f"{float(value1)}, gradient {grad} vs {grad1}")
            ll_sp, g_sp, n_sp, sp_ms = o["sp"]
            require(n_sp == {"gains_fwd": 1, "gains_bwd": 1, "ll_fwd": 0,
                             "ll_bwd": 0},
                    f"rank {r}: the horizon-sharded value+grad runs K1 and "
                    f"K2 once and no K3/K4, got {n_sp}")
            sp_grad_rel = max(float(((a - b.cpu()) / b.cpu()).abs())
                              for a, b in zip(g_sp, g_sp1))
            require(within(ll_sp, ll_sp1.cpu(), LL_RTOL, LL_ATOL)
                    and all(within(a, b.cpu(), POT_GRAD_RTOL, 0.0)
                            for a, b in zip(g_sp, g_sp1)),
                    f"rank {r}: horizon-sharded vs one-device pscan: value "
                    f"{float((ll_sp - ll_sp1.cpu()).abs().max())}, gradient "
                    f"rel {sp_grad_rel}")
            samples, steps, n_mc, wall, replays = o["chains"]
            require(all(v > 0 for v in n_mc.values()),
                    f"rank {r}: chain-sharded NUTS bypassed a kernel {n_mc}")
            mine = slice(r * CHAINS // PAR_RANKS,
                         (r + 1) * CHAINS // PAR_RANKS)
            pe_r, g_r = o["rows"]
            rows_err = (float((pe_r.double() - pe_rows[mine].double()).abs()
                              .max()),
                        float((g_r.double() - g_rows[mine].double()).abs()
                              .max()))
            require(within(pe_r.double(), pe_rows[mine].double(), POT_RTOL,
                           0.0)
                    and within(g_r.double(), g_rows[mine].double(),
                               POT_GRAD_RTOL, 0.0),
                    f"rank {r}: captured value+grad at {CHAINS // PAR_RANKS}"
                    f" chains vs at {CHAINS}, max abs diffs {rows_err}")
            first_err = float(((o["first"] - first1).abs().double() / sd1)
                              .max())
            require(first_err <= PAR_FIRST_SDS,
                    f"rank {r}: the first transition's draws vs unsharded, "
                    f"in posterior sds: {first_err}")
            # posterior means within PAR_SES standard errors of their
            # difference
            z_s = samples.double().flatten(0, 1)
            se = sd1 * (1 / ess1 + 1 / ess_of(samples)).sqrt()
            far = (z_s.mean(0) - mean1).abs() / se
            require(samples.shape == mc1._samples_u.shape
                    and bool(torch.isfinite(samples).all())
                    and bool((far <= PAR_SES).all()),
                    f"rank {r}: sharded posterior means vs unsharded, in "
                    f"standard errors: {far.tolist()} (ESS {ess1.tolist()})")
            budget_s, budget_replays, budget_same = o["budget"]
            require(budget_same,
                    f"rank {r}: a binding leapfrog budget changed the draws")
            stopped, resumed = o["resumed"]
            require(stopped is None and torch.equal(resumed, samples),
                    f"rank {r}: resumed draws vs uninterrupted, max abs diff "
                    f"{float((resumed - samples).abs().max())}")
            exact_err = float((o["exact"] - exact1).abs().max())
            require(exact_err <= PAR_EXACT_ATOL,
                    f"rank {r}: float64 sharded draws vs unsharded "
                    f"{exact_err}")
            launches[f"rank {r} trial-sharded value+grad"] = n_ll
            launches[f"rank {r} horizon-sharded"] = n_sp
            launches[f"rank {r} chain-sharded NUTS"] = n_mc
            log(f"[{card}] rank {r} of {PAR_RANKS} ({backend}, {o['device']})"
                f": trial-sharded value+grad of {x_ll.shape[0]} trials at "
                f"T={T_FIT} {ll_ms:.3f} ms host wall (one process "
                f"{one_ms:.3f} ms), value rel err "
                f"{float(abs(value.double() / value1.cpu().double() - 1)):.3e}"
                f", launches {n_ll}; horizon-sharded T={PSCAN_TS[-1]} "
                f"{sp_ms:.3f} ms host wall, max abs diff to one-device pscan "
                f"{float((ll_sp - ll_sp1.cpu()).abs().max()):.3e}, launches "
                f"{n_sp}; chain-sharded NUTS ({CHAINS // PAR_RANKS} of "
                f"{CHAINS} chains, {PAR_WARMUP} + {PAR_SAMPLES} transitions, "
                f"max_depth {PAR_DEPTH}) {wall:.2f} s, {replays} leapfrogs, "
                f"{wall * 1e3 / replays:.3f} ms a leapfrog against "
                f"{mc1_leap:.3f} ms unsharded, "
                f"{budget_s * 1e3 / budget_replays:.3f} ms with a leapfrog "
                f"budget of {PAR_BUDGET} (a pmax each transition; the same "
                f"draws); captured value+grad at its chains vs at {CHAINS}, "
                f"max abs diffs (value, grad) {rows_err}; first transition's "
                f"draws max diff {first_err:.3e} posterior sds; posterior means "
                f"{max(far.tolist()):.3f} standard errors apart at most "
                f"({[round(v, 3) for v in far.tolist()]}, ESS unsharded "
                f"{[round(v, 1) for v in ess1.tolist()]}; in unsharded sds "
                f"{max(((z_s.mean(0) - mean1).abs() / sd1).tolist()):.3f}; "
                f"draws the same bits: "
                f"{torch.equal(samples, mc1._samples_u)}); resumed the same "
                f"bits; launches (warm-up and capture) {n_mc}; float64 "
                f"(T={PAR_EXACT_T}, {PAR_EXACT_TRIALS} trials, "
                f"{PAR_EXACT_DRAWS} + {PAR_EXACT_DRAWS}) draws max abs diff "
                f"to the unsharded run {exact_err:.3e}; horizon-sharded "
                f"gradient rel err to one-device pscan {sp_grad_rel:.3e}")
        require(all(torch.equal(o["ll"][0], outs[0]["ll"][0])
                    and torch.equal(o["sp"][0], outs[0]["sp"][0])
                    and torch.equal(o["chains"][0], outs[0]["chains"][0])
                    for o in outs), "phase 19: the ranks' results differ")
        readings["ranks"] = {
            "backend": backend, "world": PAR_RANKS, "spawn_to_end_s": ranks_s,
            "one_process_value_grad_ms": one_ms,
            "sharded_value_grad_ms": [o["ll"][3] for o in outs],
            "horizon_sharded_value_grad_ms": [o["sp"][3] for o in outs],
            "ms_per_leapfrog_sharded": [o["chains"][3] * 1e3 / o["chains"][4]
                                        for o in outs],
            "ms_per_leapfrog_sharded_budget": [
                o["budget"][0] * 1e3 / o["budget"][1] for o in outs],
            "ms_per_leapfrog_unsharded": mc1_leap}

        # a one-rank nccl group through the trial-sharded likelihood
        dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl",
                                world_size=1, rank=0)
        try:
            total_ll = sharded_log_likelihood(
                lambda p: BoundedActor(T=T_FIT, device=dev, **p), x_ll,
                local_mesh(device=dev))

            def nccl_grad():
                value = total_ll(params)
                return value, torch.autograd.grad(value,
                                                  list(params.values()))

            for fn in counters:
                fn.launches = 0
            value, grad = nccl_grad()
            torch.cuda.synchronize()
            n_nccl = {k: fn.launches for k, fn in zip(names, counters)}
            nccl_ms = host_ms(nccl_grad, 5)
            backend_1 = dist.get_backend()
        finally:
            dist.destroy_process_group()
        require(backend_1 == "nccl" and n_nccl == dict.fromkeys(names, 1),
                f"one-rank nccl: backend {backend_1}, launches {n_nccl}")
        require(within(value.detach(), value1, POT_RTOL, 0.0)
                and all(within(a, b, POT_GRAD_RTOL, 0.0)
                        for a, b in zip(grad, grad1)),
                "one-rank nccl: value+grad vs one process")
        launches["one-rank nccl trial-sharded value+grad"] = n_nccl
        readings["nccl_one_rank_value_grad_ms"] = nccl_ms
        log(f"[{card}] one-rank nccl group: trial-sharded value+grad "
            f"{nccl_ms:.3f} ms host wall against {one_ms:.3f} ms without a "
            f"group; the same bits as one process: "
            f"{torch.equal(value.detach(), value1)}; launches {n_nccl}")
    log(f"phase 19: {time.perf_counter() - t_all:.1f} s")
    return launches, readings


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from lqg_tpu_torch.infer import (ess, infer, lifted_model,
                                     sample_from_prior,
                                     shared_params_lqg_model, split_rhat)
    from lqg_tpu_torch.infer.capture import (GraphedValueAndGrad,
                                             eager_value_and_grad)
    from lqg_tpu_torch.infer.hmc import draw_nuts, nuts_step
    from lqg_tpu_torch.models import (BoundedActor, DelayedSubjectiveActor,
                                      SubjectiveActor, TemporalDelayModel)
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
    from lqg_tpu_torch.ops.kernels.likelihood_blocked import (
        conditioned_log_likelihood_blocked,
        conditioned_log_likelihood_blocked_reference,
        conditioned_log_likelihood_blocked_vjp,
        conditioned_log_likelihood_blocked_vjp_reference, ll_blocked_fwd)
    from lqg_tpu_torch.ops.kernels import likelihood_blocked as kb
    from lqg_tpu_torch.ops.kernels import joint as kj
    from lqg_tpu_torch.ops import kalman, riccati
    from lqg_tpu_torch.ops.linalg import mT
    from lqg_tpu_torch.utils.profiling import kernel_counts

    counters = (fused_gains, fused_gains_vjp, conditioned_log_likelihood_fused,
                conditioned_log_likelihood_vjp)
    names = ("gains_fwd", "gains_bwd", "ll_fwd", "ll_bwd")
    all_counters = counters + (conditioned_log_likelihood_blocked,
                               conditioned_log_likelihood_blocked_vjp,
                               kj.joint_fq, kj.joint_fq_vjp)
    all_names = names + ("ll_blocked_fwd", "ll_blocked_bwd", "joint_fwd",
                         "joint_bwd")
    # the kernels the profiled paths name: K1-K4 and the joint system's
    profiled = names + ("joint_fwd", "joint_bwd")

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
    reports = nvcc.build_all(["gains", "likelihood", "likelihood_blocked",
                              "joint"])
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        for row in ptxas_summary(report):
            log(f"  {name}.cu {row}")

    # 3. K1 against its plain version, bench.py's sweep
    B = GAINS_BATCH
    spec, k1_ins = k1_inputs((2, 1, 2), B, T, dev)
    S0 = k1_ins[-1]
    # a gains sweep through the entry point a user calls, its launches
    # counted by design: auto takes the thread design at this batch
    fused_gains.launches = 0
    fused_gains.design_launches = {"thread": 0, "block": 0}
    out = fused_gains(spec, S0, T)
    torch.cuda.synchronize()
    sweep_launches = dict(fused_gains.design_launches)
    ref = fused_gains_reference(spec, S0, T)
    torch.cuda.synchronize()
    k1_err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    require(all(bool(torch.isfinite(a).all()) for a in out), "K1 not finite")
    require(k1_err <= GAINS_ATOL, f"K1 vs plain: {k1_err} > {GAINS_ATOL}")
    require(sweep_launches == {"thread": 1, "block": 0},
            f"gains sweep: K1's thread design once, got {sweep_launches}")
    log(f"K1 vs plain at B={B}, T={T} through fused_gains: max abs err "
        f"{k1_err:.3e} (atol {GAINS_ATOL}); launches by design "
        f"{sweep_launches}")
    del out, ref
    # K1's block design against its thread design, bit for bit, at the
    # instances of the bounded actor, the relative-observation actor and
    # the subjective actor's internal model (the zoo's in phase 16)
    k1_bits = k1_designs_bits(dev, card, K1_INSTANCES[:3])

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
    fused_gains.design_launches = {"thread": 0, "block": 0}
    conditioned_log_likelihood_fused.launches = 0
    kj.joint_fq.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = BoundedActor(T=T, device=dev)
    x = model.simulate(torch.Generator(device=dev).manual_seed(1),
                       n=LL_TRIALS)
    ll_main = model.log_likelihood(x, method="auto")
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"gains_fwd_block": fused_gains.design_launches["block"],
                "ll_fwd": conditioned_log_likelihood_fused.launches,
                "joint_fwd": kj.joint_fq.launches}
    require(fused_gains.launches == launches["gains_fwd_block"],
            f"main path: K1 in its thread design at one parameter set, "
            f"{fused_gains.design_launches}")
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
                                                         "ll_fwd",
                                                         "joint_fwd"))
    if n_events:
        log(f"main path under torch.profiler: wall {wall:.1f} ms, device busy "
            f"{busy:.2f} ms ({100 * busy / wall:.2f}% of wall) over "
            f"{n_events} device events; gains_fwd {named['gains_fwd']:.3f} "
            f"ms, ll_fwd {named['ll_fwd']:.3f} ms, joint_fwd "
            f"{named['joint_fwd']:.3f} ms")
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
    def rel_err(a, b):
        """max |a - b| over max |b|, per output."""
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    g2 = torch.Generator(device=dev).manual_seed(2)
    k2_err, k2_inputs, k2_large = 0.0, None, None
    for B2, T2 in ((CHAINS * CONDITIONS, T_FIT), (2048, 719)):
        sp, ins = k1_inputs((2, 1, 2), B2, T2, dev)
        out = gains_fwd(*ins, T2, stores=True)
        ref = fused_gains_reference(sp, ins[-1], T2, stores=True)
        torch.cuda.synchronize()
        st_err = max(float((a - b).abs().max())
                     for a, b in zip(out[3:], ref[3:]))
        require(all(within(a, b, K2_RTOL, K2_ATOL)
                    for a, b in zip(out[3:], ref[3:])),
                f"K1 stores vs plain carries at B={B2}: {st_err}")
        if B2 == CHAINS * CONDITIONS:  # the block design at the potential's
            blk = gains_fwd(*ins, T2, stores=True, design="block")
            torch.cuda.synchronize()
            k1_block_err = max(float((a - b).abs().max())
                               for a, b in zip(blk[:3], ref[:3]))
            require(k1_block_err <= GAINS_ATOL,
                    f"K1 block design vs plain at B={B2}: {k1_block_err}")
            k1_block_plain = cuda_ms(lambda: fused_gains_reference(
                sp, ins[-1], T2, stores=True), runs=1, launches=1)
            log(f"K1 block design vs plain at B={B2}, T={T2}: max abs err "
                f"{k1_block_err:.3e} (atol {GAINS_ATOL})")
            del blk
        cots = [0.3 * torch.randn(x.shape, generator=g2, device=dev)
                for x in out[:3]]
        A2, Bm2, _, R2, _, F2, VV2, WW2, _ = ins
        args = (A2, Bm2, R2, F2, VV2, WW2, *out[3:], *cots)
        got = fused_gains_vjp(*args)
        again = fused_gains_vjp(*args)
        want = fused_gains_vjp_reference(*args)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"K2: two launches differ at B={B2}")
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        rel = max(rel_err(a, b) for a, b in zip(got, want))
        log(f"K1 stores vs plain at B={B2}, T={T2}: max abs err {st_err:.3e};"
            f" K2 two launches the same bits; vs plain: max abs err "
            f"{err:.3e}, max err / max|plain| "
            f"{rel:.3e} (rtol {K2_RTOL}, atol {K2_ATOL} + {K2_SCALE} max|plain|);"
            f" max|plain| "
            f"{max(float(b.abs().max()) for b in want):.4g}")
        require(all(bool(torch.isfinite(a).all()) for a in got),
                "K2 not finite")
        require(all(within(a, b, K2_RTOL,
                           K2_ATOL + K2_SCALE * float(b.abs().max()))
                    for a, b in zip(got, want)), f"K2 vs plain at B={B2}")
        if k2_inputs is None:  # the potential's shape, timed in phase 12
            k2_inputs, k2_err = args, err
        else:
            k2_large = args

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
    require(st4[0].shape == (F4.shape[0], T_FIT + 1, 4, 4)
            and st4[1].shape == (F4.shape[0], T_FIT + 1, 4, LL_TRIALS),
            f"K3 stores: per-set layout expected, got "
            f"{[tuple(a.shape) for a in st4]}")
    got = conditioned_log_likelihood_vjp(*k4_args)
    again = conditioned_log_likelihood_vjp(*k4_args)
    want = conditioned_log_likelihood_vjp_reference(*k4_args)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            "K4: two launches differ")
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

    for fn in all_counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pot, grad = value_and_grad(pmodel, u)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    grad_launches = {k: fn.launches for k, fn in zip(all_names, all_counters)}
    grad_design = fused_gains.design
    log(f"gradient path: {CHAINS} chains x {CONDITIONS} conditions x "
        f"{LL_TRIALS} trials at T={T_FIT}, D={u.shape[-1]}: value+grad in "
        f"{grad_s:.3f} s (first call, host clock); launches {grad_launches} "
        f"(K1 in its {grad_design} design)")
    require(grad_launches == {k: int(not k.startswith("ll_blocked"))
                              for k in all_names},
            f"gradient path: K1-K4 and the joint kernels once each, got "
            f"{grad_launches}")
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
    wall, busy, n_events, named = profile_ms(grad_path, profiled)
    k2_in_path = named["gains_bwd"] if n_events else None
    if n_events:
        log(f"gradient path under torch.profiler: wall {wall:.2f} ms, device "
            f"busy {busy:.3f} ms ({100 * busy / wall:.2f}% of wall) over "
            f"{n_events} device events; "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in named.items())
            + f"; the other {n_events - len(named)} ops "
            f"{busy - sum(named.values()):.3f} ms")
    else:
        log("gradient path under torch.profiler: no device events recorded; "
            "device busy share not measured")
    log(f"[{card}] gradient path repeated: "
        f"{smi_text(smi_during(grad_path))}")

    # free the gradient path's graph before the delay phases
    del pmodel, model64, pot, grad, pot64, grad64, joint, sets
    torch.cuda.empty_cache()

    def scaled_err(a, b):
        """max |a - b| over max |b|."""
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-6))

    def blocked_against_plain(F_, Q_, X_, what):
        """K5 (both variants), its stores and K6 against their plain
        versions at every cluster size, K5 the same bits at every size and
        two K6 launches the same bits; returns K5's and K6's max abs errors
        (over the sizes) and K6's inputs."""
        ref = conditioned_log_likelihood_blocked_reference(F_, Q_, X_,
                                                           stores=True)
        w_ = torch.randn(ref[0].shape, generator=g2, device=dev)
        first, err5, err6 = None, 0.0, 0.0
        for C in kb.CLUSTERS:
            out = ll_blocked_fwd(F_, Q_, X_, stores=True, cluster=C)
            ll_free = ll_blocked_fwd(F_, Q_, X_, cluster=C)
            torch.cuda.synchronize()
            e5 = float((out[0] - ref[0]).abs().max())
            st = [scaled_err(a, b) for a, b in zip(out[1:], ref[1:])]
            require(bool(torch.isfinite(out[0]).all()),
                    f"K5 not finite, {what}, C={C}")
            require(within(out[0], ref[0], BLK_RTOL, BLK_ATOL),
                    f"K5 vs plain, {what}, C={C}: {e5}")
            require(bool((ll_free == out[0]).all()),
                    f"K5 store-free and stores variants differ, {what}, "
                    f"C={C}")
            require(max(st) <= BLK_SCALED,
                    f"K5 stores vs plain, {what}, C={C}: {st}")
            first = first or out
            require(all(torch.equal(a, b) for a, b in zip(out, first)),
                    f"K5 at C={C} is not the bits of C=1, {what}")
            args = (F_, X_, w_, *out[1:])
            got = conditioned_log_likelihood_blocked_vjp(*args, cluster=C)
            again = conditioned_log_likelihood_blocked_vjp(*args, cluster=C)
            want = conditioned_log_likelihood_blocked_vjp_reference(*args)
            torch.cuda.synchronize()
            require(all(torch.equal(a, b) for a, b in zip(got, again)),
                    f"K6: two launches differ, {what}, C={C}")
            e6 = max(float((a - b).abs().max()) for a, b in zip(got, want))
            sc = [scaled_err(a, b) for a, b in zip(got, want)]
            log(f"K5 vs plain, {what}, C={C}: max abs err {e5:.3e} of |ll| ~ "
                f"{float(ref[0].abs().mean()):.1f} (rtol {BLK_RTOL}, atol "
                f"{BLK_ATOL}); stores err / max|plain| Sig {st[0]:.3e}, MU "
                f"{st[1]:.3e}; K6 vs plain err / max|plain| "
                + ", ".join(f"{k} {e:.3e} (max {float(b.abs().max()):.4g})"
                            for k, e, b in zip(("Fbar", "Qbar", "Xbar"), sc,
                                               want))
                + f" (all within {BLK_SCALED})")
            require(all(bool(torch.isfinite(a).all()) for a in got),
                    f"K6 not finite, {what}, C={C}")
            require(max(sc) <= BLK_SCALED, f"K6 vs plain, {what}, C={C}: {sc}")
            err5, err6 = max(err5, e5), max(err6, e6)
        log(f"K5 the same bits at C = {kb.CLUSTERS}, two K6 launches the same "
            f"bits at each, {what}")
        return err5, err6, (F_, X_, w_, *first[1:])

    # 8. K5, its stores and K6 against their plain versions: the delay
    # fit's 24 parameter sets and its simulated data (phase 10 makes both)
    sigma_targets = [3.0 + 5.0 * c for c in range(CONDITIONS)]
    x_delay = torch.stack([
        DelayedSubjectiveActor(T=T_FIT, sigma_target=st_, device=dev).simulate(
            g2, n=LL_TRIALS)[..., :2] for st_ in sigma_targets])
    sets = DelayedSubjectiveActor(
        T=T_FIT, device=dev,
        sigma_target=torch.tensor(sigma_targets * CHAINS, device=dev),
        c=torch.tensor([0.25 * (1 + k) for k in range(CHAINS)
                        for _ in range(CONDITIONS)], device=dev))
    joint = sets._joint()
    F5, Q5 = (torch.movedim(M, 0, 1).contiguous()
              for M in (joint.F, joint.G @ mT(joint.G)))
    X5 = x_delay.repeat(CHAINS, 1, 1, 1)  # (24, 20, T+1, 2)
    del joint, sets
    J5 = F5.shape[-1]
    k5_err, k6_err, k6_args = blocked_against_plain(
        F5, Q5, X5, f"P={F5.shape[0]}, n={LL_TRIALS}, T={T_FIT}, j={J5}, d=2")
    # the edge of the scope: j = 120, d = 4
    Fe, Qe, Xe = [], [], []
    for k in range(EDGE_SETS):
        m = TemporalDelayModel(
            SubjectiveActor(dim=2, T=EDGE_T, sigma_target=4.0 + 3.0 * k,
                            device=dev), delay=EDGE_DELAY)
        joint = m._joint()
        Fe.append(joint.F)
        Qe.append(joint.G @ mT(joint.G))
        Xe.append(m.simulate(g2, n=LL_TRIALS)[..., :4])
    Fe, Qe, Xe = torch.stack(Fe), torch.stack(Qe), torch.stack(Xe)
    blocked_against_plain(
        Fe, Qe, Xe, f"P={EDGE_SETS}, n={LL_TRIALS}, T={EDGE_T}, "
        f"j={Fe.shape[-1]}, d=4")
    del Fe, Qe, Xe, joint, m
    torch.cuda.empty_cache()

    # the scans of the n=39 gains make no host synchronization: one short
    # scan under the sync debug mode, after a warm-up call
    sm = DelayedSubjectiveActor(T=8, device=dev)
    S0_scan = sm._default_Sigma0()
    for debug in ("default", "error"):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode(debug)
        try:
            gains8 = riccati.backward(sm.actor, horizon=8)
            K8 = kalman.forward(sm.actor, Sigma0=S0_scan, horizon=8)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    require(gains8.L.shape[-1] == 39 and bool(torch.isfinite(gains8.L).all()
                                             and torch.isfinite(K8).all()),
            "n=39 scan: gains not finite")
    log(f"n=39 gains scan (T=8, L {tuple(gains8.L.shape)}, K "
        f"{tuple(K8.shape)}) under set_sync_debug_mode('error'): no host "
        f"synchronization")

    # 9. the forward delay path, through the entry points a user calls
    conditioned_log_likelihood_blocked.launches = 0
    conditioned_log_likelihood_blocked.cluster = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dmodel = DelayedSubjectiveActor(T=T_FIT, device=dev)
    xd = dmodel.simulate(torch.Generator(device=dev).manual_seed(3),
                         n=LL_TRIALS)[..., :2]
    ll_d = dmodel.log_likelihood(xd, method="auto")
    torch.cuda.synchronize()
    delay_s = time.perf_counter() - t0
    delay_launches = {
        "ll_blocked_fwd": conditioned_log_likelihood_blocked.launches}
    delay_cluster = conditioned_log_likelihood_blocked.cluster
    log(f"forward delay path: DelayedSubjectiveActor simulate(n={LL_TRIALS}) "
        f"+ log_likelihood at T={T_FIT} in {delay_s:.3f} s (first call, host "
        f"clock); launches {delay_launches}, K5 on clusters of "
        f"{delay_cluster} blocks")
    require(delay_launches["ll_blocked_fwd"] > 0,
            f"forward delay path bypassed K5: {delay_launches}")
    require(xd.shape == (LL_TRIALS, T_FIT + 1, 2)
            and ll_d.shape == (LL_TRIALS,), "forward delay path: wrong shapes")
    require(bool(torch.isfinite(xd).all() and torch.isfinite(ll_d).all()),
            "forward delay path: values not finite")
    ll_d64 = DelayedSubjectiveActor(
        T=T_FIT, device=dev, dtype=torch.float64).log_likelihood(
            xd.double(), method="scan")
    d_err = float((ll_d.double() - ll_d64).abs().max())
    d_rel = float(((ll_d.double() - ll_d64) / ll_d64).abs().max())
    require(within(ll_d.double(), ll_d64, BLK_RTOL, BLK_ATOL),
            f"forward delay path vs float64 scan: {d_err}")
    log(f"forward delay path vs float64 scan on the card: max abs err "
        f"{d_err:.3e}, max rel err {d_rel:.3e} of |ll| ~ "
        f"{float(ll_d64.abs().mean()):.1f} (rtol {BLK_RTOL}, atol {BLK_ATOL})")

    def delay_path():
        dmodel.log_likelihood(dmodel.simulate(g, n=LL_TRIALS)[..., :2])

    log(f"forward delay path warm, host clock: "
        f"{host_ms(delay_path, 1) / 1e3:.4f} s (one call)")
    wall, busy, n_events, named = profile_ms(delay_path, ("ll_blocked_fwd",))
    if n_events:
        log(f"forward delay path under torch.profiler: wall {wall:.1f} ms, "
            f"device busy {busy:.2f} ms ({100 * busy / wall:.2f}% of wall) "
            f"over {n_events} device events; ll_blocked_fwd "
            f"{named['ll_blocked_fwd']:.3f} ms")
    else:
        log("forward delay path under torch.profiler: no device events "
            "recorded; device busy share not measured")

    # 10. the gradient delay path, through the entry points a user calls
    dpm = shared_params_lqg_model(x_delay, DelayedSubjectiveActor,
                                  shared_params=DELAY_SHARED)
    u0 = dpm.init_unconstrained()
    ud = (u0 + 0.1 * torch.randn((CHAINS,) + u0.shape, generator=g2,
                                 device=dev)).requires_grad_()
    for fn in all_counters:
        fn.launches = 0
    conditioned_log_likelihood_blocked.cluster = None
    conditioned_log_likelihood_blocked_vjp.cluster = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pot, grad = value_and_grad(dpm, ud)
    torch.cuda.synchronize()
    dgrad_s = time.perf_counter() - t0
    dgrad_launches = {k: fn.launches for k, fn in zip(all_names, all_counters)}
    dgrad_cluster = {"ll_blocked_fwd": conditioned_log_likelihood_blocked.cluster,
                     "ll_blocked_bwd":
                         conditioned_log_likelihood_blocked_vjp.cluster}
    log(f"gradient delay path: {CHAINS} chains x {CONDITIONS} conditions x "
        f"{LL_TRIALS} trials at T={T_FIT}, D={ud.shape[-1]}: value+grad in "
        f"{dgrad_s:.3f} s (first call, host clock); launches {dgrad_launches}"
        f"; cluster sizes {dgrad_cluster}")
    require(dgrad_launches["ll_blocked_fwd"] == 1
            and dgrad_launches["ll_blocked_bwd"] == 1
            and not any(dgrad_launches[k] for k in profiled),
            f"gradient delay path: K5 and K6 once each, the scans for the "
            f"gains and the old joint assembly (j > 12), got "
            f"{dgrad_launches}")
    require(pot.shape == (CHAINS,) and grad.shape == ud.shape,
            "gradient delay path: wrong shapes")
    require(bool(torch.isfinite(pot).all() and torch.isfinite(grad).all()),
            "gradient delay path: values not finite")
    dpm64 = shared_params_lqg_model(x_delay.double(), DelayedSubjectiveActor,
                                    shared_params=DELAY_SHARED)
    pot64, grad64 = value_and_grad(dpm64,
                                   ud.detach().double().requires_grad_())
    del dpm64
    pot, pot64 = pot.detach(), pot64.detach()
    pot_err = float(((pot.double() - pot64) / pot64).abs().max())
    gmax = float(grad64.abs().max())
    grad_rel = (grad.double() - grad64).abs() / grad64.abs()
    grad_scaled = float((grad.double() - grad64).abs().max()) / gmax
    log(f"gradient delay path vs float64 scan on the card: value rel err "
        f"{pot_err:.3e} (rtol {DELAY_POT_RTOL}) of |U| ~ "
        f"{float(pot64.abs().mean()):.1f}; gradient rel err max "
        f"{float(grad_rel.max()):.3e}, median {float(grad_rel.median()):.3e};"
        f" max abs err / max|grad| {grad_scaled:.3e} (each component within "
        f"{DELAY_GRAD_RTOL} of itself + {DELAY_GRAD_SCALED} of the largest); "
        f"|grad| from {float(grad64.abs().min()):.4g} to {gmax:.4g}")
    require(within(pot.double(), pot64, DELAY_POT_RTOL, 0.0),
            f"gradient delay path value vs float64: {pot_err}")
    require(within(grad.double(), grad64, DELAY_GRAD_RTOL,
                   DELAY_GRAD_SCALED * gmax),
            f"gradient delay path gradient vs float64: rel "
            f"{float(grad_rel.max())}, scaled {grad_scaled}")

    def delay_grad_path():
        value_and_grad(dpm, ud)

    without_sync(delay_grad_path)
    log("gradient delay path: one value+grad under set_sync_debug_mode("
        "'error'): no copy from host memory, no host synchronization")

    log(f"gradient delay path warm, host clock: "
        f"{host_ms(delay_grad_path, 1) / 1e3:.4f} s (one call)")
    wall, busy, n_events, named = profile_ms(
        delay_grad_path, ("ll_blocked_fwd", "ll_blocked_bwd"))
    if n_events:
        log(f"gradient delay path under torch.profiler: wall {wall:.1f} ms, "
            f"device busy {busy:.2f} ms ({100 * busy / wall:.2f}% of wall) "
            f"over {n_events} device events; "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in named.items()))
    else:
        log("gradient delay path under torch.profiler: no device events "
            "recorded; device busy share not measured")
    del dpm, pot, grad, pot64, grad64
    torch.cuda.empty_cache()

    # 11. the (3, 1, 2) and (5, 2) instances, through SubjectiveActor
    P3 = CHAINS * CONDITIONS
    svn = torch.linspace(0.3, 4.0, P3, device=dev)
    subj = SubjectiveActor(T=T, subj_vel_noise=svn, device=dev)
    sp3 = subj.actor
    VV3 = sp3.V @ mT(sp3.V)
    ins3 = [x.expand((P3,) + x.shape[-2:]).contiguous() for x in (
        sp3.A, sp3.B, sp3.Q, sp3.R, sp3.Qf, sp3.F, VV3, sp3.W @ mT(sp3.W),
        VV3)]
    out = gains_fwd(*ins3, T, stores=True)
    ref = fused_gains_reference(sp3, ins3[-1], T, stores=True)
    torch.cuda.synchronize()
    i1_err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    require(all(within(a, b, 0.0, GAINS_ATOL)
                for a, b in zip(out[:3], ref[:3]))
            and all(within(a, b, K2_RTOL, K2_ATOL)
                    for a, b in zip(out[3:], ref[3:])),
            f"K1 (3, 1, 2) vs plain: {i1_err}")
    cots = [0.3 * torch.randn(x.shape, generator=g2, device=dev)
            for x in out[:3]]
    A3, Bm3, _, R3, _, F3, VV3, WW3, _ = ins3
    args = (A3, Bm3, R3, F3, VV3, WW3, *out[3:], *cots)
    got = fused_gains_vjp(*args)
    want = fused_gains_vjp_reference(*args)
    torch.cuda.synchronize()
    i2_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    require(all(within(a, b, K2_RTOL,
                       K2_ATOL + K2_SCALE * float(b.abs().max()))
                for a, b in zip(got, want)), f"K2 (3, 1, 2) vs plain: {i2_err}")
    joint = subj._joint()
    F3j, Q3j = (torch.movedim(M, 0, 1).contiguous()
                for M in (joint.F, joint.G @ mT(joint.G)))
    xs = SubjectiveActor(T=T, device=dev).simulate(g2, n=LL_TRIALS)
    X3 = xs.expand(P3, *xs.shape).contiguous()
    ll3, *st3 = ll_fwd(F3j, Q3j, X3, stores=True)
    ll3_ref, *st3_ref = conditioned_log_likelihood_reference(F3j, Q3j, X3,
                                                             stores=True)
    torch.cuda.synchronize()
    i3_err = float((ll3 - ll3_ref).abs().max())
    require(within(ll3, ll3_ref, LL_RTOL, LL_ATOL)
            and all(within(a, b, LL_RTOL, LL_ATOL)
                    for a, b in zip(st3, st3_ref)),
            f"K3 (5, 2) vs plain: {i3_err}")
    args = (F3j, X3, torch.randn(ll3.shape, generator=g2, device=dev), *st3)
    got = conditioned_log_likelihood_vjp(*args)
    want = conditioned_log_likelihood_vjp_reference(*args)
    torch.cuda.synchronize()
    i4_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    require(all(within(a, b, K4_RTOL, atol + K2_SCALE * float(b.abs().max()))
                for a, b, atol in zip(got, want, (K4_FQ_ATOL, K4_FQ_ATOL,
                                                  K4_X_ATOL))),
            f"K4 (5, 2) vs plain: {i4_err}")
    k4_inst_ms = cuda_ms(lambda: conditioned_log_likelihood_vjp(*args))
    k3_inst_ms = cuda_ms(lambda: ll_fwd(F3j, Q3j, X3))
    k3_inst_stores_ms = cuda_ms(lambda: ll_fwd(F3j, Q3j, X3, stores=True))
    inst_bounds = (bound(ll_work(P3, LL_TRIALS, 5, 2, T)),
                   bound(ll_work(P3, LL_TRIALS, 5, 2, T, stores=True)),
                   bound(ll_bwd_work(P3, LL_TRIALS, 5, 2, T)))
    for fn in all_counters:
        fn.launches = 0
    svn_leaf = svn.clone().requires_grad_()
    ll_s = SubjectiveActor(T=T, subj_vel_noise=svn_leaf,
                           device=dev).log_likelihood(xs)
    (g_s,) = torch.autograd.grad(ll_s.sum(), svn_leaf)
    torch.cuda.synchronize()
    inst_launches = {k: fn.launches for k, fn in zip(all_names, all_counters)}
    require(all(inst_launches[k] == 1 for k in profiled)
            and bool(torch.isfinite(g_s).all()),
            f"SubjectiveActor value+grad: K1-K4 and the joint kernels once "
            f"each, got {inst_launches}")
    log(f"instances through SubjectiveActor at P={P3}, n={LL_TRIALS}, T={T}: "
        f"max abs err vs plain K1 (3, 1, 2) {i1_err:.3e}, K2 {i2_err:.3e}, "
        f"K3 (5, 2) {i3_err:.3e}, K4 {i4_err:.3e}; value+grad launches "
        f"{inst_launches}")
    log(f"[{card}] (5, 2) at P={P3} n={LL_TRIALS} T={T}: K3 {k3_inst_ms:.4f} "
        f"ms (bound {inst_bounds[0][0]:.5f}, {inst_bounds[0][1]}), with the "
        f"stores {k3_inst_stores_ms:.4f} ms (bound {inst_bounds[1][0]:.5f}, "
        f"{inst_bounds[1][1]}), K4 {k4_inst_ms:.4f} ms (bound "
        f"{inst_bounds[2][0]:.5f}, {inst_bounds[2][1]})")
    del out, ref, got, want, args, st3, st3_ref, joint
    torch.cuda.empty_cache()

    # 12. times
    # each kernel timed through its launching function on prepared inputs
    # (the public wrappers add host work: K1's is host-bound at this shape)
    k1_ms = cuda_ms(lambda: gains_fwd(*k1_ins, T, design="thread"))
    k1_wrapper_ms = cuda_ms(lambda: fused_gains(spec, S0, T))
    k1_plain = cuda_ms(lambda: fused_gains_reference(spec, S0, T),
                       launches=3)
    k3_ms = cuda_ms(lambda: ll_fwd(F, Q, X))
    k3_stores_ms = cuda_ms(lambda: ll_fwd(F, Q, X, stores=True))
    k3_plain = cuda_ms(
        lambda: conditioned_log_likelihood_reference(F, Q, X), runs=1,
        launches=1)
    k1_bound, k1_by = bound(gains_work(B, 2, 1, 2))
    k3_bound, k3_by = bound(ll_work(LL_SETS, LL_TRIALS, 4, 2, T))
    k3_st_bound, k3_st_by = bound(ll_work(LL_SETS, LL_TRIALS, 4, 2, T,
                                          stores=True))
    k2_ms = cuda_ms(lambda: fused_gains_vjp(*k2_inputs))
    k2_large_ms = cuda_ms(lambda: fused_gains_vjp(*k2_large))
    k2_smi = smi_during(lambda: [fused_gains_vjp(*k2_inputs)
                                 for _ in range(20)])
    # K2's own device time, from the profiler over 20 launches: at 24 specs
    # the kernel is shorter than the wrapper's host work per call, which
    # then sets the CUDA events' time
    k2_device = [kernel_device_ms(
        lambda: [fused_gains_vjp(*a) for _ in range(20)], "gains_bwd")
        for a in (k2_inputs, k2_large)]
    k2_plain = cuda_ms(lambda: fused_gains_vjp_reference(*k2_inputs), runs=1,
                       launches=1)
    k4_ms = cuda_ms(lambda: conditioned_log_likelihood_vjp(*k4_args))
    k4_plain = cuda_ms(
        lambda: conditioned_log_likelihood_vjp_reference(*k4_args), runs=1,
        launches=1)
    k2_bound, k2_by = bound(gains_bwd_work(CHAINS * CONDITIONS, 2, 1, 2,
                                           T_FIT))
    k2_large_shape = tuple(k2_large[6].shape[:2])  # (T, B)
    k2_large_bound, k2_large_by = bound(gains_bwd_work(
        k2_large_shape[1], 2, 1, 2, k2_large_shape[0]))
    k4_bound, k4_by = bound(ll_bwd_work(F4.shape[0], LL_TRIALS, 4, 2,
                                        T_FIT))
    P5 = F5.shape[0]
    k5_stores_ms = cuda_ms(lambda: ll_blocked_fwd(F5, Q5, X5, stores=True),
                           runs=5, launches=5)
    k5_plain = cuda_ms(
        lambda: conditioned_log_likelihood_blocked_reference(F5, Q5, X5),
        runs=1, launches=1)
    k6_plain = cuda_ms(
        lambda: conditioned_log_likelihood_blocked_vjp_reference(*k6_args),
        runs=1, launches=1)
    k5_work = ll_blocked_work(P5, LL_TRIALS, J5, 2, T_FIT)
    k6_work = ll_blocked_bwd_work(P5, LL_TRIALS, J5, 2, T_FIT)
    k5_bound, k5_by = bound(k5_work)
    k6_bound, k6_by = bound(k6_work)
    # K5 (store-free) and K6 at the gradient path's 24 sets and the forward
    # path's one set: one block a set (C=1) against the wrapper's cluster
    # size, in turns
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocked_ms, picked = {}, {}
    for name, fn, counter, kernel_id, work_fn, args in (
            ("K5 ll_blocked_fwd", ll_blocked_fwd,
             conditioned_log_likelihood_blocked, 0, ll_blocked_work,
             (F5, Q5, X5)),
            ("K6 ll_blocked_bwd", conditioned_log_likelihood_blocked_vjp,
             conditioned_log_likelihood_blocked_vjp, 2, ll_blocked_bwd_work,
             k6_args)):
        for P_ in (P5, 1):
            a = tuple(x[:P_] for x in args)
            fn(*a)
            C = picked[(name, P_)] = counter.cluster
            plan = kb.bwd_plan if kernel_id == 2 else kb.fwd_plan
            active = kb.max_active_clusters(
                kernel_id, 2, C, kb.MAX_THREADS,
                plan(J5, 2, LL_TRIALS, C)[1] * 4)
            t1, tc = paired_ms(lambda: fn(*a, cluster=1),
                               lambda: fn(*a, cluster=C))
            nbytes, ops = work_fn(P_, LL_TRIALS, J5, 2, T_FIT)
            whole, by = bound((nbytes, ops))

            def on(used):  # the bound on the SMs used
                return max(nbytes / HBM_BYTES_PER_S,
                           ops / (FP32_FLOPS_PER_S * used / sms)) * 1e3

            blocked_ms[(name, P_, 1)], blocked_ms[(name, P_, C)] = t1, tc
            log(f"[{card}] {name} P={P_} n={LL_TRIALS} T={T_FIT} j={J5}: "
                f"C=1 {t1:.4f} ms on {P_} SMs ({ops / t1 / 1e9:.3f} TFLOP/s, "
                f"bound on those SMs {on(P_):.4f} ms); C={C} {tc:.4f} ms on "
                f"{P_ * C} SMs ({ops / tc / 1e9:.3f} TFLOP/s, bound on those "
                f"SMs {on(P_ * C):.4f} ms); C=1 / C={C} {t1 / tc:.3f}; whole "
                f"card bound {whole:.4f} ms ({by}; {nbytes / 1e6:.1f} MB, "
                f"{ops / 1e9:.3f} GFLOP); {active} clusters of {C} at once")
    k5_C = picked[("K5 ll_blocked_fwd", P5)]
    k6_C = picked[("K6 ll_blocked_bwd", P5)]
    k5_ms = blocked_ms[("K5 ll_blocked_fwd", P5, k5_C)]
    k6_ms = blocked_ms[("K6 ll_blocked_bwd", P5, k6_C)]
    log(f"[{card}] K1 gains_fwd B={B} T={T}: {k1_ms:.4f} ms "
        f"({B / (k1_ms / 1e3):.1f} solves/s); through fused_gains "
        f"{k1_wrapper_ms:.4f} ms; plain {k1_plain:.2f} ms; bound "
        f"{k1_bound:.4f} ms ({k1_by})")
    log(f"[{card}] K3 ll_fwd P={LL_SETS} n={LL_TRIALS} T={T}: {k3_ms:.4f} ms;"
        f" plain {k3_plain:.2f} ms; bound {k3_bound:.5f} ms ({k3_by}); with "
        f"the stores {k3_stores_ms:.4f} ms, bound {k3_st_bound:.5f} ms "
        f"({k3_st_by})")
    log(f"[{card}] K2 gains_bwd B={CHAINS * CONDITIONS} T={T_FIT}: "
        f"{k2_ms:.4f} ms; plain {k2_plain:.2f} ms; bound {k2_bound:.6f} ms "
        f"({k2_by}); launches per value+grad {grad_launches['gains_bwd']}; "
        f"B={k2_large_shape[1]} T={k2_large_shape[0]}: {k2_large_ms:.4f} ms, "
        f"bound {k2_large_bound:.6f} ms ({k2_large_by}); device time a launch "
        f"(torch.profiler, mean over the K2 kernels recorded of 20 launches): "
        + ", ".join("not measured" if v is None else f"{v:.4f} ms ({c} kernels)"
                    for v, c in k2_device)
        + "; in the gradient path "
        + ("not measured" if k2_in_path is None else f"{k2_in_path:.4f} ms"))
    log(f"[{card}] K2 repeated (20 launches a call): {smi_text(k2_smi)}")
    log(f"[{card}] K4 ll_bwd P={F4.shape[0]} n={LL_TRIALS} T={T_FIT}: "
        f"{k4_ms:.4f} ms; plain "
        f"{k4_plain:.2f} ms; bound {k4_bound:.5f} ms ({k4_by}); launches per "
        f"value+grad {grad_launches['ll_bwd']}")

    log(f"[{card}] K5 ll_blocked_fwd P={P5} n={LL_TRIALS} T={T_FIT} j={J5}: "
        f"{k5_ms:.4f} ms at C={k5_C} ({k5_work[1] / k5_ms / 1e9:.3f} TFLOP/s);"
        f" with the stores {k5_stores_ms:.4f} ms; plain "
        f"{k5_plain:.2f} ms; bound {k5_bound:.4f} ms ({k5_by}; "
        f"{k5_work[0] / 1e6:.1f} MB, {k5_work[1] / 1e9:.2f} GFLOP); launches "
        f"on the forward delay path {delay_launches['ll_blocked_fwd']} (C="
        f"{delay_cluster})")
    log(f"[{card}] K6 ll_blocked_bwd P={P5} n={LL_TRIALS} T={T_FIT} j={J5}: "
        f"{k6_ms:.4f} ms at C={k6_C} ({k6_work[1] / k6_ms / 1e9:.3f} TFLOP/s);"
        f" plain {k6_plain:.2f} ms; bound {k6_bound:.4f} ms ({k6_by}; "
        f"{k6_work[0] / 1e6:.1f} MB, {k6_work[1] / 1e9:.2f} GFLOP); launches "
        f"per value+grad {dgrad_launches['ll_blocked_bwd']} (C="
        f"{dgrad_cluster['ll_blocked_bwd']})")
    by_shape = {k: {f"P={P_} C={C}": v for (n_, P_, C), v in
                    blocked_ms.items() if n_ == k}
                for k in ("K5 ll_blocked_fwd", "K6 ll_blocked_bwd")}

    # 13. the potential's value+grad replayed from a CUDA graph:
    # scripts/recover.py's shape and phase 7's fit
    truth = sample_from_prior(BoundedActor, RECOVER_SEED, device=dev)
    x_rec = BoundedActor(T=RECOVER_T, device=dev, **truth).simulate(
        torch.Generator(device=dev).manual_seed(RECOVER_SEED),
        n=RECOVER_TRIALS)
    replay_ms = {}
    for what, pm in (
            (f"recover: lifted_model, {RECOVER_TRIALS} trials at "
             f"T={RECOVER_T}", lifted_model(x_rec, BoundedActor)),
            (f"fit: {CONDITIONS} conditions x {LL_TRIALS} trials at "
             f"T={T_FIT}", shared_params_lqg_model(x_fit, BoundedActor,
                                                  shared_params=SHARED))):
        u0 = pm.init_unconstrained()
        u = u0 + 0.1 * torch.randn((CHAINS,) + u0.shape, generator=g2,
                                   device=dev)
        eager = eager_value_and_grad(pm.potential)
        eager(u)
        without_sync(lambda: eager(u))
        t0 = time.perf_counter()
        graphed = GraphedValueAndGrad(pm.potential, u)
        built_s = time.perf_counter() - t0
        errs = []
        for k in range(3):
            uk = u + 0.05 * k * torch.randn(u.shape, generator=g2, device=dev)
            (pe_g, grad_g), (pe_e, grad_e) = graphed(uk), eager(uk)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(pe_g).all()
                         and torch.isfinite(grad_g).all()),
                    f"graph replay, {what}: values not finite")
            require(within(pe_g, pe_e, POT_RTOL, 0.0)
                    and within(grad_g, grad_e, POT_GRAD_RTOL,
                               1e-6 * float(grad_e.abs().max())),
                    f"graph replay vs eager, {what}, point {k}")
            errs.append((float(((pe_g - pe_e) / pe_e).abs().max()),
                         float(((grad_g - grad_e).abs()
                                / grad_e.abs()).max())))

        eager_wall = host_ms(lambda: eager(u), 7)
        replay_wall = host_ms(lambda: graphed(u), 20)
        replay_events = cuda_ms(lambda: graphed(u))
        replay_ms[what.split(":")[0]] = replay_events
        wall, busy, n_events, named = profile_ms(lambda: graphed(u),
                                                 profiled)
        # three replays a profiled session, the most of three sessions: a
        # replay runs every node of its graph, and the profiler now and then
        # drops a kernel's record
        seen = kernel_counts(lambda: [graphed(u) for _ in range(3)],
                             profiled)
        require(all(v >= 1 for v in seen.values()),
                f"graph replay, {what}: kernels in 3 replays {seen}")
        log(f"[{card}] graph, {what}, {CHAINS} chains, D={u.shape[-1]}: "
            f"capture {graphed.capture_s:.3f} s, instantiate "
            f"{graphed.instantiate_s:.3f} s (with the warm-up {built_s:.3f} "
            f"s); replay {replay_wall:.3f} ms host wall (median of 20), "
            f"{replay_events:.4f} ms CUDA events; eager {eager_wall:.3f} ms "
            f"(median of 7); a replay under torch.profiler: wall "
            f"{wall:.3f} ms, device busy {busy:.3f} ms "
            f"({100 * busy / wall:.2f}%) over {n_events} events, "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in named.items())
            + f"; kernels in 3 replays {seen}; replay vs eager at 3 points: "
            f"value rel err max {max(e[0] for e in errs):.3e}, gradient "
            f"{max(e[1] for e in errs):.3e}; eager value+grad under "
            f"set_sync_debug_mode('error'): no copy, no synchronization")
        del graphed, eager, pm
    torch.cuda.empty_cache()

    # 14. the NUTS recovery, through the entry point a user calls
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mcmc = infer(x_rec, num_samples=RECOVER_SAMPLES,
                 num_warmup=RECOVER_WARMUP, model=BoundedActor,
                 num_chains=CHAINS, seed=RECOVER_SEED, progress_bar=False)
    torch.cuda.synchronize()
    nuts_s = time.perf_counter() - t0
    nuts_launches = {k: fn.launches for k, fn in zip(names, counters)}
    vg = mcmc.value_and_grad
    require(isinstance(vg, GraphedValueAndGrad) and vg.replays > 0,
            "NUTS: the leapfrogs did not replay the captured value+grad")
    require(all(v > 0 for v in nuts_launches.values()),
            f"NUTS bypassed a kernel: {nuts_launches}")
    samples = mcmc.get_samples(group_by_chain=True)
    extra = mcmc.get_extra_fields()
    rows, far = [], []
    for name, v in samples.items():
        v = v.double().numpy()
        require(bool(np.isfinite(v).all()), f"NUTS: {name} not finite")
        mean, sd = float(v.mean()), float(v.std(ddof=1))
        n_eff, rhat = ess(v), split_rhat(v)
        true = float(truth[name])
        rows.append(f"{name} true {true:.5g} posterior {mean:.5g} +- "
                    f"{sd:.3g} (ESS {n_eff:.1f}, {n_eff / nuts_s:.3f}/s; "
                    f"R-hat {rhat:.4f})")
        require(rhat < 1.1, f"NUTS: {name} R-hat {rhat}")
        if abs(mean - true) > RECOVER_SDS * sd:
            far.append(name)
    transitions = RECOVER_WARMUP + RECOVER_SAMPLES
    depth = extra["tree_depth"]
    log(f"[{card}] NUTS recovery, BoundedActor, {RECOVER_TRIALS} trials at "
        f"T={RECOVER_T}, {CHAINS} chains, max_depth=10, {RECOVER_WARMUP} "
        f"warmup + {RECOVER_SAMPLES} samples: {nuts_s:.2f} s with the "
        f"capture; {transitions / nuts_s:.3f} transitions/s "
        f"({CHAINS * transitions / nuts_s:.3f} chain draws/s); "
        f"{vg.replays} leapfrogs (replays), {vg.replays / nuts_s:.1f}/s, "
        f"{nuts_s * 1e3 / vg.replays:.3f} ms each; divergences "
        f"{mcmc.divergences}; kept draws' tree depth mean "
        f"{float(depth.mean()):.2f}, max {int(depth.max())}; step size "
        f"{[round(float(v), 4) for v in extra['step_size']]}; launches "
        f"(warm-up and capture) {nuts_launches}")
    for row in rows:
        log(f"  {row}")
    require(not far, f"NUTS: true {far} beyond {RECOVER_SDS} posterior sd")

    # one more transition from the last draws, profiled: its host time per
    # leapfrog against a replay's
    z_last = mcmc._samples_u[:, -1].to(dev)
    pe_last, grad_last = vg(z_last)
    step_draws = draw_nuts(torch.Generator(device=dev).manual_seed(1),
                           CHAINS, z_last.shape[-1], 10, z_last.dtype)
    before = vg.replays

    def transition():
        nuts_step(vg, step_draws, z_last, pe_last, grad_last,
                  extra["step_size"], extra["inv_mass"], max_depth=10)

    wall, busy, n_events, _ = profile_ms(transition, ())
    leaves = vg.replays - before
    log(f"[{card}] one NUTS transition under torch.profiler: {leaves} "
        f"leapfrogs, wall {wall:.3f} ms ({wall / leaves:.3f} ms a leapfrog "
        f"against {replay_ms['recover']:.4f} ms a replay alone, CUDA "
        f"events, phase 13), device busy {busy:.3f} ms "
        f"({100 * busy / wall:.2f}%) over {n_events} events")

    log(f"phases 1-14: {time.perf_counter() - t_start:.1f} s")
    # 15. the rest of the zoo, through the entry points a user calls
    zoo_launches = zoo_paths(dev, card, profiled, all_counters, all_names)
    log(f"phases 1-15: {time.perf_counter() - t_start:.1f} s")
    # 16. the zoo's instances of K1-K4 against their plain versions; K1's
    # block design against its thread design at the zoo's instances, the
    # crossover sweep of the two designs, and both timed beside their
    # bounds at the shapes the paths launch K1 at
    zoo_ms = zoo_instances(dev, card)
    t0 = time.perf_counter()
    k1_bits += k1_designs_bits(dev, card, K1_INSTANCES[3:])
    mhz = sm_clock_mhz()
    k1_cross = k1_crossover(dev, card,
                            instances=K1_INSTANCES + K1_SCOPE_SWEEP)
    k1_rows = k1_times(dev, card, mhz)
    log(f"K1 designs (bits, crossover, times): "
        f"{time.perf_counter() - t0:.1f} s")

    def zoo_rows(kernel, base):
        """The kernel's times at its base shape and at the zoo's, with each
        zoo shape's bound, error and plain time."""
        rows = zoo_ms[kernel]
        return ({**base, **{k: v[0] for k, v in rows.items()}},
                {k: {"bound_ms": v[1], "bound_by": v[2], "max_abs_err": v[3],
                     "plain_ms": v[4]} for k, v in rows.items()})

    k1_shapes = zoo_rows("gains_fwd", {f"(2, 1, 2) B={B} T={T}": k1_ms})

    def k1_design_rows(design):
        """One K1 design's times at K1's shapes (store-free, with the
        stores), with the bounds."""
        return ({k: {v: r[v][f"{design}_ms"] for v in ("free", "stores")}
                 for k, r in k1_rows.items()},
                {k: {v: {"bound_ms": r[v]["bound_ms"],
                         "bound_by": r[v]["bound_by"],
                         "chain_ms": r[v]["chain_ms"]}
                     for v in ("free", "stores")} for k, r in k1_rows.items()})

    k1_block_shape = f"{(2, 1, 2)} B={CHAINS * CONDITIONS} T={T_FIT}"
    k1_block = k1_rows[k1_block_shape]["stores"]
    crossover = {f"{nmp} B={B_} {'stores' if st else 'free'}": {
        "thread_ms": v[0], "block_ms": v[1], "auto": v[2]}
        for (nmp, B_, st), v in k1_cross.items()}
    k2_shapes = zoo_rows("gains_bwd", {
        f"(2, 1, 2) B={CHAINS * CONDITIONS} T={T_FIT}": k2_ms,
        f"(2, 1, 2) B={k2_large_shape[1]} T={k2_large_shape[0]}":
            k2_large_ms})
    k3_shapes = zoo_rows("ll_fwd", {
        f"(4, 2) P={LL_SETS} n={LL_TRIALS} T={T}": k3_ms,
        f"(5, 2) P={CHAINS * CONDITIONS} n={LL_TRIALS} T={T}": k3_inst_ms})
    k4_shapes = zoo_rows("ll_bwd", {
        f"(4, 2) P={F4.shape[0]} n={LL_TRIALS} T={T_FIT}": k4_ms,
        f"(5, 2) P={CHAINS * CONDITIONS} n={LL_TRIALS} T={T}": k4_inst_ms})
    kernels = [
        {"name": "gains_fwd", "route": "cuda",
         "source": "lqg_tpu_torch/csrc/gains.cu",
         "replaces": "lqg_tpu/ops/pallas/gains.py:149",
         "design": "thread", "launches": sweep_launches["thread"],
         "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None,
         "ms_by_shape": k1_shapes[0], "zoo_shapes": k1_shapes[1],
         "designs_ms_by_shape": k1_design_rows("thread")[0]},
        {"name": "gains_fwd_block", "route": "cuda",
         "source": "lqg_tpu_torch/csrc/gains.cu",
         "replaces": "lqg_tpu/ops/pallas/gains.py:149",
         "design": "block", "launches": launches["gains_fwd_block"],
         "launches_per_value_and_grad": grad_launches["gains_fwd"],
         "max_abs_err": k1_block_err, "ms": k1_block["block_ms"],
         "shape": k1_block_shape + " stores",
         "plain_ms": k1_block_plain, "bound_ms": k1_block["bound_ms"],
         "bound_by": k1_block["bound_by"], "chain_ms": k1_block["chain_ms"],
         "library_ms": None, "same_bits_as_thread": k1_bits,
         "ms_by_shape": k1_design_rows("block")[0],
         "bounds_by_shape": k1_design_rows("block")[1],
         "crossover": crossover},
        {"name": "ll_fwd", "route": "cuda",
         "source": "lqg_tpu_torch/csrc/likelihood.cu",
         "replaces": "lqg_tpu/ops/pallas/likelihood.py:160",
         "launches": launches["ll_fwd"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain, "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": None,
         "ms_by_shape": k3_shapes[0], "zoo_shapes": k3_shapes[1]},
        {"name": "gains_bwd", "route": "cuda",
         "source": "lqg_tpu_torch/csrc/gains.cu",
         "replaces": "lqg_tpu/ops/pallas/gains.py:237",
         "launches": grad_launches["gains_bwd"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None, "device_ms": k2_device[0][0],
         "in_path_ms": k2_in_path,
         "ms_by_shape": k2_shapes[0], "zoo_shapes": k2_shapes[1]},
        {"name": "ll_bwd", "route": "cuda",
         "source": "lqg_tpu_torch/csrc/likelihood.cu",
         "replaces": "lqg_tpu/ops/pallas/likelihood.py:270",
         "launches": grad_launches["ll_bwd"], "max_abs_err": k4_err,
         "ms": k4_ms, "plain_ms": k4_plain, "bound_ms": k4_bound,
         "bound_by": k4_by, "library_ms": None,
         "ms_by_shape": k4_shapes[0], "zoo_shapes": k4_shapes[1]},
        {"name": "ll_blocked_fwd", "route": "cuda",
         "source": "lqg_tpu_torch/csrc/likelihood_blocked.cu",
         "replaces": "lqg_tpu/ops/pallas/likelihood_blocked.py:163",
         "launches": delay_launches["ll_blocked_fwd"], "max_abs_err": k5_err,
         "ms": k5_ms, "plain_ms": k5_plain, "bound_ms": k5_bound,
         "bound_by": k5_by, "library_ms": None, "cluster": delay_cluster,
         "ms_by_shape": by_shape["K5 ll_blocked_fwd"]},
        {"name": "ll_blocked_bwd", "route": "cuda",
         "source": "lqg_tpu_torch/csrc/likelihood_blocked.cu",
         "replaces": "lqg_tpu/ops/pallas/likelihood_blocked.py:245",
         "launches": dgrad_launches["ll_blocked_bwd"], "max_abs_err": k6_err,
         "ms": k6_ms, "plain_ms": k6_plain, "bound_ms": k6_bound,
         "bound_by": k6_by, "library_ms": None,
         "cluster": dgrad_cluster["ll_blocked_bwd"],
         "ms_by_shape": by_shape["K6 ll_blocked_bwd"]},
    ]
    # 17. scripts/fit_data.py's pipeline: point estimation, the guides and
    # NeuTra NUTS, each step replaying a captured graph; K1-K4 at the
    # parameter sets it launches them at
    fit_ms = fit_batches(dev, card, x_fit)
    fit_launches, fit_times = fit_pipeline(dev, card, counters, names, x_fit)
    for entry in kernels:
        if entry["name"] in fit_launches:
            entry["fit_pipeline_launches"] = fit_launches[entry["name"]]
        rows = fit_ms.get(entry["name"])
        if rows:
            entry["fit_shapes"] = {k: {"ms": v[0], "bound_ms": v[1],
                                       "bound_by": v[2], "max_abs_err": v[3]}
                                   for k, v in rows.items()}
    log(f"fit pipeline ms a step (step; device busy a step, of a replay, of "
        f"Adam; alone a replay, Adam): {json.dumps(fit_times)}")
    # 18. the data and fit tools: the data file, scripts/torch_fit_data.py,
    # xcorr and the CCG fits, the sqrt and steady gains, profiling.timeit
    tool_launches, tool_readings = data_tools(dev, card, counters, names,
                                              replay_ms["fit"])
    for entry in kernels:
        if entry["name"] in tool_launches:
            entry["fit_script_launches"] = tool_launches[entry["name"]]
    log(f"data and fit tools (phase 18): {json.dumps(tool_readings)}")
    # 19. the parallel layer: pscan beside the kernels, ranks on the card
    par_launches, par_readings = parallel_layer(dev, card, counters, names,
                                                x_fit, x_rec)
    k_by_name = {"gains_fwd": "gains_fwd_block", "gains_bwd": "gains_bwd",
                 "ll_fwd": "ll_fwd", "ll_bwd": "ll_bwd"}
    for entry in kernels:
        for counter, name in k_by_name.items():
            if entry["name"] == name:
                entry["parallel_launches"] = {
                    path: n[counter] for path, n in par_launches.items()}
    log(f"parallel layer (phase 19): {json.dumps(par_readings)}")
    # 20. K1-K4 over lqg_tpu's whole kernel scope: the delay wrapper's
    # instances, the envelopes and the padded route, and the delay models'
    # gradient paths through the entry points
    t0 = time.perf_counter()
    scope_rows = scope_instances(dev, card, reports)
    scope_readings = scope_paths(dev, card, all_counters, all_names)
    on_path = {}  # (kernel, instance) -> launches a value+grad
    for r in scope_readings.values():
        for k, v in r["launches"].items():
            shape = r["gains"] if k.startswith("gains") else r["likelihood"]
            on_path[(k, shape)] = on_path.get((k, shape), 0) + v
    by_counter = {"gains_fwd_block": "gains_fwd"}
    for entry in kernels:
        if entry["name"] == "gains_fwd":  # the paths take the block design
            continue
        rows = scope_rows.get(entry["name"])
        if rows:
            counter = by_counter.get(entry["name"], entry["name"])
            for shape, row in rows.items():
                row["launches_on_scope_paths"] = on_path.get(
                    (counter, shape.split(" B=")[0].split(" P=")[0]), 0)
            entry["scope_shapes"] = rows
        entry["scope_path_launches"] = {
            path: r["launches"].get(by_counter.get(entry["name"],
                                                   entry["name"]), 0)
            for path, r in scope_readings.items()}
    log(f"scope paths (phase 20): {json.dumps(scope_readings)}")
    log(f"phase 20: {time.perf_counter() - t0:.1f} s")
    # 21. the joint-system kernels against the assembly they replace
    t0 = time.perf_counter()
    joint_rows = joint_kernels(dev, card)
    main_shape = f"BoundedActor (j=4) P=96 T={T_FIT}"
    for kernel, key, plain in (("joint_fwd", "fwd", "plain_fwd_ms"),
                               ("joint_bwd", "bwd", None)):
        main_row = joint_rows[main_shape]
        kernels.append({
            "name": kernel, "route": "cuda",
            "source": "lqg_tpu_torch/csrc/joint.cu",
            "replaces": "none (lqg_tpu/ops/gaussian.py:joint_system, fused "
                        "by XLA)",
            "launches_per_value_and_grad": grad_launches[kernel],
            "max_err_of_bound": main_row["max_err_of_bound"],
            "shape": main_shape, "ms": main_row[f"{key}_ms"],
            "plain_ms": main_row[plain] if plain else None,
            "bound_ms": main_row[f"{key}_bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "ms_by_shape": {k: r[f"{key}_ms"] for k, r in joint_rows.items()},
            "bounds_by_shape": {k: r[f"{key}_bound_ms"]
                                for k, r in joint_rows.items()},
            "fwd_bwd_ms_by_shape": {k: r["fwd_bwd_ms"]
                                    for k, r in joint_rows.items()},
            "plain_fwd_bwd_ms_by_shape": {k: r["plain_fwd_bwd_ms"]
                                          for k, r in joint_rows.items()}})
    log(f"phase 21: {time.perf_counter() - t0:.1f} s")
    log(f"zoo launches (phase 15): {json.dumps(zoo_launches)}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
