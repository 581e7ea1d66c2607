#!/usr/bin/env python3
"""K1's block design in each of its warp layouts against its thread design,
on one NVIDIA card.

Run from the root of a checkout: ``python scripts/k1_designs.py``.  It
builds ``lqg_tpu_torch/csrc/gains.cu`` once more with ``-DLQG_K1_LAYOUTS``,
which adds the entry ``lqg_gains_fwd_layout`` (the block design in a layout
given at run time), into ``lqg_tpu_torch/_build``, and then, at every
instance of ``ops/kernels/gains.py:INSTANCES``:

1. launches the block design in each of its four layouts (the Riccati warp
   and the Kalman warp each on one lane or spread over lanes), holds each
   against the thread design bit for bit, and times the five in turns
   (CUDA events) at B = 1, 4, 24 (T=1008) and 2,048 (T=719), store-free
   and with the stores;
2. runs ``chip_smoke.py``'s crossover sweep (both designs in turns at
   B in {1, 4, 24, 132, 264, 528, 1,056, 2,048, 16,384}, T=1000), the block
   design in the layout that was fastest at B=24 with the stores (the
   potential's launch).

It prints one line per measurement and writes everything as JSON to
``chiprun_out/k1_designs.json``.  The layouts it picks go into
``csrc/gains.cu:BlockLayout``, the crossover into
``ops/kernels/gains.py:THREAD_FROM``.
"""

import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from lqg_tpu_torch.ops.kernels import gains as kg  # noqa: E402
from lqg_tpu_torch.ops.kernels import nvcc  # noqa: E402

LAYOUTS = ((0, 0), (0, 1), (1, 0), (1, 1))  # (spread Riccati, spread Kalman)
SHAPES = ((1, 1008), (4, 1008), (24, 1008), (2048, 719))


def build_layout_lib():
    """gains.cu with -DLQG_K1_LAYOUTS, built with the port's flags beside
    the port's own build of it; prints both ``-Xptxas -v`` summaries."""
    os.makedirs(nvcc.BUILD_DIR, exist_ok=True)
    lib = os.path.join(nvcc.BUILD_DIR, "libgains_layouts.so")
    proc = subprocess.Popen(
        [nvcc._nvcc(), *nvcc.FLAGS, "-DLQG_K1_LAYOUTS", "-o", lib,
         os.path.join(nvcc.CSRC, "gains.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    report = nvcc.build_all(["gains"])["gains"]
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on gains.cu -DLQG_K1_LAYOUTS:\n{log}")
    for what, text in (("gains.cu", report), ("layouts", log)):
        for row in cs.ptxas_summary(text):
            print(f"  {what} {row}", flush=True)
    dll = ctypes.CDLL(lib)
    dll.lqg_gains_fwd_layout.argtypes = ([ctypes.c_void_p] * 14
                                         + [ctypes.c_int] * 5
                                         + [ctypes.c_float]
                                         + [ctypes.c_int] * 2
                                         + [ctypes.c_void_p])
    dll.lqg_gains_fwd_layout.restype = ctypes.c_int
    return dll


def layout_launch(dll, layout):
    """A launching function of the block design in ``layout``:
    (inputs, T, stores) -> outputs, as gains_fwd's."""

    def launch(ins, T, stores):
        n, m, p = ins[0].shape[-1], ins[1].shape[-1], ins[5].shape[-2]
        B, dev = ins[0].shape[0], ins[0].device
        new = lambda *s: torch.empty((T, B) + s, device=dev)
        out = (new(m, n), new(m, m), new(n, p))
        if stores:
            out += (new(n, n), new(n, n))
        st = [x.data_ptr() for x in out[3:]] if stores else [None, None]
        status = dll.lqg_gains_fwd_layout(
            *(x.data_ptr() for x in ins), *(x.data_ptr() for x in out[:3]),
            *st, n, m, p, B, T, kg.EPS, *layout,
            torch.cuda.current_stream(dev).cuda_stream)
        nvcc.check(status, f"gains_fwd layout {layout}")
        return out

    return launch


def turns_ms(fns, rounds=6, launches=5):
    """Medians over ``rounds`` of the mean time of ``launches`` calls of
    each function, timed in turns (the order rotating each round) from CUDA
    events, after one warm-up call of each."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for r in range(rounds):
        for k in [(r + i) % len(fns) for i in range(len(fns))]:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(launches):
                fns[k]()
            stop.record()
            stop.synchronize()
            times[k].append(start.elapsed_time(stop) / launches)
    return [statistics.median(t) for t in times]


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_designs: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = cs.card_line()
    print(card, flush=True)
    dll = build_layout_lib()
    launches = {lay: layout_launch(dll, lay) for lay in LAYOUTS}
    result = {"card": card, "layouts": {}, "best": {}, "crossover": {}}
    for nmp in cs.K1_INSTANCES:
        for B, T in SHAPES:
            ins = cs.k1_inputs(nmp, B, T, dev)[1]
            for stores in (False, True):
                ref = kg.gains_fwd(*ins, T, stores=stores, design="thread")
                for lay, fn in launches.items():
                    got = fn(ins, T, stores)
                    torch.cuda.synchronize()
                    cs.require(all(torch.equal(a, b)
                                   for a, b in zip(got, ref)),
                               f"{nmp} B={B} T={T} layout {lay}: not the "
                               f"thread design's bits")
                fns = [lambda: kg.gains_fwd(*ins, T, stores=stores,
                                            design="thread")]
                fns += [lambda fn=fn: fn(ins, T, stores)
                        for fn in launches.values()]
                ms = turns_ms(fns)
                key = f"{nmp} B={B} T={T} {'stores' if stores else 'free'}"
                result["layouts"][key] = dict(zip(
                    ["thread"] + [f"R{r}K{k}" for r, k in LAYOUTS], ms))
                print(f"[{card}] {key}: thread {ms[0]:.4f}; " + ", ".join(
                    f"R{r}K{k} {t:.4f}" for (r, k), t in zip(LAYOUTS, ms[1:]))
                    + " ms (R/K: 1 spread, 0 one lane); the same bits",
                    flush=True)
        row = result["layouts"][f"{nmp} B=24 T=1008 stores"]
        best = min(LAYOUTS, key=lambda lay: row[f"R{lay[0]}K{lay[1]}"])
        result["best"][str(nmp)] = best
        print(f"[{card}] {nmp}: fastest layout at B=24 with the stores "
              f"R{best[0]}K{best[1]}", flush=True)
    cross = cs.k1_crossover(dev, card, {
        nmp: launches[tuple(result["best"][str(nmp)])]
        for nmp in cs.K1_INSTANCES})
    result["crossover"] = {f"{nmp} B={B} {'stores' if st else 'free'}": v
                           for (nmp, B, st), v in cross.items()}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "k1_designs.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result["best"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
