#!/usr/bin/env python3
"""K1 of this checkout against K1 built from another copy of
``lqg_tpu_torch/csrc``, bit for bit, on one NVIDIA card.

Run from the root of a checkout, with the other sources unpacked beside it
(for an older commit: ``git archive <commit> lqg_tpu_torch/csrc | tar -x -C
DIR``)::

    python scripts/k1_bits_vs_build.py DIR/lqg_tpu_torch/csrc

It builds the other ``gains.cu`` with the port's flags and, at every
instance, launches the other build's ``lqg_gains_fwd`` and this checkout's
thread and block designs (``gains_fwd(design=...)``), all with the stores,
on the instance's model specs (``chip_smoke.k1_inputs``: B=1, T=1000; B=24,
T=1008; B=2,048, T=719), on 2,048 random specs at T=33 and on the random
spec of ``tests/test_torch_gains_grad.py:test_adjoint_kernel_matches_
reference_on_card`` (seed 4, B=5, T=65); it prints the entries of L, H, K
and the two stores that differ from the other build.  On each build's
stores of that random spec it also holds this checkout's K2 and the plain
float32 K2 against the plain K2 in float64, as that test holds K2 against
the plain float32 K2: the largest share of the test's allowed error (rtol
1e-3, atol 1e-4 + 1e-5 of each output's largest entry).  An edit of K1's
arithmetic changes its stores in the last bit, and where the plain
float32 K2 is itself far from float64 the test reads that as K2's error.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import chip_smoke as cs  # noqa: E402
from lqg_tpu_torch.ops.kernels import gains as kg  # noqa: E402
from lqg_tpu_torch.ops.kernels import nvcc  # noqa: E402
from lqg_tpu_torch.ops.linalg import mT  # noqa: E402
from test_torch_gains_grad import _random_spec, _torch_spec  # noqa: E402


def other_build(csrc):
    lib = os.path.join(nvcc.BUILD_DIR, "libgains_other.so")
    os.makedirs(nvcc.BUILD_DIR, exist_ok=True)
    subprocess.run([nvcc._nvcc(), *nvcc.FLAGS, "-o", lib,
                    os.path.join(csrc, "gains.cu")], check=True,
                   capture_output=True, text=True)
    dll = ctypes.CDLL(lib)
    dll.lqg_gains_fwd.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 5
                                  + [ctypes.c_float, ctypes.c_void_p])
    dll.lqg_gains_fwd.restype = ctypes.c_int
    return dll


def launch_other(dll, ins, T):
    n, m, p = ins[0].shape[-1], ins[1].shape[-1], ins[5].shape[-2]
    B, dev = ins[0].shape[0], ins[0].device
    new = lambda *s: torch.empty((T, B) + s, device=dev)
    out = (new(m, n), new(m, m), new(n, p), new(n, n), new(n, n))
    nvcc.check(dll.lqg_gains_fwd(
        *(x.data_ptr() for x in ins), *(x.data_ptr() for x in out), n, m, p,
        B, T, kg.EPS, torch.cuda.current_stream(dev).cuda_stream),
        "other build's gains_fwd")
    return out


def random_inputs(nmp, B, dev, seed):
    n, m, p = nmp
    rng = np.random.default_rng(seed)

    def pd(k, s=1.0):
        X = rng.normal(size=(B, k, k)) * s
        return X @ np.swapaxes(X, -1, -2) / k + 0.1 * np.eye(k)

    fields = [np.eye(n) + 0.1 * rng.normal(size=(B, n, n)),
              rng.normal(size=(B, n, m)), pd(n), pd(m), pd(n),
              rng.normal(size=(B, p, n)), pd(n, 0.3), pd(p, 0.3), pd(n)]
    return [torch.tensor(x, dtype=torch.float32, device=dev) for x in fields]


def test_spec_inputs(nmp, dev):
    spec = _torch_spec(_random_spec(4, B=5, n=nmp[0], m=nmp[1], p=nmp[2]),
                       torch.float32)[0]
    spec = spec._replace(**{k: getattr(spec, k).to(dev) for k in "ABQRFVW"},
                         Qf=spec.Qf.to(dev))
    VV, WW = spec.V @ mT(spec.V), spec.W @ mT(spec.W)
    return [x.contiguous() for x in (spec.A, spec.B, spec.Q, spec.R, spec.Qf,
                                     spec.F, VV, WW, VV)]


def share(got, want):
    """The largest share of the test's allowed error over the outputs."""
    return max(float(((a.double() - b.double()).abs()
                      / (1e-4 + 1e-3 * b.double().abs()
                         + 1e-5 * b.double().abs().max())).max())
               for a, b in zip(got, want))


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("usage, on a card: k1_bits_vs_build.py OTHER_CSRC",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    dll = other_build(sys.argv[1])
    differ = 0
    for nmp in cs.K1_INSTANCES:
        cases = [(f"model B={B} T={T}", cs.k1_inputs(nmp, B, T, dev)[1], T)
                 for B, T in ((1, 1000), (24, 1008), (2048, 719))]
        cases.append(("random B=2048 T=33",
                      random_inputs(nmp, 2048, dev, 7 + nmp[0]), 33))
        cases.append(("test spec B=5 T=65", test_spec_inputs(nmp, dev), 65))
        for name, ins, T in cases:
            ref = launch_other(dll, ins, T)
            row = []
            for design in ("thread", "block"):
                out = kg.gains_fwd(*ins, T, stores=True, design=design)
                torch.cuda.synchronize()
                counts = [int((a != b).sum()) for a, b in zip(out, ref)]
                differ += sum(counts)
                row.append(f"{design} {counts}")
            print(f"{nmp} {name}: entries of (L, H, K, S, P) that differ "
                  f"from the other build: " + "; ".join(row), flush=True)
        ins = cases[-1][1]
        A, Bm, _, R, _, F, VV, WW, _ = ins
        for what, st in (("other", launch_other(dll, ins, 65)),
                         ("this", kg.gains_fwd(*ins, 65, stores=True))):
            g = torch.Generator(device=dev).manual_seed(0)
            cots = [0.3 * torch.randn(x.shape, generator=g, device=dev)
                    for x in st[:3]]
            args = (A, Bm, R, F, VV, WW, *st[3:], *cots)
            k2 = kg.fused_gains_vjp(*args)
            plain = kg.fused_gains_vjp_reference(*args)
            plain64 = kg.fused_gains_vjp_reference(*(x.double()
                                                     for x in args))
            torch.cuda.synchronize()
            print(f"{nmp} test spec, {what} build's stores: share of the "
                  f"allowed error, K2 vs plain float32 {share(k2, plain):.3f}"
                  f", K2 vs float64 {share(k2, plain64):.3f}, plain float32 "
                  f"vs float64 {share(plain, plain64):.3f}", flush=True)
    print(f"entries that differ, in all: {differ}")
    return 0 if differ == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
