"""K1: fused Riccati backward + Kalman forward gains on the card.

Replaces ``lqg_tpu/ops/pallas/gains.py:_gains_merged_kernel`` (via its
wrapper ``fused_gains``).  Kernel source: ``lqg_tpu_torch/csrc/gains.cu``.

What it computes: for a batch of stationary specs with structurally zero
affine costs, the control gains ``L_t`` and Hessians ``H_t`` of the Riccati
backward pass and the Kalman gains ``K_t`` of the covariance forward pass,
in one time loop, with closed-form symmetric inverses that add ``eps`` to
the determinant.  Outputs keep the public time-leading layout
``(T, B, ., .)``; ``L`` and ``H`` fill their slots in reverse time.

What bounds it on an H100: not bytes.  At the bench shape (B=16,384,
T=1000) it writes 459 MB, 0.14 ms at 3.35 TB/s, and does ~3 GFLOP, far
below float32 peak; but one thread per particle gives only 16,384 threads
(~4 warps per SM), each walking a T-step chain of dependent scalar FMAs and
two divisions.  It is latency-bound.  The design keeps the whole carry and
the spec in registers (no shared or local memory, no time chunking, so any
T works, a prime one too) and writes each step's gains straight to their
final slots, so the chain is the only cost; covering that latency with
more independent work per SM is left for a later change.

The plain PyTorch version :func:`fused_gains_reference` repeats the same
arithmetic (same closed-form inverses, same ``eps``, same order of the
additions); the wrapper takes it only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from lqg_tpu_torch.spec import LQGSpec
from lqg_tpu_torch.ops.linalg import mT
from lqg_tpu_torch.ops.kernels import nvcc

EPS = 1e-12  # added to every determinant before its reciprocal

# (n, m, p) instantiated in csrc/gains.cu: the dim=1 tracking models
# (BoundedActor, OptimalActor: (2, 1, 2); RelativeObservation: (2, 1, 1))
INSTANCES = frozenset({(2, 1, 2), (2, 1, 1)})


def _sym(M: torch.Tensor) -> torch.Tensor:
    return 0.5 * (M + mT(M))


def _sym_inv_det(S: torch.Tensor):
    """(inverse, determinant) of symmetric PD matrices ``(..., k, k)``,
    k <= 4, in closed form with ``EPS`` on the determinant of the inverse
    only (``gains.py:_sym_inv``, ``likelihood.py:_sym_inv_det``)."""
    k = S.shape[-1]
    if k == 1:
        det = S[..., 0, 0]
        return (1.0 / (det + EPS))[..., None, None], det
    if k == 2:
        a, b, dd = S[..., 0, 0], S[..., 0, 1], S[..., 1, 1]
        det = a * dd - b * b
        inv = 1.0 / (det + EPS)
        return torch.stack([dd * inv, -b * inv, -b * inv, a * inv],
                           -1).reshape(S.shape), det
    if k == 3:
        a, b, c = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
        e, f, i = S[..., 1, 1], S[..., 1, 2], S[..., 2, 2]
        A11 = e * i - f * f
        A12 = c * f - b * i
        A13 = b * f - c * e
        det = a * A11 + b * A12 + c * A13
        inv = 1.0 / (det + EPS)
        A22 = a * i - c * c
        A23 = b * c - a * f
        A33 = a * e - b * b
        return torch.stack([A11 * inv, A12 * inv, A13 * inv,
                            A12 * inv, A22 * inv, A23 * inv,
                            A13 * inv, A23 * inv, A33 * inv],
                           -1).reshape(S.shape), det
    if k == 4:
        # blockwise Schur complement on 2x2 blocks
        Ab, Bb, Cb = S[..., :2, :2], S[..., :2, 2:], S[..., 2:, 2:]
        Ai, detA = _sym_inv_det(Ab)
        AiB = Ai @ Bb
        Sc = _sym(Cb - mT(Bb) @ AiB)
        Si, detS = _sym_inv_det(Sc)
        TL = Ai + AiB @ (Si @ mT(AiB))
        TR = -(AiB @ Si)
        top = torch.cat([TL, TR], -1)
        bottom = torch.cat([mT(TR), Si], -1)
        return torch.cat([top, bottom], -2), detA * detS
    raise ValueError(f"closed-form inverse supports k <= 4, got {k}")


def fused_gains_reference(spec: LQGSpec, Sigma0: torch.Tensor, horizon: int):
    """Plain PyTorch version of K1: batched over particles, a Python loop
    over T.  Same contract as :func:`fused_gains`, any float dtype."""
    A, Bm, Q, R, F = spec.A, spec.B, spec.Q, spec.R, spec.F
    VV = spec.V @ mT(spec.V)
    WW = spec.W @ mT(spec.W)
    At, Bt, Ft = mT(A), mT(Bm), mT(F)
    S, P = spec.Qf, Sigma0
    Ls, Hs, Ks = [], [], []
    for _ in range(horizon):
        # Riccati backward (reverse-time slot)
        SB = S @ Bm
        SA = S @ A
        H = R + Bt @ SB
        G = Bt @ SA
        L = -(_sym_inv_det(H)[0] @ G)
        HL = H @ L
        Lt = mT(L)
        S = (Q + At @ SA) + (Lt @ HL + (Lt @ G + mT(G) @ L))
        Ls.append(L)
        Hs.append(H)
        # Kalman forward
        P = A @ (P @ At) + VV
        PFt = P @ Ft
        Gk = F @ PFt + WW
        K = PFt @ _sym_inv_det(Gk)[0]
        P = P - K @ mT(PFt)
        Ks.append(K)
    return torch.stack(Ls[::-1]), torch.stack(Hs[::-1]), torch.stack(Ks)


def fused_gains_available(spec: LQGSpec) -> bool:
    """Kernel scope: a stationary spec whose (n, m, p) is instantiated, with
    square noise scales."""
    if spec.A.dim() != spec.Qf.dim():  # stacked
        return False
    n, m, p = spec.A.shape[-1], spec.B.shape[-1], spec.F.shape[-2]
    return ((n, m, p) in INSTANCES and spec.V.shape[-1] == n
            and spec.W.shape[-1] == p)


def _lib():
    lib = nvcc.load("gains")
    lib.lqg_gains_fwd.argtypes = ([ctypes.c_void_p] * 12
                                  + [ctypes.c_int] * 5
                                  + [ctypes.c_float, ctypes.c_void_p])
    lib.lqg_gains_fwd.restype = ctypes.c_int
    return lib


def fused_gains(spec: LQGSpec, Sigma0: torch.Tensor, horizon: int):
    """Fused gain schedules for a batch of stationary specs.

    Args:
        spec: stationary spec with leading batch axis B (fields may
            broadcast along it) and ``zero_affine`` set.
        Sigma0: ``(B, n, n)`` initial state covariance.
        horizon: T, any positive length.

    Returns ``(L (T, B, m, n), H (T, B, m, m), K (T, B, n, p))``, the same
    as :func:`lqg_tpu_torch.ops.riccati.backward` with ``regularize="none"``
    and :func:`lqg_tpu_torch.ops.kalman.forward`.  A CUDA tensor launches
    the kernel (float32) or raises; a CPU tensor takes the plain version.
    No gradient: that is K2's, which is not ported yet.
    """
    if not spec.zero_affine:
        raise ValueError(
            "fused gains kernel requires structurally-zero affine/cross cost "
            "terms (spec.zero_affine); use System.gains(method='scan')")
    if not fused_gains_available(spec) or spec.A.dim() != 3:
        raise ValueError(
            f"spec outside the kernel's scope: batched stationary (n, m, p) "
            f"in {sorted(INSTANCES)} required")
    if horizon < 1:
        raise ValueError(f"horizon must be positive, got {horizon}")
    fields = (spec.A, spec.B, spec.Q, spec.R, spec.Qf, spec.F, spec.V,
              spec.W, Sigma0)
    if any(x.requires_grad for x in fields) and torch.is_grad_enabled():
        raise NotImplementedError(
            "fused gains have no backward yet; use method='scan' for "
            "gradients")
    device = spec.A.device
    if any(x.device != device for x in fields):
        raise ValueError("spec and Sigma0 must lie on one device")
    if device.type == "cpu":
        return fused_gains_reference(spec, Sigma0, horizon)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if any(x.dtype != torch.float32 for x in fields):
        raise TypeError("fused gains kernel takes float32 tensors")

    n, m, p = spec.A.shape[-1], spec.B.shape[-1], spec.F.shape[-2]
    Bn = torch.broadcast_shapes(*(x.shape[:-2] for x in fields))[0]
    VV = spec.V @ mT(spec.V)
    WW = spec.W @ mT(spec.W)
    ins = [x.expand((Bn,) + x.shape[-2:]).contiguous()
           for x in (spec.A, spec.B, spec.Q, spec.R, spec.Qf, spec.F, VV, WW,
                     Sigma0)]
    L = torch.empty((horizon, Bn, m, n), dtype=torch.float32, device=device)
    H = torch.empty((horizon, Bn, m, m), dtype=torch.float32, device=device)
    K = torch.empty((horizon, Bn, n, p), dtype=torch.float32, device=device)
    status = _lib().lqg_gains_fwd(
        *(x.data_ptr() for x in ins), L.data_ptr(), H.data_ptr(),
        K.data_ptr(), n, m, p, Bn, horizon, EPS,
        torch.cuda.current_stream(device).cuda_stream)
    nvcc.check(status, "gains_fwd")
    fused_gains.launches += 1
    return L, H, K


fused_gains.launches = 0
