"""K1 and K2: fused Riccati backward + Kalman forward gains on the card, and
their analytic adjoint.

K1 replaces ``lqg_tpu/ops/pallas/gains.py:_gains_merged_kernel`` (via its
wrapper ``fused_gains``); K2 replaces ``gains.py:_gains_adjoint_kernel`` (via
``_gains_adjoint_call``).  :func:`fused_gains` joins them in a
``torch.autograd.Function``, the counterpart of the JAX ``custom_vjp``
``gains_fused``.  Kernel source: ``lqg_tpu_torch/csrc/gains.cu``.

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

K2 (:func:`fused_gains_vjp`) runs both adjoint recursions in one time loop
per particle, reading the carries K1 stores on the gradient path (``S_t``
and ``P_t``, ``(T, B, n, n)``) and recomputing every other intermediate with
K1's arithmetic; it is latency-bound for the same reason.  Unlike the JAX
package (``gains.py:785``) the backward does not re-run K1: the forward
writes the stores once, only when an input needs a gradient.  Also unlike
it, K2 keeps the Kalman adjoint carry in the symmetric gauge each step, as
autograd through the scan twin (whose ``symmetrize`` projects it) does: the
hand-derived Kalman step (``gains.py:266-274``) assumes a symmetric carry,
and unprojected the carry can grow (a step map of spectral radius above
1.05 for a bounded actor with ``action_cost=0.01``,
``action_variability=0.1``, ``sigma_target=2``, ``sigma_cursor=0.5``:
beyond 1e21 over T=1008), which leaves the cotangents of ``F`` and ``A``
to cancellation between huge terms.

The plain PyTorch versions :func:`fused_gains_reference` and
:func:`fused_gains_vjp_reference` repeat the same arithmetic (same
closed-form inverses, same ``eps``, same order of the additions); the
wrappers take them only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

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


def _gains_reference(A, Bm, Q, R, Qf, F, VV, WW, Sigma0, horizon: int,
                     stores: bool = False):
    """The plain K1 on its inputs ``(B, ., .)`` (noise covariances ``VV``,
    ``WW``); with ``stores`` also the carries ``S`` and ``P``."""
    At, Bt, Ft = mT(A), mT(Bm), mT(F)
    S, P = Qf, Sigma0
    Ls, Hs, Ks, Ss, Ps = [], [], [], [], []
    for _ in range(horizon):
        Ss.append(S)
        Ps.append(P)
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
    out = torch.stack(Ls[::-1]), torch.stack(Hs[::-1]), torch.stack(Ks)
    if stores:
        out += (torch.stack(Ss[::-1]), torch.stack(Ps))
    return out


def fused_gains_reference(spec: LQGSpec, Sigma0: torch.Tensor, horizon: int,
                          stores: bool = False):
    """Plain PyTorch version of K1: batched over particles, a Python loop
    over T.  Same contract as :func:`fused_gains`, any float dtype; with
    ``stores`` it also returns K1's stores ``(S, P)``, each ``(T, B, n,
    n)``."""
    return _gains_reference(spec.A, spec.B, spec.Q, spec.R, spec.Qf, spec.F,
                            spec.V @ mT(spec.V), spec.W @ mT(spec.W), Sigma0,
                            horizon, stores)


def fused_gains_vjp_reference(A, Bm, R, F, VV, WW, S_st, P_st, Lbar, Hbar,
                              Kbar):
    """Plain PyTorch version of K2: batched over particles, a Python loop
    over T.  Same contract as :func:`fused_gains_vjp`, any float dtype."""
    At, Bt, Ft = mT(A), mT(Bm), mT(F)
    T = S_st.shape[0]
    zero = torch.zeros_like
    Sb, Pb = zero(S_st[0]), zero(P_st[0])
    aA, aB, aQ, aR = zero(A), zero(Bm), zero(S_st[0]), zero(R)
    aF, aV, aW = zero(F), zero(VV), zero(WW)
    for i in range(T):
        # Riccati adjoint (ascending slot i)
        S = S_st[i]
        SB = S @ Bm
        SA = S @ A
        H = R + Bt @ SB
        G = Bt @ SA
        Hinv = _sym_inv_det(H)[0]
        L = -(Hinv @ G)
        HL = H @ L
        Sbt = mT(Sb)
        LSb = L @ Sb
        Lb = Lbar[i] + (HL @ Sbt + (G @ Sbt + (G @ Sb + H @ LSb)))
        Hb = Hbar[i] + L @ (Sb @ mT(L))
        HinvLb = Hinv @ Lb
        Hb = Hb + HinvLb @ (mT(G) @ Hinv)
        Gbar = (LSb + L @ Sbt) - HinvLb
        aR = aR + Hb
        aQ = aQ + Sb
        SBbar = Bm @ Hb
        SAbar = A @ Sb + Bm @ Gbar
        aA = aA + (SA @ Sbt + S @ SAbar)
        aB = aB + (SA @ mT(Gbar) + (SB @ mT(Hb) + S @ SBbar))
        Sb = SBbar @ Bt + SAbar @ At
        # Kalman adjoint (descending slot T-1-i); the carry in the
        # symmetric gauge, as the scan twin's symmetrize() projects it
        Pb = _sym(Pb)
        P = P_st[T - 1 - i]
        Pp = A @ (P @ At) + VV
        PFt = Pp @ Ft
        Gki = _sym_inv_det(F @ PFt + WW)[0]
        K = PFt @ Gki
        Kb = Kbar[T - 1 - i] - Pb @ PFt
        KbGki = Kb @ Gki
        PFtb = -(mT(Pb) @ K) + KbGki
        Gkbar = -(Gki @ (mT(PFt) @ KbGki))
        aW = aW + Gkbar
        aF = aF + Gkbar @ mT(PFt)
        PFtb = PFtb + Ft @ Gkbar
        aF = aF + mT(PFtb) @ Pp
        Ppbar = Pb + PFtb @ F
        aV = aV + Ppbar
        aA = aA + (Ppbar + mT(Ppbar)) @ (A @ P)
        Pb = At @ (Ppbar @ A)
    return aA, aB, aQ, aR, Sb, aF, aV, aW, Pb


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
    lib.lqg_gains_fwd.argtypes = ([ctypes.c_void_p] * 14
                                  + [ctypes.c_int] * 5
                                  + [ctypes.c_float, ctypes.c_void_p])
    lib.lqg_gains_fwd.restype = ctypes.c_int
    lib.lqg_gains_bwd.argtypes = ([ctypes.c_void_p] * 20
                                  + [ctypes.c_int] * 5
                                  + [ctypes.c_float, ctypes.c_void_p])
    lib.lqg_gains_bwd.restype = ctypes.c_int
    return lib


def _on_card(tensors, what: str) -> bool:
    """True for CUDA float32 tensors on one card, False for CPU tensors;
    raises on anything else."""
    device = tensors[0].device
    if any(x.device != device for x in tensors):
        raise ValueError(f"{what}: inputs must lie on one device")
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if any(x.dtype != torch.float32 for x in tensors):
        raise TypeError(f"{what} kernel takes float32 tensors")
    return True


def _dims(A, Bm, F):
    return A.shape[-1], Bm.shape[-1], F.shape[-2]


def gains_fwd(A, Bm, Q, R, Qf, F, VV, WW, Sigma0, horizon: int,
              stores: bool = False):
    """K1 on its inputs, each ``(B, ., .)``: ``(L, H, K)`` and, with
    ``stores``, the carries ``(S, P)`` K2 reads.  A CUDA tensor launches
    the kernel (float32) or raises; a CPU tensor takes the plain version."""
    ins = (A, Bm, Q, R, Qf, F, VV, WW, Sigma0)
    if not _on_card(ins, "fused gains"):
        return _gains_reference(*ins, horizon, stores)
    n, m, p = _dims(A, Bm, F)
    Bn, device = A.shape[0], A.device
    ins = [x.contiguous() for x in ins]
    new = lambda *shape: torch.empty((horizon, Bn) + shape,
                                     dtype=torch.float32, device=device)
    out = (new(m, n), new(m, m), new(n, p))
    if stores:
        out += (new(n, n), new(n, n))
    st = [x.data_ptr() for x in out[3:]] if stores else [None, None]
    status = _lib().lqg_gains_fwd(
        *(x.data_ptr() for x in ins), *(x.data_ptr() for x in out[:3]), *st,
        n, m, p, Bn, horizon, EPS,
        torch.cuda.current_stream(device).cuda_stream)
    nvcc.check(status, "gains_fwd")
    fused_gains.launches += 1
    return out


def fused_gains_vjp(A, Bm, R, F, VV, WW, S_st, P_st, Lbar, Hbar, Kbar):
    """K2: the cotangents of K1's inputs from those of its outputs.

    Args:
        A, Bm, R, F, VV, WW: K1's inputs, each ``(B, ., .)``.
        S_st, P_st: K1's stores, ``(T, B, n, n)``.
        Lbar, Hbar, Kbar: cotangents of ``L, H, K``, shaped like them.

    Returns the raw cotangents ``(Abar, Bbar, Qbar, Rbar, Qfbar, Fbar,
    VVbar, WWbar, Sigma0bar)``, each ``(B, ., .)``.  A CUDA tensor launches
    the kernel (float32) or raises; a CPU tensor takes the plain version.
    """
    ins = (A, Bm, R, F, VV, WW, S_st, P_st, Lbar, Hbar, Kbar)
    if not _on_card(ins, "fused gains adjoint"):
        return fused_gains_vjp_reference(*ins)
    n, m, p = _dims(A, Bm, F)
    T, Bn = S_st.shape[:2]
    ins = [x.contiguous() for x in ins]
    out = [torch.empty((Bn,) + shape, dtype=torch.float32, device=A.device)
           for shape in ((n, n), (n, m), (n, n), (m, m), (n, n), (p, n),
                         (n, n), (p, p), (n, n))]
    status = _lib().lqg_gains_bwd(
        *(x.data_ptr() for x in ins), *(x.data_ptr() for x in out),
        n, m, p, Bn, T, EPS, torch.cuda.current_stream(A.device).cuda_stream)
    nvcc.check(status, "gains_bwd")
    fused_gains_vjp.launches += 1
    return tuple(out)


class _FusedGains(torch.autograd.Function):
    """K1 forward, K2 backward; every input is ``(B, ., .)``."""

    @staticmethod
    def forward(ctx, A, Bm, Q, R, Qf, F, V, W, Sigma0, horizon):
        VV, WW = V @ mT(V), W @ mT(W)
        grad = any(ctx.needs_input_grad[:9])
        out = gains_fwd(A, Bm, Q, R, Qf, F, VV, WW, Sigma0, horizon,
                        stores=grad)
        if grad:
            ctx.save_for_backward(A, Bm, R, F, V, W, VV, WW, *out[3:])
        return out[:3]

    @staticmethod
    @once_differentiable
    def backward(ctx, Lbar, Hbar, Kbar):
        A, Bm, R, F, V, W, VV, WW, S_st, P_st = ctx.saved_tensors
        (Abar, Bbar, Qbar, Rbar, Qfbar, Fbar, VVbar, WWbar,
         S0bar) = fused_gains_vjp(A, Bm, R, F, VV, WW, S_st, P_st, Lbar, Hbar,
                                  Kbar)
        # chain VV = V V^T, WW = W W^T back to the noise scales
        # (gains.py:857-859)
        Vbar = (VVbar + mT(VVbar)) @ V
        Wbar = (WWbar + mT(WWbar)) @ W
        # the cotangents of the symmetric inputs in the symmetric gauge
        # (gains.py:861-868)
        return (Abar, Bbar, _sym(Qbar), _sym(Rbar), _sym(Qfbar), Fbar, Vbar,
                Wbar, _sym(S0bar), None)


def fused_gains(spec: LQGSpec, Sigma0: torch.Tensor, horizon: int):
    """Fused gain schedules for a batch of stationary specs, differentiable.

    Args:
        spec: stationary spec with leading batch axis B (fields may
            broadcast along it) and ``zero_affine`` set.
        Sigma0: ``(B, n, n)`` initial state covariance.
        horizon: T, any positive length.

    Returns ``(L (T, B, m, n), H (T, B, m, m), K (T, B, n, p))``, the same
    as :func:`lqg_tpu_torch.ops.riccati.backward` with ``regularize="none"``
    and :func:`lqg_tpu_torch.ops.kalman.forward`.  A CUDA tensor launches
    K1 (float32) and, for the gradient, K2, or raises; a CPU tensor takes
    their plain versions.  The gradients of ``Q``, ``Qf``, ``R`` and
    ``Sigma0`` come back symmetric; the affine terms get none (they are
    structurally zero).
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
    Bn = torch.broadcast_shapes(*(x.shape[:-2] for x in fields))[0]
    # expand before apply, so that autograd sums the gradient of a field
    # shared along B
    ins = [x.expand((Bn,) + x.shape[-2:]).contiguous() for x in fields]
    return _FusedGains.apply(*ins, horizon)


fused_gains.launches = 0
fused_gains_vjp.launches = 0
