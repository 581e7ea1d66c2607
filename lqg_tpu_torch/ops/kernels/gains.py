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
below float32 peak; at the potential's B=4-24 the bytes would take well
under a microsecond.  Each particle is two T-step chains of dependent
scalar FMAs and divisions: it is latency-bound.  K1 has two designs, which
give the same bits (every operation an explicitly rounded intrinsic, in
the plain version's order):

- ``"thread"``: one thread per particle walks both recursions, the carry
  and the spec in registers (no shared or local memory, no time chunking,
  so any T works, a prime one too), each step's gains written straight to
  their final slots.  At B=16,384 it has ~4 warps an SM.
- ``"block"``: one 64-thread block per particle, the Riccati recursion on
  one warp and the Kalman recursion on another, so that the two chains
  overlap; at the larger instances each warp spreads a step's entries over
  its lanes (lane ``r n + q`` owns entry ``(r, q)`` of the carry, which
  goes through shared memory once a step for the Riccati warp, three times
  for the Kalman warp).  It is for small batches, where the thread design
  leaves all but one warp of the card idle.

``gains_fwd(..., design="auto")`` takes the block design below each
instance's crossover batch (:data:`THREAD_FROM`, store-free and with the
stores) and the thread design from it on; ``design="thread"`` or
``"block"`` forces one.  The design launched last is left on
``fused_gains.design``, and each design's launches are counted in
``fused_gains.design_launches`` beside ``.launches``.

K2 (:func:`fused_gains_vjp`) reads the carries K1 stores on the gradient
path (``S_t`` and ``P_t``, ``(T, B, n, n)``) and runs both adjoint
recursions, one thread block per particle.  Of its work only the two
adjoint carries are serial, two small linear maps a step; K1's primal
quantities, recomputed from the stores with K1's arithmetic, and the
cotangent sums hold no carry.  So the block walks T in chunks of
:data:`CHUNK` steps through a ring of chunk slots in shared memory: a copy
warp stages the stores and cotangents with ``cp.async`` on mbarriers, a
recompute warp computes the coefficients of a chunk's steps one lane a
step, one lane in each of two warps walks the Riccati and the Kalman carry
on coefficients read from shared memory a step ahead, and an accumulate
warp forms each step's contributions one lane a step, sums the chunk in a
fixed order (a shuffle transpose) and adds the chunk sums in chunk order,
with no atomics.  What bounds it is latency: the two carry lanes' chains
of T dependent steps, ~100 instructions a step issued in order, with the
recompute and the sums a chunk apart beside them.  Unlike the JAX package
(``gains.py:785``) the backward does not re-run K1: the forward writes the
stores once, only when an input needs a gradient.  Also unlike it, K2
keeps the Kalman adjoint carry in the symmetric gauge each step, as
autograd through the scan twin (whose ``symmetrize`` projects it) does: the
hand-derived Kalman step (``gains.py:266-274``) assumes a symmetric carry,
and unprojected the carry can grow (a step map of spectral radius above
1.05 for a bounded actor with ``action_cost=0.01``,
``action_variability=0.1``, ``sigma_target=2``, ``sigma_cursor=0.5``:
beyond 1e21 over T=1008), which leaves the cotangents of ``F`` and ``A``
to cancellation between huge terms.  For the same reason K1 keeps its
Riccati carry in the symmetric gauge at m > 1 (``gains.py:207-209`` does
not): there the carry's antisymmetric part reaches the control Hessian,
whose closed-form inverse reads one off-diagonal entry, and grows from
float32 rounding where the open loop is unstable (on a random (4, 2, 2)
spec ``L`` is off by more than 1 against float64 at T=65 unprojected,
within 1e-4 projected: ``tests/test_torch_gains_grad.py``); K2 applies the
projection's adjoint to its Riccati carry.  At m = 1 the Hessian is a scalar, the antisymmetric
part only rides along (``A^T S_a A``), and both keep the Pallas kernel's
arithmetic.

The scope is lqg_tpu's (``gains.py:621-630``): any stationary spec with n
<= 8, m <= 2, p <= 3.  K1 and K2 are templates on (n, m, p), built at the
instances of :data:`PART`: the zoo's, the delay wrapper's at delays 1-3,
and at n = 8 an envelope for each (m, p).  Any other (n, m, p) in scope is
padded with zeros in n onto the smallest instance with its (m, p)
(:func:`instance_for`), and the wrappers slice the padded entries away.
The padding is exact: A, Q, Qf, VV, Sigma0 and the columns of F are zero
in the padded block, so S, P, the padded columns of L and the padded rows
of K stay exactly zero; the m x m and p x p inverses never see it; and every
extra term of a sum is a product with a zero, which leaves a finite sum's
bits as they are.  The adjoint's carries stay in the real block the same
way.

The plain PyTorch versions :func:`fused_gains_reference` and
:func:`fused_gains_vjp_reference` repeat the same arithmetic (same
closed-form inverses, same ``eps``, same order of the additions, K2's sums
over T in its chunk order, :func:`_chunk_sum`); the wrappers take them
only for tensors on the CPU, padded as the kernels would be.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as nnf
from torch.autograd.function import once_differentiable

from lqg_tpu_torch.spec import LQGSpec
from lqg_tpu_torch.ops.linalg import mT
from lqg_tpu_torch.ops.kernels import nvcc

EPS = 1e-12  # added to every determinant before its reciprocal
CHUNK = 32  # K2's steps a chunk, one lane a step (csrc/gains.cu: kChunk)

# The (n, m, p) instantiated in csrc/gains.cu, each with the part of the
# source (nvcc.PARTS) whose library holds it.  Part 0, the zoo: the dim=1
# tracking models (BoundedActor, OptimalActor: (2, 1, 2);
# RelativeObservation: (2, 1, 1); the SubjectiveActor's 3-state internal
# model: (3, 1, 2)), PointMass (4, 1, 3), Hand (5, 1, 2) and
# RelativeObservation(dim=2) (4, 2, 2).  Parts 1-2, TemporalDelayModel at
# delays k = 1-3 around the dim=1 models: 2 (k + 1) = 4, 6, 8 states, m = 1,
# p = 2 (p = 1 around the relative-observation actor; the SubjectiveActor
# at delay 1 is (6, 1, 2) too).  Parts 3-4, with (8, 1, 3) the point mass
# at delay 1, the envelopes at n = 8 for the other (m, p) of the scope.
PART = {(2, 1, 2): 0, (2, 1, 1): 0, (3, 1, 2): 0, (4, 1, 3): 0,
        (5, 1, 2): 0, (4, 2, 2): 0,
        (4, 1, 2): 1, (4, 1, 1): 1, (6, 1, 2): 1, (6, 1, 1): 1,
        (8, 1, 2): 2, (8, 1, 1): 2, (8, 1, 3): 3, (8, 2, 1): 3,
        (8, 2, 2): 4, (8, 2, 3): 4}
INSTANCES = frozenset(PART)
# lqg_tpu's kernel scope (lqg_tpu/ops/pallas/gains.py:621-630)
MAX_N, MAX_M, MAX_P = 8, 2, 3


def in_scope(n: int, m: int, p: int) -> bool:
    return 1 <= n <= MAX_N and 1 <= m <= MAX_M and 1 <= p <= MAX_P


def instance_for(n: int, m: int, p: int):
    """The instance K1 and K2 launch for ``(n, m, p)``: itself where it is
    instantiated, else the smallest instance with its (m, p) and more
    states, onto which the inputs are padded with zeros; None outside the
    scope."""
    if not in_scope(n, m, p):
        return None
    return min(k for k in INSTANCES if k[1:] == (m, p) and k[0] >= n)


DESIGNS = ("auto", "thread", "block")
# The batch from which ``design="auto"`` takes K1's thread design, per
# instance, store-free and with the stores (None: never); below it the
# block design.  Both designs timed in turns at B in {1, 4, 24, 132, 264,
# 528, 1,056, 2,048, 16,384}, T=1000 (chip_smoke.py:k1_crossover, run by
# scripts/k1_designs.py and by chip_smoke.py's phase 16, on an NVIDIA H100
# 80GB HBM3 at 700 W; both runs agree): the block design was the faster at
# every batch below the entry, the thread design at the entry and above.
# With the stores the thread design slows down at n >= 3 from B=132 on
# (each lane writes its carries to 32-byte sectors of its own): at (5, 1,
# 2) the block design was the faster at every batch, 16,384 included (7.87
# against 16.67 ms).
# The delay wrapper's instances at n = 4 and 6 (chip_smoke.py:k1_crossover
# over K1_SCOPE_SWEEP, phase 16, the same card, two runs): store-free the
# thread design was the faster from B=1,056 on (at 528 the block design by
# 2-7% at n = 4, the two within 1% at n = 6); with the stores the block
# design at every batch (at B=132 already 3.5-10.8 against 0.30-0.62 ms).  At n = 8 the thread design spills (-Xptxas -v), and those
# instances take the block design at every batch.
THREAD_FROM = {(2, 1, 2): (1056, 1056), (2, 1, 1): (1056, 1056),
               (3, 1, 2): (1056, 1056), (4, 1, 3): (1056, 16384),
               (5, 1, 2): (2048, None), (4, 2, 2): (1056, 16384),
               (4, 1, 2): (1056, None), (4, 1, 1): (1056, None),
               (6, 1, 2): (1056, None), (6, 1, 1): (1056, None),
               **{k: (None, None) for k in PART if k[0] == 8}}


def design_for(n: int, m: int, p: int, batch: int,
               stores: bool = False) -> str:
    """The K1 design ``design="auto"`` launches for ``batch`` particles of
    instance ``(n, m, p)`` (or of the instance it is padded onto),
    store-free or with the stores."""
    cross = THREAD_FROM[instance_for(n, m, p)][int(stores)]
    return "block" if cross is None or batch < cross else "thread"


def _grow(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``x (..., r, c)`` padded with zeros to ``(..., rows, cols)``."""
    r, c = x.shape[-2:]
    if (r, c) == (rows, cols):
        return x
    return nnf.pad(x, (0, cols - c, 0, rows - r))


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
        if Bm.shape[-1] > 1:  # at m > 1 in the symmetric gauge
            S = _sym(S)
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


def _chunk_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x (T, ...)`` over its leading axis in K2's order: step
    ``c CHUNK + l`` is lane ``l`` of chunk ``c`` (zeros past T); a chunk's
    lanes fold by halving (lane l + o onto l, o = 16, 8, 4, 2, 1: the xor
    tree of the shuffle transpose), and the chunk sums are added to a
    running total in chunk order."""
    T = x.shape[0]
    chunks = -(-T // CHUNK)
    x = torch.cat([x, x.new_zeros((chunks * CHUNK - T,) + x.shape[1:])])
    x = x.reshape((chunks, CHUNK) + x.shape[1:])
    off = CHUNK
    while off > 1:
        off //= 2
        x = x[:, :off] + x[:, off:2 * off]
    total = torch.zeros_like(x[0, 0])
    for c in range(chunks):
        total = total + x[c, 0]
    return total


def fused_gains_vjp_reference(A, Bm, R, F, VV, WW, S_st, P_st, Lbar, Hbar,
                              Kbar):
    """Plain PyTorch version of K2: batched over particles, in the kernel's
    three parts and order.  Same contract as :func:`fused_gains_vjp`, any
    float dtype.

    1. K1's primal quantities of every step at once, the Kalman side in
       carry order (step i reads slot T-1-i);
    2. a Python loop over T for the two adjoint carries alone, recording
       what each step's contributions need;
    3. the contributions of every step at once, summed over T by
       :func:`_chunk_sum`; A's cotangent is the Riccati total plus the
       Kalman total.
    """
    At, Bt, Ft = mT(A), mT(Bm), mT(F)
    T = S_st.shape[0]
    # 1. the recompute
    S = S_st
    SB = S @ Bm
    SA = S @ A
    H = R + Bt @ SB
    G = Bt @ SA
    Hinv = _sym_inv_det(H)[0]
    L = -(Hinv @ G)
    HL = H @ L
    GtHinv = mT(G) @ Hinv
    P = P_st.flip(0)
    Pp = A @ (P @ At) + VV
    PFt = Pp @ Ft
    Gki = _sym_inv_det(F @ PFt + WW)[0]
    K = PFt @ Gki
    AP = A @ P
    Kbar = Kbar.flip(0)
    # 2. the carries
    Sb, Pb = torch.zeros_like(S_st[0]), torch.zeros_like(P_st[0])
    Sbs, Hbs, Gbars, SBbars, SAbars = [], [], [], [], []
    Gkbars, PFtbs, Ppbars = [], [], []
    for i in range(T):
        if Bm.shape[-1] > 1:  # the adjoint of K1's projection at m > 1
            Sb = _sym(Sb)
        Sbs.append(Sb)
        Sbt = mT(Sb)
        LSb = L[i] @ Sb
        Lb = Lbar[i] + (HL[i] @ Sbt + (G[i] @ Sbt + (G[i] @ Sb
                                                     + H[i] @ LSb)))
        HinvLb = Hinv[i] @ Lb
        Hb = (Hbar[i] + L[i] @ (Sb @ mT(L[i]))) + HinvLb @ GtHinv[i]
        Gbar = (LSb + L[i] @ Sbt) - HinvLb
        SBbar = Bm @ Hb
        SAbar = A @ Sb + Bm @ Gbar
        Hbs.append(Hb)
        Gbars.append(Gbar)
        SBbars.append(SBbar)
        SAbars.append(SAbar)
        Sb = SBbar @ Bt + SAbar @ At
        # the Kalman carry in the symmetric gauge, as the scan twin's
        # symmetrize() projects it
        Pb = _sym(Pb)
        KbGki = (Kbar[i] - Pb @ PFt[i]) @ Gki[i]
        Gkbar = -(Gki[i] @ (mT(PFt[i]) @ KbGki))
        PFtb = (-(mT(Pb) @ K[i]) + KbGki) + Ft @ Gkbar
        Ppbar = Pb + PFtb @ F
        Gkbars.append(Gkbar)
        PFtbs.append(PFtb)
        Ppbars.append(Ppbar)
        Pb = At @ (Ppbar @ A)
    Sb_, Hb, Gbar, SBbar, SAbar, Gkbar, PFtb, Ppbar = (
        torch.stack(x) for x in (Sbs, Hbs, Gbars, SBbars, SAbars, Gkbars,
                                 PFtbs, Ppbars))
    # 3. the contributions and their sums
    aA = (_chunk_sum(SA @ mT(Sb_) + S @ SAbar)
          + _chunk_sum((Ppbar + mT(Ppbar)) @ AP))
    aB = _chunk_sum(SA @ mT(Gbar) + (SB @ mT(Hb) + S @ SBbar))
    aF = _chunk_sum(Gkbar @ mT(PFt) + mT(PFtb) @ Pp)
    return (aA, aB, _chunk_sum(Sb_), _chunk_sum(Hb), Sb, aF,
            _chunk_sum(Ppbar), _chunk_sum(Gkbar), Pb)


def fused_gains_available(spec: LQGSpec) -> bool:
    """Kernel scope, lqg_tpu's: a stationary spec with n <= 8, m <= 2, p <= 3
    and square noise scales."""
    if spec.A.dim() != spec.Qf.dim():  # stacked
        return False
    n, m, p = spec.A.shape[-1], spec.B.shape[-1], spec.F.shape[-2]
    return (in_scope(n, m, p) and spec.V.shape[-1] == n
            and spec.W.shape[-1] == p)


def _lib(nmp):
    """The library of the part that holds instance ``nmp``."""
    if nmp not in PART:
        raise ValueError(f"(n, m, p) = {nmp} outside the kernels' scope")
    lib = nvcc.load("gains", PART[nmp])
    lib.lqg_gains_fwd.argtypes = ([ctypes.c_void_p] * 14
                                  + [ctypes.c_int] * 5
                                  + [ctypes.c_float, ctypes.c_void_p])
    lib.lqg_gains_fwd.restype = ctypes.c_int
    lib.lqg_gains_fwd_block.argtypes = lib.lqg_gains_fwd.argtypes
    lib.lqg_gains_fwd_block.restype = ctypes.c_int
    lib.lqg_gains_bwd.argtypes = ([ctypes.c_void_p] * 20
                                  + [ctypes.c_int] * 5
                                  + [ctypes.c_float, ctypes.c_void_p])
    lib.lqg_gains_bwd.restype = ctypes.c_int
    lib.lqg_gains_bwd_chunk.argtypes = []
    lib.lqg_gains_bwd_chunk.restype = ctypes.c_int
    if lib.lqg_gains_bwd_chunk() != CHUNK:
        raise RuntimeError("csrc/gains.cu's K2 chunk differs from CHUNK: the "
                           "plain version would sum in another order")
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


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def gains_fwd(A, Bm, Q, R, Qf, F, VV, WW, Sigma0, horizon: int,
              stores: bool = False, design: str = "auto"):
    """K1 on its inputs, each ``(B, ., .)``: ``(L, H, K)`` and, with
    ``stores``, the carries ``(S, P)`` K2 reads.  A CUDA tensor launches
    the kernel (float32) in ``design`` (``"auto"``: :func:`design_for`;
    ``"thread"``, ``"block"``) or raises; a CPU tensor takes the plain
    version, whatever the design."""
    if design not in DESIGNS:
        raise ValueError(f"design must be one of {DESIGNS}, got {design!r}")
    n, m, p = _dims(A, Bm, F)
    N = (instance_for(n, m, p) or (n,))[0]
    if N != n:  # padded onto the instance, the padding sliced away
        out = gains_fwd(_grow(A, N, N), _grow(Bm, N, m), _grow(Q, N, N),
                        R, _grow(Qf, N, N), _grow(F, p, N),
                        _grow(VV, N, N), WW, _grow(Sigma0, N, N), horizon,
                        stores, design)
        return ((out[0][..., :n], out[1], out[2][..., :n, :])
                + tuple(x[..., :n, :n] for x in out[3:]))
    ins = (A, Bm, Q, R, Qf, F, VV, WW, Sigma0)
    if not _on_card(ins, "fused gains"):
        return _gains_reference(*ins, horizon, stores)
    Bn, device = A.shape[0], A.device
    if design == "auto":
        design = design_for(n, m, p, Bn, stores)
    lib = _lib((n, m, p))
    launch = (lib.lqg_gains_fwd if design == "thread"
              else lib.lqg_gains_fwd_block)
    ins = [x.contiguous() for x in ins]
    new = lambda *shape: torch.empty((horizon, Bn) + shape,
                                     dtype=torch.float32, device=device)
    out = (new(m, n), new(m, m), new(n, p))
    if stores:
        out += (new(n, n), new(n, n))
    st = [x.data_ptr() for x in out[3:]] if stores else [None, None]
    status = launch(
        *(x.data_ptr() for x in ins), *(x.data_ptr() for x in out[:3]), *st,
        n, m, p, Bn, horizon, EPS, _stream(device))
    nvcc.check(status, f"gains_fwd ({design} design)")
    fused_gains.launches += 1
    fused_gains.design_launches[design] += 1
    fused_gains.design = design
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
    n, m, p = _dims(A, Bm, F)
    N = (instance_for(n, m, p) or (n,))[0]
    if N != n:  # padded onto the instance, the padding sliced away
        out = fused_gains_vjp(
            _grow(A, N, N), _grow(Bm, N, m), R, _grow(F, p, N),
            _grow(VV, N, N), WW, _grow(S_st, N, N), _grow(P_st, N, N),
            _grow(Lbar, m, N), Hbar, _grow(Kbar, N, p))
        Abar, Bbar, Qbar, Rbar, Qfbar, Fbar, VVbar, WWbar, S0bar = out
        sq = lambda x: x[..., :n, :n]
        return (sq(Abar), Bbar[..., :n, :], sq(Qbar), Rbar, sq(Qfbar),
                Fbar[..., :n], sq(VVbar), WWbar, sq(S0bar))
    ins = (A, Bm, R, F, VV, WW, S_st, P_st, Lbar, Hbar, Kbar)
    if not _on_card(ins, "fused gains adjoint"):
        return fused_gains_vjp_reference(*ins)
    T, Bn = S_st.shape[:2]
    ins = [x.contiguous() for x in ins]
    out = [torch.empty((Bn,) + shape, dtype=torch.float32, device=A.device)
           for shape in ((n, n), (n, m), (n, n), (m, m), (n, n), (p, n),
                         (n, n), (p, p), (n, n))]
    status = _lib((n, m, p)).lqg_gains_bwd(
        *(x.data_ptr() for x in ins), *(x.data_ptr() for x in out),
        n, m, p, Bn, T, EPS, torch.cuda.current_stream(A.device).cuda_stream)
    nvcc.check(status, "gains_bwd")
    fused_gains_vjp.launches += 1
    return tuple(out)


def _twin_spec(A, Bm, Q, R, Qf, F, V, W) -> LQGSpec:
    """The stationary spec of K1's inputs, affine terms zero."""
    zeros = lambda *shape: A.new_zeros(A.shape[:1] + shape)
    n, m = Bm.shape[-2:]
    return LQGSpec(Q=Q, q=zeros(n), Qf=Qf, qf=zeros(n), P=zeros(m, n), R=R,
                   r=zeros(m), A=A, B=Bm, V=V, F=F, W=W, zero_affine=True)


def _scan_gains(spec: LQGSpec, Sigma0: torch.Tensor, horizon: int):
    """The scans' gains, the differentiable twin of K1."""
    from lqg_tpu_torch.ops import kalman, riccati

    g = riccati.backward(spec, horizon=horizon, regularize="none")
    K = kalman.forward(spec, Sigma0=Sigma0, horizon=horizon)
    return g.L, g.H, K


def _assoc_gains(spec: LQGSpec, Sigma0: torch.Tensor, horizon: int):
    """The associative scans' gains (:mod:`lqg_tpu_torch.parallel.pscan`),
    the O(log T)-depth differentiable twin of K1: the same math as
    :func:`_scan_gains`."""
    from lqg_tpu_torch.parallel.pscan import (kalman_forward_assoc,
                                              lqr_backward_assoc)

    g = lqr_backward_assoc(spec, horizon=horizon)
    K = kalman_forward_assoc(spec, Sigma0=Sigma0, horizon=horizon)
    return g.L, g.H, K


# The backward of fused_gains, read when it runs (gains.py:600-618):
#   "kernel" - K2, the analytic adjoint (the default);
#   "scan"   - autograd through the scans' twin;
#   "assoc"  - autograd through the associative scans' twin.
GAINS_VJP_METHOD = "kernel"
VJP_METHODS = ("kernel", "scan", "assoc")


class _FusedGains(torch.autograd.Function):
    """K1 forward, K2 backward (or, by :data:`GAINS_VJP_METHOD`, autograd
    through a twin); every input is ``(B, ., .)``."""

    @staticmethod
    def forward(ctx, A, Bm, Q, R, Qf, F, V, W, Sigma0, horizon):
        VV, WW = V @ mT(V), W @ mT(W)
        grad = any(ctx.needs_input_grad[:9])
        out = gains_fwd(A, Bm, Q, R, Qf, F, VV, WW, Sigma0, horizon,
                        stores=grad)
        if grad:
            ctx.save_for_backward(A, Bm, R, F, V, W, VV, WW, *out[3:], Q, Qf,
                                  Sigma0)
            ctx.horizon = horizon
        return out[:3]

    @staticmethod
    @once_differentiable
    def backward(ctx, Lbar, Hbar, Kbar):
        (A, Bm, R, F, V, W, VV, WW, S_st, P_st, Q, Qf,
         Sigma0) = ctx.saved_tensors
        if GAINS_VJP_METHOD not in VJP_METHODS:
            raise ValueError(f"GAINS_VJP_METHOD must be one of {VJP_METHODS},"
                             f" got {GAINS_VJP_METHOD!r}")
        if GAINS_VJP_METHOD != "kernel":
            twin = (_assoc_gains if GAINS_VJP_METHOD == "assoc"
                    else _scan_gains)
            with torch.enable_grad():
                ins = [x.detach().requires_grad_()
                       for x in (A, Bm, Q, R, Qf, F, V, W, Sigma0)]
                out = twin(_twin_spec(*ins[:8]), ins[8], ctx.horizon)
                bars = torch.autograd.grad(out, ins, (Lbar, Hbar, Kbar))
            return (*bars, None)
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
            f"spec outside the kernel's scope: a batched stationary spec with "
            f"n <= {MAX_N}, m <= {MAX_M}, p <= {MAX_P} and square noise "
            f"scales required")
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
fused_gains.design = None  # the K1 design launched last
fused_gains.design_launches = {"thread": 0, "block": 0}
fused_gains_vjp.launches = 0
