"""K5 and K6: the large-j conditioned and marginalized trajectory likelihood
on the card, and its analytic adjoint.

K5 replaces ``lqg_tpu/ops/pallas/likelihood_blocked.py:_ll_blocked_kernel``
(via ``_blocked_ll_call``), K6 replaces
``likelihood_blocked.py:_ll_blocked_bwd_kernel`` (via ``_blocked_bwd_call``).
:func:`conditioned_log_likelihood_blocked` joins them in a
``torch.autograd.Function``, the counterpart of the JAX ``custom_vjp`` of
the same name.  Kernel source: ``lqg_tpu_torch/csrc/likelihood_blocked.cu``.

What it computes, per parameter set, on whole ``j x j`` matrices with the
trials in the trailing axis of the mean (``MU (j, n)``), in
condition-then-propagate form:

    init:  Sig_0 = Q_0,  MU_0 = [X_0; 0]
    t = 0..T-1:
        S = Sig[:d,:d]; Sinv = S^-1 (closed form, eps on the determinant)
        E = X_t - MU[:d];  SE = Sinv E
        if t >= 1:  quad_n += sum_r E SE;  ld += log det S     (Neumaier)
        Kc  = Sig[:, :d] Sinv
        Sc  = sym(Sig - Kc Sig[:d, :])
        MU  <- F_t (MU + Kc E)
        Sig <- (F_t Sc) F_t^T + Q_t
    final: score X_T against (Sig_T, MU_T)
    ll_n = -0.5 ((qc + lc + quad_T + log det S_T) + quad + ld + T d log 2pi)

Only ``Sig[:d, :d]`` is ever inverted: ``Q = G G^T`` of a delay model is
rank-deficient and ``Sig`` has exactly-zero rows early on, so neither is
factorized.

What bounds it on an H100: operations, nominally (three ``j^3``-sized
products a step: at 24 sets, T = 1008, j = 65 about 31 GFLOP against 0.8 GB
moved), but each set's T steps form one chain, so one thread block per set
put 24 of the card's 132 SMs to work.  A set runs on a cluster of ``C``
blocks (:func:`cluster_size`): each rank holds the full carries in its
shared memory, repeats the O(j^2) conditioning, computes its rows of the
``j^3`` products and writes them into every rank's next carry through
distributed shared memory, one cluster barrier a step.  Each output is one
thread's sum in a fixed order, so the result is the same bits at every
``C``.  The products are register-tiled float32 FMA loops at the true ``j``
(no padding to a tile, no TF32).

K6 (:func:`conditioned_log_likelihood_blocked_vjp`) runs the reverse
recursion of ``likelihood_blocked.py:250-273`` from the carries K5 stores
on the gradient path (``Sig_t``, ``MU_t`` for ``t = 0..T``).  The sums over
trials are contractions inside the cluster, so ``Fbar`` and ``Qbar`` are
written once per set and step: no per-trial copies, no atomics, a fixed
order.  Its contractions over all rows are partials over each rank's rows,
added in rank order after a cluster barrier; a second barrier ends the
step.  The ``t = 0`` boundary (``Sig_0 = Q_0``, ``MU_0 = [X_0; 0]``) is
folded inside the kernel.  ``Qbar`` comes back in the symmetric gauge.

The plain PyTorch versions
:func:`conditioned_log_likelihood_blocked_reference` and
:func:`conditioned_log_likelihood_blocked_vjp_reference` repeat the
arithmetic (same closed-form inverses, same ``eps``, same Neumaier order,
the same grouping of the products); the wrappers take them only for tensors
on the CPU.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as nnf
from torch.autograd.function import once_differentiable

from lqg_tpu_torch.ops.linalg import mT
from lqg_tpu_torch.ops.kernels import nvcc
from lqg_tpu_torch.ops.kernels.gains import EPS, _on_card, _sym, _sym_inv_det
from lqg_tpu_torch.ops.kernels.likelihood import _neumaier_add

_LOG_2PI = math.log(2.0 * math.pi)

# the kernels' scope (likelihood_blocked.py:350-351)
MIN_J, MAX_J, MAX_D, MAX_N = 13, 128, 4, 128
# threads a block, the kernels' most (__launch_bounds__): at 128 registers
# a thread one block fills an SM's register file, so the card runs one block
# an SM whatever the count, and more warps hide more of the latency of a
# step's dependent phases (PERF.md, section 6); every count gives the same
# bits
MAX_THREADS = 512
# shared memory a block may use on Hopper, and what the kernels keep for
# their static buffers
SMEM_LIMIT = 232448
SMEM_RESERVE = 1024
# cluster sizes a parameter set may run on, and the fewest rows a rank owns
# under the wrapper's rule
CLUSTERS = (1, 2, 4, 8)
MIN_PANEL = 8
# floats of the kernels' table of the ranks' carry addresses (kTable)
_TABLE = 64


def _score(Sig, MU, Xt, d):
    """Score of the data ``Xt (P, d, n)`` against ``(Sig[:d,:d], MU[:d])``:
    per-trial ``e^T S^-1 e`` summed in row order, ``det S``, ``S^-1``, ``E``
    and ``S^-1 E``."""
    Sinv, det = _sym_inv_det(Sig[..., :d, :d])
    E = Xt - MU[..., :d, :]
    SE = Sinv @ E
    quad = E[..., 0, :] * SE[..., 0, :]
    for r in range(1, d):
        quad = quad + E[..., r, :] * SE[..., r, :]
    return quad, det, Sinv, E, SE


def _condition(Sig, Sinv, d):
    """``Kc = Sig[:, :d] Sinv``, ``KcT = Sinv Sig[:d, :]`` and the
    conditioned covariance ``Sc = sym(Sig - Kc Sig[:d, :])``."""
    R = Sig[..., :d, :]
    Kc = Sig[..., :, :d] @ Sinv
    return Kc, Sinv @ R, _sym(Sig - Kc @ R)


def conditioned_log_likelihood_blocked_reference(F: torch.Tensor,
                                                 Q: torch.Tensor,
                                                 X: torch.Tensor,
                                                 stores: bool = False):
    """Plain PyTorch version of K5: batched over parameter sets, a Python
    loop over T.  Same contract as
    :func:`conditioned_log_likelihood_blocked`, any float dtype; with
    ``stores`` it also returns K5's stores, the carries ``(Sig_t, MU_t)``,
    ``t = 0..T``: ``(P, T+1, j, j)`` and ``(P, T+1, j, n)``."""
    P_, T, j, _ = F.shape
    n, d = X.shape[1], X.shape[-1]
    Xt = X.permute(0, 2, 3, 1)  # (P, T+1, d, n): trials trailing
    Sig = Q[:, 0]
    MU = nnf.pad(Xt[:, 0], (0, 0, 0, j - d))
    quad_acc = quad_c = X.new_zeros((P_, n))
    ld_acc = ld_c = X.new_zeros((P_,))
    Sigs, MUs = [], []
    for t in range(T):
        Sigs.append(Sig)
        MUs.append(MU)
        quad, det, Sinv, E, _ = _score(Sig, MU, Xt[:, t], d)
        mask = 1.0 if t >= 1 else 0.0
        quad_acc, quad_c = _neumaier_add(quad_acc, quad_c, mask * quad)
        ld_acc, ld_c = _neumaier_add(ld_acc, ld_c, mask * torch.log(det))
        Kc, _, Sc = _condition(Sig, Sinv, d)
        MU = F[:, t] @ (MU + Kc @ E)
        Sig = torch.baddbmm(Q[:, t], F[:, t] @ Sc, mT(F[:, t]))
    quad, det, _, _, _ = _score(Sig, MU, Xt[:, T], d)
    # fold the compensation terms (small) before the large partials
    total = ((((quad_c + ld_c[:, None]) + quad) + torch.log(det)[:, None])
             + quad_acc) + ld_acc[:, None] + T * d * _LOG_2PI
    ll = -0.5 * total
    if not stores:
        return ll
    Sigs.append(Sig)
    MUs.append(MU)
    return ll, torch.stack(Sigs, 1), torch.stack(MUs, 1)


def conditioned_log_likelihood_blocked_vjp_reference(F, X, w, Sig_st, MU_st):
    """Plain PyTorch version of K6: batched over parameter sets, a Python
    loop over T.  Same contract as
    :func:`conditioned_log_likelihood_blocked_vjp`, any float dtype."""
    P_, T, j, _ = F.shape
    d = X.shape[-1]
    Xt = X.permute(0, 2, 3, 1)  # (P, T+1, d, n)
    wr = w[:, None, :]  # (P, 1, n): weights along the trial axis
    wsum = w.sum(-1)[:, None, None]

    # seed: adjoint of the final score on (Sig_T, MU_T)
    _, _, Sinv, _, SE = _score(Sig_st[:, T], MU_st[:, T], Xt[:, T], d)
    SEw = SE * wr
    m = nnf.pad(SEw, (0, 0, 0, j - d))
    B = nnf.pad(0.5 * (SEw @ mT(SE) - wsum * Sinv), (0, j - d, 0, j - d))

    Fbars, Qbars, Xbars = [], [], [-SEw]
    for t in range(T - 1, -1, -1):
        Sig, MU, F_t = Sig_st[:, t], MU_st[:, t], F[:, t]
        # recompute the forward intermediates from the stored carry
        _, _, Sinv, E, SE = _score(Sig, MU, Xt[:, t], d)
        Kc, KcT, Sc = _condition(Sig, Sinv, d)
        MUc = MU + Kc @ E
        mask = 1.0 if t >= 1 else 0.0

        Bs = _sym(B)
        # grouped as K6 groups them: (Bs F) Sc, and (Bs F)^T F for F^T Bs F
        BsF = Bs @ F_t
        Fbar = 2.0 * (BsF @ Sc) + m @ mT(MUc)
        Scrb = mT(BsF) @ F_t
        MUc_bar = mT(F_t) @ m
        Kcbar = -(Scrb @ Sig[..., :, :d]) + MUc_bar @ mT(E)
        Ebar = KcT @ MUc_bar - mask * (SE * wr)
        Sinvbar = _sym(Sig[..., :d, :] @ Kcbar
                       - (mask * 0.5) * ((E * wr) @ mT(E)))
        Sbar = -(Sinv @ (Sinvbar @ Sinv)) - (mask * 0.5) * (wsum * Sinv)
        rows = -(KcT @ Scrb)  # rows < d
        cols = Kcbar @ Sinv  # columns < d
        B = (Scrb + nnf.pad(rows, (0, 0, 0, j - d))
             + nnf.pad(cols, (0, j - d)) + nnf.pad(Sbar, (0, j - d, 0, j - d)))
        m = MUc_bar - nnf.pad(Ebar, (0, 0, 0, j - d))
        # t = 0: Sig_0 = Q_0 and MU_0 = [X_0; 0], so the carries' cotangents
        # fold into Qbar_0 and Xbar_0
        Qbars.append(Bs + _sym(B) if t == 0 else Bs)
        Xbars.append(Ebar + m[..., :d, :] if t == 0 else Ebar)
        Fbars.append(Fbar)
    Xbar = torch.stack(Xbars[::-1], 1).permute(0, 3, 1, 2)  # (P, n, T+1, d)
    return torch.stack(Fbars[::-1], 1), torch.stack(Qbars[::-1], 1), Xbar


def blocked_ll_available(j: int, d: int, n: int, dtype) -> bool:
    """Kernel scope: ``12 < j <= 128``, ``d <= 4``, ``n <= 128``, float32."""
    return (MIN_J <= j <= MAX_J and 1 <= d <= MAX_D and d <= j
            and 1 <= n <= MAX_N and dtype == torch.float32)


def cluster_size(P: int, j: int, sms: int) -> int:
    """Blocks of the cluster that runs one parameter set: the largest ``C``
    of :data:`CLUSTERS` with ``P C <= sms`` (one SM a block) and at least
    :data:`MIN_PANEL` rows a rank.  At the fit's 24 sets (j = 65) on 132
    SMs that is 4; for the one set of the forward delay path, 8."""
    fits = [C for C in CLUSTERS
            if P * C <= sms and -(-j // C) >= MIN_PANEL]
    return max(fits, default=1)


def row_panels(j: int, C: int) -> list:
    """``(start, rows)`` of each rank: a near-even split of ``[0, j)``,
    the larger panels first (the kernels' ``row_panel``)."""
    base, extra = divmod(j, C)
    return [(r * base + min(r, extra), base + (r < extra)) for r in range(C)]


def _round4(k: int) -> int:
    return (k + 3) // 4 * 4


def _small_floats(j: int, d: int, n: int, C: int = 0) -> int:
    """Floats of the kernels' small buffers: the table of the ranks' carry
    addresses, Kc, KcT, the first d rows and columns of Sig, Kcbar, the
    row correction, E, SE, Ebar, two d x d scalars and, for K6 (``C`` > 0),
    the C ranks' partials of the three contractions over rows."""
    partials = C * (d * j + d * n + d * d)
    return (_TABLE + _round4(6 * j * d) + _round4(3 * d * n) + 32
            + _round4(partials))


def plan_buffers(small: int, sizes) -> tuple:
    """Place the kernels' large buffers after ``small`` floats of small
    ones: ``sizes`` lists their floats in order of priority; each goes to
    shared memory while the block's budget lasts and to a per-rank scratch
    in device memory after that.  The last is the staged ``F_t``: without
    room it gets no scratch, the kernel then reads ``F_t`` where it lies.

    Returns ``(place, smem_floats, scratch_floats)``: ``place[i] >= 0`` is
    buffer ``i``'s offset in shared memory, ``place[i] < 0`` means offset
    ``-place[i] - 1`` in the rank's scratch.
    """
    used = small
    budget = (SMEM_LIMIT - SMEM_RESERVE) // 4
    if used > budget:
        raise ValueError(f"blocked likelihood: the per-step buffers alone "
                         f"({used * 4} B) exceed the block's shared memory")
    place, scratch = [], 0
    for i, size in enumerate(sizes):
        size = _round4(size)
        if used + size <= budget:
            place.append(used)
            used += size
        elif i == len(sizes) - 1:
            place.append(-1)
        else:
            place.append(-scratch - 1)
            scratch += size
    return tuple(place), used, scratch


def fwd_sizes(j: int, n: int, C: int = 1) -> tuple:
    """K5's large buffers for one rank of a cluster of ``C``: two Sig and
    two MU (the carries, double-buffered: the ranks write the next while
    they read the current), the rank's rows of ``F Sc``, and the staged
    ``F_t``."""
    rows = row_panels(j, C)[0][1]
    return (j * j, j * j, j * n, j * n, rows * j, j * j)


def bwd_sizes(j: int, n: int, C: int = 1) -> tuple:
    """K6's large buffers for one rank: the carry ``B``, Sig (then Sc), the
    carry ``m``, MU (then MUc), the rank's rows and columns of ``Bs F``, its
    rows of ``Scrb`` and of ``MUc_bar``, and the staged ``F_t``."""
    rows = row_panels(j, C)[0][1]
    return (j * j, j * j, j * n, j * n, rows * j, j * rows, rows * j,
            rows * n, j * j)


def fwd_plan(j: int, d: int, n: int, C: int = 1) -> tuple:
    """K5's buffer plan for one rank of a cluster of ``C``."""
    return plan_buffers(_small_floats(j, d, n), fwd_sizes(j, n, C))


def bwd_plan(j: int, d: int, n: int, C: int = 1) -> tuple:
    """K6's buffer plan for one rank of a cluster of ``C``."""
    return plan_buffers(_small_floats(j, d, n, C), bwd_sizes(j, n, C))


def _lib():
    lib = nvcc.load("likelihood_blocked")
    lib.lqg_ll_blocked_fwd.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 15
        + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    lib.lqg_ll_blocked_fwd.restype = ctypes.c_int
    lib.lqg_ll_blocked_bwd.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 18
        + [ctypes.c_float, ctypes.c_void_p])
    lib.lqg_ll_blocked_bwd.restype = ctypes.c_int
    lib.lqg_ll_blocked_max_clusters.argtypes = (
        [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)])
    lib.lqg_ll_blocked_max_clusters.restype = ctypes.c_int
    return lib


def _check_scope(j, d, n):
    if not blocked_ll_available(j, d, n, torch.float32):
        raise ValueError(
            f"(j, d, n) = {(j, d, n)} outside the blocked kernels' scope: "
            f"{MIN_J} <= j <= {MAX_J}, d <= {MAX_D}, n <= {MAX_N}")


_active_clusters = {}


def max_active_clusters(kernel: int, d: int, C: int, threads: int,
                        smem_bytes: int) -> int:
    """Clusters of ``C`` blocks the card runs at once
    (``cudaOccupancyMaxActiveClusters``) for K5 (``kernel`` 0 store-free,
    1 with stores) or K6 (2); cached."""
    key = (torch.cuda.current_device(), kernel, d, C, threads, smem_bytes)
    if key not in _active_clusters:
        count = ctypes.c_int(0)
        nvcc.check(_lib().lqg_ll_blocked_max_clusters(
            kernel, d, C, threads, smem_bytes, ctypes.byref(count)),
            "cudaOccupancyMaxActiveClusters")
        _active_clusters[key] = count.value
    return _active_clusters[key]


def _launch_plan(kernel, P, j, d, n, device, cluster):
    """``(C, place, smem_floats, scratch_floats)`` of a launch: ``cluster``
    where the caller gives it, else :func:`cluster_size`, lowered while
    the card runs fewer than ``P`` clusters of that shape at once."""
    plan = bwd_plan if kernel == 2 else fwd_plan
    if cluster is not None:
        if cluster not in CLUSTERS:
            raise ValueError(f"cluster={cluster}: expected one of {CLUSTERS}")
        return (cluster,) + plan(j, d, n, cluster)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    C = cluster_size(P, j, sms)
    while True:
        place, smem, scratch = plan(j, d, n, C)
        if C == 1 or max_active_clusters(kernel, d, C, MAX_THREADS,
                                         smem * 4) >= P:
            return C, place, smem, scratch
        C //= 2


def ll_blocked_fwd(F, Q, X, stores: bool = False, cluster=None):
    """K5 on checked inputs: ``ll (P, n)`` and, with ``stores``, the
    carries ``(Sig_t, MU_t)`` K6 reads, ``(P, T+1, j, j)`` and ``(P, T+1,
    j, n)``.  A CUDA tensor launches the kernel (float32) or raises; a CPU
    tensor takes the plain version.  ``cluster`` fixes the blocks a
    parameter set runs on (tests and timing); by default the wrapper picks
    them (:func:`cluster_size`).  The result is the same bits at every
    cluster size."""
    if not _on_card((F, Q, X), "blocked likelihood"):
        return conditioned_log_likelihood_blocked_reference(F, Q, X, stores)
    P_, T, j, _ = F.shape
    n, d = X.shape[1], X.shape[-1]
    _check_scope(j, d, n)
    C, place, smem, scratch = _launch_plan(int(stores), P_, j, d, n,
                                           F.device, cluster)
    F, Q, X = F.contiguous(), Q.contiguous(), X.contiguous()
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=F.device)
    ll = new(P_, n)
    st = (new(P_, T + 1, j, j), new(P_, T + 1, j, n)) if stores else ()
    work = new(P_ * C, max(scratch, 1))
    status = _lib().lqg_ll_blocked_fwd(
        F.data_ptr(), Q.data_ptr(), X.data_ptr(), ll.data_ptr(),
        *([x.data_ptr() for x in st] if stores else [None, None]),
        work.data_ptr(), j, d, P_, C, n, T, MAX_THREADS, smem * 4, scratch,
        *place, EPS, T * d * _LOG_2PI,
        torch.cuda.current_stream(F.device).cuda_stream)
    nvcc.check(status, "ll_blocked_fwd")
    conditioned_log_likelihood_blocked.launches += 1
    conditioned_log_likelihood_blocked.cluster = C
    return (ll,) + st if stores else ll


def conditioned_log_likelihood_blocked_vjp(F, X, w, Sig_st, MU_st,
                                           cluster=None):
    """K6: the cotangents of K5's inputs from ``w``, that of its output.

    Args:
        F: ``(P, T, j, j)`` joint transitions; X: ``(P, n, T+1, d)``.
        w: ``(P, n)`` cotangent of the per-trial log likelihoods.
        Sig_st, MU_st: K5's stores, ``(P, T+1, j, j)`` and ``(P, T+1, j,
            n)``.
        cluster: blocks a parameter set runs on, as for
            :func:`ll_blocked_fwd`.

    Returns ``(Fbar, Qbar)``, each ``(P, T, j, j)`` with ``Qbar``
    symmetric, and ``Xbar (P, n, T+1, d)``.  A CUDA tensor launches the
    kernel (float32) or raises; a CPU tensor takes the plain version.
    """
    ins = (F, X, w, Sig_st, MU_st)
    if not _on_card(ins, "blocked likelihood adjoint"):
        return conditioned_log_likelihood_blocked_vjp_reference(*ins)
    P_, T, j, _ = F.shape
    n, d = X.shape[1], X.shape[-1]
    _check_scope(j, d, n)
    C, place, smem, scratch = _launch_plan(2, P_, j, d, n, F.device, cluster)
    ins = [x.contiguous() for x in ins]
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=F.device)
    Fbar, Qbar, Xbar = new(P_, T, j, j), new(P_, T, j, j), new(P_, n, T + 1, d)
    work = new(P_ * C, max(scratch, 1))
    status = _lib().lqg_ll_blocked_bwd(
        *(x.data_ptr() for x in ins), Fbar.data_ptr(), Qbar.data_ptr(),
        Xbar.data_ptr(), work.data_ptr(), j, d, P_, C, n, T, MAX_THREADS,
        smem * 4, scratch, *place, EPS,
        torch.cuda.current_stream(F.device).cuda_stream)
    nvcc.check(status, "ll_blocked_bwd")
    conditioned_log_likelihood_blocked_vjp.launches += 1
    conditioned_log_likelihood_blocked_vjp.cluster = C
    return Fbar, Qbar, Xbar


class _BlockedLikelihood(torch.autograd.Function):
    """K5 forward, K6 backward."""

    @staticmethod
    def forward(ctx, F, Q, X):
        if not any(ctx.needs_input_grad):
            return ll_blocked_fwd(F, Q, X)
        ll, Sig_st, MU_st = ll_blocked_fwd(F, Q, X, stores=True)
        ctx.save_for_backward(F, X, Sig_st, MU_st)
        return ll

    @staticmethod
    @once_differentiable
    def backward(ctx, w):
        F, X, Sig_st, MU_st = ctx.saved_tensors
        return conditioned_log_likelihood_blocked_vjp(F, X, w, Sig_st, MU_st)


def conditioned_log_likelihood_blocked(F: torch.Tensor, Q: torch.Tensor,
                                       X: torch.Tensor):
    """Marginalized trajectory log likelihood for large joint dims,
    differentiable.

    Same contract as
    :func:`lqg_tpu_torch.ops.kernels.likelihood.conditioned_log_likelihood_fused`
    (``F, Q (P, T, j, j)``, ``X (P, n, T+1, d)`` -> ``(P, n)``), for ``12 <
    j <= 128``, ``d <= 4``, ``n <= 128``.  A CUDA tensor launches K5
    (float32) and, for the gradient, K6, or raises; a CPU tensor takes
    their plain versions.  The gradient of ``Q`` comes back symmetric.
    """
    if F.dim() != 4 or Q.shape != F.shape or X.dim() != 4:
        raise ValueError("expected F, Q (P, T, j, j) and X (P, n, T+1, d)")
    P_, T, j, _ = F.shape
    n, d = X.shape[1], X.shape[-1]
    if X.shape[0] != P_ or X.shape[2] != T + 1:
        raise ValueError(f"X {tuple(X.shape)} does not match F "
                         f"{tuple(F.shape)}: expected ({P_}, n, {T + 1}, d)")
    _check_scope(j, d, n)
    return _BlockedLikelihood.apply(F, Q, X)


# launches, and the cluster size of the last launch
conditioned_log_likelihood_blocked.launches = 0
conditioned_log_likelihood_blocked_vjp.launches = 0
conditioned_log_likelihood_blocked.cluster = None
conditioned_log_likelihood_blocked_vjp.cluster = None
