"""The joint (state, belief) system on the card: ``F`` and ``Q = G G^T``
assembled from the gains straight into the layout K3/K4 read, and the
adjoint of that map.  Kernel source: ``lqg_tpu_torch/csrc/joint.cu``
(``joint_fwd``, ``joint_bwd``).

It replaces no TPU kernel: ``lqg_tpu`` assembles the joint system with jnp
ops (``lqg_tpu/ops/gaussian.py:joint_system``) that XLA fuses into the
likelihood's program.  In eager PyTorch the same assembly,
:func:`lqg_tpu_torch.ops.gaussian.joint_system` with ``G G^T`` and the move
of the time axis, ran as ~27 batched gemms over ``T P`` matrices of 1x2 to
4x4 (a 32x32 tile each) with their cats, expands and copies, forward and
backward.  What bounds the kernels on an H100 is bytes: at ``P = 96``,
``T = 1008`` the forward writes 12.4 MB and reads 1.5 MB, the adjoint about
as much.  The design, in the source's header: a thread a step, the set's
spec products formed once a block in shared memory, tiles written out
coalesced; the adjoint one block a set, its spec gradients summed over ``t``
in a fixed tree inside the block.

For a step ``t`` of set ``p``, with ``D = F_d B_d - F_a B_a``, ``S = V_d
V_d^T``, ``U = F_d S`` and ``Y = U F_d^T + W_d W_d^T`` once a set:

    F = [[A_d,        B_d L                           ],
         [K F_d A_d,  A_a - K F_a A_a + (B_a + K D) L ]]
    Q = [[S,          (K U)^T ],
         [K U,        K Y K^T ]]   (upper triangle of K Y K^T, mirrored)

the matrices of :func:`~lqg_tpu_torch.ops.gaussian.joint_system` and ``G
G^T``.  The kernels are templates on the six dims (ND, NA, NU, NY, NV, NW)
of the models, built at the instances of :data:`PART`; a shape with the
same ``(ND, NA)`` and fewer controls, observations or noise columns is
padded with zeros onto the smallest instance that holds it (the padding
leaves ``F`` and ``Q`` as they are, so nothing is sliced away), and a shape
that no instance holds keeps the old assembly (:func:`joint_fq_available`).

:func:`joint_fq_reference` is the plain PyTorch version, any float dtype:
the assembly the kernels replace, whose autograd is the plain adjoint.
:func:`joint_fq` takes it for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from lqg_tpu_torch.ops import gaussian
from lqg_tpu_torch.ops.kernels import nvcc
from lqg_tpu_torch.ops.kernels.gains import _grow, _on_card, _stream
from lqg_tpu_torch.ops.linalg import mT
from lqg_tpu_torch.spec import LQGSpec

# The instances of csrc/joint.cu, (ND, NA, NU, NY, NV, NW), each with the
# part of the source (nvcc.PARTS) whose library holds it.  Part 0: every
# dim=1 tracking model (the relative-observation one padded onto it), the
# SubjectiveActor, the delay wrapper at delay 1 around the dim=1 models,
# the hand model.  Part 1: the dim=2 tracking models (the point mass padded
# onto them), SubjectiveActor(dim=2), the delay wrapper at delay 2, the
# dim=3 models.
PART = {(2, 2, 1, 2, 2, 2): 0, (2, 3, 1, 2, 2, 2): 0, (4, 4, 1, 2, 4, 2): 0,
        (5, 5, 1, 2, 5, 2): 0, (4, 4, 2, 4, 4, 4): 1, (4, 6, 2, 4, 4, 4): 1,
        (6, 6, 1, 2, 6, 2): 1, (6, 6, 3, 6, 6, 6): 1}
INSTANCES = frozenset(PART)
MAX_J = 12  # K3/K4's scope; every instance lies within it


def spec_dims(dynamics: LQGSpec, actor: LQGSpec) -> Tuple[int, ...]:
    """``(ND, NA, NU, NY, NV, NW)`` of a pair of specs."""
    return (dynamics.A.shape[-1], actor.A.shape[-1], dynamics.B.shape[-1],
            dynamics.F.shape[-2], dynamics.V.shape[-1], dynamics.W.shape[-1])


def instance_for(dims: Sequence[int]):
    """The instance the kernels launch for ``dims``: the one with the same
    ``(ND, NA)`` and the fewest controls, observations and noise columns
    that hold these; None where no instance does."""
    fits = [k for k in INSTANCES if k[:2] == tuple(dims[:2])
            and all(a >= b for a, b in zip(k[2:], dims[2:]))]
    return min(fits, key=lambda k: sum(k[2:])) if fits else None


def joint_fq_available(dims: Sequence[int], dtype) -> bool:
    """Is there a kernel for specs of these dims: float32, ``ND + NA <=
    12`` and an instance that holds them."""
    return (dtype == torch.float32 and dims[0] + dims[1] <= MAX_J
            and instance_for(dims) is not None)


def _spec_mats(dynamics: LQGSpec, actor: LQGSpec):
    """The eight matrices the joint system reads, in the kernels' order."""
    return (dynamics.A, dynamics.B, dynamics.F, dynamics.V, dynamics.W,
            actor.A, actor.B, actor.F)


def joint_fq_reference(dynamics: LQGSpec, actor: LQGSpec, L: torch.Tensor,
                       K: torch.Tensor, horizon: int):
    """Plain PyTorch version of :func:`joint_fq`, any float dtype: the
    assembly the kernels replace, :func:`gaussian.joint_system`, ``G G^T``
    with its upper triangle mirrored (exactly symmetric, as the kernel
    writes it) and the time axis moved second.  Autograd through it is the
    plain adjoint."""
    joint = gaussian.joint_system(dynamics, actor, L, K, horizon)
    GG = joint.G @ mT(joint.G)
    Q = torch.triu(GG) + mT(torch.triu(GG, 1))
    return (torch.movedim(joint.F, 0, 1).contiguous(),
            torch.movedim(Q, 0, 1).contiguous())


def _lib(dims):
    """The library of the part that holds instance ``dims``."""
    lib = nvcc.load("joint", PART[dims])
    ptrs = ctypes.c_void_p
    lib.lqg_joint_fwd.argtypes = [ptrs, ptrs, ptrs, ptrs, ptrs, ptrs, ptrs,
                                  ctypes.c_int, ctypes.c_int, ptrs]
    lib.lqg_joint_fwd.restype = ctypes.c_int
    lib.lqg_joint_bwd.argtypes = [ptrs] * 9 + [ptrs, ctypes.c_int,
                                               ctypes.c_int, ptrs]
    lib.lqg_joint_bwd.restype = ctypes.c_int
    return lib


def _card_args(mats, dims):
    """The matrices as the C interface takes them: pointers, set strides in
    floats (0 for a matrix every set shares), the dims; and the tensors the
    pointers belong to, to be kept alive over the call."""
    keep = []
    for x in mats:
        r, c = x.shape[-2:]
        if (r > 1 and x.stride(-2) != c) or (c > 1 and x.stride(-1) != 1):
            x = x.contiguous()
        keep.append(x)
    strides = [0 if x.dim() == 2 or x.shape[0] == 1 else x.stride(0)
               for x in keep]
    c_mats = (ctypes.c_void_p * 8)(*(x.data_ptr() for x in keep))
    c_strides = (ctypes.c_longlong * 8)(*strides)
    c_dims = (ctypes.c_int * 6)(*dims)
    return c_mats, c_strides, c_dims, keep


def _dims(mats, L, K):
    """``(ND, NA, NU, NY, NV, NW)`` of the kernels' inputs."""
    return (mats[0].shape[-1], mats[5].shape[-1], L.shape[-2], K.shape[-1],
            mats[3].shape[-1], mats[4].shape[-1])


def _card_only(tensors, what):
    if not _on_card(tensors, what):
        raise ValueError(f"{what} launches a kernel and takes CUDA tensors; "
                         f"joint_fq takes the plain version on the CPU")


def joint_fwd(mats, L, K):
    """The forward kernel on checked inputs (every dim at its instance):
    ``F, Q (P, T, j, j)``.  CUDA float32 tensors only."""
    _card_only((L, K) + tuple(mats), "joint_fwd")
    T, P_ = L.shape[:2]
    dims = _dims(mats, L, K)
    L, K = L.contiguous(), K.contiguous()
    j = dims[0] + dims[1]
    F, Q = (torch.empty((P_, T, j, j), dtype=torch.float32, device=L.device)
            for _ in range(2))
    c_mats, c_strides, c_dims, _keep = _card_args(mats, dims)
    status = _lib(dims).lqg_joint_fwd(
        L.data_ptr(), K.data_ptr(), c_mats, c_strides, F.data_ptr(),
        Q.data_ptr(), c_dims, P_, T, _stream(L.device))
    nvcc.check(status, "joint_fwd")
    joint_fq.launches += 1
    return F, Q


def joint_fq_vjp(mats, L, K, Fbar, Qbar, needs: Optional[Sequence[bool]]
                 = None):
    """The adjoint kernel: ``(L-bar, K-bar, [eight spec gradients (P, r,
    c)])`` from ``F-bar, Q-bar (P, T, j, j)``; ``needs`` (ten flags, L, K
    and the eight matrices) leaves an output that is not needed None.  CUDA
    float32 tensors only."""
    needs = [True] * 10 if needs is None else list(needs)
    _card_only((L, K, Fbar, Qbar) + tuple(mats), "joint_bwd")
    T, P_ = L.shape[:2]
    dims = _dims(mats, L, K)
    L, K = L.contiguous(), K.contiguous()
    Fbar, Qbar = Fbar.contiguous(), Qbar.contiguous()
    new = lambda shape, need: (torch.empty(shape, dtype=torch.float32,
                                           device=L.device) if need else None)
    Lbar, Kbar = new(L.shape, needs[0]), new(K.shape, needs[1])
    bars = [new((P_,) + x.shape[-2:], need)
            for x, need in zip(mats, needs[2:])]
    c_mats, c_strides, c_dims, _keep = _card_args(mats, dims)
    c_bars = (ctypes.c_void_p * 8)(*(None if b is None else b.data_ptr()
                                     for b in bars))
    ptr = lambda x: None if x is None else x.data_ptr()
    status = _lib(dims).lqg_joint_bwd(
        L.data_ptr(), K.data_ptr(), c_mats, c_strides, Fbar.data_ptr(),
        Qbar.data_ptr(), ptr(Lbar), ptr(Kbar), c_bars, c_dims, P_, T,
        _stream(L.device))
    nvcc.check(status, "joint_bwd")
    joint_fq_vjp.launches += 1
    return (Lbar, Kbar, *bars)


class _JointFQ(torch.autograd.Function):
    """The forward kernel, the adjoint kernel backward; inputs ``L, K`` and
    the eight spec matrices."""

    @staticmethod
    def forward(ctx, L, K, *mats):
        F, Q = joint_fwd(mats, L, K)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(L, K, *mats)
        return F, Q

    @staticmethod
    @once_differentiable
    def backward(ctx, Fbar, Qbar):
        L, K, *mats = ctx.saved_tensors
        out = joint_fq_vjp(mats, L, K, Fbar, Qbar, ctx.needs_input_grad)
        # a matrix every set shares gets the sum over the sets
        return out[:2] + tuple(
            None if g is None else g.sum_to_size(x.shape)
            for g, x in zip(out[2:], mats))


def joint_fq(dynamics: LQGSpec, actor: LQGSpec, L: torch.Tensor,
             K: torch.Tensor, horizon: int):
    """The joint (state, belief) system as K3/K4 read it, differentiable.

    Args:
        dynamics, actor: stationary specs, their matrices ``(r, c)`` or with
            a parameter-set axis ``(P, r, c)``.
        L: ``(T, P, m, na)`` control gains; K: ``(T, P, na, p)`` Kalman
            gains (time leading, as K1 writes them).
        horizon: T.

    Returns ``F, Q (P, T, j, j)``, contiguous: ``F`` of
    :func:`~lqg_tpu_torch.ops.gaussian.joint_system` and ``Q = G G^T``,
    with the parameter-set axis first.  CUDA tensors launch the kernels
    (float32) or raise; CPU tensors take :func:`joint_fq_reference`.
    """
    if dynamics.A.dim() != dynamics.Qf.dim() or actor.A.dim() != actor.Qf.dim():
        raise ValueError("joint_fq takes stationary specs")
    if L.dim() != 4 or K.dim() != 4 or L.shape[0] != horizon \
            or K.shape[0] != horizon:
        raise ValueError(f"expected L (T, P, m, na), K (T, P, na, p) with "
                         f"T = {horizon}")
    mats = _spec_mats(dynamics, actor)
    if any(x.dim() > 3 for x in mats):
        raise ValueError("joint_fq takes at most one parameter-set axis")
    dims = spec_dims(dynamics, actor)
    inst = instance_for(dims)
    if inst is None:
        raise ValueError(f"dims {dims} outside the kernels' instances")
    if not _on_card((L, K) + tuple(mats), "joint system"):
        return joint_fq_reference(dynamics, actor, L, K, horizon)
    P_ = torch.broadcast_shapes(L.shape[1:2], K.shape[1:2],
                                *(x.shape[:-2] for x in mats))
    L = L.expand((horizon,) + P_ + L.shape[-2:])
    K = K.expand((horizon,) + P_ + K.shape[-2:])
    if inst != dims:  # zeros in the extra controls, observations, columns
        nd, na, nu, ny, nv, nw = inst
        size = ((nd, nd), (nd, nu), (ny, nd), (nd, nv), (ny, nw), (na, na),
                (na, nu), (ny, na))
        mats = [_grow(x, *rc) for x, rc in zip(mats, size)]
        L, K = _grow(L, nu, na), _grow(K, na, ny)
    return _JointFQ.apply(L, K, *mats)


joint_fq.launches = 0
joint_fq_vjp.launches = 0
