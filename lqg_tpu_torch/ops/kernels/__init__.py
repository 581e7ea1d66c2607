"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``), each with
its plain PyTorch version beside it, each forward joined with its adjoint
in a ``torch.autograd.Function``.

* :mod:`~lqg_tpu_torch.ops.kernels.gains`: K1, fused Riccati + Kalman gains
  (replaces ``lqg_tpu/ops/pallas/gains.py:_gains_merged_kernel``), and K2,
  its adjoint (replaces ``gains.py:_gains_adjoint_kernel``);
* :mod:`~lqg_tpu_torch.ops.kernels.likelihood`: K3, fused conditioned
  likelihood (replaces ``lqg_tpu/ops/pallas/likelihood.py:_ll_fwd_kernel``),
  and K4, its adjoint (replaces ``likelihood.py:_ll_bwd_kernel``);
* :mod:`~lqg_tpu_torch.ops.kernels.likelihood_blocked`: K5, the same
  likelihood on whole matrices for joint dims 13 to 128, the delay-register
  models (replaces
  ``lqg_tpu/ops/pallas/likelihood_blocked.py:_ll_blocked_kernel``), and K6,
  its adjoint (replaces ``likelihood_blocked.py:_ll_blocked_bwd_kernel``).

* :mod:`~lqg_tpu_torch.ops.kernels.joint`: the joint (state, belief)
  system ``F``, ``Q = G G^T`` from the gains in the layout K3 reads, and
  its adjoint (no TPU counterpart: ``lqg_tpu`` leaves
  ``ops/gaussian.py:joint_system`` to XLA, which fuses it).

Every function of the JAX package that reaches ``pl.pallas_call`` has its
counterpart here.
"""
