"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``), each with
its plain PyTorch version beside it, each forward joined with its adjoint
in a ``torch.autograd.Function``.

* :mod:`~lqg_tpu_torch.ops.kernels.gains`: K1, fused Riccati + Kalman gains
  (replaces ``lqg_tpu/ops/pallas/gains.py:_gains_merged_kernel``), and K2,
  its adjoint (replaces ``gains.py:_gains_adjoint_kernel``);
* :mod:`~lqg_tpu_torch.ops.kernels.likelihood`: K3, fused conditioned
  likelihood (replaces ``lqg_tpu/ops/pallas/likelihood.py:_ll_fwd_kernel``),
  and K4, its adjoint (replaces ``likelihood.py:_ll_bwd_kernel``).
"""
