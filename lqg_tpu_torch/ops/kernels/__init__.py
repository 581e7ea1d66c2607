"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``), each with
its plain PyTorch version beside it.

* :mod:`~lqg_tpu_torch.ops.kernels.gains`: K1, fused Riccati + Kalman gains
  (replaces ``lqg_tpu/ops/pallas/gains.py:_gains_merged_kernel``);
* :mod:`~lqg_tpu_torch.ops.kernels.likelihood`: K3, fused conditioned
  likelihood (replaces ``lqg_tpu/ops/pallas/likelihood.py:_ll_fwd_kernel``).
"""
