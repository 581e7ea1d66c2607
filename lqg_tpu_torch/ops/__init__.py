from lqg_tpu_torch.ops import riccati, kalman, gaussian, linalg

__all__ = ["riccati", "kalman", "gaussian", "linalg"]
