from lqg_tpu_torch.infer.dists import GaussianSequence, MultivariateNormal

__all__ = ["GaussianSequence", "MultivariateNormal"]
