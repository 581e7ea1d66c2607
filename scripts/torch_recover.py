"""Parameter-recovery CLI on the PyTorch/CUDA port.

The workflow of ``scripts/recover.py`` (reference ``main.py``) with
``lqg_tpu_torch``'s modules: draw ground-truth parameters from the prior,
simulate trajectories, run NUTS, print, plot and save the posterior summary
with the truth attached.  The CLI is the JAX script's, with ``--device``
(default ``cuda``) in place of ``--platform``.

Example:
    python scripts/torch_recover.py --model BoundedActor --ntrial 20 \
        --time 720 --nsamp 500 --nwarmup 500 --nchain 4 --no-plot --save
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(args=None):
    parser = argparse.ArgumentParser(description="Parameter recovery runs")
    parser.add_argument("--ntrial", type=int, default=20,
                        help="Number of trials.")
    parser.add_argument("--seed", type=int, default=7432,
                        help="Seed for the simulation")
    parser.add_argument("--time", type=int, default=720,
                        help="Time steps per trial")
    parser.add_argument("--nsamp", type=int, default=5_000,
                        help="Number of samples drawn by NUTS")
    parser.add_argument("--nwarmup", type=int, default=2_500,
                        help="Number of burn-in samples.")
    parser.add_argument("--nchain", type=int, default=4,
                        help="Number of chains.")
    parser.add_argument("--model", type=str, default="BoundedActor",
                        help="Model type (lqg_tpu_torch.tracking)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device (cuda, or cpu)")
    parser.add_argument("--plot", action=argparse.BooleanOptionalAction,
                        default=True)
    parser.add_argument("--save", action=argparse.BooleanOptionalAction)
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="Checkpoint the in-flight run here (and resume "
                             "from it if present)")
    return parser.parse_args(args=args)


def main(args=None):
    """Run the recovery; returns ``(truth, mcmc, summary)``."""
    args = parse_args(args)

    import torch

    from lqg_tpu_torch import tracking
    from lqg_tpu_torch.config import resolve_device
    from lqg_tpu_torch.infer.utils import infer, sample_from_prior
    from lqg_tpu_torch.results import save_summary_csv

    device = resolve_device(args.device)
    Model = getattr(tracking, args.model)

    params = sample_from_prior(Model, args.seed, device=device)
    print({k: float(v) for k, v in params.items()})

    model = Model(T=args.time, device=device, **params)
    x = model.simulate(torch.Generator(device=device).manual_seed(args.seed),
                       n=args.ntrial)[..., :2]

    if args.plot:
        import matplotlib.pyplot as plt

        xs = x.cpu().numpy()
        plt.plot(xs[0, :, 0])
        plt.plot(xs[0, :, 1])
        plt.xlabel("time")
        plt.ylabel("position")
        plt.show()

    mcmc = infer(x, num_samples=args.nsamp, num_warmup=args.nwarmup,
                 model=Model, num_chains=args.nchain, seed=args.seed,
                 checkpoint_path=args.checkpoint)
    summary = mcmc.print_summary()

    if args.plot:
        import matplotlib.pyplot as plt

        samples = {k: v.numpy() for k, v in mcmc.get_samples().items()}
        names = list(samples)
        fig, axes = plt.subplots(len(names), len(names), figsize=(10, 10))
        for i, a in enumerate(names):
            for j, b in enumerate(names):
                ax = axes[i][j]
                if i == j:
                    ax.hist(samples[a], bins=40)
                else:
                    ax.scatter(samples[b], samples[a], s=2, alpha=0.3)
                if i == len(names) - 1:
                    ax.set_xlabel(b)
                if j == 0:
                    ax.set_ylabel(a)
        plt.tight_layout()
        plt.show()

    if args.save:
        path = f"results/parameter-recovery/{args.model}-{args.seed}.csv"
        save_summary_csv(path, summary, true_params=params, seed=args.seed)
        print(f"saved {path}")
    return params, mcmc, summary


if __name__ == "__main__":
    main()
