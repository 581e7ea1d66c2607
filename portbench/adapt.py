"""The sampler settings of a NUTS mix, from the program's own warm-up
adaptation: :class:`~lqg_tpu_torch.infer.mcmc.MCMC` run as a fit runs it
(dense mass at this size, Stan's windows, target acceptance 0.8), on the
cell's trials made from the seed, from the cell's initial point.  Prints
one JSON object: each chain's adapted step size, the inverse mass (each
chain's ``L L^T``, averaged), and the sampling phase's tree depths,
acceptance and divergences.  The benchmark's own runs do not run this; its
numbers go into the mix's file by hand.

    python3 -m portbench.adapt --workload bounded_fit.nuts4 --seed 11 \\
        --warmup 500 --samples 200
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from portbench import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--warmup", type=int, required=True)
    p.add_argument("--samples", type=int, required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("adapt: no CUDA device", file=sys.stderr)
        return 2
    from lqg_tpu_torch.infer.mcmc import MCMC

    t0 = time.perf_counter()
    cell = harness.Cell.load(args.workload)
    run = harness.Run(cell=cell, seed=args.seed, device=torch.device("cuda"))
    harness.set_up(run, t0)
    t = cell.traffic
    mcmc = MCMC(run.model, num_warmup=args.warmup, num_samples=args.samples,
                num_chains=t["chains"], max_depth=t["max_depth"],
                init_jitter=t["init_jitter"])
    t1 = time.perf_counter()
    mcmc.run(args.seed)
    seconds = time.perf_counter() - t1
    extra = mcmc.get_extra_fields()
    L = extra["inv_mass"].double().cpu()
    cov = (L @ L.mT).mean(0) if L.dim() == 3 else torch.diag_embed(L).mean(0)
    depth = np.asarray(extra["tree_depth"])
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "warmup": args.warmup, "samples": args.samples,
        "names": run.model.names, "seconds": seconds,
        "step_size": extra["step_size"].cpu().tolist(),
        "inv_mass": cov.tolist(),
        "mean_tree_depth": float(depth.mean()),
        "tree_depth_counts": np.bincount(depth.reshape(-1)).tolist(),
        "mean_leapfrogs": float(np.asarray(extra["num_steps"]).mean()),
        "accept_prob": float(np.asarray(extra["accept_prob"]).mean()),
        "divergences": int(np.asarray(extra["diverging"]).sum())}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
