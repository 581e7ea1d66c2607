"""Simulation-based recovery at the real-data scale on the PyTorch/CUDA
port (``scripts/recover_at_scale.py``'s validation study).

Simulate the complete experiment (6 conditions x 20 trials x T steps, the
shape of the data.mat fit) from known ground-truth parameters with a rising
``sigma_target`` profile, run the hierarchical fit of
``scripts/torch_fit_data.py`` (MAP, ``ll_baseline`` at the MAP, NUTS) and
report whether the posterior recovers the trend.  The CLI is the JAX
script's, with ``--device`` (default ``cuda``) in place of ``--platform``.

Example:
    python scripts/torch_recover_at_scale.py --model SubjectiveActor \
        --nsamp 800 --nburnin 600 --nchain 8 --max-depth 8 \
        --max-leapfrogs 4096 --init map --init-jitter 0.02
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(args=None):
    parser = argparse.ArgumentParser(
        description="Data-scale simulation-based recovery study")
    parser.add_argument("--model", type=str, default="SubjectiveActor")
    parser.add_argument("--time", type=int, default=1008,
                        help="Samples per trial (data.mat post-clip length)")
    parser.add_argument("--ntrial", type=int, default=20)
    parser.add_argument("--sigma-targets", type=float, nargs="*",
                        default=[8.6, 10.5, 12.6, 21.4, 29.1, 49.9],
                        help="Ground-truth per-condition sigma_target "
                             "profile (default: rising, the BoundedActor "
                             "data.mat posterior means)")
    parser.add_argument("--truth", type=str, nargs="*", default=[],
                        help="Ground-truth shared parameters as name=value "
                             "(defaults per model below)")
    parser.add_argument("--nsamp", type=int, default=800)
    parser.add_argument("--nburnin", type=int, default=600)
    parser.add_argument("--nchain", type=int, default=8)
    parser.add_argument("--max-depth", type=int, default=8)
    parser.add_argument("--max-leapfrogs", type=int, default=4096)
    parser.add_argument("--init", type=str, default="map",
                        choices=["median", "map"])
    parser.add_argument("--map-steps", type=int, default=1500)
    parser.add_argument("--init-jitter", type=float, default=0.02)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--out", type=str, default="results/recovery-at-scale")
    parser.add_argument(
        "--shared_params", type=str, nargs="*",
        default=["action_variability", "action_cost", "sigma_cursor",
                 "subj_noise", "subj_vel_noise"],
        help="Parameters shared across conditions (reference "
             "cpp_data_fit.py defaults)")
    return parser.parse_args(args=args)


# ground-truth shared parameters: the BoundedActor data.mat MAP for the
# overlapping parameters, prior-plausible values for the subjective-model
# extras (the JAX script's)
DEFAULT_TRUTH = {
    "action_cost": 0.0012,
    "action_variability": 0.42,
    "sigma_cursor": 30.0,
    "subj_noise": 1.0,
    "subj_vel_noise": 0.5,
    "sigma": 30.0,           # RelativeObservationBoundedActor
}


def main(args=None):
    """Run the study; returns its report (the dict written as JSON)."""
    args = parse_args(args)

    import numpy as np
    import torch

    from lqg_tpu_torch import tracking
    from lqg_tpu_torch.config import resolve_device
    from lqg_tpu_torch.infer.mcmc import MCMC, Draws
    from lqg_tpu_torch.infer.models import (get_model_params,
                                            shared_params_lqg_model)
    from lqg_tpu_torch.results import save_netcdf

    device = resolve_device(args.device)
    Model = getattr(tracking, args.model)
    model_params = list(get_model_params(Model).keys())
    shared = [p for p in args.shared_params if p in model_params]

    truth = {k: v for k, v in DEFAULT_TRUTH.items() if k in shared}
    for kv in args.truth:
        name, value = kv.split("=")
        truth[name] = float(value)
    sigma_targets = list(args.sigma_targets)
    Nc = len(sigma_targets)

    print(f"ground truth: sigma_target = {sigma_targets} (rising)")
    print("              " + ", ".join(f"{k}={v}" for k, v in truth.items()))

    # --- simulate the full experiment, condition c from the seed (seed, 2, c)
    seeds = Draws(args.seed, device)
    conds = []
    for c, st in enumerate(sigma_targets):
        m = Model(T=args.time - 1, sigma_target=st, device=device, **truth)
        conds.append(m.simulate(seeds._seeded(2, c), n=args.ntrial)[..., :2])
    data = torch.stack(conds)   # (Nc, ntrial, T, 2)
    print("simulated data:", tuple(data.shape))

    # --- the hierarchical fit of torch_fit_data.py ---
    prob_model = shared_params_lqg_model(data, Model, shared_params=shared)

    if args.init == "map":
        from lqg_tpu_torch.infer.svi import optimize

        t0 = time.perf_counter()
        map_params, losses = optimize(prob_model, steps=args.map_steps,
                                      step_size=0.05)
        prob_model.init = dict(map_params)
        print(f"[map] {args.map_steps} Adam steps in "
              f"{time.perf_counter() - t0:.1f}s, potential "
              f"{float(losses[-1]):.1f}; init at MAP:", flush=True)
        print("      " + ", ".join(f"{k}={float(v):.4g}"
                                   for k, v in map_params.items()),
              flush=True)
    baseline, before, after = prob_model.set_baseline()
    print(f"[baseline] ll_baseline = {baseline:.8g}; potential at the init "
          f"{before:.8g} at baseline 0, {after:.8g} now", flush=True)

    mcmc = MCMC(prob_model, num_warmup=args.nburnin, num_samples=args.nsamp,
                num_chains=args.nchain, max_depth=args.max_depth,
                progress=True, init_jitter=args.init_jitter,
                max_leapfrogs_per_launch=args.max_leapfrogs)
    mcmc.run(args.seed + 1, checkpoint_path=args.checkpoint)
    mcmc.print_summary()

    samples = {k: v.numpy()
               for k, v in mcmc.get_samples(group_by_chain=True).items()}
    os.makedirs(args.out, exist_ok=True)
    nc_path = os.path.join(args.out, f"{args.model}-recovery.nc")
    save_netcdf(nc_path, samples,
                attrs=dict(model=args.model, seed=args.seed,
                           shared_params=",".join(shared),
                           study="simulation-based recovery at data scale"))

    # --- recovery report ---
    from scipy.stats import spearmanr

    st_names = [f"sigma_target_{c}" for c in range(Nc)]
    means = np.array([float(np.mean(samples[s])) for s in st_names])
    q5 = np.array([float(np.quantile(samples[s], 0.05)) for s in st_names])
    q95 = np.array([float(np.quantile(samples[s], 0.95)) for s in st_names])
    rho, _ = spearmanr(np.arange(Nc), means)
    rho_truth, _ = spearmanr(sigma_targets, means)

    print("\ncondition: true sigma_target -> posterior mean [5%, 95%]")
    covered = 0
    for c in range(Nc):
        hit = q5[c] <= sigma_targets[c] <= q95[c]
        covered += hit
        print(f"  {c}: {sigma_targets[c]:7.2f} -> {means[c]:7.2f} "
              f"[{q5[c]:7.2f}, {q95[c]:7.2f}] {'ok' if hit else 'MISS'}")

    report = {
        "model": args.model,
        "truth": {**truth, "sigma_target": sigma_targets},
        "posterior_sigma_target_mean": means.tolist(),
        "posterior_sigma_target_q5": q5.tolist(),
        "posterior_sigma_target_q95": q95.tolist(),
        "shared_posterior_means": {
            k: float(np.mean(samples[k])) for k in shared},
        "spearman_rho_vs_condition": float(rho),
        "spearman_rho_vs_truth": float(rho_truth),
        "ci90_coverage": int(covered),
        "trend_recovered": bool(rho > 0.9),
    }
    json_path = os.path.join(args.out, f"{args.model}-recovery.json")
    with open(json_path, "w") as f:
        json.dump(report, f, indent=2)
    print(f"\nSpearman rho (posterior trend) = {rho:.3f}  "
          f"(vs truth values: {rho_truth:.3f}); "
          f"90% CI coverage {covered}/{Nc}")
    print(f"trend recovered: {report['trend_recovered']}")
    print(f"saved {nc_path} and {json_path}")
    return report


if __name__ == "__main__":
    main()
