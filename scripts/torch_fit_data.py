"""Real-data fit CLI on the PyTorch/CUDA port: continuous psychophysics
(Bonnen et al. 2015 data).

The pipeline of ``scripts/fit_data.py`` with ``lqg_tpu_torch``'s modules:
load the tracking dataset, build the hierarchical shared-parameters model
across the 6 blob-width conditions, optionally fit a MAP, a NeuTra guide
(with a warped-space polish) or a fixed dense mass from an earlier
posterior, run NUTS, and persist the posterior as netcdf with the JAX
script's names and attributes.  The CLI is the JAX script's, with
``--device`` (default ``cuda``) in place of ``--platform``; without a card
it raises unless ``--device cpu`` is given.

One deliberate difference: the script sets the model's ``ll_baseline`` to
the log likelihood at the MAP (at the initial point without ``--init
map``), after the MAP and before the guide fit, the polish and NUTS
capture the potential.  The shift is a constant, so HMC and SVI are
unchanged, and the float32 potential sits at O(1-100) nats instead of the
likelihood's ~3e5, where one float32 ULP is ~0.03 nats.

Example (``data.mat`` supplied by the user under ``/path/to/data``):
    python scripts/torch_fit_data.py --model BoundedActor --nsamp 500 \
        --nburnin 300 --nchain 2 --data /path/to/data
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(args=None):
    parser = argparse.ArgumentParser(description="Continuous Psychophysics")
    parser.add_argument("--delay", type=int, default=12,
                        help="Temporal shift between target and response")
    parser.add_argument("--clip", type=int, default=180,
                        help="Clip the initial n time steps of the data")
    parser.add_argument("--nsamp", type=int, default=5_000,
                        help="Number of samples drawn by NUTS")
    parser.add_argument("--nburnin", type=int, default=1_500,
                        help="Number of burn-in samples.")
    parser.add_argument("--nchain", type=int, default=4)
    parser.add_argument("--max-depth", type=int, default=10,
                        help="NUTS maximum tree depth (2^depth leapfrogs "
                             "worst case)")
    parser.add_argument("--model", type=str, default="BoundedActor",
                        help="Model type")
    parser.add_argument("--seed", type=int, default=1,
                        help="Random seed (for NUTS)")
    parser.add_argument("--data", type=str, default=None,
                        help="Directory containing data.mat")
    parser.add_argument("--out", type=str, default="data/processed",
                        help="Output directory for the netcdf posterior")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="Checkpoint the in-flight run here (and resume "
                             "from it if present)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device (cuda, or cpu)")
    parser.add_argument("--neutra", type=str, default="none",
                        choices=["none", "mvn", "iaf", "laplace"],
                        help="NeuTra preconditioning: fit a variational "
                             "guide (full-rank Gaussian or IAF flow) and "
                             "run NUTS in the whitened space, or (laplace) "
                             "whiten by the exact inverse Hessian at the "
                             "MAP")
    parser.add_argument("--neutra-steps", type=int, default=3000,
                        help="SVI steps for the NeuTra guide fit")
    parser.add_argument("--max-leapfrogs", type=int, default=None,
                        help="Leapfrog budget per chunk of transitions")
    parser.add_argument("--init", type=str, default="median",
                        choices=["median", "map"],
                        help="Chain initialization: prior median (reference "
                             "init_to_median parity) or a MAP point fit "
                             "(the data.mat posterior is multimodal; init=map "
                             "starts all chains in the MAP's basin)")
    parser.add_argument("--map-steps", type=int, default=1500,
                        help="Adam steps for the MAP fit (--init map)")
    parser.add_argument("--init-jitter", type=float, default=0.2,
                        help="Uniform jitter around the init point in "
                             "unconstrained space (use ~0.02 with "
                             "--init map to stay in-basin)")
    parser.add_argument("--precondition", type=str, default=None,
                        help="Empirical preconditioning: netcdf posterior "
                             "from a previous run; its pooled draw "
                             "covariance (unconstrained space) becomes a "
                             "FIXED dense inverse mass (warmup adapts the "
                             "step size only)")
    parser.add_argument(
        "--shared_params", type=str, nargs="*",
        default=["action_variability", "action_cost", "c", "sigma_cursor",
                 "subj_noise", "subj_vel_noise"],
        help="Parameters shared across conditions ('c' is the delay "
             "models' action-cost name; entries absent from a model's "
             "signature are dropped)")
    return parser.parse_args(args=args)


def synchronize(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(args=None):
    """Run the fit; returns a dict with the model (``model``), the run
    (``mcmc``), the baseline and the potential at the initial point before
    and after it (``ll_baseline``, ``potential_baseline0``,
    ``potential``), the netcdf path (``out_path``) and the host seconds of
    each stage (``times``)."""
    args = parse_args(args)

    import numpy as np
    import torch

    from lqg_tpu_torch import tracking
    from lqg_tpu_torch.config import resolve_device
    from lqg_tpu_torch.io import load_tracking_data
    from lqg_tpu_torch.infer.mcmc import MCMC
    from lqg_tpu_torch.infer.models import (get_model_params,
                                            shared_params_lqg_model)
    from lqg_tpu_torch.results import save_netcdf

    device = resolve_device(args.device)
    Model = getattr(tracking, args.model)
    model_params = get_model_params(Model).keys()
    shared = [p for p in args.shared_params if p in list(model_params)]

    data, bws = load_tracking_data(delay=args.delay, clip=args.clip,
                                   subtract_mean=False, data_path=args.data)
    print("data:", data.shape, "blob widths:", bws)
    x = torch.as_tensor(data, dtype=torch.float32, device=device)

    prob_model = shared_params_lqg_model(x, Model, shared_params=shared)
    times = {}

    if args.init == "map":
        # base-model MAP first: with --neutra it anchors the guide's
        # starting location (the fits seed their loc at
        # init_unconstrained()) in the MAP's basin
        from lqg_tpu_torch.infer.svi import optimize

        t0 = time.perf_counter()
        map_params, losses = optimize(prob_model, steps=args.map_steps,
                                      step_size=0.05)
        synchronize(device)
        times["map_s"] = time.perf_counter() - t0
        prob_model.init = dict(map_params)
        print(f"[map] {args.map_steps} Adam steps in {times['map_s']:.1f}s, "
              f"potential {float(losses[-1]):.1f}; init at MAP:", flush=True)
        print("      " + ", ".join(f"{k}={float(v):.4g}"
                                   for k, v in map_params.items()),
              flush=True)

    # before anything below captures the potential in a graph
    baseline, before, after = prob_model.set_baseline()
    print(f"[baseline] ll_baseline = {baseline:.8g} (the log likelihood at "
          f"the {'MAP' if args.init == 'map' else 'prior median'}); "
          f"potential there {before:.8g} at baseline 0, {after:.8g} now",
          flush=True)

    sampled = prob_model
    if args.neutra != "none":
        from lqg_tpu_torch.infer.utils import neutra_reparam

        t0 = time.perf_counter()
        if args.neutra == "laplace":
            from lqg_tpu_torch.infer.svi import laplace_guide

            guide, eigs = laplace_guide(prob_model)
            sds = torch.sqrt(torch.diagonal(
                guide.scale_tril @ guide.scale_tril.mT)).cpu().numpy()
            print(f"[neutra] laplace guide (exact MAP Hessian) in "
                  f"{time.perf_counter() - t0:.1f}s; eigenvalue range "
                  f"[{float(eigs[0]):.3g}, {float(eigs[-1]):.3g}] "
                  f"(condition {float(eigs[-1] / eigs[0]):.1f}); "
                  "posterior sds " + np.array2string(sds, precision=4),
                  flush=True)
        else:
            if args.neutra == "mvn":
                from lqg_tpu_torch.infer.svi import fit_auto_mvn as fit_guide
            else:
                from lqg_tpu_torch.infer.flows import (
                    fit_auto_iaf as fit_guide)
            guide, losses = fit_guide(prob_model, args.seed + 1,
                                      steps=args.neutra_steps)
            print(f"[neutra] {args.neutra} guide fit: {args.neutra_steps} "
                  f"SVI steps in {time.perf_counter() - t0:.1f}s, final "
                  f"ELBO {-float(losses[-1]):.1f}", flush=True)
        times["guide_s"] = time.perf_counter() - t0
        sampled = neutra_reparam(prob_model, guide)

        if args.init == "map":
            # short polish in the warped space: the guide's mean need not
            # sit exactly on the mode, so re-center the chains' eps init
            from lqg_tpu_torch.infer.svi import optimize

            t0 = time.perf_counter()
            _, losses, eps_map = optimize(
                sampled, steps=max(200, args.map_steps // 3),
                step_size=0.02, return_unconstrained=True)
            sampled.init_eps = eps_map
            print(f"[map/neutra] warped-space polish in "
                  f"{time.perf_counter() - t0:.1f}s, potential "
                  f"{float(losses[-1]):.1f}, |eps_map| = "
                  f"{float(eps_map.norm()):.3f}", flush=True)

    mass_kwargs = {}
    if args.precondition:
        from lqg_tpu_torch.results import load_netcdf

        prev = load_netcdf(args.precondition)
        for name in sampled.names:
            # the stack below folds (chains, draws) into one draw axis per
            # scalar site; a vector-valued site would fold its parameter
            # dims into the draw axis and corrupt the dense mass
            if np.asarray(prev[name]).ndim > 2:
                raise ValueError(
                    f"--precondition supports scalar sites only; "
                    f"{name!r} has shape {np.asarray(prev[name]).shape} "
                    f"(chains, draws, *param_dims)")
        U = np.stack([
            sampled.transforms[name].inverse(torch.as_tensor(
                np.asarray(prev[name], dtype=np.float64).reshape(-1))).numpy()
            for name in sampled.names])            # (zdim, draws)
        cov = np.cov(U)
        cov = cov + 1e-8 * np.eye(cov.shape[0])
        L = np.linalg.cholesky(0.5 * (cov + cov.T))
        mass_kwargs = dict(init_inv_mass=torch.as_tensor(
            L, dtype=torch.float32, device=device), adapt_mass=False)
        print(f"[precondition] fixed dense mass from {args.precondition} "
              f"({U.shape[1]} draws); sqrt diag cov: "
              + np.array2string(np.sqrt(np.diag(cov)), precision=4),
              flush=True)

    mcmc = MCMC(sampled, num_warmup=args.nburnin, num_samples=args.nsamp,
                num_chains=args.nchain, max_depth=args.max_depth,
                progress=True, init_jitter=args.init_jitter,
                max_leapfrogs_per_launch=args.max_leapfrogs, **mass_kwargs)
    t0 = time.perf_counter()
    mcmc.run(args.seed, checkpoint_path=args.checkpoint)
    synchronize(device)
    times["mcmc_s"] = time.perf_counter() - t0
    mcmc.print_summary()

    out_path = os.path.join(args.out, f"{args.model}-{args.seed}.nc")
    save_netcdf(out_path, mcmc.get_samples(group_by_chain=True),
                attrs=dict(model=args.model, seed=args.seed,
                           shared_params=",".join(shared)))
    print(f"saved {out_path}")
    return dict(model=prob_model, mcmc=mcmc, ll_baseline=baseline,
                potential_baseline0=before, potential=after,
                out_path=out_path, times=times)


if __name__ == "__main__":
    main()
