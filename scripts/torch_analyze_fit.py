"""Convergence and science report for a data.mat posterior artifact, on the
PyTorch/CUDA port's modules (``scripts/analyze_fit.py``'s report).

Loads ``data/processed/{model}-{seed}.nc`` (written by either package),
prints the diagnostic table (split-R-hat, Geyer ESS), and the per-condition
sensory noise ``sigma_target_i`` against the target blob width (Bonnen et
al. 2015 stimuli; the eLife trend is a monotone increase).  The blob widths
come from ``data.mat``, found as ``lqg_tpu_torch.io.find_data_file`` finds
it.  Host-only: it needs no card.

Usage: python scripts/torch_analyze_fit.py data/processed/BoundedActor-1.nc
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def parse_args(args=None):
    parser = argparse.ArgumentParser(
        description="Report on a data.mat posterior (netcdf)")
    parser.add_argument("path", nargs="?",
                        default="data/processed/BoundedActor-1.nc",
                        help="The posterior's netcdf file")
    return parser.parse_args(args=args)


def main(args=None):
    """Print the report; returns the summary table."""
    path = parse_args(args).path
    from lqg_tpu_torch.io import load_tracking_data
    from lqg_tpu_torch.infer.diagnostics import summary
    from lqg_tpu_torch.results import load_netcdf

    samples = load_netcdf(path)
    df = summary(samples)
    print(f"== {path} ==")
    print(df.to_string(float_format=lambda v: f"{v:10.4f}"))

    rhat = df["r_hat"]
    ess = df["n_eff"]
    print(f"\nmax r_hat = {rhat.max():.4f}   min ESS = {ess.min():.0f}")

    _, bws = load_tracking_data(delay=12, clip=180, subtract_mean=False)
    st = [f"sigma_target_{i}" for i in range(6)]
    if all(s in samples for s in st):
        means = np.array([np.mean(samples[s]) for s in st])
        q5 = np.array([np.quantile(samples[s], 0.05) for s in st])
        q95 = np.array([np.quantile(samples[s], 0.95) for s in st])
        print("\nblob width (arcmin) vs posterior sigma_target:")
        for w, m, a, b in zip(bws, means, q5, q95):
            print(f"  {w:7.2f}  ->  {m:7.2f}  [{a:7.2f}, {b:7.2f}]")
        from scipy.stats import spearmanr

        rho, _ = spearmanr(bws, means)
        slope = np.polyfit(np.log(np.asarray(bws, float)),
                           np.log(means), 1)[0]
        print(f"\nsigma_target vs blob width: Spearman rho = {rho:.3f}, "
              f"log-log slope = {slope:.3f} "
              f"(eLife trend: monotone increase, rho = 1)")
    return df


if __name__ == "__main__":
    main()
