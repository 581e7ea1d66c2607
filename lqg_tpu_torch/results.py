"""Posterior result persistence: netcdf and CSV artifacts, run checkpoints
(the port's copy of :mod:`lqg_tpu.results`, which is numpy and scipy only).

The files are those the JAX package writes, so either package reads the
other's: samples as classic netcdf (``chain``/``draw`` dimensions, the
arviz layout without arviz), a summary CSV, and an ``.npz`` checkpoint of an
:class:`~lqg_tpu_torch.infer.mcmc.MCMC` run.  Tensors go to numpy on the
way out.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _numpy(value) -> np.ndarray:
    if torch.is_tensor(value):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def save_netcdf(path: str, samples: dict, attrs: dict | None = None):
    """Write posterior samples to a classic netcdf file.

    ``samples``: dict name -> (chains, draws) array or tensor (a 1-D value
    is one chain).  Each becomes a float64 variable over the ``chain`` and
    ``draw`` dimensions; ``attrs`` become global string attributes.
    """
    from scipy.io import netcdf_file

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    samples = {k: _numpy(v) for k, v in samples.items()}
    arr = next(iter(samples.values()))
    if arr.ndim == 1:
        samples = {k: v[None] for k, v in samples.items()}
        arr = arr[None]
    chains, draws = arr.shape[:2]

    with netcdf_file(path, "w") as f:
        f.createDimension("chain", chains)
        f.createDimension("draw", draws)
        for name, vals in samples.items():
            v = f.createVariable(name, "d", ("chain", "draw"))
            v[:] = np.asarray(vals, dtype=np.float64)
        for k, val in (attrs or {}).items():
            setattr(f, k, str(val))


def load_netcdf(path: str) -> dict:
    """The variables of a netcdf file as numpy arrays, by name."""
    from scipy.io import netcdf_file

    out = {}
    with netcdf_file(path, "r") as f:
        for name, var in f.variables.items():
            out[name] = np.array(var[:])
    return out


def save_summary_csv(path: str, summary_df, true_params: dict | None = None,
                     seed=None):
    """Write a parameter-recovery CSV like the reference CLI
    (``main.py:80-84``), the true values (numbers or tensors) in a column
    ``true``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    df = summary_df.copy()
    if true_params:
        for key, val in true_params.items():
            if key in df.index:
                df.loc[key, "true"] = float(val)
    if seed is not None:
        df["seed"] = seed
    df.to_csv(path)
    return df


def save_mcmc_checkpoint(path: str, mcmc):
    """Persist an MCMC run (unconstrained draws, extra fields and the
    model's names) for resume or re-analysis."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    extra = {k: _numpy(v) for k, v in mcmc.get_extra_fields().items()}
    np.savez_compressed(
        path,
        samples_u=_numpy(mcmc._samples_u),
        names=np.array(mcmc.model.names),
        **{f"extra_{k}": v for k, v in extra.items()},
    )


def load_mcmc_checkpoint(path: str, mcmc):
    """Restore draws and extra fields into an MCMC object built with the
    same model: the draws as a CPU tensor, the extra fields as numpy."""
    data = np.load(path, allow_pickle=False)
    names = [str(n) for n in data["names"]]
    if names != list(mcmc.model.names):
        raise ValueError(f"model parameter mismatch: {names} vs "
                         f"{mcmc.model.names}")
    mcmc._samples_u = torch.from_numpy(data["samples_u"])
    mcmc._extra = {k[len("extra_"):]: data[k] for k in data.files
                   if k.startswith("extra_")}
    return mcmc
