"""The port's posterior files (``lqg_tpu_torch.results``) against
``lqg_tpu.results``: netcdf round trips, the repository's
``data/processed/*.nc`` read the same through both packages, files written
by either package read by the other, the summary CSV, and an MCMC
checkpoint round trip on the port's ``MCMC``."""

import glob
import os
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
import torch
from scipy.io import netcdf_file

from lqg_tpu_torch import results as tres
from lqg_tpu_torch.infer import transforms as ttfm
from lqg_tpu_torch.infer.mcmc import MCMC
from lqg_tpu_torch.infer.models import ProbModel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROCESSED = sorted(glob.glob(os.path.join(ROOT, "data", "processed", "*.nc")))


def _samples(rng, chains=3, draws=7):
    return {"b": rng.normal(size=(chains, draws)),
            "a": torch.tensor(rng.normal(size=(chains, draws))),
            "sigma_target_0": np.exp(rng.normal(size=(chains, draws)))}


def _attrs(path):
    with netcdf_file(path, "r") as f:
        return {k: v.decode() for k, v in f._attributes.items()}


def test_netcdf_round_trip(tmp_path):
    samples = _samples(np.random.default_rng(0))
    path = os.path.join(tmp_path, "sub", "run.nc")
    tres.save_netcdf(path, samples, attrs=dict(model="BoundedActor", seed=3))
    back = tres.load_netcdf(path)
    assert sorted(back) == sorted(samples)
    for k, v in samples.items():
        # classic netcdf stores big-endian float64, and both packages read
        # it back as such
        assert back[k].dtype == np.dtype(">f8") and back[k].shape == (3, 7)
        np.testing.assert_array_equal(back[k], np.asarray(v))
    assert _attrs(path) == {"model": "BoundedActor", "seed": "3"}
    # one chain given as (draws,)
    tres.save_netcdf(path, {"a": torch.arange(5.0)})
    np.testing.assert_array_equal(tres.load_netcdf(path)["a"],
                                  np.arange(5.0)[None])


@pytest.mark.parametrize("path", PROCESSED,
                         ids=[os.path.basename(p) for p in PROCESSED])
def test_processed_files_read_the_same(path):
    from lqg_tpu import results as jres

    t, j = tres.load_netcdf(path), jres.load_netcdf(path)
    assert list(t) == list(j)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k])


def test_files_cross_between_the_packages(tmp_path):
    from lqg_tpu import results as jres

    rng = np.random.default_rng(1)
    samples = _samples(rng)
    attrs = dict(model="SubjectiveActor", seed=1, shared_params="a,b")
    tpath, jpath = (os.path.join(tmp_path, f"{k}.nc") for k in ("t", "j"))
    tres.save_netcdf(tpath, samples, attrs=attrs)
    jres.save_netcdf(jpath, {k: np.asarray(v) for k, v in samples.items()},
                     attrs=attrs)
    for reader in (tres.load_netcdf, jres.load_netcdf):
        a, b = reader(tpath), reader(jpath)
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert _attrs(tpath) == _attrs(jpath)
    with open(tpath, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()


def test_summary_csv_matches_jax(tmp_path):
    from lqg_tpu import results as jres

    df = pd.DataFrame({"mean": [1.0, 2.5], "sd": [0.1, 0.2]},
                      index=["action_cost", "sigma_cursor"])
    truth = {"action_cost": torch.tensor(0.9), "sigma_cursor": 2.0,
             "absent": 5.0}
    tpath, jpath = (os.path.join(tmp_path, k, "s.csv") for k in ("t", "j"))
    out = tres.save_summary_csv(tpath, df, true_params=truth, seed=7)
    jres.save_summary_csv(jpath, df, true_params={
        k: float(v) for k, v in truth.items()}, seed=7)
    assert "true" not in df and list(out["true"]) == [
        pytest.approx(0.9), 2.0]
    with open(tpath) as f, open(jpath) as g:
        assert f.read() == g.read()


def _gaussian_model():
    def ll(p):
        return -0.5 * (p["a"] ** 2 + (p["b"] - 1.0) ** 2 / 4.0)

    zero = torch.zeros((), dtype=torch.float64)
    return ProbModel(init={"a": zero, "b": zero},
                     transforms={"a": ttfm.identity, "b": ttfm.identity},
                     log_likelihood=ll, priors={})


def test_mcmc_checkpoint_round_trip(tmp_path):
    """A run of the port's ``MCMC`` saved and restored into a fresh one:
    the same samples and extra fields; JAX's loader reads the file too; a
    model with other names is refused."""
    from lqg_tpu import results as jres

    model = _gaussian_model()
    mcmc = MCMC(model, num_warmup=10, num_samples=12, num_chains=2,
                max_depth=4).run(3)
    path = os.path.join(tmp_path, "ckpt", "run.npz")
    tres.save_mcmc_checkpoint(path, mcmc)
    fresh = tres.load_mcmc_checkpoint(path, MCMC(_gaussian_model()))
    for k, v in mcmc.get_samples(group_by_chain=True).items():
        assert torch.equal(fresh.get_samples(group_by_chain=True)[k], v)
    extra = mcmc.get_extra_fields()
    assert set(fresh.get_extra_fields()) == set(extra)
    for k, v in extra.items():
        np.testing.assert_array_equal(
            fresh.get_extra_fields()[k],
            v.cpu().numpy() if torch.is_tensor(v) else v)
    stub = SimpleNamespace(model=SimpleNamespace(names=model.names))
    jres.load_mcmc_checkpoint(path, stub)
    np.testing.assert_array_equal(stub._samples_u,
                                  mcmc._samples_u.numpy())
    other = ProbModel(init={"c": torch.zeros(())},
                      transforms={"c": ttfm.identity},
                      log_likelihood=lambda p: -p["c"] ** 2)
    with pytest.raises(ValueError, match="mismatch"):
        tres.load_mcmc_checkpoint(path, MCMC(other))
