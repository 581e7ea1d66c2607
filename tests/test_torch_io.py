"""The port's dataset loader (``lqg_tpu_torch.io``) against
``lqg_tpu.io`` on a synthetic ``data.mat`` (data.mat itself is not in the
repository): the same arrays bit for bit, the same search order, and
``FileNotFoundError`` for a missing file."""

import os

import numpy as np
import pytest
import scipy.io as spio

from lqg_tpu_torch import io as tio


def write_data_mat(directory, raw=230, trials=3, seed=0):
    """A ``data.mat`` with the fields of Bonnen et al.'s: ``sigma`` (blob
    widths whose arcmin values round to 6 distinct widths), ``target`` and
    ``response`` random walks ``(6 trials, raw)``."""
    rng = np.random.default_rng(seed)
    sigma = np.repeat(np.array([5.0, 8.0, 11.0, 14.0, 17.0, 20.0]), trials)
    rng.shuffle(sigma)
    walk = np.cumsum(rng.normal(size=(2, sigma.size, raw)), axis=-1)
    spio.savemat(os.path.join(directory, "data.mat"),
                 dict(sigma=sigma, target=walk[0], response=walk[1]))
    return os.path.join(directory, "data.mat")


@pytest.mark.parametrize("delay,clip,subtract_mean", [
    (12, 180, False), (12, 120, True), (0, 180, False), (0, 0, True)])
def test_load_tracking_data_matches_jax_bit_for_bit(tmp_path, delay, clip,
                                                    subtract_mean):
    from lqg_tpu import io as jio

    write_data_mat(tmp_path)
    kw = dict(delay=delay, clip=clip, subtract_mean=subtract_mean,
              data_path=str(tmp_path))
    jd, jb = jio.load_tracking_data(**kw)
    td, tb = tio.load_tracking_data(**kw)
    assert isinstance(td, np.ndarray) and td.dtype == jd.dtype
    assert td.shape == (6, 3, 230 - clip - delay, 2)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tb, jb)


def test_loadmat_nested_structs_match_jax(tmp_path):
    from lqg_tpu import io as jio

    path = os.path.join(tmp_path, "s.mat")
    spio.savemat(path, {"outer": {"inner": {"a": np.arange(3.0)}, "b": 2.0}})
    t, j = tio.loadmat(path), jio.loadmat(path)
    np.testing.assert_array_equal(t["outer"]["inner"]["a"],
                                  j["outer"]["inner"]["a"])
    assert t["outer"]["b"] == j["outer"]["b"]


def test_find_data_file_search_order_matches_jax(tmp_path, monkeypatch):
    """The given directory first, then the working directory's ``data/``,
    then the repository's ``data/``: JAX's order, which searches one more
    directory (a reference checkout's) after these."""
    from lqg_tpu import io as jio

    n = len(tio._DATA_SEARCH_PATHS)
    assert n == 2 and tio._DATA_SEARCH_PATHS == jio._DATA_SEARCH_PATHS[:n]
    given = tmp_path / "given"
    cwd = tmp_path / "cwd"
    (cwd / "data").mkdir(parents=True)
    given.mkdir()
    monkeypatch.chdir(cwd)
    write_data_mat(cwd / "data")
    write_data_mat(given)
    for pkg in (tio, jio):
        assert pkg.find_data_file(str(given)) == os.path.join(
            str(given), "data.mat")
        assert pkg.find_data_file() == os.path.join("data/", "data.mat")
        assert pkg.find_data_file(str(tmp_path / "absent")) == os.path.join(
            "data/", "data.mat")


def test_missing_file_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="data.mat not found"):
        tio.find_data_file(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="other.mat"):
        tio.find_data_file(filename="other.mat")
    with pytest.raises(FileNotFoundError):
        tio.load_tracking_data(data_path=str(tmp_path))
