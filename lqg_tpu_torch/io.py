"""MATLAB I/O and the Bonnen et al. (2015) tracking dataset loader (a copy
of :mod:`lqg_tpu.io`, which is numpy and scipy only; the port keeps its own
so that it imports nothing of the JAX package).

Robust ``.mat`` struct loading and ``load_tracking_data`` returning the
``(6 conditions, 20 trials, T, 2)`` tracking array plus the blob widths, as
numpy arrays: the callers move them to a device.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.io as spio

# default search locations for data.mat (first hit wins): the working
# directory's data/, then the repository's, found from this file
_DATA_SEARCH_PATHS = (
    "data/",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "data"),
)


def loadmat(filename):
    """Load a ``.mat`` file with mat_structs converted to nested dicts
    (reference ``io.py:9-42``)."""
    data = spio.loadmat(filename, struct_as_record=False, squeeze_me=True)
    return _check_keys(data)


def _check_keys(d):
    for key in d:
        if isinstance(d[key], spio.matlab.mat_struct):
            d[key] = _todict(d[key])
    return d


def _todict(matobj):
    out = {}
    for name in matobj._fieldnames:
        elem = matobj.__dict__[name]
        if isinstance(elem, spio.matlab.mat_struct):
            out[name] = _todict(elem)
        else:
            out[name] = elem
    return out


def find_data_file(data_path=None, filename="data.mat"):
    """Resolve the dataset path, trying the provided dir then defaults."""
    candidates = ([data_path] if data_path else []) + list(_DATA_SEARCH_PATHS)
    for base in candidates:
        path = os.path.join(base, filename)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(
        f"{filename} not found in any of: {candidates}")


def load_tracking_data(delay=12, clip=120, subtract_mean=True,
                       data_path=None):
    """Load tracking data from Bonnen et al. (2015).

    Same preprocessing as the reference (``io.py:45-98``): scale blob widths
    by arcmin factor 1.32, time-shift the response by ``delay``, clip the
    first ``clip`` steps, optionally mean-subtract per trial, group trials by
    the 6 unique blob widths.

    Returns:
        ``(data, sigmas)`` numpy arrays, ``data`` of shape
        ``(n_conditions, n_trials, T, 2)``.
    """
    arcscale = 1.32

    mat = loadmat(find_data_file(data_path))

    sigma = (mat["sigma"] * arcscale).round()
    sigmas = np.unique(sigma)

    target = mat["target"].astype(np.float32)
    mouse = mat["response"].astype(np.float32)

    if delay:
        target = target[:, clip:-delay]
        mouse = mouse[:, clip + delay:]
    else:
        target = target[:, clip:]
        mouse = mouse[:, clip:]

    if subtract_mean:
        target = target - np.mean(target, axis=1, keepdims=True)
        mouse = mouse - np.mean(mouse, axis=1, keepdims=True)

    data = np.stack(
        [np.array([target[np.where(sigma == blob_width)[0], :],
                   mouse[np.where(sigma == blob_width)[0], :]])
         for blob_width in sigmas])

    # (condition, channel, trial, time) -> (condition, trial, time, channel)
    data = data.transpose(0, 2, 3, 1)

    # zero each trial's target at t=0
    data = data - data[:, :, 0, 0][:, :, np.newaxis, np.newaxis]

    return data, sigmas
