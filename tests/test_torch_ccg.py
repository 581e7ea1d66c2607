"""The port's cross-correlograms (``lqg_tpu_torch.ccg``) against
``lqg_tpu.ccg`` on the CPU: ``xcorr`` at the data's shape and at other
lengths, the two CCG shapes, the batched Levenberg-Marquardt fit fed JAX's
restart inits (float64, iteration for iteration), the ``"torch"`` engine's
recovery of known parameters, and the scipy engine."""

import numpy as np
import pytest
import torch

import lqg_tpu_torch
from lqg_tpu_torch import ccg as tccg

LAGS = np.arange(-60, 61).astype(float)
# known parameters of each shape, and the noise on the correlograms
TRUTH = {"dog": [1.0, 0.8, 2.0, 15.0, 4.0, 6.0],
         "skewed_gabor": [0.6, 3.0, 8.0, 4.0, 0.05]}
NOISE = 5e-4


def _pair(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape), rng.normal(size=shape)


@pytest.mark.parametrize("shape,maxlags,normed", [
    ((6, 20, 1009), 60, True), ((6, 20, 1009), 60, False),
    ((3, 37), None, True), ((4, 64), 63, True), ((2, 5, 100), 1, False)])
def test_xcorr_matches_jax_float64(x64, shape, maxlags, normed):
    from lqg_tpu import ccg as jccg

    x, y = _pair(shape)
    jl, jc = jccg.xcorr(x, y, maxlags=maxlags, normed=normed)
    tl, tc = tccg.xcorr(torch.tensor(x), torch.tensor(y), maxlags=maxlags,
                        normed=normed)
    n = 2 * (shape[-1] - 1 if maxlags is None else maxlags) + 1
    assert isinstance(tl, np.ndarray) and tc.dtype == torch.float64
    assert tc.shape == shape[:-1] + (n,)
    np.testing.assert_array_equal(tl, jl)
    jc = np.asarray(jc)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=0,
                               atol=1e-10 * np.abs(jc).max())


def test_xcorr_matches_jax_float32():
    """In float32 (JAX without x64), within 1e-5 of the largest entry."""
    from lqg_tpu import ccg as jccg

    x, y = (a.astype(np.float32) for a in _pair((6, 20, 1009), 1))
    jc = np.asarray(jccg.xcorr(x, y)[1])
    tc = tccg.xcorr(x, y, device="cpu")[1]  # arrays become float32
    assert tc.dtype == torch.float32
    np.testing.assert_allclose(tc.numpy(), jc, rtol=0,
                               atol=1e-5 * np.abs(jc).max())


def test_xcorr_broadcasts_and_checks_maxlags():
    x, y = _pair((4, 50))
    lags, c = tccg.xcorr(torch.tensor(x), torch.tensor(y[:1]), maxlags=5)
    _, c0 = tccg.xcorr(torch.tensor(x[2]), torch.tensor(y[0]), maxlags=5)
    assert c.shape == (4, 11) and torch.allclose(c[2], c0, atol=1e-12)
    assert list(lags) == list(range(-5, 6))
    for bad in (0, 50, -3):
        with pytest.raises(ValueError, match="maxlags"):
            tccg.xcorr(torch.tensor(x), torch.tensor(y), maxlags=bad)


def test_xcorr_is_exported():
    assert lqg_tpu_torch.xcorr is tccg.xcorr
    assert "xcorr" in lqg_tpu_torch.__all__


@pytest.mark.parametrize("name", ["dog", "skewed_gabor"])
def test_shapes_match_numpy(x64, name):
    from lqg_tpu import ccg as jccg

    rng = np.random.default_rng(2)
    for _ in range(3):
        p = np.asarray(TRUTH[name]) * rng.uniform(0.5, 2.0, len(TRUTH[name]))
        want = getattr(jccg, name)(LAGS, *p)
        np.testing.assert_array_equal(getattr(tccg, name)(LAGS, *p), want)
        got = tccg._SHAPES_TORCH[name](torch.tensor(LAGS),
                                       *torch.tensor(p).unbind())
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-15)


def canonical(name, p):
    """Parameters in one form of each set of equivalent ones: a difference
    of Gaussians is unchanged by ``(a, sigma) -> (-a, -sigma)`` in either
    term and by swapping the terms with their amplitudes negated; take
    both widths positive and then ``a1 >= 0``."""
    p = np.array(p, dtype=float)
    if name != "dog":
        return p
    for row in p.reshape(-1, 6):
        for a, s in ((0, 4), (1, 5)):
            if row[s] < 0:
                row[a], row[s] = -row[a], -row[s]
        if row[0] < 0:
            row[:] = [-row[1], -row[0], row[3], row[2], row[5], row[4]]
    return p


def _correlograms(name, n, seed):
    """``n`` noisy correlograms from parameters near ``TRUTH[name]``."""
    from lqg_tpu import ccg as jccg

    rng = np.random.default_rng(seed)
    ps = np.asarray(TRUTH[name]) * (1 + 0.05 * rng.normal(size=(n, len(
        TRUTH[name]))))
    ys = np.stack([getattr(jccg, name)(LAGS, *p) for p in ps])
    return ps, ys + NOISE * rng.normal(size=ys.shape)


@pytest.mark.parametrize("name", ["dog", "skewed_gabor"])
def test_lm_fit_matches_jax_given_its_inits(x64, name):
    """``lm_fit_batch`` fed the restart inits JAX's ``_lm_fit_batch`` draws
    (its threefry key, replayed here): the best parameters within rtol
    1e-6 (plus 1e-6 of the largest of the correlogram's parameters: a fit
    that ends off a minimum keeps the two packages' rounding there; in
    :func:`canonical` form, since restarts reach equivalent minima of equal
    loss) and the best losses within rtol 1e-8, float64."""
    import jax
    import jax.numpy as jnp
    from lqg_tpu import ccg as jccg

    _, ys = _correlograms(name, 5, 3)
    restarts, seed = 8, 0
    jp, jl = jccg._lm_fit_batch(name, jnp.asarray(LAGS), jnp.asarray(ys),
                                steps=60, restarts=restarts, seed=seed)
    # _lm_fit_batch's inits (lqg_tpu/ccg.py:159-167)
    _, p0, bounds = jccg._SHAPE_META[name]
    p0 = jnp.asarray(p0, jnp.float64)
    jitter = jax.random.uniform(jax.random.PRNGKey(seed),
                                (restarts - 1, p0.shape[0]),
                                dtype=jnp.float64, minval=0.25, maxval=4.0)
    p0s = jnp.concatenate([p0[None], p0[None] * jitter])
    if bounds is not None:
        p0s = jnp.clip(p0s, *(jnp.asarray(b) for b in bounds))
    tp, tl = tccg.lm_fit_batch(name, torch.tensor(LAGS), torch.tensor(ys),
                               torch.tensor(np.asarray(p0s)), steps=60)
    jp = canonical(name, np.asarray(jp))
    err = np.abs(canonical(name, tp.numpy()) - jp)
    assert (err <= 1e-6 * (np.abs(jp) + np.abs(jp).max(-1, keepdims=True))
            ).all(), err
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-8)


def test_generator_inits_recover_known_parameters():
    """``lm_fit_batch`` from inits drawn by a seeded generator
    (``restart_inits``), float32, fits each of 8 noisy difference-of-
    Gaussians correlograms to the noise floor and recovers the parameters
    they were drawn from (in :func:`canonical` form), within 10%.  32
    restarts: with the engine's 8, some of these fits end in a local
    minimum (JAX's engine draws 8 too)."""
    ps, ys = _correlograms("dog", 8, 4)
    p0s = tccg.restart_inits("dog", 32, torch.Generator().manual_seed(0))
    params, losses = tccg.lm_fit_batch(
        "dog", torch.tensor(LAGS, dtype=torch.float32),
        torch.tensor(ys, dtype=torch.float32), p0s)
    assert params.shape == (8, 6) and params.dtype == torch.float32
    floor = LAGS.size * NOISE ** 2
    assert float(losses.max()) < 2.0 * floor
    np.testing.assert_allclose(canonical("dog", params), ps, rtol=0.1)


def test_torch_engine_is_the_seeded_fit():
    """``fit_ccg_shape_batch(engine="torch")`` is ``lm_fit_batch`` from 8
    inits of a generator seeded by 0, in float32, the batch shape kept."""
    _, ys = _correlograms("dog", 6, 6)
    params, losses = tccg.fit_ccg_shape_batch(
        "dog", LAGS, torch.tensor(ys.reshape(2, 3, -1)), engine="torch")
    assert params.shape == (2, 3, 6) and losses.shape == (2, 3)
    assert params.dtype == torch.float32
    want = tccg.lm_fit_batch(
        "dog", torch.tensor(LAGS, dtype=torch.float32),
        torch.tensor(ys, dtype=torch.float32),
        tccg.restart_inits("dog", 8, torch.Generator().manual_seed(0)))
    assert torch.equal(params.reshape(6, 6), want[0])
    assert torch.equal(losses.reshape(6), want[1])


def test_restart_inits_are_seeded_and_bounded():
    g = lambda: torch.Generator().manual_seed(5)
    a = tccg.restart_inits("skewed_gabor", 8, g())
    assert torch.equal(a, tccg.restart_inits("skewed_gabor", 8, g()))
    lo, hi = (torch.tensor(b) for b in tccg._SHAPE_META["skewed_gabor"][2])
    assert a.shape == (8, 5) and bool(((a >= lo) & (a <= hi)).all())
    assert a[0].tolist() == tccg._SHAPE_META["skewed_gabor"][1]


def test_scipy_engine_matches_jax():
    from lqg_tpu import ccg as jccg

    _, ys = _correlograms("dog", 3, 5)
    t = tccg.fit_ccg_shape_batch("dog", LAGS, torch.tensor(ys))
    j = jccg.fit_ccg_shape_batch("dog", LAGS, ys)
    assert t == j and len(t) == 3 and set(t[0]) == set(
        jccg._SHAPE_META["dog"][0])
    assert tccg.fit_dog(LAGS, ys[0]) == jccg.fit_dog(LAGS, ys[0])


def test_unknown_engine_raises():
    with pytest.raises(ValueError, match="'scipy' or 'torch'"):
        tccg.fit_ccg_shape_batch("dog", LAGS, np.zeros((2, 121)),
                                 engine="jax")
