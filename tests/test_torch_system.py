"""The port's slice as a whole: BoundedActor gains -> simulate -> likelihood
against ``lqg_tpu``, the goldens, the device policy and the import rule."""

import ast
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from lqg_tpu import models as jmodels
from lqg_tpu_torch import models as tmodels
from lqg_tpu_torch.system import System
from lqg_tpu_torch.ops.kernels.gains import fused_gains
from lqg_tpu_torch.ops.kernels.likelihood import (
    conditioned_log_likelihood_fused)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "goldens")
GOLDENS = ["bounded_actor", "optimal_actor", "relative_observation",
           "tracking_2d"]
T = 60
PARAMS = dict(action_cost=0.6, action_variability=0.4, sigma_target=5.0,
              sigma_cursor=3.0)
F64 = dict(device="cpu", dtype=torch.float64)


def close(t, j, rtol=1e-10, atol=1e-10):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


def _jax_noise(jm, key, n):
    """The noise ``lqg_tpu.System.simulate`` draws (system.py:232-234)."""
    key_eps, key_eta, _ = random.split(key, 3)
    eps = random.normal(key_eps, (jm.T, n, jm.dynamics.V.shape[-1]))
    eta = random.normal(key_eta, (jm.T, n, jm.dynamics.W.shape[-1]))
    return torch.tensor(np.asarray(eps)), torch.tensor(np.asarray(eta))


@pytest.fixture
def pair64(x64):
    return (jmodels.BoundedActor(T=T, **PARAMS),
            tmodels.BoundedActor(T=T, **PARAMS, **F64))


def test_gains_scan_and_auto(pair64):
    jm, tm = pair64
    jg, jK = jm.gains(method="scan")
    for method in ("scan", "auto"):  # auto: the scan on the CPU
        tg, tK = tm.gains(method=method)
        close(tg.L, jg.L)
        close(tg.l, jg.l)
        close(tK, jK)


def test_gains_fused_float32():
    jm = jmodels.BoundedActor(T=T, **PARAMS)
    tm = tmodels.BoundedActor(T=T, **PARAMS, device="cpu")
    jg, jK = jm.gains(method="fused")
    tg, tK = tm.gains(method="fused")
    for t, j in ((tg.L, jg.L), (tg.H, jg.H), (tK, jK)):
        close(t, j, rtol=0, atol=2e-5)
    assert tg.l.shape == jg.l.shape and not tg.l.any()


def test_simulate_with_jax_noise(pair64):
    jm, tm = pair64
    key = random.PRNGKey(3)
    eps, eta = _jax_noise(jm, key, 5)
    jx, jxh, jy, ju = jm.simulate(key, n=5, return_all=True)
    tx, txh, ty, tu = tm.rollout(eps, eta, return_all=True)
    for t, j in ((tx, jx), (txh, jxh), (ty, jy), (tu, ju)):
        close(t, j)
    x = tm.simulate(torch.Generator().manual_seed(0), n=2)
    assert x.shape == (2, T + 1, 2) and torch.isfinite(x).all()


def test_log_likelihood_scan_and_auto(pair64):
    jm, tm = pair64
    jx = jm.simulate(random.PRNGKey(4), n=4)
    x = torch.tensor(np.asarray(jx))
    ll_jax = jm.log_likelihood(jx, method="scan")
    before = (fused_gains.launches, conditioned_log_likelihood_fused.launches)
    for method in ("scan", "auto"):
        close(tm.log_likelihood(x, method=method), ll_jax)
    # on the CPU nothing launches a kernel
    assert before == (fused_gains.launches,
                      conditioned_log_likelihood_fused.launches)


def test_log_likelihood_fused_float32():
    jm = jmodels.BoundedActor(T=T, **PARAMS)
    tm = tmodels.BoundedActor(T=T, **PARAMS, device="cpu")
    jx = jm.simulate(random.PRNGKey(5), n=4)
    ll_jax = jm.log_likelihood(jx, method="fused")
    ll = tm.log_likelihood(torch.tensor(np.asarray(jx)), method="fused")
    close(ll, ll_jax, rtol=2e-4, atol=2e-3)


def test_conditional_and_belief_distributions(pair64):
    jm, tm = pair64
    jx = jm.simulate(random.PRNGKey(6), n=3)
    x = torch.tensor(np.asarray(jx))
    jd, td = jm.conditional_distribution(jx), tm.conditional_distribution(x)
    close(td.loc, jd.loc)
    close(td.covariance_matrix, jd.covariance_matrix)
    close(td.log_prob(x[:, 1:]), jd.log_prob(jx[:, 1:]))
    jb = jm.belief_tracking_distribution(jx)
    tb = tm.belief_tracking_distribution(x)
    close(tb.loc, jb.loc)
    close(tb.covariance_matrix, jb.covariance_matrix)
    jmu, jS = jm.conditional_moments(jx[0])
    tmu, tS = tm.conditional_moments(x[0])
    close(tmu, jmu)
    close(tS, jS)


def test_stacked_actor_dynamics_system(x64):
    """Reference-style stacked specs (``Actor``/``Dynamics``) through gains,
    rollout and likelihood, and ``LQG`` with ``LQGDistribution``."""
    import lqg_tpu as jlqg
    import lqg_tpu_torch as tlqg

    mats = {k: np.array(getattr(jmodels.BoundedActor(T=1, **PARAMS).actor, k))
            for k in "ABFVWQR"}
    dyn = {k: mats[k] for k in "ABFVW"}
    jm = jlqg.System(actor=jlqg.Actor(**mats, T=T),
                     dynamics=jlqg.Dynamics(**dyn, T=T))
    tm = tlqg.System(actor=tlqg.Actor(**mats, T=T, **F64),
                     dynamics=tlqg.Dynamics(**dyn, T=T, **F64))
    assert tm.horizon == T and tm.actor.zero_affine
    jg, jK = jm.gains()
    tg, tK = tm.gains()
    close(tg.L, jg.L)
    close(tK, jK)
    key = random.PRNGKey(7)
    eps, eta = _jax_noise(jm, key, 3)
    jx = jm.simulate(key, n=3)
    x = tm.rollout(eps, eta)
    close(x, jx)
    close(tm.log_likelihood(x), jm.log_likelihood(jx))

    jd = jlqg.LQG(**mats, T=T).to_distribution()
    td = tlqg.LQG(**mats, T=T, **F64).to_distribution()
    close(td.log_prob(x), jd.log_prob(jx))
    assert td.event_shape == jd.event_shape
    assert td.sample(torch.Generator().manual_seed(0), (2, 3)).shape == \
        (2, 3, T + 1, 2)


@pytest.mark.parametrize("case", GOLDENS)
def test_golden_log_likelihood(case):
    data = np.load(os.path.join(GOLDEN_DIR, f"{case}.npz"))
    meta = json.loads(str(data["params"]))
    params = {k: v for k, v in meta.items() if k not in ("class", "n")}
    model = getattr(tmodels, meta["class"])(**params, **F64)
    ll = model.log_likelihood(torch.tensor(data["x"]))
    np.testing.assert_allclose(ll.numpy(), data["log_likelihood"], rtol=1e-5)


def test_methods_not_ported_raise():
    m = tmodels.BoundedActor(T=5, device="cpu")
    x = m.simulate(None, n=1)
    for method in ("sqrt", "steady"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            m.gains(method=method)
    for method in ("pscan", "blocked"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            m.log_likelihood(x, method=method)
    with pytest.raises(ValueError):
        m.log_likelihood(x, method="bogus")


def test_gradient_goes_through_the_scan(monkeypatch):
    """The gradient of the likelihood in a parameter: on the scan and, with
    both kernels' routes forced on, through the two ``autograd.Function``s
    (their plain versions on the CPU), equal up to the scan's Riccati
    jitter (relative 1e-8)."""
    c = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    x = tmodels.BoundedActor(T=20, action_cost=0.7, **F64).simulate(
        torch.Generator().manual_seed(1), n=2)

    def grad(method):
        m = tmodels.BoundedActor(T=20, action_cost=c, **F64)
        return torch.autograd.grad(m.log_likelihood(x, method=method).sum(),
                                   c)[0]

    g_scan = grad("scan")
    monkeypatch.setattr(System, "_fused_ok", lambda self, Sigma0: True)
    g_fused = grad("fused")
    assert torch.isfinite(g_fused)
    close(g_fused, g_scan, rtol=1e-6, atol=0)


@pytest.mark.parametrize("model,param,values", [
    ("BoundedActor", "action_cost", [0.3, 0.7, 1.5]),
    ("BoundedActor", "sigma_target", [2.0, 6.0, 20.0, 40.0, 9.0]),  # P == T
    ("RelativeObservationBoundedActor", "sigma", [2.0, 5.0]),
])
def test_batched_system_equals_loop_over_parameter_sets(model, param, values,
                                                        monkeypatch):
    """A System whose parameter carries a leading axis P equals P unbatched
    Systems: gains, and the likelihood on the scan and the fused routes
    (trajectories shared by the sets, or one batch per set)."""
    T = 5
    cls = getattr(tmodels, model)
    batched = cls(T=T, **{param: torch.tensor(values, dtype=torch.float64)},
                  **F64)
    singles = [cls(T=T, **{param: v}, **F64) for v in values]
    P = len(values)
    assert batched.batch_shape == (P,)
    x = singles[0].simulate(torch.Generator().manual_seed(2), n=3)
    xs = x.expand(P, *x.shape)
    with pytest.raises(ValueError, match="unbatched"):
        batched.simulate(None, n=1)
    monkeypatch.setattr(System, "_fused_ok", lambda self, Sigma0: True)
    for method in ("scan", "fused"):
        g, K = batched.gains(method=method)
        loop = [m.gains(method=method) for m in singles]
        assert g.L.shape[:2] == (T, P)
        close(g.L, torch.stack([gi.L for gi, _ in loop], 1), rtol=1e-12,
              atol=0)
        close(K, torch.stack([Ki for _, Ki in loop], 1), rtol=1e-12, atol=0)
        want = torch.stack([m.log_likelihood(x, method=method)
                            for m in singles])
        for data in (x, xs):
            ll = batched.log_likelihood(data, method=method)
            assert ll.shape == (P, 3)
            close(ll, want, rtol=1e-12, atol=0)


def test_default_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodels.BoundedActor(T=10)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _banned(module):
    return module.split(".")[0] in ("jax", "jaxlib", "lqg_tpu")


def test_port_imports_no_jax():
    """Neither the package nor chip_smoke.py imports jax or lqg_tpu, and
    importing every module of the port loads neither."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    modules = []
    pkg = os.path.join(ROOT, "lqg_tpu_torch")
    for dirpath, _, names in os.walk(pkg):
        for name in names:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                files.append(path)
                rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
                modules.append(rel.removesuffix(".__init__"))
    for path in files:
        bad = [m for m in _imports(path) if _banned(m)]
        assert not bad, (path, bad)
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'lqg_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
