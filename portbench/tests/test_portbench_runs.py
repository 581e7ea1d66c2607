"""Whole runs of the harness on the CPU at a small size: the result line,
the reference against the port, the control and the faults the check has
to catch.  ``harness.execute`` takes the device, so these skip the command
line's look for a card and drive the rest of a run; the command line
itself is held to failing without one."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness
from portbench.reference import lqg

SMALL = {"T": 12, "trials": 3, "max_depth": 4, "trace_calls": 4,
         "check_calls": 2, "check_states": 2, "check_transitions": 3,
         "span_calls": 4, "chunk_steps": 3, "pool": 4}
SEED = 2**31 + 12345  # more than 32 signed bits hold
# at this size the posterior is as wide as the prior: a unit mass and a
# step that make the sampler's trees turn within max_depth
WIDE = {"inv_mass": torch.eye(9).tolist(), "step_size": 0.1, "max_depth": 6}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(name, trace=False, seed=SEED, control=False):
    overrides = dict(SMALL, **(WIDE if name.endswith("nuts4") else {}))
    return harness.execute(name, seed, 0.5, trace, time.perf_counter(),
                           device="cpu", overrides=overrides,
                           control=control)


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_has_the_contract_keys(trace):
    line, _ = run("bounded_fit.vg1", trace=trace)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if not trace:
        assert set(line["metrics"]) == {"vg_sets_per_s", "vg_p95_ms",
                                        "setup_s"}
    else:  # no card: no device metric is read from a CPU run
        assert line["metrics"] == {}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit", "side"}


def test_same_seed_same_inputs():
    a = run("bounded_fit.vg1")[1]
    b = run("bounded_fit.vg1")[1]
    assert torch.equal(a.x, b.x)
    assert not torch.equal(a.x, run("bounded_fit.vg1", seed=7)[1].x)


@pytest.mark.parametrize("config", ["bounded_fit", "subjective_fit",
                                    "delayed_fit"])
def test_reference_agrees_with_the_port_in_float64(config):
    from lqg_tpu_torch import models
    from lqg_tpu_torch.infer.models import shared_params_lqg_model

    cfg = dict(harness.load_json(os.path.join(
        harness.HERE, "configs", f"{config}.json")), T=12, trials=3)
    g = torch.Generator().manual_seed(3)
    x = lqg.simulate(cfg, g, "cpu")
    pm = shared_params_lqg_model(x, getattr(models, cfg["model"]),
                                 process_noise=cfg["process_noise"],
                                 dt=cfg["dt"],
                                 shared_params=cfg["shared_params"])
    fit = lqg.Fit(cfg, x)
    assert pm.names == fit.names
    u0 = pm.init_unconstrained()
    assert [fit.prior_median(n) for n in fit.names] == pytest.approx(
        torch.exp(u0).tolist(), rel=1e-12)
    b_prog = pm.set_baseline()[0]
    u = u0 + 0.1 * torch.randn((3, u0.shape[0]), generator=g,
                               dtype=torch.float64)
    pe, grad, ll = fit.evaluate(torch.cat([u, u0[None]]), lqg.REFERENCE)
    assert float(ll[-1]) == pytest.approx(b_prog, rel=1e-12)
    pe, grad = pe[:-1] + ll[-1], grad[:-1]
    pe2, grad2 = pm.value_and_grad(u)
    torch.testing.assert_close(pe, pe2, rtol=1e-10, atol=1e-9)
    torch.testing.assert_close(grad, grad2, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name", ["bounded_fit.vg1", "bounded_fit.nuts4",
                                  "subjective_fit.map"])
def test_control_is_not_correct(name):
    """The reference in TF32 in the program's place fails the cell's
    limits, at this size as on the card."""
    line, r = run(name, control=True)
    assert line["correct"] is True
    checks, correct = harness.check.judge(r.control, r.cell.limits)
    assert not correct, checks


def _unchanged_adam(monkeypatch):
    from lqg_tpu_torch.infer import svi

    monkeypatch.setattr(svi, "apply_updates", lambda params, updates: params)


def _unchanged_nuts(monkeypatch):
    from lqg_tpu_torch.infer import hmc

    real = hmc.nuts_step

    def step(vg, draws, z, pe, grad, *a, **k):
        info = real(vg, draws, z, pe, grad, *a, **k)[3]
        return z, pe, grad, info

    monkeypatch.setattr(hmc, "nuts_step", step)


def _halved_momentum(monkeypatch):
    """A leapfrog whose first momentum half-step is half as long."""
    from lqg_tpu_torch.infer import hmc

    def leapfrog(value_and_grad, inv_mass, step_size, state):
        r = state.r - (0.25 * step_size)[:, None] * state.grad
        z = state.z + step_size[:, None] * hmc.velocity(inv_mass, r)
        pe, grad = value_and_grad(z)
        r = r - (0.5 * step_size)[:, None] * grad
        return hmc.IntegratorState(z=z, r=r, pe=pe, grad=grad)

    monkeypatch.setattr(hmc, "leapfrog", leapfrog)


def _no_uturn(monkeypatch):
    """A U-turn test that never finds one."""
    from lqg_tpu_torch.infer import hmc

    monkeypatch.setattr(hmc, "_uturn", lambda inv_mass, r_left, r_right,
                        rho: torch.zeros(r_left.shape[0], dtype=torch.bool))


def _always_accept(monkeypatch):
    """Every new half-tree taken whatever its weight: the sampler reads
    acceptance uniforms of 0 in place of the draws."""
    from lqg_tpu_torch.infer import hmc

    real = hmc.nuts_step

    def step(vg, draws, *a, **k):
        return real(vg, draws._replace(accept=torch.zeros_like(
            draws.accept)), *a, **k)

    monkeypatch.setattr(hmc, "nuts_step", step)


def _half_batch(monkeypatch):
    """The likelihood over the first half of the trials, its mean taken as
    the whole's."""
    from lqg_tpu_torch.infer import models

    real = models._total

    def total(lls, baseline):
        n = lls.shape[-1]
        return 2.0 * real(lls[..., :n // 2], baseline / 2.0)

    monkeypatch.setattr(models, "_total", total)


def _altered_answer(monkeypatch):
    """Each value+grad's answer altered where it is produced: the first
    gradient entry's sign flipped in what the value+grad function the
    models and the sampler build returns."""
    from lqg_tpu_torch.infer import capture, mcmc, models

    real = capture.value_and_grad_fn

    def make(potential, u0):
        fn = real(potential, u0)

        def vg(u):
            pe, grad = fn(u)
            grad = grad.clone()
            grad[..., 0] = -grad[..., 0]
            return pe, grad

        return vg

    for module in (capture, mcmc, models):
        monkeypatch.setattr(module, "value_and_grad_fn", make)


@pytest.mark.parametrize("name, fault", [
    ("bounded_fit.vg1", _half_batch),
    ("bounded_fit.vg1", _altered_answer),
    ("bounded_fit.vg16", _half_batch),
    ("bounded_fit.nuts4", _unchanged_nuts),
    ("bounded_fit.nuts4", _half_batch),
    ("bounded_fit.nuts4", _altered_answer),
    ("bounded_fit.nuts4", _halved_momentum),
    ("bounded_fit.nuts4", _no_uturn),
    ("bounded_fit.nuts4", _always_accept),
    ("subjective_fit.map", _unchanged_adam),
    ("subjective_fit.map", _half_batch),
    ("subjective_fit.map", _altered_answer),
])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    line, _ = run(name)
    assert line["correct"] is False, line["checks"]


def test_forbidden_modules_are_found_by_their_top_level_name():
    found = harness.forbidden_modules(
        ["lqg_tpu_torch", "lqg_tpu_torch.infer", "torch", "jaxtyping"])
    assert found == []
    assert harness.forbidden_modules(
        ["jax.numpy", "lqg_tpu.infer", "flax", "jaxlib"]) == [
        "flax", "jax", "jaxlib", "lqg_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, time, json, torch; torch.set_num_threads(1); "
            "from portbench import harness; "
            f"harness.execute('bounded_fit.vg1', 3, 0.3, False, "
            f"time.perf_counter(), device='cpu', overrides={SMALL!r}); "
            "print(json.dumps(harness.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_command_line_fails_without_a_card():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "bounded_fit.vg1", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
