"""The port's fit scripts (``scripts/torch_*.py``) and the graph cache of
``ProbModel.value_and_grad``: each script's CLI against its JAX script's,
``torch_fit_data.main`` end to end on the CPU on a small synthetic
``data.mat`` (the baseline set before anything captures the potential, the
netcdf the JAX script would write), ``torch_analyze_fit.main`` against
``analyze_fit.main``, and a value+grad that follows a new ``ll_baseline``
or ``method`` (on the CPU, and through a graph replay on the card)."""

import ast
import importlib.util
import os
import sys

import numpy as np
import pytest
import scipy.io as spio
import torch

from lqg_tpu_torch import models as tmodels
from lqg_tpu_torch.infer import models as tinfer
from lqg_tpu_torch.results import load_netcdf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
PAIRS = [("torch_fit_data", "fit_data"), ("torch_recover", "recover"),
         ("torch_recover_at_scale", "recover_at_scale"),
         ("torch_analyze_fit", "analyze_fit")]


@pytest.fixture(autouse=True)
def one_thread():
    """Many small ops on the CPU: one intra-op thread, so that the pool
    does not keep every core busy and slow the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def script(name):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _imports(path):
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("port,jax_name", PAIRS)
def test_cli_matches_the_jax_script(port, jax_name, monkeypatch):
    """``parse_args([])`` equals the JAX script's defaults, ``--device``
    (default ``cuda``) in place of ``--platform``; the script imports
    neither JAX nor ``lqg_tpu``."""
    bad = [m for m in _imports(os.path.join(SCRIPTS, f"{port}.py"))
           if m.split(".")[0] in ("jax", "jaxlib", "lqg_tpu")]
    assert not bad
    got = vars(script(port).parse_args([]))
    jmod = script(jax_name)
    if not hasattr(jmod, "parse_args"):  # analyze_fit: one positional path
        assert got == {"path": "data/processed/BoundedActor-1.nc"}
        return
    monkeypatch.setattr(sys, "argv", [f"{jax_name}.py"])
    want = vars(jmod.parse_args())
    assert got.pop("device") == "cuda" and want.pop("platform") is None
    assert got == want


def write_data_mat(directory, raw, trials=2, seed=0):
    """A ``data.mat`` simulated by the port's ``BoundedActor``: 6 blob
    widths x ``trials`` trials of ``raw`` steps, the response lagging the
    cursor by the loader's default delay (12 steps)."""
    sigma = np.repeat(np.array([5.0, 8.0, 11.0, 14.0, 17.0, 20.0]), trials)
    g = torch.Generator().manual_seed(seed)
    x = np.stack([tmodels.BoundedActor(
        T=raw - 1, sigma_target=float(s) * 1.32, device="cpu",
        dtype=torch.float64).simulate(g, n=1)[0].numpy() for s in sigma])
    response = np.concatenate([np.repeat(x[:, :1, 1], 12, 1),
                               x[:, :-12, 1]], 1)
    spio.savemat(os.path.join(directory, "data.mat"),
                 dict(sigma=sigma, target=x[:, :, 0], response=response))


@pytest.mark.parametrize("neutra", ["none", "mvn"])
def test_fit_data_end_to_end(tmp_path, monkeypatch, neutra):
    """6 conditions x 2 trials at T=16, 2 chains, 5 MAP steps, 5 + 5
    transitions: the baseline is the log likelihood at the MAP and is set
    before the guide fit and ``MCMC.run``; the potential there is small;
    the netcdf holds the JAX model's names and the JAX script's attrs."""
    import jax.numpy as jnp
    from lqg_tpu import models as jmodels
    from lqg_tpu.infer import models as jinfer
    from lqg_tpu_torch.infer import mcmc as tmcmc
    from lqg_tpu_torch.infer import svi as tsvi

    write_data_mat(tmp_path, 180 + 12 + 17)
    seen = []
    run, fit = tmcmc.MCMC.run, tsvi.fit_auto_mvn

    def recording_run(self, *a, **k):
        seen.append(("run", self.model.ll_baseline,
                     self.model.log_likelihood))
        return run(self, *a, **k)

    def recording_fit(model, *a, **k):
        seen.append(("guide", model.ll_baseline, model.log_likelihood))
        return fit(model, *a, **k)

    monkeypatch.setattr(tmcmc.MCMC, "run", recording_run)
    monkeypatch.setattr(tsvi, "fit_auto_mvn", recording_fit)
    fit_data = script("torch_fit_data")
    out = fit_data.main(["--device", "cpu", "--data", str(tmp_path),
                         "--out", str(tmp_path), "--init", "map",
                         "--map-steps", "5", "--nsamp", "5", "--nburnin",
                         "5", "--nchain", "2", "--max-depth", "3",
                         "--neutra", neutra, "--neutra-steps", "5"])
    pm, baseline = out["model"], out["ll_baseline"]
    assert [s[0] for s in seen] == (["guide"] if neutra == "mvn" else []) \
        + ["run"]
    # every stage saw the baseline, on the likelihood of the fitted model
    assert all(b == baseline and ll is pm.log_likelihood
               for _, b, ll in seen)
    u0 = pm.init_unconstrained()
    with torch.no_grad():
        ll0 = float(pm.log_likelihood(pm.constrain(u0))) + baseline
    assert baseline == pytest.approx(ll0, rel=1e-5)
    assert abs(out["potential"]) < 0.1 * abs(out["potential_baseline0"])
    assert out["potential"] == pytest.approx(
        out["potential_baseline0"] + baseline, abs=1e-2)
    # the netcdf: lqg_tpu's model names, fit_data.py's attrs
    x = jnp.zeros((6, 2, 17, 2))
    shared = ["action_variability", "action_cost", "sigma_cursor"]
    names = jinfer.shared_params_lqg_model(x, jmodels.BoundedActor,
                                           shared_params=shared).names
    path = os.path.join(tmp_path, "BoundedActor-1.nc")
    assert out["out_path"] == path
    samples = load_netcdf(path)
    assert sorted(samples) == sorted(names) == pm.names
    assert all(v.shape == (2, 5) and np.isfinite(v).all()
               for v in samples.values())
    from scipy.io import netcdf_file

    with netcdf_file(path, "r") as f:
        attrs = {k: v.decode() for k, v in f._attributes.items()}
    assert attrs == dict(model="BoundedActor", seed="1",
                         shared_params=",".join(shared))


def test_fit_data_without_a_card_raises(tmp_path, monkeypatch):
    """With no card and no ``--device cpu`` it raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        script("torch_fit_data").main(["--data", str(tmp_path)])


def test_analyze_fit_matches_jax(tmp_path, monkeypatch):
    """The report on ``data/processed/BoundedActor-1.nc``, the blob widths
    read from a synthetic ``data.mat`` in the working directory's
    ``data/``: the same summary table as ``analyze_fit.main``'s."""
    path = os.path.join(ROOT, "data", "processed", "BoundedActor-1.nc")
    os.makedirs(tmp_path / "data")
    write_data_mat(tmp_path / "data", 180 + 12 + 17)
    monkeypatch.chdir(tmp_path)
    got = script("torch_analyze_fit").main([path])
    want = script("analyze_fit").main(path)
    assert list(got.index) == list(want.index)
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())


def _small_model(device="cpu", dtype=torch.float64):
    m = tmodels.BoundedActor(T=10, device=device, dtype=dtype)
    x = m.simulate(torch.Generator(device=device).manual_seed(0), n=3)
    return tinfer.lifted_model(x, tmodels.BoundedActor)


def _baseline_moves_the_value(model, u, baseline=-123.5, owner=None):
    """The potential is ``-(log joint - baseline)``: after ``owner``'s
    baseline (``model``'s by default) is set, ``model``'s value moves by the
    baseline, up to the rounding of the value, and its gradient stays."""
    pe0, g0 = model.value_and_grad(u)
    (owner or model).ll_baseline = baseline
    pe1, g1 = model.value_and_grad(u)
    scale = 1e-12 if u.dtype == torch.float64 else 2e-6
    tol = scale * (float(pe0.abs().max()) + abs(baseline))
    assert float((pe1 - pe0 - baseline).abs().max()) <= tol
    assert torch.allclose(g1, g0, rtol=100 * scale, atol=0)
    assert len(model.value_and_grad_fns) == 2
    return pe0, g0


def _neutra(model):
    from lqg_tpu_torch.infer.svi import AutoMVN
    from lqg_tpu_torch.infer.utils import neutra_reparam

    loc = model.init_unconstrained()
    D = loc.shape[-1]
    tril = torch.eye(D, dtype=loc.dtype, device=loc.device) * 0.5 + 0.05
    return neutra_reparam(model, AutoMVN(loc=loc, scale_tril=tril.tril()))


def test_value_and_grad_follows_baseline_and_method():
    """After ``ll_baseline`` changes, the next value moves by the baseline
    and the gradient stays; a new ``method`` is a new entry too."""
    model = _small_model()
    u = model.init_unconstrained()[None] + 0.1
    _baseline_moves_the_value(model, u)
    model.method = "scan"
    pe2, _ = model.value_and_grad(u)
    assert len(model.value_and_grad_fns) == 3
    model.method = "auto"
    assert torch.equal(model.value_and_grad(u)[0], pe2)
    assert len(model.value_and_grad_fns) == 3


def test_neutra_model_follows_the_base_models_baseline():
    """A NeuTra model's likelihood is its base model's: a baseline set on
    the base model after ``neutra_reparam`` moves the NeuTra model's next
    value by exactly that baseline, one set on the NeuTra model is the base
    model's, and the same holds for ``method``."""
    base = _small_model()
    reparam = _neutra(base)
    eps = torch.full((1, len(base.names)), 0.3, dtype=torch.float64)
    _baseline_moves_the_value(reparam, eps, owner=base)
    reparam.ll_baseline = 7.0
    assert base.ll_baseline == 7.0 and reparam.ll_baseline == 7.0
    base.method = "scan"
    assert reparam.method == "scan"
    reparam.value_and_grad(eps)
    assert len(reparam.value_and_grad_fns) == 3


@pytest.mark.cuda
def test_value_and_grad_follows_baseline_through_a_replay():
    """The same on the card, each call a replay of a captured graph: the
    graph captured before the change keeps baseline 0, the next call
    captures anew."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lqg_tpu_torch.infer.capture import GraphedValueAndGrad

    model = _small_model("cuda", torch.float32)
    u = model.init_unconstrained()[None] + 0.1
    pe0, _ = _baseline_moves_the_value(model, u)
    assert all(isinstance(f, GraphedValueAndGrad)
               for f in model.value_and_grad_fns.values())
    first = next(iter(model.value_and_grad_fns.values()))
    assert torch.equal(first(u)[0], pe0)
    # a NeuTra model's replays follow its base model's baseline
    model.ll_baseline = 0.0
    reparam = _neutra(model)
    eps = torch.full_like(u, 0.3)
    _baseline_moves_the_value(reparam, eps, owner=model)
    assert all(isinstance(f, GraphedValueAndGrad)
               for f in reparam.value_and_grad_fns.values())
