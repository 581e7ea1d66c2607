"""The port's parallel layer (``lqg_tpu_torch.parallel``): the mesh over
``torch.distributed`` ranks, the trial- and horizon-sharded likelihoods and
chain-sharded NUTS with checkpoint resume.

In-process tests cover the one-rank world.  One group of 4 gloo ranks on
the CPU, spawned once for the module (``ranks``), runs every sharded
function; the tests read its results.  The ranks are started with the
spawn method (the parent holds JAX's threads), meet through a ``FileStore``
under ``tmp_path`` and are killed after ``JOIN_S`` seconds, so that a hang
fails one test, not the suite.  JAX is imported inside the tests only, which
keeps it out of the ranks."""

import functools
import multiprocessing
import os
import sys
import time
import traceback

import numpy as np
import pytest
import torch

from lqg_tpu_torch.infer import transforms as ttfm
from lqg_tpu_torch.infer.mcmc import MCMC
from lqg_tpu_torch.infer.models import ProbModel, lifted_model
from lqg_tpu_torch.models import BoundedActor
from lqg_tpu_torch.parallel import distributed_init, local_mesh, make_mesh
from lqg_tpu_torch.parallel import mesh as pmesh
from lqg_tpu_torch.parallel.pscan import trial_log_likelihood_assoc
from lqg_tpu_torch.parallel.sharding import (
    sequence_parallel_log_likelihood, sharded_chains_run,
    sharded_log_likelihood)

F64 = dict(device="cpu", dtype=torch.float64)
WORLD, JOIN_S = 4, 240
T_LL, N_LL, COST = 100, 16, 0.7  # the trial-sharded likelihood
T_SP, N_SP = (3, 160, 161), 4  # the horizon-sharded likelihood, over 4
# chain-sharded NUTS: a lifted bounded actor, 4 chains over the chains axis
T_MC, N_MC, SEED = 24, 3, 5
MC_KW = dict(num_warmup=6, num_samples=6, num_chains=4, max_depth=4)
# checkpoints, on a Gaussian target: stop after a chunk, resume
GAUSS_KW = dict(num_warmup=16, num_samples=16, num_chains=4, max_depth=5,
                chunk_steps=8)
BUDGET = 12  # leapfrogs a chunk, below a chunk's trees: it binds
MU = np.array([1.0, -2.0])
COV = np.array([[2.0, 1.2], [1.2, 1.5]])


def _gaussian_model():
    mu = torch.tensor(MU)
    prec = torch.tensor(np.linalg.inv(COV))

    def ll(p):
        z = torch.stack([p["a"], p["b"]], -1) - mu
        return -0.5 * ((z @ prec) * z).sum(-1)

    zero = torch.zeros((), dtype=torch.float64)
    return ProbModel(init={"a": zero, "b": zero},
                     transforms={"a": ttfm.identity, "b": ttfm.identity},
                     log_likelihood=ll, priors={})


def _inputs():
    """The trajectories every rank and the parent score, from seeds."""
    g = torch.Generator().manual_seed(0)
    out = {"x_ll": BoundedActor(T=T_LL, **F64).simulate(g, n=N_LL),
           "x_mc": BoundedActor(T=T_MC, **F64).simulate(g, n=N_MC)}
    for T in T_SP:
        out[f"x_sp{T}"] = BoundedActor(T=T, **F64).simulate(g, n=N_SP)
    return out


def _ll_model(dtype):
    return lambda p: BoundedActor(T=T_LL, device="cpu", dtype=dtype, **p)


def _rank(rank: int, tmp: str):
    """One rank of the group: every sharded function on its meshes; the
    results to ``rank{rank}.pt``, a failure's traceback to
    ``rank{rank}.err``."""
    torch.set_num_threads(1)
    try:
        out = {"backend": distributed_init(f"file://{tmp}/store", WORLD,
                                           rank)}
        data = torch.load(os.path.join(tmp, "inputs.pt"))
        mesh = make_mesh([("chains", 2), ("dp", 2)], device="cpu")
        out["coords"] = (mesh.index("chains"), mesh.index("dp"))
        for dtype in (torch.float64, torch.float32):
            total_ll = sharded_log_likelihood(
                _ll_model(dtype), data["x_ll"].to(dtype), mesh)
            c = torch.tensor(COST, dtype=dtype, requires_grad=True)
            value = total_ll({"action_cost": c})
            out[f"ll_{dtype}"] = (value.detach(),
                                  torch.autograd.grad(value, c)[0])
        sp = make_mesh([("sp", WORLD)], device="cpu")
        for T in T_SP:
            c = torch.tensor(COST, dtype=torch.float64, requires_grad=True)
            ll = sequence_parallel_log_likelihood(
                BoundedActor(T=T, action_cost=c, **F64), data[f"x_sp{T}"],
                sp)
            out[f"sp_{T}"] = (ll.detach(),
                              torch.autograd.grad(ll.sum(), c)[0])

        mc = sharded_chains_run(
            MCMC(lifted_model(data["x_mc"], BoundedActor), **MC_KW), SEED,
            mesh)
        out["chains"] = (mc._samples_u, mc.get_extra_fields())

        gauss = _gaussian_model()
        out["gauss"] = sharded_chains_run(MCMC(gauss, **GAUSS_KW), SEED,
                                          mesh)._samples_u
        # a leapfrog budget that ends chunks early: the ranks agree on
        # where through a max all-reduce a transition
        budget = MCMC(gauss, max_leapfrogs_per_launch=BUDGET, **GAUSS_KW)
        out["budget"] = (sharded_chains_run(budget, SEED, mesh)._samples_u,
                         torch.as_tensor(budget.get_extra_fields()[
                             "num_steps"]))
        path = os.path.join(tmp, "sharded.npz")
        out["stopped"] = sharded_chains_run(
            MCMC(gauss, checkpoint_every=1, **GAUSS_KW), SEED, mesh,
            checkpoint_path=path, _stop_after_launches=1)
        out["resumed"] = sharded_chains_run(
            MCMC(gauss, **GAUSS_KW), SEED, mesh,
            checkpoint_path=path)._samples_u
        # a checkpoint the parent wrote unsharded, resumed sharded
        out["resumed_unsharded"] = sharded_chains_run(
            MCMC(gauss, **GAUSS_KW), SEED, mesh,
            checkpoint_path=os.path.join(tmp, "unsharded.npz"))._samples_u
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _failure(procs, tmp, why):
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(10)
    logs = []
    for r in range(WORLD):
        err = os.path.join(tmp, f"rank{r}.err")
        if os.path.exists(err):
            with open(err) as f:
                logs.append(f"rank {r}:\n{f.read()}")
    codes = [p.exitcode for p in procs]
    pytest.fail(f"{why}; exit codes {codes}\n" + "\n".join(logs))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The group's results, one dict a rank, beside the parent's unsharded
    references, which it computes while the ranks run."""
    tmp = str(tmp_path_factory.mktemp("ranks"))
    data = _inputs()
    torch.save(data, os.path.join(tmp, "inputs.pt"))
    gauss = _gaussian_model()
    assert MCMC(gauss, checkpoint_every=1, **GAUSS_KW).run(
        SEED, checkpoint_path=os.path.join(tmp, "unsharded.npz"),
        _stop_after_launches=1) is None
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, tmp)) for r in range(WORLD)]
    for p in procs:
        p.start()
    # one thread beside the ranks: the potential's ops are small
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = {"data": data,
               "chains": MCMC(lifted_model(data["x_mc"], BoundedActor),
                              **MC_KW).run(SEED),
               "gauss": MCMC(gauss, **GAUSS_KW).run(SEED)}
    except BaseException:
        _failure(procs, tmp, "the parent's references failed")
        raise
    finally:
        torch.set_num_threads(threads)
    deadline = time.monotonic() + JOIN_S
    while any(p.is_alive() for p in procs):
        if any(p.exitcode not in (None, 0) for p in procs):
            _failure(procs, tmp, "a rank failed")
        if time.monotonic() > deadline:
            _failure(procs, tmp, f"the ranks did not end in {JOIN_S} s")
        time.sleep(0.1)
    if any(p.exitcode != 0 for p in procs):
        _failure(procs, tmp, "a rank failed")
    outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]
    # the checkpoint rank 0 wrote sharded, resumed in one process
    ref["resumed_sharded"] = MCMC(gauss, **GAUSS_KW).run(
        SEED, checkpoint_path=os.path.join(tmp, "sharded.npz"))
    return outs, ref


# --- one rank, in-process ---------------------------------------------------

def test_make_mesh_and_shard_batch_in_one_rank_world():
    mesh = make_mesh([("chains", 1), ("dp", 1)], device="cpu")
    assert mesh.shape == {"chains": 1, "dp": 1}
    assert (mesh.index("chains"), mesh.index("dp")) == (0, 0)
    assert mesh.groups == {"chains": None, "dp": None}
    assert local_mesh(device="cpu").shape == {"dp": 1}
    x = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(pmesh.shard_batch(x, mesh), x)
    assert torch.equal(pmesh.replicate(x.numpy(), mesh), x)
    # collectives of a one-rank world do nothing
    assert torch.equal(mesh.psum(x, "dp"), x)
    assert torch.equal(mesh.gather([x], "chains")[0], x)
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        make_mesh([("chains", 2), ("dp", 1)], device="cpu")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        local_mesh(4, device="cpu")


def test_axis_sharding_blocks_and_their_errors():
    """Blocks along an axis of 3 ranks, as rank 1 sees them, and the
    ValueError of a leading axis that does not divide."""
    mesh = make_mesh([("dp", 1)], device="cpu")
    mesh.shape, mesh._coords = {"dp": 3}, {"dp": 1}
    assert pmesh.AxisSharding(mesh, "dp").block(6) == slice(2, 4)
    x = torch.arange(6.0)
    assert torch.equal(pmesh.shard_batch(x, mesh), x[2:4])
    with pytest.raises(ValueError, match="must divide by mesh axis 'dp'"):
        pmesh.shard_batch(torch.arange(7.0), mesh)
    with pytest.raises(ValueError, match="num_chains=4 must divide"):
        sharded_chains_run(MCMC(_gaussian_model(), num_chains=4), 0, mesh,
                           axis="dp")


def test_the_layer_names_those_of_lqg_tpu():
    import lqg_tpu.parallel as jax_parallel
    import lqg_tpu_torch.parallel as parallel

    assert parallel.__all__ == jax_parallel.__all__
    assert all(hasattr(parallel, k) for k in parallel.__all__)
    for module in ("pscan", "sharding", "mesh"):
        jax_names = {k for k in vars(getattr(jax_parallel, module))
                     if not k.startswith("_") and k not in (
                         "jax", "jnp", "lax", "np", "Mesh", "NamedSharding",
                         "PartitionSpec", "P", "partial", "annotations")}
        missing = {k for k in jax_names
                   if not hasattr(getattr(parallel, module), k)}
        assert not missing, (module, missing)


def test_distributed_init_is_a_no_op_at_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert distributed_init() is None
    assert distributed_init(num_processes=1, process_id=0) is None
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed_init() is None
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("cards,ranks_on_node,want", [
    (0, 1, "gloo"), (0, 4, "gloo"), (1, 2, "gloo"), (1, 1, "nccl"),
    (4, 4, "nccl"), (2, 4, "gloo")])
def test_backend_rule(monkeypatch, cards, ranks_on_node, want):
    """``nccl`` exactly when every rank of the node has a card of its
    own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert pmesh.backend_for(ranks_on_node) == want


def test_one_rank_world_equals_the_unsharded_functions():
    data = _inputs()
    mesh = local_mesh(device="cpu")
    c = torch.tensor(COST, dtype=torch.float64, requires_grad=True)
    total = sharded_log_likelihood(_ll_model(torch.float64), data["x_ll"],
                                   mesh)({"action_cost": c})
    want = BoundedActor(T=T_LL, action_cost=c, **F64).log_likelihood(
        data["x_ll"]).sum()
    assert torch.equal(total, want)
    g, g_want = (torch.autograd.grad(v, c)[0] for v in (total, want))
    assert torch.equal(g, g_want)

    x = data[f"x_sp{T_SP[1]}"]
    cs = [torch.tensor(COST, dtype=torch.float64, requires_grad=True)
          for _ in range(2)]
    m, m_want = (BoundedActor(T=T_SP[1], action_cost=c, **F64) for c in cs)
    sp = sequence_parallel_log_likelihood(m, x, local_mesh(name="sp",
                                                           device="cpu"))
    want = trial_log_likelihood_assoc(m_want._joint(), x)
    assert torch.equal(sp, want)
    g, g_want = (torch.autograd.grad(v.sum(), c)[0]
                 for v, c in zip((sp, want), cs))
    assert torch.equal(g, g_want)

    gauss = _gaussian_model()
    chains = make_mesh([("chains", 1)], device="cpu")
    one = sharded_chains_run(MCMC(gauss, **GAUSS_KW), SEED, chains)
    ref = MCMC(gauss, **GAUSS_KW).run(SEED)
    assert torch.equal(one._samples_u, ref._samples_u)


# --- the 4-rank gloo group --------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_ll(T, x_bytes):
    """``lqg_tpu``'s per-trial log likelihoods of the bounded actor's trials
    at ``action_cost=COST`` and the gradient of their sum in it, float64
    (the tests run with ``x64``)."""
    import jax
    import jax.numpy as jnp
    from lqg_tpu.models import BoundedActor as JaxBoundedActor

    x = jnp.asarray(np.frombuffer(x_bytes).reshape(-1, T + 1, 2))

    def total(cost):
        value = JaxBoundedActor(T=T, action_cost=cost).log_likelihood(x)
        return value.sum(), value

    (_, value), grad = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jnp.asarray(COST))
    return np.asarray(value), np.asarray(grad)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-10),
                                        (torch.float32, 2e-5)],
                         ids=["float64", "float32"])
def test_sharded_log_likelihood_value_and_gradient(ranks, x64, dtype, rtol):
    """The trial-sharded total and its gradient in ``action_cost`` on a
    (chains=2, dp=2) mesh: on every rank the one-rank value and gradient,
    and ``lqg_tpu``'s ``System.log_likelihood(x).sum()`` and ``jax.grad``
    of it (the tolerance of ``tests/_dist_worker.py`` in float32)."""
    outs, ref = ranks
    x = ref["data"]["x_ll"]
    c = torch.tensor(COST, dtype=dtype, requires_grad=True)
    one = BoundedActor(T=T_LL, action_cost=c, device="cpu",
                       dtype=dtype).log_likelihood(x.to(dtype)).sum()
    g_one = torch.autograd.grad(one, c)[0]
    j_value, j_grad = _jax_ll(T_LL, x.numpy().tobytes())
    j_value = j_value.sum()
    for out in outs:
        value, grad = out[f"ll_{dtype}"]
        assert value.dtype == dtype
        np.testing.assert_allclose(value.numpy(), one.detach().numpy(),
                                   rtol=rtol)
        np.testing.assert_allclose(grad.numpy(), g_one.numpy(), rtol=rtol)
        np.testing.assert_allclose(value.numpy(), np.asarray(j_value),
                                   rtol=rtol)
        np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad),
                                   rtol=rtol)


@pytest.mark.parametrize("T", T_SP)
def test_sequence_parallel_log_likelihood(ranks, x64, T):
    """The horizon split over 4 ranks (blocks of 40, of 41 and 40, and of
    one step with an empty fourth block) against ``lqg_tpu``'s
    ``log_likelihood`` on every rank, and the gradient of its sum in
    ``action_cost`` against ``jax.grad`` of it: the gather of the blocks'
    totals and the sum pass the other ranks' cotangents back."""
    outs, ref = ranks
    x = ref["data"][f"x_sp{T}"]
    want, g_want = _jax_ll(T, x.numpy().tobytes())
    for out in outs:
        value, grad = out[f"sp_{T}"]
        np.testing.assert_allclose(value.numpy(), want, rtol=1e-8)
        np.testing.assert_allclose(grad.numpy(), g_want, rtol=1e-8)


def test_sharded_chains_run_gives_the_unsharded_draws(ranks):
    """4 chains of the lifted bounded actor over the chains axis, 2 a rank:
    every rank holds all chains' draws and extra fields, those of the
    unsharded run with the same seed."""
    outs, ref = ranks
    want = ref["chains"]
    assert want.get_extra_fields()["num_steps"].max() > 1
    for out in outs:
        samples, extra = out["chains"]
        assert samples.shape == want._samples_u.shape
        np.testing.assert_allclose(samples.numpy(), want._samples_u.numpy(),
                                   rtol=0, atol=1e-10)
        for k, v in want.get_extra_fields().items():
            np.testing.assert_allclose(np.asarray(extra[k]), np.asarray(v),
                                       rtol=0, atol=1e-10)


def test_sharded_checkpoint_resume(ranks):
    """A sharded run stopped after one chunk resumes from rank 0's
    checkpoint to the uninterrupted sharded run's draws, bit for bit; in
    one process it resumes to the unsharded run's, and a checkpoint written
    unsharded resumes sharded to them (a potential's products at 2 chains
    and at 4 round alike only to ~1e-12)."""
    outs, ref = ranks
    want = ref["gauss"]._samples_u.numpy()

    def close(a):
        np.testing.assert_allclose(a.numpy(), want, rtol=0, atol=1e-10)

    close(ref["resumed_sharded"]._samples_u)
    for out in outs:
        assert out["stopped"] is None
        assert torch.equal(out["resumed"], out["gauss"])
        close(out["gauss"])
        close(out["resumed_unsharded"])


def test_sharded_chains_with_a_binding_leapfrog_budget(ranks):
    """Chunks ended early on the deepest tree of all ranks' chains give the
    uninterrupted sharded run's draws, bit for bit, on every rank."""
    outs, _ = ranks
    for out in outs:
        samples, steps = out["budget"]
        # a chunk of draws' deepest trees outrun the budget
        assert steps[:, :GAUSS_KW["chunk_steps"]].amax(0).sum() > BUDGET
        assert torch.equal(samples, out["gauss"])


def test_dp_groups_agree_bit_for_bit(ranks):
    """The two ranks of each dp group (the same chains coordinate) hold the
    same bits of every result; the backend is gloo (no card)."""
    outs, _ = ranks
    assert [o["coords"] for o in outs] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert {o["backend"] for o in outs} == {"gloo"}
    keys = [k for k in outs[0] if k not in ("coords", "backend")]
    for a, b in ((0, 1), (2, 3)):
        for k in keys:
            x, y = outs[a][k], outs[b][k]
            if k == "chains":
                assert torch.equal(x[0], y[0])
                for f in x[1]:
                    assert np.array_equal(np.asarray(x[1][f]),
                                          np.asarray(y[1][f]))
            elif isinstance(x, tuple):
                assert all(torch.equal(u, v) for u, v in zip(x, y))
            elif x is not None:
                assert torch.equal(x, y), k
