"""MCMC runs: warmup-adapted NUTS over a batch of chains (port of
:mod:`lqg_tpu.infer.mcmc`).

* Chains are the leading axis of every state tensor and one batch of the
  potential, as JAX vmaps them; the warmup adaptation is gated by the
  per-step flags of one precomputed schedule, shared by the chains.
* The run advances in chunks of up to ``chunk_steps`` transitions, stopping
  a chunk early once its leapfrogs (the deepest chain's, per transition)
  reach ``max_leapfrogs_per_launch``.  Between chunks the host reads the
  draws and writes checkpoints.
* Early-warmup trees are capped at ``warmup_depth_cap`` for the first
  ``warmup_depth_cap_steps`` transitions.
* Every random number comes from a :class:`Draws` source: transition
  ``s`` draws from a generator seeded by ``(seed, s)`` alone, so chunk
  boundaries (and a resume with another ``chunk_steps``) do not change the
  sampled trajectory.
* On the card each leapfrog's value and gradient of the potential is a
  replay of one captured CUDA graph (:mod:`lqg_tpu_torch.infer.capture`),
  the counterpart of JAX compiling the transition into one program.
* With ``chain_sharding`` each rank of a mesh axis runs its contiguous
  block of the chains (:func:`lqg_tpu_torch.parallel.sharding.
  sharded_chains_run`): the draws of the full block are drawn and sliced,
  so a sharded run gives the unsharded run's draws chain for chain, and
  every rank gathers all chains' draws after each chunk.
"""

from __future__ import annotations

import glob
import os
import tempfile
from typing import NamedTuple, Optional

import numpy as np
import torch

from lqg_tpu_torch.infer import adaptation as adapt
from lqg_tpu_torch.infer.capture import value_and_grad_fn
from lqg_tpu_torch.infer.hmc import NUTSDraws, draw_nuts, nuts_step
from lqg_tpu_torch.infer.models import ProbModel
from lqg_tpu_torch.parallel.mesh import _world


class ChainState(NamedTuple):
    z: torch.Tensor          # (C, D)
    pe: torch.Tensor         # (C,)
    grad: torch.Tensor       # (C, D)
    step_size: torch.Tensor  # (C,)
    inv_mass: torch.Tensor   # (C, D) or (C, D, D)
    da: adapt.DualAveragingState
    welford: adapt.WelfordState


class Draws:
    """The random numbers of a run, on ``device``: the initial jitter and
    the step-size search's momentum from a generator seeded by ``(seed,
    0)``, transition ``s``'s :class:`NUTSDraws` from one seeded by ``(seed,
    1, s)`` (numpy's ``SeedSequence`` mixes the key).

    A test may hand :meth:`MCMC.run` another object with the same two
    methods (the JAX package's draws, replayed)."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.generator = torch.Generator(device=device)

    def _seeded(self, *key) -> torch.Generator:
        a, b = np.random.SeedSequence([self.seed, *key]).generate_state(
            2, np.uint32)
        return self.generator.manual_seed((int(a) << 31) ^ int(b))

    def init(self, C: int, D: int, dtype):
        """``(jitter (C, D)`` uniform on [-1, 1), ``eps (C, D))``."""
        g = self._seeded(0)
        kw = dict(generator=g, dtype=dtype, device=g.device)
        return torch.rand((C, D), **kw) * 2.0 - 1.0, torch.randn((C, D), **kw)

    def transition(self, s: int, C: int, D: int, max_depth: int,
                   dtype) -> NUTSDraws:
        return draw_nuts(self._seeded(1, s), C, D, max_depth, dtype)


def _leaves(state) -> list:
    out = []
    for x in state:
        out.extend(_leaves(x) if isinstance(x, tuple) else [x])
    return out


def _rebuild(template, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, tuple):
            return type(t)(*(build(x) for x in t))
        return next(it)

    return build(template)


def _barrier(device):
    """Wait until every process of the world gets here (a no-op for one):
    an all-reduce the host waits on, which every backend offers."""
    if _world()[0] > 1:
        x = torch.zeros(1, device=device)
        torch.distributed.all_reduce(x)
        x.cpu()


def _check_resume(steps_done: int, path: str, device):
    """In multi-process runs every process read ``path`` on its own; a
    path that is not on a shared filesystem gives divergent resume or
    fresh-start decisions, and the collectives that follow would deadlock.
    The resume step is checked against process 0's instead."""
    world, rank = _world()
    if world <= 1:
        return
    p0 = torch.tensor([steps_done], dtype=torch.int64).to(device)
    torch.distributed.broadcast(p0, src=0)
    p0_step = int(p0.cpu())
    if p0_step != steps_done:
        raise RuntimeError(
            f"multi-process checkpoint resume diverged: process 0 is at "
            f"step {p0_step} but process {rank} read step {steps_done} from "
            f"{path}. checkpoint_path must be on a filesystem shared by all "
            f"processes (process 0 writes, every process reads)")


class MCMC:
    """Run NUTS on a :class:`ProbModel`.

    The constructor takes the JAX package's arguments
    (``lqg_tpu/infer/mcmc.py:90-101``) with their meaning:

    Args:
        model: the probabilistic model (potential + transforms); its
            initial point's device is where the chains run.
        num_warmup / num_samples: warmup and kept draws per chain.
        num_chains: chains, run as one batch.
        max_depth: NUTS maximum tree depth.
        target_accept: dual-averaging target acceptance probability.
        init_jitter: chains start at the model's initial point plus a
            uniform jitter of this half-width.
        thinning: keep every k-th sample.
        dense_mass: adapt a dense inverse mass (the posterior covariance)
            instead of a diagonal one; ``None`` = dense for 2 <= zdim <= 64.
        init_inv_mass: start from this inverse mass instead of identity:
            ``(zdim,)`` variances or the ``(zdim, zdim)`` lower-Cholesky
            factor of the posterior covariance.
        adapt_mass: False keeps ``init_inv_mass`` fixed (warmup then adapts
            the step size only).
        chunk_steps: transitions between host reads of the draws.
        max_leapfrogs_per_launch: end a chunk early once this many batched
            leapfrogs have run in it.
        warmup_depth_cap / warmup_depth_cap_steps: cap tree depth at
            ``warmup_depth_cap`` for the first ``warmup_depth_cap_steps``
            warmup transitions.
        checkpoint_every: chunks between checkpoint writes when
            ``checkpoint_path`` is given (default: roughly every 128 steps).
    """

    def __init__(self, model: ProbModel, num_warmup: int = 1000,
                 num_samples: int = 1000, num_chains: int = 1,
                 max_depth: int = 10, target_accept: float = 0.8,
                 init_jitter: float = 0.2, thinning: int = 1,
                 progress: bool = False, chunk_steps: Optional[int] = None,
                 max_leapfrogs_per_launch: Optional[int] = None,
                 warmup_depth_cap: int = 7,
                 warmup_depth_cap_steps: int = 75,
                 checkpoint_every: Optional[int] = None,
                 dense_mass: Optional[bool] = None,
                 init_inv_mass=None, adapt_mass: bool = True):
        self.model = model
        self.num_warmup = num_warmup
        self.num_samples = num_samples
        self.num_chains = num_chains
        self.max_depth = max_depth
        self.target_accept = target_accept
        self.init_jitter = init_jitter
        self.thinning = thinning
        self.progress = progress
        self.chunk_steps = max(1, int(64 if chunk_steps is None
                                      else chunk_steps))
        self.max_leapfrogs_per_launch = int(
            1 << 30 if max_leapfrogs_per_launch is None
            else max_leapfrogs_per_launch)
        self.warmup_depth_cap = int(warmup_depth_cap)
        self.warmup_depth_cap_steps = int(warmup_depth_cap_steps)
        self.checkpoint_every = checkpoint_every
        self.dense_mass = dense_mass
        self.init_inv_mass = (None if init_inv_mass is None
                              else torch.as_tensor(init_inv_mass))
        self.adapt_mass = adapt_mass
        self._dense = False  # resolved against zdim in run()
        self.value_and_grad = None  # built in run()
        self._samples_u = None
        self._extra = None

    # --- chain programs ---
    def _init_chain(self, z0, eps) -> ChainState:
        """Every chain's first state (``lqg_tpu/infer/mcmc.py:137``);
        ``eps (C, D)`` are the step-size search's momentum normals."""
        C, D = z0.shape
        like = dict(dtype=z0.dtype, device=z0.device)
        pe0, grad0 = self.value_and_grad(z0)
        if self.init_inv_mass is not None:
            m = self.init_inv_mass.to(**like)
            inv_mass0 = m.expand((C,) + m.shape).clone()
        elif self._dense:
            inv_mass0 = torch.eye(D, **like).expand(C, D, D).clone()
        else:
            inv_mass0 = torch.ones((C, D), **like)
        step0 = adapt.find_reasonable_step_size(
            self.value_and_grad, inv_mass0, z0, pe0, grad0, eps)
        return ChainState(z=z0, pe=pe0, grad=grad0, step_size=step0,
                          inv_mass=inv_mass0, da=adapt.da_init(step0),
                          welford=adapt.welford_init(C, D, self._dense,
                                                     **like))

    def _step_one(self, state: ChainState, draws: NUTSDraws, flags,
                  depth_cap):
        """One NUTS transition and its adaptation for every chain
        (``lqg_tpu/infer/mcmc.py:159``).  ``flags`` are the step's warmup
        schedule flags, shared by the chains."""
        is_warmup, in_win, win_end, freeze = (bool(f) for f in flags)
        z, pe, grad, info = nuts_step(
            self.value_and_grad, draws, state.z, state.pe, state.grad,
            state.step_size, state.inv_mass, max_depth=self.max_depth,
            depth_cap=depth_cap)

        da, step_size = state.da, state.step_size
        if is_warmup:
            da = adapt.da_update(da, info.accept_prob,
                                 target=self.target_accept)
            step_size = torch.exp(da.log_step)
        welford = (adapt.welford_update(state.welford, z) if in_win
                   else state.welford)
        inv_mass = state.inv_mass
        if win_end:
            # close a slow window: adopt the variance/covariance as inverse
            # mass, reset the accumulator and restart dual averaging
            inv_mass = adapt.welford_mass(welford)
            da = adapt.da_init(torch.exp(da.log_step_avg))
            C, D = z.shape
            welford = adapt.welford_init(C, D, self._dense, dtype=z.dtype,
                                         device=z.device)
            step_size = torch.exp(da.log_step)
        if freeze:  # end of warmup: the dual-averaged step size
            step_size = torch.exp(da.log_step_avg)

        new_state = ChainState(z=z, pe=pe, grad=grad, step_size=step_size,
                               inv_mass=inv_mass, da=da, welford=welford)
        out = (z, info.accept_prob, info.diverging, info.num_steps,
               info.tree_depth, pe)
        return new_state, out

    def _build_schedule(self, total):
        """Per-step flags ``(is_warmup, in_win, win_end, freeze)`` and depth
        caps for the whole run, numpy arrays."""
        in_window, window_end = adapt.build_schedule(self.num_warmup)
        is_warmup = np.arange(total) < self.num_warmup
        freeze = np.arange(total) == (self.num_warmup - 1)
        in_win = np.zeros(total, dtype=bool)
        in_win[:self.num_warmup] = in_window
        win_end = np.zeros(total, dtype=bool)
        win_end[:self.num_warmup] = window_end
        flags = np.stack([is_warmup, in_win, win_end, freeze], axis=1)

        if not self.adapt_mass:
            flags[:, 1] = False   # never accumulate
            flags[:, 2] = False   # never adopt a new mass
        caps = np.full(total, self.max_depth, dtype=np.int32)
        n_cap = min(self.warmup_depth_cap_steps, self.num_warmup)
        caps[:n_cap] = min(self.warmup_depth_cap, self.max_depth)
        return flags, caps

    def run(self, rng, checkpoint_path: Optional[str] = None,
            chain_sharding=None, _stop_after_launches: Optional[int] = None):
        """Run all chains; returns self for chaining.

        Args:
            rng: an integer seed, or a draw source with :class:`Draws`'s
                methods.
            checkpoint_path: if given, the in-flight run state is written
                there every ``checkpoint_every`` chunks (draws to
                nonce-stamped side files, chain state atomically replaced),
                and an existing compatible checkpoint at that path is
                resumed from instead of starting over.  Resume is exact: a
                transition's draws depend on its index alone, so chunk
                boundaries (even another ``chunk_steps``) do not change the
                sampled trajectory.
                In multi-process runs the path must be on a filesystem
                shared by all processes (process 0 writes the checkpoint of
                all chains, every process reads it; a divergent read
                raises instead of deadlocking), and a checkpoint resumes
                sharded or not, whichever way it was written.
            chain_sharding: optional :class:`lqg_tpu_torch.parallel.mesh.
                AxisSharding` of the chain axis: this rank runs its block of
                the chains, with the value+grad captured at that batch, and
                every rank ends with all chains' draws (used by
                :func:`lqg_tpu_torch.parallel.sharding.sharded_chains_run`).
            _stop_after_launches: testing hook - stop (returning ``None``)
                after this many chunks, leaving the checkpoint behind.
        """
        total = self.num_warmup + self.num_samples * self.thinning
        chunk = min(self.chunk_steps, total)
        flags, caps = self._build_schedule(total)
        ckpt_every = self.checkpoint_every
        if ckpt_every is None:
            ckpt_every = max(1, 128 // chunk)

        u0 = self.model.init_unconstrained().detach()
        C, D = self.num_chains, u0.shape[0]
        if self.init_inv_mass is not None:
            self._dense = self.init_inv_mass.dim() == 2
        else:
            self._dense = (self.dense_mass if self.dense_mass is not None
                           else 2 <= D <= 64)
        draws = (Draws(rng, u0.device) if isinstance(rng, (int, np.integer))
                 else rng)
        # this rank's chains; every rank's, gathered along the mesh axis
        mine, (mesh, axis) = slice(None), (None, None)
        if chain_sharding is not None:
            mine, (mesh, axis) = chain_sharding.block(C), chain_sharding

        def gather(tensors):
            return list(tensors) if mesh is None else mesh.gather(tensors,
                                                                  axis)

        def deepest(steps):  # the deepest tree of all ranks' chains
            return steps.max() if mesh is None else mesh.pmax(steps.max(),
                                                               axis)

        # the leapfrog budget can end a chunk only if a chunk's trees may
        # reach it (a tree has fewer than 2**max_depth leaves); else the
        # trees' sizes go unread, a host read (and, sharded, a collective)
        # each transition spared
        budget_binds = (self.max_leapfrogs_per_launch
                        <= (chunk - 1) * 2 ** self.max_depth)
        jitter, eps = (a[mine] for a in draws.init(C, D, u0.dtype))
        z0 = u0[None, :] + self.init_jitter * jitter
        self.value_and_grad = value_and_grad_fn(self.model.potential, z0)
        state = self._init_chain(z0, eps)

        outs_host = []  # 6-tuples of (steps_k, chains, ...) arrays
        pending = []    # buffered since the last checkpoint write
        steps_done, n_files = 0, 0
        nonce = np.uint64(int.from_bytes(os.urandom(8), "little"))
        if checkpoint_path is not None:
            resumed = self._load_run_checkpoint(checkpoint_path, state)
            if resumed is not None:
                state, outs_host, steps_done, nonce, n_files = resumed
                # the checkpoint holds every chain
                state = _rebuild(state, [x[mine] for x in _leaves(state)])
                if self.progress:
                    print(f"[mcmc] resumed at step {steps_done}/{total} "
                          f"from {checkpoint_path}", flush=True)
            else:
                self._clean_orphan_chunks(checkpoint_path)
            _check_resume(steps_done, checkpoint_path, u0.device)

        def save(pending):
            # every rank gathers; rank 0 writes; no rank goes on (to a
            # resume that reads the files) before the write is done
            full = _rebuild(state, gather(_leaves(state)))
            n = (self._save_run_checkpoint(checkpoint_path, full, pending,
                                           steps_done, nonce, n_files)
                 if _world()[1] == 0 else n_files + 1)
            _barrier(u0.device)
            return n

        launches = 0
        while steps_done < total:
            outs, leapfrogs = [], 0.0
            while (len(outs) < chunk and steps_done < total
                   and leapfrogs < self.max_leapfrogs_per_launch):
                step_draws = draws.transition(steps_done, C, D,
                                              self.max_depth, u0.dtype)
                state, out = self._step_one(
                    state, NUTSDraws(*(a[mine] for a in step_draws)),
                    flags[steps_done], caps[steps_done])
                outs.append(out)
                steps_done += 1
                if budget_binds:
                    # a transition's batched cost: the deepest chain's tree
                    leapfrogs += float(deepest(out[3]))
            # (steps_k, chains, ...), every rank's chains
            host_out = tuple(
                x.movedim(0, 1).cpu().numpy() for x in gather(
                    [torch.stack([o[i] for o in outs], 1) for i in range(6)]))
            outs_host.append(host_out)
            pending.append(host_out)
            launches += 1

            if checkpoint_path is not None and (
                    launches % ckpt_every == 0 or steps_done >= total):
                n_files = save(pending)
                pending = []
            if self.progress:
                acc = float(np.mean(host_out[1]))
                print(f"[mcmc] step {steps_done}/{total} "
                      f"({'warmup' if steps_done <= self.num_warmup else 'sample'})"
                      f" accept={acc:.2f} (+{len(outs)} steps/chunk)",
                      flush=True)
            if (_stop_after_launches is not None
                    and launches >= _stop_after_launches
                    and steps_done < total):
                if checkpoint_path is not None and pending:
                    n_files = save(pending)
                return None

        # concat per-chunk outputs along the step axis, chains to front
        zs, accept, div, steps, depth, pes = (
            np.moveaxis(np.concatenate([o[i] for o in outs_host], axis=0),
                        0, 1)
            for i in range(6))
        sel = slice(self.num_warmup + self.thinning - 1, None, self.thinning)
        zs, accept, div, steps, depth, pes = (
            a[:, sel] for a in (zs, accept, div, steps, depth, pes))

        self._samples_u = torch.from_numpy(zs)  # (chains, draws, zdim)
        step_size, inv_mass = gather([state.step_size, state.inv_mass])
        self._extra = dict(accept_prob=accept, diverging=div,
                           num_steps=steps, tree_depth=depth,
                           potential_energy=pes,
                           step_size=step_size, inv_mass=inv_mass)
        return self

    # --- in-flight run checkpointing ---
    def _ckpt_config(self):
        # everything that changes the sampled trajectory (chunk_steps and
        # the leapfrog budget only move chunk boundaries, so resuming with
        # different chunk sizing is exact and allowed)
        return np.array([self.num_warmup, self.num_samples, self.num_chains,
                         self.thinning, self.max_depth,
                         min(self.warmup_depth_cap, self.max_depth),
                         min(self.warmup_depth_cap_steps, self.num_warmup),
                         int(self._dense), int(self.adapt_mass)])

    @staticmethod
    def _chunk_path(path, c):
        return f"{path}.chunk_{c:05d}.npz"

    def _clean_orphan_chunks(self, path):
        """Starting fresh: remove chunk files a previous run at the same
        path left behind, so they can never be mistaken for this run's.
        In multi-process runs process 0 does it."""
        if _world()[1] != 0:
            return
        for p in glob.glob(f"{path}.chunk_*.npz"):
            try:
                os.remove(p)
            except OSError:
                pass

    @staticmethod
    def _atomic_savez(path, payload):
        # atomic replace so a mid-write kill cannot corrupt the checkpoint
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                   suffix=".npz")
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)

    def _save_run_checkpoint(self, path, state, pending, steps_done, nonce,
                             n_files):
        """Streaming checkpoint: draws buffered since the last write go to
        ONE nonce-stamped side file (``{path}.chunk_NNNNN.npz``, always
        overwritten - never trusted from a previous run); the small
        chain-state file at ``path`` is atomically replaced afterwards.
        Returns the new side-file count."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = {"nonce": nonce}
        for i in range(6):
            payload[f"out_{i}"] = np.concatenate(
                [p[i] for p in pending], axis=0)
        self._atomic_savez(self._chunk_path(path, n_files), payload)
        n_files += 1

        main = {"config": self._ckpt_config(),
                "nonce": nonce,
                "steps_done": np.array(steps_done),
                "n_files": np.array(n_files)}
        for i, leaf in enumerate(_leaves(state)):
            main[f"state_{i}"] = leaf.cpu().numpy()
        self._atomic_savez(path, main)
        return n_files

    def _load_run_checkpoint(self, path, state_template):
        if not os.path.exists(path):
            return None
        data = np.load(path, allow_pickle=False)
        if not np.array_equal(data["config"], self._ckpt_config()):
            raise ValueError(
                f"checkpoint at {path} was written with a different MCMC "
                f"configuration: {data['config']} vs {self._ckpt_config()}")
        nonce = data["nonce"][()]
        leaves = [torch.from_numpy(data[f"state_{i}"]).to(
            dtype=leaf.dtype, device=leaf.device)
            for i, leaf in enumerate(_leaves(state_template))]
        state = _rebuild(state_template, leaves)
        outs = []
        steps = 0
        for c in range(int(data["n_files"])):
            cp = self._chunk_path(path, c)
            if not os.path.exists(cp):
                raise ValueError(
                    f"checkpoint at {path} is missing its chunk file {cp}")
            cd = np.load(cp, allow_pickle=False)
            if cd["nonce"][()] != nonce:
                raise ValueError(
                    f"chunk file {cp} belongs to a different run "
                    f"(stale nonce) - delete it or the main checkpoint")
            out = tuple(cd[f"out_{i}"] for i in range(6))
            steps += out[0].shape[0]
            outs.append(out)
        if steps != int(data["steps_done"]):
            raise ValueError(
                f"checkpoint at {path}: chunk files hold {steps} steps but "
                f"the state file says {int(data['steps_done'])}")
        return state, outs, int(data["steps_done"]), nonce, int(data["n_files"])

    # --- results ---
    def get_samples(self, group_by_chain: bool = False) -> dict:
        """Constrained-space samples per parameter name, CPU tensors
        ``(chains * draws,)`` or, grouped, ``(chains, draws)``."""
        if self._samples_u is None:
            raise RuntimeError("call .run(seed) first")
        u = self._samples_u
        if not group_by_chain:
            u = u.reshape(-1, u.shape[-1])
        return self.model.constrain(u)

    def get_extra_fields(self) -> dict:
        return self._extra

    @property
    def divergences(self):
        return int(np.asarray(self._extra["diverging"]).sum())

    def summary(self):
        from lqg_tpu_torch.infer.diagnostics import summary as _summary
        return _summary({k: v.numpy() for k, v in
                         self.get_samples(group_by_chain=True).items()})

    def print_summary(self):
        df = self.summary()
        print(df.to_string(float_format=lambda v: f"{v:8.3f}"))
        print(f"\ndivergences: {self.divergences}")
        return df
