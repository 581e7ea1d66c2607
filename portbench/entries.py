"""The program's entry points that a traffic mix drives, one class each,
chosen by the mix's ``"entry"``:

* ``value_and_grad``: :meth:`ProbModel.value_and_grad` at ``points`` chains
  a call, from one caller that waits for each call's outputs (the ELBO's
  and the MAP's batches);
* ``nuts``: NUTS transitions of ``chains`` chains through the program's
  transition (``infer.hmc.nuts_step``), each leapfrog a replay;
* ``map``: :func:`~lqg_tpu_torch.infer.svi.optimize` (Adam) in chunks of
  steps, each chunk continuing from the last and ending in one
  synchronize.

Every call of the program's value+grad goes through :class:`Recorder`,
which keeps its input and outputs (the answers the check samples) and the
host time spent inside it.  Each class gives its set-up
(:meth:`warm_up`), its measured window, a traced slice, its end-to-end
metrics and its answers.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Recorder:
    """Wraps a value+grad callable: each call's ``(input, pe, grad)`` and
    the host seconds inside it.  While ``waiting``, it also waits for each
    call's outputs on the card and keeps those seconds apart
    (``wait_s``)."""

    def __init__(self, fn, device):
        self.fn = fn
        self.device = device
        self.calls = []
        self.inside_s = 0.0
        self.wait_s = 0.0
        self.waiting = False

    def __call__(self, z):
        t = time.perf_counter()
        pe, grad = self.fn(z)
        t1 = time.perf_counter()
        self.inside_s += t1 - t
        if self.waiting:
            _sync(self.device)
            self.wait_s += time.perf_counter() - t1
        self.calls.append((z, pe, grad))
        return pe, grad


class Entry:
    """What the entries share: the run, the traffic, the recorder and the
    window's bookkeeping."""

    def __init__(self, run):
        self.run = run
        self.traffic = run.cell.traffic
        self.model = run.model
        self.device = run.device
        self.recorder = None
        self.first = 0  # the window's first call in the recorder

    def calls(self) -> int:
        return len(self.recorder.calls)

    def _init_point(self, where: str) -> None:
        """The model's initial point: the prior medians (the model's own
        default) or the configuration's truth."""
        if where == "truth":
            truth = self.run.cell.config["truth"]
            like = dict(dtype=torch.float32, device=self.device)
            self.model.init = {n: torch.tensor(truth[n], **like)
                               for n in self.model.names}
        elif where != "prior_median":
            raise ValueError(f"unknown initial point {where!r}")
        self.u_init = self.model.init_unconstrained().detach()

    def _record_graph(self):
        """Route the model's captured value+grad through a recorder."""
        (key,) = self.model.value_and_grad_fns
        self.recorder = Recorder(self.model.value_and_grad_fns[key],
                                 self.device)
        self.model.value_and_grad_fns[key] = self.recorder

    def window_calls(self) -> list:
        return self.recorder.calls[self.first:self.first + self.n_window]

    def _finish(self, t0: float, n: int) -> dict:
        _sync(self.device)
        seconds = time.perf_counter() - t0
        self.n_window = n
        pes = [pe for _, pe, _ in self.window_calls()]
        failed = int((~torch.isfinite(torch.stack(pes))).any(-1).sum()) \
            if pes else 0
        return {"seconds": seconds, "calls": n, "failed": failed,
                "inside_s": self.recorder.inside_s - self._inside0}

    def _start(self):
        _sync(self.device)
        self.first = self.calls()
        self._inside0 = self.recorder.inside_s
        return time.perf_counter()

    def sample(self, k: int, key: int) -> list:
        """``k`` of the window's calls, drawn from the seed."""
        calls = self.window_calls()
        idx = self.run.rng(key).choice(len(calls), size=min(k, len(calls)),
                                       replace=False)
        return [calls[i] for i in sorted(idx)]

    def release(self):
        """Drop the program's state; the answers are kept apart."""
        self.model = self.recorder = None


class ValueAndGrad(Entry):
    """Closed loop of one caller: each call at a new batch of ``points``
    chains from a pool drawn around the truth, timed from its enqueue to
    the wait on its outputs."""

    def __init__(self, run):
        super().__init__(run)
        self._init_point(self.traffic["init"])
        C, D = self.traffic["points"], len(self.model.names)
        self.sets = C * run.cell.config["conditions"]
        g = run.seeded(2)
        self.pool = self.u_init + self.traffic["spread"] * torch.randn(
            (self.traffic["pool"], C, D), generator=g, device=self.device)
        self.k = 0
        self.latencies = []

    def warm_up(self):
        self.model.value_and_grad(self.pool[0])  # captures
        self._record_graph()
        for i in range(self.traffic["warm_calls"]):
            self.model.value_and_grad(self.pool[i % len(self.pool)])
        _sync(self.device)

    def _call(self):
        t = time.perf_counter()
        self.model.value_and_grad(self.pool[self.k % len(self.pool)])
        _sync(self.device)
        self.k += 1
        return time.perf_counter() - t

    def window(self, seconds: float) -> dict:
        t0 = self._start()
        n, lat = 0, []
        while True:
            lat.append(self._call())
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self.latencies = lat
        return self._finish(t0, n)

    def traced_slice(self):
        for _ in range(self.traffic["trace_calls"]):
            self._call()

    def end_to_end(self) -> dict:
        w = self.run.window
        return {"vg_sets_per_s": w["calls"] * self.sets / w["seconds"],
                "vg_p95_ms": float(np.percentile(self.latencies, 95)) * 1e3}

    def describe(self) -> str:
        w = self.run.window
        return (f"window {w['seconds']:.3f} s: {w['calls']} calls of "
                f"{self.sets} sets, median "
                f"{float(np.median(self.latencies)) * 1e3:.4f} ms")

    def answers(self) -> dict:
        calls = self.sample(self.traffic["check_calls"], 3)
        return {"points": [(z, pe, g) for z, pe, g in calls]}


class Nuts(Entry):
    """NUTS transitions of every chain through the program's transition,
    :func:`~lqg_tpu_torch.infer.hmc.nuts_step`, as
    :meth:`~lqg_tpu_torch.infer.mcmc.MCMC.run` calls it in its sampling
    phase: the step size and the dense inverse mass fixed by the traffic
    (the program's own warm-up adaptation, ``portbench.adapt``), the
    value+grad :meth:`ProbModel.value_and_grad`'s replayed graph, the
    draws made by the benchmark from the seed.  The chains start at the
    truth with a uniform jitter, as a fit's chains start at its MAP."""

    def __init__(self, run):
        super().__init__(run)
        t = self.traffic
        self._init_point(t["init"])
        self.C, self.D = t["chains"], len(self.model.names)
        self.sets = self.C * run.cell.config["conditions"]
        like = dict(dtype=torch.float64, device=self.device)
        cov = torch.tensor(t["inv_mass"], **like)
        if cov.shape != (self.D, self.D):
            raise ValueError(f"inv_mass is {tuple(cov.shape)}, the model "
                             f"has {self.D} coordinates")
        self.L = torch.linalg.cholesky(cov).to(torch.float32)
        self.inv_mass = self.L.expand(self.C, self.D, self.D).contiguous()
        self.step = torch.tensor(t["step_size"], dtype=torch.float32,
                                 device=self.device).expand(self.C)
        self.s = 0
        self.log = []    # (first call, start state, draws, depth) a step
        self.state = None

    def warm_up(self):
        g = self.run.seeded(4)
        jitter = torch.rand((self.C, self.D), generator=g,
                            device=self.device) * 2.0 - 1.0
        z0 = self.u_init[None, :] + self.traffic["init_jitter"] * jitter
        self.model.value_and_grad(z0)  # captures
        self._record_graph()
        self.state = self.model.value_and_grad(z0)
        self.state = (z0,) + tuple(self.state)
        for _ in range(self.traffic["warm_transitions"]):
            self._transition()
        _sync(self.device)

    def _transition(self):
        from lqg_tpu_torch.infer.hmc import draw_nuts, nuts_step

        draws = draw_nuts(self.run.seeded(5, self.s), self.C, self.D,
                          self.traffic["max_depth"], torch.float32)
        first, start = self.calls(), self.state
        z, pe, grad, info = nuts_step(
            self.model.value_and_grad, draws, *start, self.step,
            self.inv_mass, max_depth=self.traffic["max_depth"])
        self.state = (z, pe, grad)
        self.s += 1
        return first, start, draws, info.tree_depth

    def window(self, seconds: float) -> dict:
        t0 = self._start()
        self.log = []
        while time.perf_counter() - t0 < seconds:
            self.log.append(self._transition())
        self.after = self.state
        return self._finish(t0, self.calls() - self.first)

    def span_slice(self):
        """Transitions with each value+grad waited for, for
        ``sampler_host_ms``: ``(seconds, calls, inside, waits)``."""
        rec = self.recorder
        before = (self.calls(), rec.inside_s, rec.wait_s)
        _sync(self.device)
        rec.waiting = True
        t = time.perf_counter()
        while self.calls() - before[0] < self.traffic["span_calls"]:
            self._transition()
        _sync(self.device)
        seconds = time.perf_counter() - t
        rec.waiting = False
        return (seconds, self.calls() - before[0],
                rec.inside_s - before[1], rec.wait_s - before[2])

    def traced_slice(self):
        start = self.calls()
        while self.calls() - start < self.traffic["trace_calls"]:
            self._transition()

    def end_to_end(self) -> dict:
        w = self.run.window
        return {"leapfrogs_per_s": w["calls"] / w["seconds"]}

    def describe(self) -> str:
        w = self.run.window
        depth = torch.stack([d for *_, d in self.log]).float()
        return (f"window {w['seconds']:.3f} s: {len(self.log)} "
                f"transitions of {self.C} chains, {w['calls']} leapfrogs, "
                f"mean tree depth {float(depth.mean()):.3f}, step sizes "
                f"{self.step.tolist()}")

    def answers(self) -> dict:
        """Calls and kept states drawn from the seed for the value check,
        the share of chain-transitions that moved, and sampled
        transitions with all they need for a replay, on the host."""
        calls = self.sample(self.traffic["check_calls"], 3)
        kept = [start for _, start, _, _ in self.log[1:]] + [self.after]
        idx = self.run.rng(5).choice(len(kept), size=min(
            self.traffic["check_states"], len(kept)), replace=False)
        zs = torch.stack([z for z, _, _ in
                          [self.log[0][1]] + kept])
        moved = (zs[1:] != zs[:-1]).any(-1).float().mean()
        host = lambda xs: tuple(x.cpu().numpy() for x in xs)
        ends = ([entry[0] for entry in self.log[1:]]
                + [self.first + self.n_window])
        pick = self.run.rng(7).choice(len(self.log), size=min(
            self.traffic["check_transitions"], len(self.log)), replace=False)
        steps = []
        for i in sorted(pick):
            first, start, draws, depth = self.log[i]
            leaves = self.recorder.calls[first:ends[i]]
            steps.append({
                "start": host(start), "after": host(kept[i]),
                "draws": host(draws), "depth": depth.cpu().numpy(),
                "leaves": tuple(torch.stack(x).cpu().numpy()
                                for x in zip(*leaves)),
                "calls": ends[i] - first})
        return {"points": calls + [kept[i] for i in sorted(idx)],
                "moved_share": float(moved),
                "transitions": {"steps": steps,
                                "step": self.step.cpu().numpy(),
                                "L": self.L.cpu().numpy(),
                                "max_depth": self.traffic["max_depth"]}}

    def release(self):
        super().release()
        self.state = self.log = self.after = None


class Map(Entry):
    """Adam on the potential from the prior medians, as the fit's first
    stage: ``optimize`` called for ``chunk_steps`` steps at a time, each
    chunk starting where the last ended, each ending in one synchronize."""

    def __init__(self, run):
        super().__init__(run)
        self._init_point(self.traffic["init"])
        self.sets = run.cell.config["conditions"]
        self.chunks, self.chunk_s = [], []

    def _chunk(self, steps: int):
        from lqg_tpu_torch.infer.svi import optimize

        u0 = self.model.init_unconstrained().detach()[None]
        t = time.perf_counter()
        params, losses = optimize(self.model, steps=steps,
                                  step_size=self.traffic["step_size"])
        self.model.init = params
        _sync(self.device)
        self.chunk_s.append(time.perf_counter() - t)
        return u0, losses

    def warm_up(self):
        from lqg_tpu_torch.infer.svi import optimize

        init = dict(self.model.init)
        optimize(self.model, steps=self.traffic["warm_steps"],
                 step_size=self.traffic["step_size"])  # captures
        self._record_graph()
        self.model.init = init
        _sync(self.device)

    def window(self, seconds: float) -> dict:
        t0 = self._start()
        self.chunk_s = []
        while time.perf_counter() - t0 < seconds:
            self.chunks.append(self._chunk(self.traffic["chunk_steps"]))
        return self._finish(t0, self.calls() - self.first)

    def traced_slice(self):
        self._chunk(self.traffic["trace_calls"])

    def end_to_end(self) -> dict:
        w = self.run.window
        return {"map_steps_per_s": w["calls"] / w["seconds"]}

    def describe(self) -> str:
        w = self.run.window
        last = self.chunks[-1][1][-1]
        return (f"window {w['seconds']:.3f} s: {len(self.chunks)} chunks of "
                f"{self.traffic['chunk_steps']} steps, each "
                + ", ".join(f"{s:.3f}" for s in self.chunk_s)
                + f" s; loss {float(self.chunks[0][1][0]):.3f} -> "
                f"{float(last):.3f}")

    def answers(self) -> dict:
        k = int(self.run.rng(6).integers(len(self.chunks)))
        u0, losses = self.chunks[k]
        n = self.traffic["follow_steps"]
        return {"points": self.sample(self.traffic["check_calls"], 3),
                "follow": (u0, losses[:n], self.traffic["step_size"])}


ENTRIES = {"value_and_grad": ValueAndGrad, "nuts": Nuts, "map": Map}
