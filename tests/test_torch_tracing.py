"""The program's recorder (``lqg_tpu_torch.utils.profiling.tracing``): off by
default and then without effect, the spans and counters of a NUTS transition
and of the Adam loops on the CPU, the Chrome trace, and (``-m cuda``, on the
card) the card's events on the host's clock.  No JAX here: the card runs
this file."""

import json
import time

import pytest
import torch

from lqg_tpu_torch.infer import capture, hmc, svi
from lqg_tpu_torch.utils import profiling

C, D, MAX_DEPTH = 3, 4, 6


class Quadratic:
    """A Gaussian potential with the three methods the optimizers call,
    and the value+grad calls counted."""

    def __init__(self, dtype=torch.float64, device="cpu"):
        g = torch.Generator().manual_seed(0)
        a = torch.randn((D, D), generator=g, dtype=dtype)
        self.prec = (a @ a.T + D * torch.eye(D, dtype=dtype)).to(device)
        self.mean = torch.randn(D, generator=g, dtype=dtype).to(device)
        self.vg = capture.eager_value_and_grad(self.potential)
        self.calls = 0

    def potential(self, u):
        r = u - self.mean
        return 0.5 * ((r @ self.prec) * r).sum(-1)

    def value_and_grad(self, u):
        self.calls += 1
        return self.vg(u)

    def init_unconstrained(self):
        return torch.zeros_like(self.mean)

    def constrain(self, u):
        return {"u": u}


def _transition(model, C=C, seed=3, step=None):
    g = torch.Generator().manual_seed(seed)
    draws = hmc.draw_nuts(g, C, D, MAX_DEPTH, torch.float64)
    z = torch.randn((C, D), generator=g, dtype=torch.float64)
    pe, grad = model.vg(z)
    if step is None:
        step = torch.full((C,), 0.05, dtype=torch.float64)
    inv_mass = torch.ones((C, D), dtype=torch.float64)
    return hmc.nuts_step(model.value_and_grad, draws, z, pe, grad, step,
                         inv_mass, max_depth=MAX_DEPTH)


def _optimize(model):
    return svi.optimize(model, steps=5, step_size=0.1)


def _elbo(model):
    return svi.fit_auto_mvn(model, 0, steps=3, num_particles=2)


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [v for k in sorted(out) for v in _flat(out[k])]
    return [t for x in out for t in _flat(x)]


@pytest.mark.parametrize("run", [_transition, _optimize, _elbo])
def test_off_by_default_it_records_nothing(monkeypatch, run):
    """Off, no span object, CUDA event or profiler range is made."""
    assert profiling._active is None
    assert profiling.span("x") is profiling._OFF

    def refuse(*a, **k):
        raise AssertionError("recorded while off")

    monkeypatch.setattr(profiling.Span, "__init__", refuse)
    monkeypatch.setattr(profiling.Recorder, "__init__", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    run(Quadratic())


@pytest.mark.parametrize("run", [_transition, _optimize, _elbo])
def test_outputs_are_the_same_bits_on_and_off(run):
    off = _flat(run(Quadratic()))
    with profiling.tracing() as rec:
        on = _flat(run(Quadratic()))
    assert rec.spans
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert torch.equal(a, b)


@pytest.mark.parametrize("chains, seed, step", [
    (C, 3, None),
    # a chain stops inside a half-tree that another chain still grows
    (4, 7, torch.linspace(0.03, 0.3, 4, dtype=torch.float64)),
])
def test_a_transition_nests_and_counts(monkeypatch, chains, seed, step):
    reads = []
    real = torch.Tensor.__bool__

    def counted(self):
        reads.append(1)
        return real(self)

    model = Quadratic()
    with profiling.tracing() as rec:
        monkeypatch.setattr(torch.Tensor, "__bool__", counted)
        z, pe, grad, info = _transition(model, chains, seed, step)
        monkeypatch.setattr(torch.Tensor, "__bool__", real)

    (t,) = rec.named("nuts.transition")
    assert t.parent == -1 and all(s.root == t.index for s in rec.spans)
    leaves, syncs = rec.named("nuts.leaf"), rec.named("nuts.sync")
    assert all(s.parent == t.index for s in leaves)
    assert {rec.spans[s.parent].name for s in syncs} == {
        "nuts.transition", "nuts.leaf"}
    for s in rec.spans[1:]:  # each inside its parent
        p = rec.spans[s.parent]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns

    depth = int(info.tree_depth.max())
    assert depth >= 3  # a leaf sync closes some half-tree early
    # one read a doubling, and one that ends them below the largest depth
    per_depth = [s for s in syncs if s.parent == t.index]
    assert len(per_depth) == depth + (depth < MAX_DEPTH)
    assert rec.counts["nuts.leaves"] == model.calls
    assert rec.counts["nuts.host_syncs"] == len(reads) == len(syncs)
    assert rec.counts["nuts.chain_leaves_useful"] == int(
        info.num_steps.sum())
    assert rec.counts["nuts.chain_leaves_useful"] < chains * model.calls
    assert "graph.replays" not in rec.counts  # eager on the CPU

    children = [s for s in rec.spans if s.parent == t.index]
    assert rec.self_ns(t) == t.duration_ns - sum(s.duration_ns
                                                 for s in children)
    assert rec.self_ns(t, ["nuts.sync"]) == t.duration_ns - sum(
        s.duration_ns for s in syncs)
    assert all(s.card_start_ns is None for s in rec.spans)


@pytest.mark.parametrize("run, steps, call", [
    (_optimize, 5, "svi.optimize"), (_elbo, 3, "svi.fit")])
def test_every_adam_step_is_a_span(run, steps, call):
    with profiling.tracing() as rec:
        run(Quadratic())
        run(Quadratic())
    calls, spans = rec.named(call), rec.named("svi.step")
    assert len(spans) == rec.counts["svi.steps"] == 2 * steps
    # the steps of one call share its id
    assert [s.root for s in spans] == [c.index for c in calls
                                       for _ in range(steps)]
    assert all(s.parent == s.root for s in spans)
    assert all(a.end_ns <= b.start_ns for a, b in zip(spans, spans[1:]))


def test_blocks_do_not_nest_and_end_off():
    with profiling.tracing():
        with pytest.raises(RuntimeError):
            with profiling.tracing():
                pass
    assert profiling._active is None
    with pytest.raises(ValueError):
        with profiling.tracing():
            raise ValueError
    assert profiling._active is None


def test_chrome_trace_has_a_host_and_a_card_track(tmp_path):
    with profiling.tracing() as rec:
        with profiling.span("outer"):
            with profiling.span("inner", device=True):
                profiling.count("n", 2)
    inner = rec.named("inner")[0]  # a card interval, as the card gives one
    inner.card_start_ns, inner.card_end_ns = inner.start_ns, inner.end_ns
    path = tmp_path / "trace.json"
    rec.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    names = {e["args"]["name"]: e["tid"] for e in trace["traceEvents"]
             if e["ph"] == "M"}
    assert names == {"host": 0, "card": 1}
    spans = [(e["name"], e["tid"]) for e in trace["traceEvents"]
             if e["ph"] == "X"]
    assert spans == [("outer", 0), ("inner", 0), ("inner", 1)]
    assert trace["otherData"]["counts"] == {"n": 2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_events_sit_on_the_host_clock(cuda):
    """A replay's start on the card is no earlier than the host start of
    the span that enqueued it (less the anchor's latency), and its end no
    later than the wait that follows it; no event is recorded inside a
    capture."""
    model = Quadratic(torch.float32, cuda)

    def potential(u):
        with profiling.span("inside.capture", device=True):
            return model.potential(u)

    u0 = torch.zeros((C, D), device=cuda)
    with profiling.tracing() as rec:
        graph = capture.GraphedValueAndGrad(potential, u0)
        used = rec._used
        waits = []
        for k in range(20):
            graph(u0 + 0.01 * k)
            torch.cuda.synchronize()
            waits.append(time.perf_counter_ns())
    # two eager warm-ups on a side stream, then the capture
    _, warm2, captured = rec.named("inside.capture")
    assert used == 4 and warm2.card_end_ns is not None
    assert captured.card_start_ns is None and captured.card_end_ns is None
    assert rec.counts["graph.captures"] == 1
    assert rec.counts["graph.replays"] == 20
    replays = rec.named("graph.replay")
    assert len(replays) == 20 and rec.events_dropped == 0
    for s, w in zip(replays, waits):
        assert s.card_start_ns >= s.start_ns - 10_000
        assert s.card_start_ns <= s.card_end_ns <= w + 10_000
    assert abs(rec.clock_scale - 1.0) < 1e-3
