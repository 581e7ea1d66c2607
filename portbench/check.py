"""The check that decides ``correct``: the program's answers from the window
against the plain reference, each number beside its limit.

Answers are of two kinds.  *Points*: inputs of the program's value+grad
calls with the potential and gradient the program returned there (for
NUTS also the positions the sampler kept, with their potential and
gradient).  *Follow* (MAP): a chunk's start point and the losses of its
first steps; the reference runs Adam from the same point and gives its
own losses.  The numbers:

* ``value_rel``: the largest gap of a potential (or a loss) to the
  reference's, over the reference's total log likelihood there;
* ``grad_gap``: the largest gap of a gradient entry to the reference's,
  over that entry of the reference or the median entry of its row,
  whichever is larger (some entries are all but zero);
* ``loss_rel``: as ``value_rel``, over the followed steps' losses;
* ``moved_share``: the share of the sampler's chain-transitions in the
  window that moved the chain (a transition that returns its state
  unchanged reads 0);
* ``leapfrog_gap``: over a sample of the window's NUTS transitions,
  replayed by the plain sampler of :mod:`portbench.reference.nuts`, the
  largest gap of a position the sampler evaluated to the plain leapfrog's,
  in float32 spacings at that position;
* ``choice_miss``: the chains of those transitions that the sampler did
  not move as the replay allows: to a state that is none of the possible
  choices, at another depth, or with another number of calls.

The control is the reference in TF32 put in the program's place: its
answers at the same points, its own Adam from the same start, and its
leapfrog from the same positions and momenta.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import lqg, nuts


def _block(run) -> int:
    """Chains a reference pass holds at once: its autograd graph keeps some
    30 matrices a step of the joint and the actor's size, per set."""
    cfg = run.cell.config
    j, n = cfg["sizes"]["j"], cfg["sizes"]["n"]
    per_chain = cfg["conditions"] * 30 * (j * j + n * n) * 8 * cfg["T"]
    return max(1, int(24e9 // per_chain))


def _stack(points):
    return (torch.cat([z.reshape(-1, z.shape[-1]) for z, _, _ in points]),
            torch.cat([pe.reshape(-1) for _, pe, _ in points]),
            torch.cat([g.reshape(-1, g.shape[-1]) for _, _, g in points]))


def evaluate(run, answers, ar) -> dict:
    """The reference's (or, in ``ar``, the control's) answers at the
    answers' inputs: one batched pass over the points, the initial point
    (whose log likelihood is the baseline, worked out again) and a followed
    chunk's start; then the chunk's further Adam steps."""
    rows, out = [], {}
    if answers.get("points"):
        rows.append(_stack(answers["points"])[0])
    rows.append(run.entry.u_init[None])
    if "follow" in answers:
        rows.append(answers["follow"][0])
    U = torch.cat(rows).to(ar.dtype)
    pe, g, ll = run.fit.evaluate(U, ar, block=_block(run))
    n = rows[0].shape[0] if answers.get("points") else 0
    base = ll[n]
    if n:
        out["points"] = (pe[:n] + base, g[:n], ll[:n])
    if "follow" in answers:
        u0, losses, lr = answers["follow"]
        first = (pe[n + 1:], g[n + 1:], ll[n + 1:])
        follow, lls = lqg.adam_follow(run.fit, u0, first, losses.shape[0],
                                      lr, ar)
        out["follow"] = (follow + base, lls)
    return out


def reference(run, answers) -> dict:
    """The reference's values at the answers' inputs, in float64."""
    return evaluate(run, answers, lqg.REFERENCE)


def replay(answers) -> tuple:
    """The sampled NUTS transitions replayed: the program's
    ``leapfrog_gap`` and ``choice_miss``, and the control's
    ``leapfrog_gap``."""
    t = answers["transitions"]
    gap, control_gap, miss = 0.0, 0.0, 0
    for st in t["steps"]:
        chains = st["start"][0].shape[0]
        try:
            reps, calls = nuts.transition(st["start"], st["draws"],
                                          t["step"], t["L"], st["leaves"],
                                          t["max_depth"])
        except nuts.TooFewCalls:
            gap, miss = math.inf, miss + chains
            continue
        miss += nuts.judge(reps, calls, st["calls"], st["start"],
                           st["after"], st["leaves"], st["depth"])
        gap = max([gap] + [r.gap for r in reps])
        control_gap = max([control_gap] + [r.control_gap for r in reps])
    return ({"leapfrog_gap": gap, "choice_miss": miss},
            {"leapfrog_gap": control_gap})


def control(run, answers) -> dict:
    """The answers the control gives in the program's place."""
    found = evaluate(run, answers, lqg.CONTROL)
    out = {}
    if "transitions" in answers:
        out["replayed"] = replay(answers)[1]
    if "points" in found:
        U = _stack(answers["points"])[0]
        out["points"] = [(U, found["points"][0], found["points"][1])]
    if "follow" in found:
        u0, _, lr = answers["follow"]
        out["follow"] = (u0, found["follow"][0], lr)
    return out


def _rel(tested, ref, scale):
    """The largest ``|tested - ref| / |scale|`` over the entries where the
    reference is finite; infinite where the tested answer is not."""
    tested, ref, scale = tested.double(), ref.double(), scale.double()
    ok = torch.isfinite(ref) & torch.isfinite(scale)
    gap = (tested - ref).abs() / scale.abs()
    gap = torch.where(torch.isfinite(tested), gap, math.inf)
    return float(torch.where(ok, gap, 0.0).max()) if ok.any() else math.inf


def numbers(answers: dict, ref: dict) -> dict:
    out = {}
    if "points" in ref:
        _, pe, g = _stack(answers["points"])
        pe_r, g_r, ll_r = ref["points"]
        out["value_rel"] = _rel(pe, pe_r, ll_r)
        med = g_r.abs().median(-1, keepdim=True).values
        out["grad_gap"] = _rel(g, g_r, torch.maximum(g_r.abs(), med))
    if "follow" in ref:
        losses_r, lls_r = ref["follow"]
        out["loss_rel"] = _rel(answers["follow"][1], losses_r, lls_r)
    if "moved_share" in answers:
        out["moved_share"] = answers["moved_share"]
    if "transitions" in answers:
        out.update(replay(answers)[0])
    out.update(answers.get("replayed", {}))
    return out


def judge(found: dict, limits: dict):
    """``(checks, correct)``: each limited number with its value and limit;
    correct where every one holds (``max``: at most, ``min``: at least)."""
    checks, correct = {}, True
    for name, lim in limits.items():
        v = found.get(name, math.nan)
        side, limit = next(iter(lim.items()))
        holds = math.isfinite(v) and (v <= limit if side == "max"
                                      else v >= limit)
        correct = correct and holds
        checks[name] = {"value": v, "limit": limit, "side": side}
    return checks, correct
