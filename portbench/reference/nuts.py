"""A plain No-U-Turn transition, one chain at a time in float64, that
replays the sampler's transitions in the window to judge them.

The algorithm is the published one (Hoffman & Gelman 2014, JMLR 15; with
multinomial sampling of the trajectory, biased progressive sampling between
its halves, and the generalized U-turn criterion of Betancourt 2017,
arXiv:1701.02434, as Stan and NumPyro build it leaf by leaf): the
trajectory doubles, each new half-tree extends one end by ``2**depth``
leapfrog steps, a half-tree stops at a U-turn of any of its balanced
subtrees or at an energy error over ``max_delta_energy``, and the whole
trajectory stops at its own U-turn.

A replay takes the draws the benchmark handed the sampler (the momentum's
standard normals, each doubling's direction, the half-trees' and the
leaves' uniforms), the step size and the inverse mass ``M^-1 = L L^T``. At
each leaf it takes the value and gradient of the potential that the
sampler's own call returned there: the reference cannot evaluate some 60
potentials a transition within a run, and those answers are held to the
reference's potential by the value check at a sample of the window's calls.
The rest is the replay's own: each leaf's position from the leapfrog (held
against the position the sampler evaluated), the momenta, the energies,
where each half-tree stops, the depth, and the states the transition may
move to.  A choice whose uniform lies within ``tol`` of its probability may
go either way under float32 energies, so both outcomes stay possible there.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List

import numpy as np

START = -1  # the transition's start state, among the possible choices


class TooFewCalls(Exception):
    """The sampler made fewer value+grad calls than the replay needs."""


def tf32(x) -> np.ndarray:
    """``x`` in float32, rounded to TF32's 10 mantissa bits, to nearest."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.int32)
    return ((bits + 0x1000) & np.int32(-0x2000)).view(np.float32)


def leapfrog_position(z, r, g, step, L, control: bool = False):
    """The position after one leapfrog step from ``(z, r)`` with gradient
    ``g`` there, and the half-step momentum: ``r' = r - step/2 g``, ``z +
    step L L^T r'``.  ``control``: in float32 with every product's inputs
    rounded to TF32, the precision below the configuration's."""
    if not control:
        r_half = r - 0.5 * step * g
        return z + step * (L @ (L.T @ r_half)), r_half
    r_half = np.float32(r) - tf32(0.5 * step) * tf32(g)
    Lt = tf32(L)
    v = Lt @ tf32(Lt.T @ tf32(r_half))
    return np.float32(z) + tf32(step) * tf32(v), r_half


def _uturn(L, r_left, r_right, rho) -> bool:
    v_left, v_right = L @ (L.T @ r_left), L @ (L.T @ r_right)
    return bool(v_left @ rho <= 0.0) or bool(v_right @ rho <= 0.0)


def _kinetic(L, r) -> float:
    w = L.T @ r
    return 0.5 * float(w @ w)


@dataclass
class _End:
    k: int            # the call that evaluated it, or START
    z: np.ndarray
    r: np.ndarray
    g: np.ndarray


@dataclass
class _Half:
    right: _End
    count: int = 0    # leaves the sampler had to evaluate for this chain
    log_weight: float = -math.inf
    rho: np.ndarray = None
    turning: bool = False
    diverging: bool = False
    choices: set = field(default_factory=set)


@dataclass
class Replay:
    """One chain's replayed transition."""

    gap: float = 0.0          # largest leapfrog position gap
    control_gap: float = 0.0  # the same, of the control's leapfrog
    depth: int = 0
    choices: set = field(default_factory=lambda: {START})


def _gap(z_tested, z_plain, z_from) -> float:
    """The largest gap of a position entry, in float32 spacings at the
    largest of the step's start, its displacement and its end: a float32
    leapfrog rounds each of them about once, to half a spacing or less, and
    the rounding of its momentum moves it far less."""
    big = np.maximum.reduce([np.abs(z_from), np.abs(z_plain - z_from),
                             np.abs(z_plain)])
    spacing = np.spacing(np.float32(big))
    return float(np.max(np.abs(np.float64(z_tested) - z_plain) / spacing))


def _half(c, edge: _End, step, L, d, base, leaves, leaf_u, energy0,
          max_delta, tol, out: Replay) -> _Half:
    """Extend the trajectory of chain ``c`` by up to ``2**d`` leaves from
    ``edge``, taking call ``base + i``'s answer at leaf ``i``."""
    zs, pes, gs = leaves
    h = _Half(right=edge, rho=np.zeros_like(edge.r), choices={edge.k})
    r_ck, rho_ck = {}, {}
    z, r, g = edge.z, edge.r, edge.g
    for i in range(1 << d):
        k = base + i
        if k >= zs.shape[0]:
            raise TooFewCalls(k)
        z_k, pe_k, g_k = zs[k, c], float(pes[k, c]), np.float64(gs[k, c])
        z_plain, r_half = leapfrog_position(z, r, g, step, L)
        out.gap = max(out.gap, _gap(z_k, z_plain, z))
        z_ctl, _ = leapfrog_position(z, r, g, step, L, control=True)
        out.control_gap = max(out.control_gap, _gap(z_ctl, z_plain, z))
        r = r_half - 0.5 * step * g_k
        delta = pe_k + _kinetic(L, r) - energy0
        delta = math.inf if math.isnan(delta) else delta
        h.log_weight = float(np.logaddexp(h.log_weight, -delta))
        p = math.exp(-delta - h.log_weight) if h.log_weight > -math.inf \
            else math.nan
        u = float(leaf_u[c, d, i])
        if p >= 1.0 or u < p - tol:
            h.choices = {k}
        elif u < p + tol:
            h.choices.add(k)
        rho_before = h.rho
        h.rho = h.rho + r
        if i % 2 == 0:
            n = bin(i).count("1")
            r_ck[n], rho_ck[n] = r, rho_before
        else:
            top = bin(i >> 1).count("1")
            ones = len(bin(i)) - len(bin(i).rstrip("1"))
            for n in range(top - ones + 1, top + 1):
                h.turning = h.turning or _uturn(L, r_ck[n], r,
                                                h.rho - rho_ck[n])
        h.diverging = h.diverging or delta > max_delta
        z, g = np.float64(z_k), g_k
        h.right = _End(k, z, r, g)
        h.count = i + 1
        if h.turning or h.diverging:
            break
    return h


def transition(start, draws, step: float, L, leaves, max_depth: int,
               max_delta: float = 1000.0, tol: float = 1e-3):
    """Replay one transition of every chain.

    Args:
        start: ``(z (C, D), pe (C,), grad (C, D))`` where it starts.
        draws: ``(eps (C, D), forward (C, max_depth), accept (C,
            max_depth), leaf (C, max_depth, 2**(max_depth-1)))``.
        step: ``(C,)``, each chain's step size; ``L``: ``(D, D)``, the
            lower Cholesky factor of M^-1.
        leaves: ``(z (K, C, D), pe (K, C), grad (K, C, D))``, the answers
            of the transition's ``K`` value+grad calls, in call order.

    Returns ``(replays, calls)``: one :class:`Replay` a chain and the
    number of value+grad calls the transition makes.
    """
    z0, pe0, g0 = (np.float64(a) for a in start)
    eps, forward, accept, leaf_u = draws
    C = z0.shape[0]
    L = np.float64(L)
    outs = [Replay() for _ in range(C)]
    ends, rhos, log_w, energy0, stopped = [], [], [], [], []
    for c in range(C):
        r0 = np.linalg.solve(L.T, np.float64(eps[c]))
        end = _End(START, z0[c], r0, g0[c])
        ends.append([end, end])  # left, right
        rhos.append(r0)
        log_w.append(0.0)
        energy0.append(float(pe0[c]) + _kinetic(L, r0))
        stopped.append(False)
    base = 0
    for d in range(max_depth):
        live = [c for c in range(C) if not stopped[c]]
        if not live:
            break
        halves = {}
        for c in live:
            fwd = bool(forward[c, d])
            edge = ends[c][1] if fwd else ends[c][0]
            h = step[c] if fwd else -step[c]
            halves[c] = _half(c, edge, h, L, d, base, leaves, leaf_u,
                              energy0[c], max_delta, tol, outs[c])
        base += max(h.count for h in halves.values())
        for c in live:
            h, fwd, out = halves[c], bool(forward[c, d]), outs[c]
            ok = not (h.turning or h.diverging)
            turned = False
            if ok:
                a = math.exp(min(h.log_weight - log_w[c], 0.0))
                u = float(accept[c, d])
                if a >= 1.0 or u < a - tol:
                    out.choices = set(h.choices)
                elif u < a + tol:
                    out.choices |= h.choices
                ends[c][1 if fwd else 0] = h.right
                rhos[c] = rhos[c] + h.rho
                log_w[c] = float(np.logaddexp(log_w[c], h.log_weight))
                turned = _uturn(L, ends[c][0].r, ends[c][1].r, rhos[c])
            stopped[c] = h.turning or h.diverging or turned
            out.depth += 1
    return outs, base


def judge(replays: List[Replay], calls: int, n_calls: int, start, after,
          leaves, depth) -> int:
    """Chains whose transition the sampler did not make as the replay
    allows: a next state ``after`` (``(z, pe, grad)``) that is none of the
    possible choices, another depth, or another number of calls (every
    chain then counts)."""
    if calls != n_calls:
        return len(replays)
    zs, pes, gs = leaves
    miss = 0
    for c, rep in enumerate(replays):
        state = tuple(np.asarray(a[c]) for a in after)

        def same(k):
            src = (tuple(np.asarray(a[c]) for a in start) if k == START
                   else (zs[k, c], pes[k, c], gs[k, c]))
            return all(np.array_equal(x, y) for x, y in zip(state, src))

        if int(depth[c]) != rep.depth or not any(same(k)
                                                 for k in rep.choices):
            miss += 1
    return miss
