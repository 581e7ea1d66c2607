"""Work counts of the hand-written kernels, from their shapes alone, and the
published peaks of one NVIDIA H100 SXM.

A frozen copy of ``chip_smoke.py``'s counts (``mm``, ``INV_OPS``,
``gains_work`` ... ``ll_blocked_bwd_work``, ``bound``): inputs read once,
outputs written once, every operation of the algorithm counted once.  The
benchmark owns this copy, so that a change to the program cannot move the
yardstick.  Two extensions: K5's stores (the carries K6 reads) are counted
where the gradient path writes them, and :func:`value_and_grad_work` counts
one value+grad of a configuration, the delay model's n=39 gains (which the
program runs as scans) by the K1/K2 formulas at their true shape, so that
the count is the same whatever implements the work.
"""

from __future__ import annotations

FP32_FLOPS_PER_S = 67e12  # H100 SXM, fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # H100 SXM


def mm(r, k, c):
    """Operations of an (r, k) @ (k, c) product."""
    return r * c * (2 * k - 1)


# closed-form symmetric inverse, eps included (3: cofactors; 4: Schur
# complement on 2 x 2 blocks)
INV_OPS = {1: 2, 2: 11, 3: 34, 4: 102}


def gains_work(B, n, m, p, steps, stores=False):
    """(bytes, operations) of K1 for B particles over ``steps`` steps:
    inputs read once, outputs written once; with ``stores``, the carries
    ``(S, P)`` K2 reads, written once."""
    riccati = (mm(n, n, m) + mm(n, n, n) + mm(m, n, m) + m * m + mm(m, n, n)
               + INV_OPS[m] + mm(m, m, n) + m * n + mm(m, m, n) + mm(n, n, n)
               + 3 * mm(n, m, n) + 3 * n * n
               + (2 * n * n if m > 1 else 0))  # sym(S) at m > 1
    kalman = (2 * mm(n, n, n) + n * n + mm(n, n, p) + mm(p, n, p) + p * p
              + INV_OPS[p] + mm(n, p, p) + mm(n, p, n) + n * n)
    inputs = B * (5 * n * n + n * m + m * m + p * n + p * p) * 4
    outputs = steps * B * (m * n + m * m + n * p) * 4
    if stores:
        outputs += 2 * steps * B * n * n * 4
    return inputs + outputs, steps * B * (riccati + kalman)


def gains_bwd_work(B, n, m, p, T):
    """(bytes, operations) of K2 for B particles over T steps: K1's inputs
    (A, B, R, F, VV, WW) and stores (S, P) and the cotangents of L, H, K
    read once, the nine cotangents written once."""
    riccati = (mm(n, n, m) + mm(n, n, n) + mm(m, n, m) + m * m + mm(m, n, n)
               + INV_OPS[m] + 2 * mm(m, m, n) + m * n
               + 4 * mm(m, n, n) + mm(m, m, n) + 4 * m * n
               + mm(n, n, m) + mm(m, n, m) + m * m + mm(m, m, n)
               + mm(n, m, m) + mm(m, n, m) + m * m + mm(m, n, n) + 2 * m * n
               + m * m + n * n + mm(n, m, m) + mm(n, n, n) + mm(n, m, n)
               + n * n + 2 * mm(n, n, n) + 2 * n * n + mm(n, n, m)
               + mm(n, m, m) + mm(n, n, m) + 3 * n * m + mm(n, m, n)
               + mm(n, n, n) + n * n
               + (2 * n * n if m > 1 else 0))  # sym(Sb) at m > 1
    kalman = (2 * n * n + 2 * mm(n, n, n) + n * n + mm(n, n, p)
              + mm(p, n, p) + p * p + INV_OPS[p] + mm(n, p, p)
              + 2 * mm(n, n, p) + mm(n, p, p) + 3 * n * p + mm(p, n, p)
              + mm(p, p, p) + 2 * p * p + mm(p, p, n) + 2 * p * n
              + mm(n, p, p) + n * p + mm(n, p, n) + mm(p, n, n)
              + 4 * n * n + 4 * mm(n, n, n) + n * n)
    spec = 2 * n * n + n * m + m * m + p * n + p * p
    inputs = B * spec + T * B * (2 * n * n + m * n + m * m + n * p)
    outputs = B * (5 * n * n + n * m + m * m + p * n + p * p)
    return (inputs + outputs) * 4, T * B * (riccati + kalman)


def ll_work(P, n, j, d, T, stores=False):
    """(bytes, operations) of K3 for P sets x n trials over T steps: F, Q
    and the data read once, ll written once (with ``stores``, also Sigma_t
    once per set and mu_t per trial); the covariance recursion counted once
    per set, the mean and the quadratic form per trial."""
    neumaier = 7
    cov = (INV_OPS[d] + 1 + neumaier + 2 * mm(j, j, j) + mm(j, d, d)
           + mm(j, d, j) + 4 * j * j)
    trial = (d + mm(d, d, 1) + (2 * d - 1) + neumaier + mm(j, j, 1)
             + mm(j, d, 1) + j)
    final = P * (INV_OPS[d] + 1) + P * n * (d + mm(d, d, 1) + 2 * d + 5)
    nbytes = 2 * P * T * j * j + P * n * (T + 1) * d + P * n
    if stores:
        nbytes += P * (T + 1) * (j * j + j * n)
    return nbytes * 4, T * (P * cov + P * n * trial) + final


def ll_bwd_work(P, n, j, d, T):
    """(bytes, operations) of K4 for P sets x n trials over T steps: F, the
    data, the cotangent and K3's per-set stores read once, F-bar and Q-bar
    (per set) and the data cotangent written once; the recomputed
    covariance pieces and the Sigma-bar chain counted once per set, the
    mean's cotangent and each trial's share of the four sums per trial."""
    sums = j * j + j * d + 2 * d * d + 1  # products, then as many adds
    cov = (INV_OPS[d] + mm(j, j, j) + mm(j, d, d)  # S^-1, FS, J
           + 2 * j * j + 3 * mm(j, j, j) + j * j + j * d  # Sbn, Sbn F, Sbn FS
           + mm(j, j, d) + mm(j, d, d) + 2 * j * d  # P-bar
           + mm(j, j, j) + j * j + mm(j, j, j)  # FS-bar Sigma, F^T FS-bar
           + mm(d, j, d) + 2 * d * d + 2 * mm(d, d, d) + 3 * d * d
           + 3 * d * d)
    trial = (d + mm(d, d, 1) + 1 + 2 * sums + mm(d, j, 1) + 2 * d
             + mm(j, j, 1) + d)
    seed = (P * (INV_OPS[d] + 2 * d * d)
            + P * n * (d + mm(d, d, 1) + 2 * d * d + 3 * d))
    nbytes = (P * T * j * j + P * n * (T + 1) * d + P * n
              + P * (T + 1) * (j * j + j * n)
              + 2 * P * T * j * j + P * n * (T + 1) * d)
    return nbytes * 4, T * (P * cov + P * n * trial) + seed


def _blocked_common(n, j, d):
    """Operations of what K5 and K6 share in a step: the score of n trials,
    Kc, the rank-d conditioning of Sig and MU, and F Sc."""
    score = INV_OPS[d] + 1 + n * (d + mm(d, d, 1) + 2 * d - 1 + 14)
    return (score + mm(j, d, d) + j * j * (2 * d + 1) + 2 * j * n * d
            + mm(j, j, j))


def ll_blocked_work(P, n, j, d, T, stores=False):
    """(bytes, operations) of K5 for P sets x n trials over T steps at the
    true j: F, Q and the data read once, ll written once; with ``stores``,
    the carries ``(Sig_t, MU_t)`` K6 reads, written once."""
    step = _blocked_common(n, j, d) + mm(j, j, j) + j * j + mm(j, j, n)
    final = INV_OPS[d] + 1 + n * (d + mm(d, d, 1) + 2 * d + 6)
    nbytes = 2 * P * T * j * j + P * n * (T + 1) * d + P * n
    if stores:
        nbytes += P * (T + 1) * (j * j + j * n)
    return nbytes * 4, P * (T * step + final)


def ll_blocked_bwd_work(P, n, j, d, T):
    """(bytes, operations) of K6: F, the data, the cotangent and K5's stores
    read once, F-bar, Q-bar and the data cotangent written once."""
    step = (_blocked_common(n, j, d) + mm(j, d, d) + j * j
            + mm(j, j, j) + j * j + mm(j, n, j) + j * j  # Fbar
            + 2 * mm(j, j, j) + mm(j, j, n)  # Scrb, MUc_bar
            + mm(j, j, d) + mm(j, n, d) + j * d  # Kcbar
            + mm(d, j, n) + 2 * d * n + mm(d, j, j)  # Ebar, row correction
            + mm(d, j, d) + d * d * 3 * n + 2 * mm(d, d, d) + 5 * d * d
            + j * d * 2 * d + 2 * d * j + d * n)
    seed = INV_OPS[d] + n * (d + mm(d, d, 1) + 2 * d) + d * d * (2 * n + 2)
    inputs = (P * T * j * j + P * n * (T + 1) * d + P * n
              + P * (T + 1) * (j * j + j * n))
    outputs = 2 * P * T * j * j + P * n * (T + 1) * d
    return (inputs + outputs) * 4, P * (T * step + seed)


def bound_ms(work):
    """The least time (ms) the card could take: the larger of the bytes at
    HBM bandwidth and the operations at the fp32 peak."""
    nbytes, ops = work
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S) * 1e3


def value_and_grad_work(sizes: dict, sets: int):
    """``{kernel: (bytes, operations)}`` of one value+grad of ``sets``
    parameter sets: the gains forward and adjoint at ``(n, m, p)`` and the
    likelihood forward (with the stores the adjoint reads) and adjoint at
    ``(j, d)``, over ``trials`` trials and ``T`` steps.  The likelihood is
    K3/K4 up to j = 12 and K5/K6 above, as the program dispatches."""
    n, m, p = sizes["n"], sizes["m"], sizes["p"]
    j, d, T, N = sizes["j"], sizes["d"], sizes["T"], sizes["trials"]
    out = {"K1": gains_work(sets, n, m, p, T, stores=True),
           "K2": gains_bwd_work(sets, n, m, p, T)}
    if j <= 12:
        out["K3"] = ll_work(sets, N, j, d, T, stores=True)
        out["K4"] = ll_bwd_work(sets, N, j, d, T)
    else:
        out["K5"] = ll_blocked_work(sets, N, j, d, T, stores=True)
        out["K6"] = ll_blocked_bwd_work(sets, N, j, d, T)
    return out
