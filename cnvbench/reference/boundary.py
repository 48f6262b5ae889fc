"""DNAcopy's sequential stopping boundary (Canvas GetBoundary.cs), the
reference's own copy in numpy and scipy.

The permutation walk stops a segment's test early: after np_i
permutations with k - 1 of them at or above the observed statistic, it
accepts once np_i >= sbdry[k - 1].  The boundary for j = 1 .. maxOnes
rejections is a triangle of the hypergeometric first-crossing indices at
an eta found by bisection so that the crossing probability is eta.
"""

from __future__ import annotations

import numpy as np
from scipy.special import gammaln


def _binomln(n, k):
    return gammaln(n + 1.0) - gammaln(k + 1.0) - gammaln(n - k + 1.0)


def _hyper_cdf_matrix(n_perm: int, n1s: int) -> np.ndarray:
    """cdf[k, i-1] = phyper(k; n1s, n_perm - n1s, i) for k < n1s and
    i = 1 .. n_perm."""
    dn = n_perm - n1s
    i = np.arange(1, n_perm + 1, dtype=np.float64)
    j = np.arange(0, n1s, dtype=np.float64)
    ij = i[None, :] - j[:, None]
    valid = (ij >= 0) & (ij <= dn)
    logpmf = (_binomln(float(n1s), j)[:, None]
              + _binomln(float(dn), np.where(valid, ij, 0.0))
              - _binomln(float(n_perm), i)[None, :])
    pmf = np.where(valid, np.exp(logpmf), 0.0)
    return np.minimum(np.cumsum(pmf, axis=0), 1.0)


def _eta_boundary(cdf: np.ndarray, n_perm: int, eta0: float,
                  n1s: int) -> np.ndarray:
    """The first n1s boundary values: the smallest i with
    phyper(k; n1s, n - n1s, i) <= eta0 for k = 0 .. n1s - 1, made strictly
    increasing in k (GetBoundary.EtaBoundary)."""
    hit = cdf <= eta0
    first = np.argmax(hit, axis=1) + 1
    first[~hit.any(axis=1)] = 0
    out = np.zeros(n1s, dtype=np.uint32)
    prev = 0
    for k in range(n1s):
        if first[k] == 0:
            break
        v = max(int(first[k]), prev + 1)
        if v > n_perm:
            break
        out[k] = v
        prev = v
    return out


def _scalar_binomln(n, k) -> float:
    if k < 0 or k > n:
        return -np.inf
    return float(gammaln(n + 1) - gammaln(k + 1) - gammaln(n - k + 1))


def _p_exceed(n_perm: int, n1s: int, bdry: np.ndarray) -> float:
    """The boundary's crossing probability (GetBoundary.PExceed)."""
    lb = _scalar_binomln
    dlcnk = lb(n_perm, n1s)
    n1 = n_perm - int(bdry[0])
    p = np.exp(lb(n1, n1s) - dlcnk)
    if n1s >= 2:
        n1 = int(bdry[0])
        nn = n_perm - int(bdry[1])
        p += np.exp(np.log(n1) + lb(nn, n1s - 1) - dlcnk)
    if n1s >= 3:
        n1, n2 = int(bdry[0]), int(bdry[1])
        nn = n_perm - int(bdry[2])
        kk = n1s - 2
        p += np.exp(np.log(n1) + np.log(n1 - 1.0) - np.log(2.0)
                    + lb(nn, kk) - dlcnk)
        p += np.exp(np.log(n1) + np.log(n2 - n1) + lb(nn, kk) - dlcnk)
    if n1s > 3:
        for i in range(4, n1s + 1):
            n1 = int(bdry[i - 4])
            n2 = int(bdry[i - 3])
            n3 = int(bdry[i - 2])
            nn = n_perm - int(bdry[i - 1])
            kk = n1s - i + 1
            p += np.exp(lb(n1, i - 1) + lb(nn, kk) - dlcnk)
            p += np.exp(lb(n1, i - 2) + np.log(n3 - n1) + lb(nn, kk) - dlcnk)
            p += np.exp(lb(n1, i - 3) + np.log(n2 - n1) + np.log(n3 - n2)
                        + lb(nn, kk) - dlcnk)
            p += np.exp(lb(n1, i - 3) + np.log(n2 - n1) - np.log(2.0)
                        + np.log(n2 - n1 - 1.0) + lb(nn, kk) - dlcnk)
    return float(p)


def compute_boundary(n_perm: int, alpha: float, eta: float = 0.05,
                     tol: float = 1e-2) -> np.ndarray:
    """The concatenated boundary triangles for j = 1 .. maxOnes
    (GetBoundary.ComputeBoundary)."""
    max_ones = int(np.floor(n_perm * alpha) + 1)
    sbdry = np.zeros(max_ones * (max_ones + 1) // 2, dtype=np.uint32)
    sbdry[0] = n_perm - int(n_perm * eta)
    eta0 = eta
    offset = 1
    for j in range(2, max_ones + 1):
        cdf = _hyper_cdf_matrix(n_perm, j)
        eta_hi = eta0 * 1.1
        b = _eta_boundary(cdf, n_perm, eta_hi, j)
        p_hi = _p_exceed(n_perm, j, b)
        eta_lo = eta0 * 0.25
        b = _eta_boundary(cdf, n_perm, eta_lo, j)
        p_lo = _p_exceed(n_perm, j, b)
        while (eta_hi - eta_lo) / eta_lo > tol:
            eta0 = eta_lo + (eta_hi - eta_lo) * (eta - p_lo) / (p_hi - p_lo)
            b = _eta_boundary(cdf, n_perm, eta0, j)
            p = _p_exceed(n_perm, j, b)
            if p > eta:
                eta_hi, p_hi = eta0, p
            else:
                eta_lo, p_lo = eta0, p
        sbdry[offset:offset + j] = b
        offset += j
    return sbdry
