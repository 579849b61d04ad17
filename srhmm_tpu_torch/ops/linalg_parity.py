"""Reference-exact covariance linear algebra (float64, NumPy, host-side).

Counterpart of ``srhmm_tpu/ops/linalg_parity.py``, the same numpy code.
Replicates the reference's LDL^T machinery with identical operation order so
trained models match the committed fixtures to float64 reporting precision:

  decomposition      Sigma = T D T^T, unit lower-triangular T (T1:2058-2096)
  inv_triang_matrix  T^-1 for unit lower-triangular T (T1:2118-2142)
  inv_cov_matrix     Sigma^-1 = T^-T D^-1 T^-1 in place, returns det
                     (NaN det -> 0) (T1:2164-2202)
  calc_det           product of a diagonal (T1:2020-2032)

These run on the host: the M-step touches S*M matrices of size D^2 (tiny next
to the E-step), and the EM driver is host-side orchestration anyway.  The
fast path uses a batched torch Cholesky instead (train/em.py
_batched_inv_logdet).
"""

from __future__ import annotations

import numpy as np


def decomposition(cov: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Sigma = T D T^T.  Returns (d (D,), t (D, D) unit lower-triangular).

    Loop order matches T1:2058-2096 exactly.
    """
    D = cov.shape[0]
    d = np.zeros(D)
    t = np.eye(D)
    d[0] = cov[0, 0]
    for i in range(1, D):
        t[i, 0] = cov[i, 0] / d[0]
    for j in range(1, D - 1):
        d[j] = cov[j, j]
        for k in range(j):
            d[j] -= t[j, k] * t[j, k] * d[k]
        for i in range(j + 1, D):
            t[i, j] = cov[i, j]
            for k in range(j):
                t[i, j] -= t[i, k] * d[k] * t[j, k]
            t[i, j] /= d[j]
    if D > 1:
        j = D - 1
        d[j] = cov[j, j]
        for k in range(j):
            d[j] -= t[j, k] * t[j, k] * d[k]
    return d, t


def inv_triang_matrix(t: np.ndarray) -> np.ndarray:
    """Invert a unit lower-triangular matrix (T1:2118-2142 loop order)."""
    D = t.shape[0]
    im = np.eye(D)
    for k in range(D - 1):
        for i in range(k + 1, D):
            j = i - k - 1
            im[i, j] = 0.0
            for l in range(j, i):
                im[i, j] -= t[i, l] * im[l, j]
    return im


def calc_det(d: np.ndarray) -> float:
    det = 1.0
    for x in d:
        det *= x
    return det


def inv_cov_matrix(cov: np.ndarray) -> tuple[np.ndarray, float]:
    """Invert a covariance matrix via LDL^T; returns (inverse, det).

    Matches T1:2164-2202: det = prod(D); NaN det -> 0; det == 0 leaves the
    input matrix unchanged (returned as-is).
    """
    D = cov.shape[0]
    d, t = decomposition(cov)
    det = calc_det(d)
    if np.isnan(det):
        det = 0.0
    if det == 0.0:
        return cov.copy(), det
    im = inv_triang_matrix(t)
    out = np.empty_like(cov)
    for i in range(D):
        acc = 0.0
        for j in range(i, D):
            acc += im[j, i] * im[j, i] / d[j]
        out[i, i] = acc
    for i in range(D - 1):
        for j in range(i + 1, D):
            acc = 0.0
            for k in range(j, D):
                acc += im[k, i] * im[k, j] / d[k]
            out[i, j] = acc
            out[j, i] = acc
    return out, det
