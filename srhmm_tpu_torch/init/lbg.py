"""Cold-start model initialization: segmentation means + LBG split k-means.

Counterpart of ``srhmm_tpu/init/lbg.py``: the same numpy code; only the
returned containers are this package's GmmStream / GmmHmm (float64, CPU).

Replicates `creating_initial_model` (T1:731-952):
  1. per-state global mean over uniform time segments of all utterances
     (`init_mix_mean` first pass, T1:1016-1059)
  2. LBG: split means (x1.05/x0.95 when doubling fits, else split the
     highest-distortion cells by +/-0.5%, T1:1158-1201), then 5 k-means
     iterations per level with empty-cell repair (`new_mix_mean`,
     T1:1282-1311); cells sorted by distortion with the reference's stable
     bubble sort
  3. cluster-residual covariance init, diagonal floored at FINITE_PROBAB,
     symmetrized, inverted; weights = cluster counts / state duration,
     floored + renormalized (`changing_zero_coef`, T1:1377-1393)

Documented divergence: T1:1113 `distortion[k][index] += classifying(...,&index)`
reads and writes `index` in one unsequenced C expression; we use the index of
the frame being classified (the only defensible semantics).  For the fixture
configuration (1 mixture) the LBG loop never runs, so this has no effect on
parity tests.
"""

from __future__ import annotations

import numpy as np

from ..models.gmm_hmm import DIAG, FINITE_PROBAB, FULL, GmmHmm, GmmStream, init_left_right_trans
from ..ops.linalg_parity import inv_cov_matrix
from .segmentation import segment_bounds


def _c_sort_desc(values: np.ndarray) -> np.ndarray:
    """The reference's stable bubble sort, descending (`sorting`, T1:1331-1356)."""
    idx = list(range(len(values)))
    done = False
    while not done:
        done = True
        for i in range(len(values) - 1):
            if values[idx[i]] < values[idx[i + 1]]:
                idx[i], idx[i + 1] = idx[i + 1], idx[i]
                done = False
    return np.asarray(idx)


def _classify(frames: np.ndarray, means: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Nearest-centroid (squared Euclidean) assignment (T1:1222-1261).
    Returns (index (T,), min_distance (T,)).  Ties resolve to the lowest
    index, matching the strict `<` comparison in C."""
    d2 = ((frames[:, None, :] - means[None, :, :]) ** 2).sum(-1)  # (T, K)
    idx = np.argmin(d2, axis=1)
    return idx, d2[np.arange(len(frames)), idx]


def init_mix_mean(
    utterances: list[np.ndarray], states_number: int, mixture_number: int
) -> np.ndarray:
    """LBG mixture means, (S, M, D)."""
    D = utterances[0].shape[1]
    S, M = states_number, mixture_number
    mean = np.zeros((S, M, D))
    count = np.zeros(S)
    for frames in utterances:
        bounds = segment_bounds(len(frames), S)
        for k in range(S):
            seg = frames[bounds[k] : bounds[k + 1]]
            mean[k, 0] += seg.sum(0)
            count[k] += len(seg)
    mean[:, 0] /= count[:, None]

    m = 1
    # at the first split the C reads an uninitialized distortion array
    # (harmless there: sorting a single cell); zeros give the same result
    distortion = np.zeros((S, M))
    while m < M:
        # split (T1:1158-1201)
        if 2 * m < M:
            for k in range(S):
                mean[k, m : 2 * m] = mean[k, :m] * 1.05
                mean[k, :m] *= 0.95
            new_m = 2 * m
        else:
            dif = M - m
            for k in range(S):
                order = _c_sort_desc(distortion[k, :m])
                for j in range(dif):
                    src = order[j]
                    mean[k, m + j] = mean[k, src] * 1.005
                    mean[k, src] *= 0.995
            new_m = M
        m = new_m

        for _ in range(5):  # k-means iterations per level (T1:1073-1130)
            sums = np.zeros((S, m, D))
            counts = np.zeros((S, m), dtype=np.int64)
            distortion = np.zeros((S, M))
            for frames in utterances:
                bounds = segment_bounds(len(frames), S)
                for k in range(S):
                    seg = frames[bounds[k] : bounds[k + 1]]
                    if len(seg) == 0:
                        continue
                    idx, dist = _classify(seg, mean[k, :m])
                    np.add.at(distortion[k], idx, dist)
                    np.add.at(counts[k], idx, 1)
                    np.add.at(sums[k], idx, seg)
            # new means + empty-cell repair (T1:1282-1311)
            for k in range(S):
                with np.errstate(invalid="ignore", divide="ignore"):
                    mean[k, :m] = sums[k] / counts[k][:, None]
                order = _c_sort_desc(distortion[k, :m])
                donor = 0
                for j in range(m):
                    if counts[k, j] == 0:
                        src = order[donor]
                        donor += 1
                        mean[k, j] = mean[k, src] * 1.005
                        mean[k, src] *= 0.995
    return mean


def init_stream(
    utterances: list[np.ndarray],
    states_number: int,
    mixture_number: int,
    cov_type: str = FULL,
) -> GmmStream:
    """Initial GMM parameters for one stream (`init_mix_param`, T1:810-952)."""
    S, M = states_number, mixture_number
    D = utterances[0].shape[1]
    mean = init_mix_mean(utterances, S, M)

    cov = np.zeros((S, M, D, D))
    counts = np.zeros((S, M))
    state_duration = np.zeros(S)
    for frames in utterances:
        bounds = segment_bounds(len(frames), S)
        for k in range(S):
            seg = frames[bounds[k] : bounds[k + 1]]
            if len(seg) == 0:
                continue
            idx, _ = _classify(seg, mean[k])
            dif = seg - mean[k, idx]  # residual about assigned cluster mean
            for j in range(M):
                sel = dif[idx == j]
                if len(sel):
                    cov[k, j] += np.einsum("ti,tj->ij", sel, sel)
                counts[k, j] += (idx == j).sum()
            state_duration[k] += len(seg)

    inv = np.zeros_like(cov) if cov_type == FULL else np.zeros((S, M, D))
    det = np.zeros((S, M))
    for k in range(S):
        for j in range(M):
            with np.errstate(invalid="ignore", divide="ignore"):
                c = cov[k, j] / counts[k, j]
            dg = np.diag(c).copy()
            dg[dg < FINITE_PROBAB] = FINITE_PROBAB
            np.fill_diagonal(c, dg)
            if cov_type == DIAG:
                det[k, j] = np.prod(dg)
                inv[k, j] = 1.0 / dg
            elif D > 1:
                inv[k, j], det[k, j] = inv_cov_matrix(c)
            else:
                det[k, j] = c[0, 0]
                inv[k, j] = np.array([[1.0 / c[0, 0]]])

    with np.errstate(invalid="ignore", divide="ignore"):
        weights = counts / state_duration[:, None]
    # changing_zero_coef: floor then renormalize (T1:1377-1393)
    weights = np.maximum(weights, FINITE_PROBAB)
    weights /= weights.sum(-1, keepdims=True)

    return GmmStream(weights=weights, means=mean, inv_cov=inv, det=det, cov_type=cov_type)


def create_initial_model(
    utterances_per_stream: list[list[np.ndarray]],
    states_number: int,
    mixture_numbers: list[int],
    word: str = "",
    cov_type: str = FULL,
    delta: int = 1,
) -> GmmHmm:
    """`creating_initial_model` (T1:731-752): banded-uniform transitions plus
    per-stream LBG GMM init."""
    streams = [
        init_stream(utts, states_number, m, cov_type)
        for utts, m in zip(utterances_per_stream, mixture_numbers)
    ]
    return GmmHmm(
        trans=init_left_right_trans(states_number, delta),
        streams=streams,
        word=word,
    )
