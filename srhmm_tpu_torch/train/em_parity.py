"""Reference-exact Baum-Welch EM (float64, probability domain).

Counterpart of ``srhmm_tpu/train/em_parity.py``: the same numpy code, with
this package's GmmHmm going in and coming out (float64, CPU).

This is the bit-comparable training path: it mirrors the reference EM driver
(T1:223-346) operation-for-operation — scaled forward/backward, banded xi
accumulation, GMM sufficient statistics about the *pre-update* means
(T1:1745), the same floors and repair passes, and the same convergence
semantics (|old-new|/|old| vs 1e-3 with old_probab initialized to 1.0, the
final pass NOT applying an update).

The fast path (train/em.py) reformulates all of this in log space over
padded batches with psum-able sufficient statistics; this module is the
oracle it is validated against, and the path the parity tests run.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..init.lbg import _c_sort_desc
from ..models.gmm_hmm import (
    DIAG,
    FINITE_PROBAB,
    FULL,
    GAUS_INF_CLAMP,
    BETA_INF_CLAMP,
    ZERO_DET_THRESHOLD,
    GmmHmm,
    GmmStream,
)
from ..ops.linalg_parity import inv_cov_matrix

THRESHOLD = 1.0e-3  # THRESHOULD (T1:36)


# ---------------------------------------------------------------------------
# probability-domain building blocks (numpy mirrors of ops/*.py parity paths,
# kept in numpy so the EM driver is one coherent f64 host computation)
# ---------------------------------------------------------------------------


def _gauss(frames: np.ndarray, stream_np: dict) -> np.ndarray:
    mu, k, det = stream_np["means"], stream_np["inv_cov"], stream_np["det"]
    D = frames.shape[-1]
    norm = (2.0 * np.pi) ** (D / 2.0)
    dif = frames[:, None, None, :] - mu
    if stream_np["cov_type"] == FULL:
        quad = np.einsum("tsmd,smde,tsme->tsm", dif, k, dif)
    else:
        quad = np.einsum("tsmd,smd->tsm", dif * dif, k)
    with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
        gaus = np.exp(-0.5 * quad) / (norm * np.sqrt(np.abs(det)))
    if stream_np["cov_type"] == FULL:
        gaus[np.isinf(gaus)] = GAUS_INF_CLAMP  # T1:1880-1883
    return np.where(det != 0.0, gaus, 0.0)


def _symbol_probab(frames: np.ndarray, stream_np: dict):
    """(b (T,S), posteriors (T,S,M)) — calc_symbol_probab (T1:1775-1813)."""
    g = _gauss(frames, stream_np) * stream_np["weights"]
    b = g.sum(-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        post = np.where(b[..., None] != 0.0, g / b[..., None], 0.0)
    return b, post


def _scaled_forward(b: np.ndarray, trans: np.ndarray):
    T, S = b.shape
    alpha = np.zeros((T, S))
    scaling = np.zeros(T)
    alpha[0, 0] = b[0, 0]  # pi = [1, 0, ...]
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        scaling[0] = 1.0 / alpha[0].sum()
        alpha[0] *= scaling[0]
        for t in range(1, T):
            alpha[t] = (alpha[t - 1] @ trans) * b[t]
            scaling[t] = 1.0 / alpha[t].sum()
            alpha[t] *= scaling[t]
    return alpha, scaling


def _scaled_backward(b: np.ndarray, trans: np.ndarray, scaling: np.ndarray):
    T, S = b.shape
    beta = np.zeros((T, S))
    beta[T - 1, S - 1] = 1.0 * scaling[T - 1]
    with np.errstate(over="ignore", invalid="ignore"):
        for t in range(T - 2, -1, -1):
            beta[t] = (trans @ (beta[t + 1] * b[t + 1])) * scaling[t]
            beta[t][np.isinf(beta[t])] = BETA_INF_CLAMP  # T1:1540
    return beta


def _host(t) -> np.ndarray:
    """Writable float64 numpy copy of a tensor."""
    return np.array(t.detach().cpu().numpy(), dtype=np.float64)


def _stream_to_np(s: GmmStream) -> dict:
    return {
        "weights": _host(s.weights),
        "means": _host(s.means),
        "inv_cov": _host(s.inv_cov),
        "det": _host(s.det),
        "cov_type": s.cov_type,
    }


def _treat_zero_det(weights, means, dets, invs):
    """treat_zero_det (T1:2226-2265), one state; arrays shaped (M, ...).

    NOTE the C splits from the largest-DET mixture (vector = det), copying its
    *inverse* covariance & det, halving its weight.
    """
    M = len(dets)
    order = _c_sort_desc(dets.copy())
    donor = 0
    for j in range(M):
        if dets[j] < ZERO_DET_THRESHOLD:
            src = order[donor]
            donor += 1
            means[j] = means[src] * 1.05
            means[src] = means[src] * 0.95
            invs[j] = invs[src].copy()
            dets[j] = dets[src]
            weights[src] /= 2.0
            weights[j] = weights[src]
    s = weights.sum()
    weights /= s  # always renormalizes, even when nothing was repaired


@dataclass
class TrainResult:
    model: GmmHmm
    iterations: int
    mean_log_prob: float
    exemplar_count: int
    log_prob_history: list = field(default_factory=list)


def train_word_parity(
    utterances_per_stream: list[list[np.ndarray]],
    initial_model: GmmHmm,
    threshold: float = THRESHOLD,
    delta: int = 1,
    max_iterations: int = 1000,
) -> TrainResult:
    """The reference EM do-while loop (T1:223-346), float64.

    utterances_per_stream[p][u] is utterance u's frames for stream p; all
    streams of an utterance must have equal frame counts (the reference
    silently requires this — obs_time comes from the last stream, T1:274).
    """
    model = initial_model
    P = model.num_streams
    S = model.num_states
    n_utts = len(utterances_per_stream[0])
    trans = _host(model.trans)
    streams = [_stream_to_np(s) for s in model.streams]
    mix = [st["weights"].shape[1] for st in streams]
    coef = [st["means"].shape[2] for st in streams]

    old_probab = 1.0
    iteration = 0
    history = []
    while True:
        iteration += 1
        probab = 0.0
        num_trans = np.zeros((S, S))
        den_trans = np.zeros(S)
        den_mix = np.zeros(S)
        w_num = [np.zeros((S, m)) for m in mix]
        mean_num = [np.zeros((S, m, d)) for m, d in zip(mix, coef)]
        cov_num = [
            np.zeros((S, m, d, d)) if streams[p]["cov_type"] == FULL else np.zeros((S, m, d))
            for p, (m, d) in enumerate(zip(mix, coef))
        ]

        band = np.zeros((S, S), dtype=bool)
        for i in range(S):
            band[i, i : min(i + delta + 1, S)] = True

        for u in range(n_utts):
            bs, posts = [], []
            for p in range(P):
                b_p, post_p = _symbol_probab(utterances_per_stream[p][u], streams[p])
                bs.append(b_p)
                posts.append(post_p)
            b = bs[0].copy()
            for p in range(1, P):
                b *= bs[p]
            T = b.shape[0]

            alpha, scaling = _scaled_forward(b, trans)
            beta = _scaled_backward(b, trans, scaling)

            # xi accumulation, banded (calc_transition_probab T1:1609-1647)
            with np.errstate(invalid="ignore", over="ignore"):
                xi = np.einsum(
                    "ti,ij,tj,tj->ij", alpha[:-1], trans, b[1:], beta[1:]
                )
                num_trans += np.where(band, xi, 0.0)
                ab_over_c = alpha * beta / scaling[:, None]
                den_trans += ab_over_c[:-1].sum(0)
                den_mix += ab_over_c.sum(0)

                # GMM stats (calc_mix_param T1:1714-1753); residuals about the
                # CURRENT (pre-update) means
                for p in range(P):
                    x = utterances_per_stream[p][u]
                    gamma = ab_over_c[:, :, None] * posts[p]  # (T, S, M)
                    w_num[p] += gamma.sum(0)
                    mean_num[p] += np.einsum("tsm,td->smd", gamma, x)
                    difp = x[:, None, None, :] - streams[p]["means"]  # (T,S,M,D)
                    if streams[p]["cov_type"] == FULL:
                        cov_num[p] += np.einsum("tsm,tsmd,tsme->smde", gamma, difp, difp)
                    else:
                        cov_num[p] += np.einsum("tsm,tsmd->smd", gamma, difp * difp)

                probab += -np.sum(np.log(scaling)) + np.log(alpha[T - 1, S - 1])

        history.append(probab)
        variation = abs((old_probab - probab) / old_probab)
        if variation <= threshold or iteration >= max_iterations:
            break

        old_probab = probab
        # M-step (updating_transition_probab T1:1907-1929,
        #         updating_mix_param T1:1951-2000, re-inversion T1:320-341).
        # Documented divergence: for a state with zero occupancy the C leaves
        # its parameters untouched in updating_mix_param but then re-inverts
        # the stored INVERSE in the main loop (T1:322-341), silently turning
        # it back into a covariance.  We keep untouched states truly
        # untouched; zero-occupancy states cannot occur for left-right models
        # with T >= S (the fixture regime).
        with np.errstate(invalid="ignore", divide="ignore"):
            for i in range(S):
                if den_trans[i] != 0.0:
                    trans[i] = num_trans[i] / den_trans[i]
            for p in range(P):
                st = streams[p]
                cov_pending = np.zeros_like(cov_num[p])
                for i in range(S):
                    if den_mix[i] == 0.0:
                        continue
                    st["weights"][i] = w_num[p][i] / den_mix[i]
                    st["means"][i] = mean_num[p][i] / w_num[p][i][:, None]
                    if st["cov_type"] == FULL:
                        newcov = cov_num[p][i] / w_num[p][i][:, None, None]
                        for m in range(mix[p]):
                            dg = np.diag(newcov[m]).copy()
                            dg[dg < FINITE_PROBAB] = FINITE_PROBAB
                            np.fill_diagonal(newcov[m], dg)
                    else:
                        newcov = np.maximum(
                            cov_num[p][i] / w_num[p][i][:, None], FINITE_PROBAB
                        )
                    cov_pending[i] = newcov
                # changing_zero_coef on every state (T1:1988-1990)
                w = st["weights"]
                w[w < FINITE_PROBAB] = FINITE_PROBAB
                st["weights"] = w / w.sum(-1, keepdims=True)
                # re-inversion (main loop T1:320-341)
                for i in range(S):
                    if den_mix[i] == 0.0:
                        continue
                    for m in range(mix[p]):
                        if st["cov_type"] == DIAG:
                            st["det"][i, m] = np.prod(cov_pending[i, m])
                            st["inv_cov"][i, m] = 1.0 / cov_pending[i, m]
                        elif coef[p] > 1:
                            inv, det = inv_cov_matrix(cov_pending[i, m].copy())
                            st["inv_cov"][i, m] = inv
                            st["det"][i, m] = det
                        else:
                            st["det"][i, m] = cov_pending[i, m][0, 0]
                            st["inv_cov"][i, m] = 1.0 / cov_pending[i, m][0, 0]
                if st["cov_type"] == FULL and coef[p] > 1:
                    for i in range(S):
                        _treat_zero_det(
                            st["weights"][i],
                            st["means"][i],
                            st["det"][i],
                            st["inv_cov"][i],
                        )

    out_streams = [
        GmmStream(
            weights=st["weights"],
            means=st["means"],
            inv_cov=st["inv_cov"],
            det=st["det"],
            cov_type=st["cov_type"],
        )
        for st in streams
    ]
    final = GmmHmm(trans=trans, streams=out_streams, word=model.word)
    return TrainResult(
        model=final,
        iterations=iteration,
        mean_log_prob=probab / n_utts,
        exemplar_count=n_utts,
        log_prob_history=history,
    )
