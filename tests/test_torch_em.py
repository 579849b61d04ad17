"""The plain EM path and the trainers against the JAX package, in float64.

e_step, update_stream and m_step at rtol 1e-10 for diagonal, full and
two-stream models, including the degenerate-mixture donor repair, the
non-PD diagonal fallback and the --cmvn absolute floor; em_train_scan and
train_fast against JAX's fused=False path (the same log-prob history at
rtol 1e-10, the same iteration count, the same final model);
chunked_convergence_train on a scripted run_chunk (and its checkpoint saves); train_word_parity on
generated data (identical leaves and iterations).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srhmm_tpu.train.driver as j_driver
import srhmm_tpu.train.em as j_em
import srhmm_tpu.train.em_parity as j_parity
import srhmm_tpu_torch.train.driver as t_driver
import srhmm_tpu_torch.train.em as t_em
import srhmm_tpu_torch.train.em_parity as t_parity
from srhmm_tpu.io.dataset import pack_utterances as j_pack
from srhmm_tpu_torch.io.dataset import pack_utterances as t_pack
from torch_port_utils import assert_same_leaves, both_models, rand_word, sample_utterance

RTOL = 1e-10


def _batches(utts, lengths=None):
    """The same utterances as a JAX and a torch float64 batch; lengths
    overrides the rows' lengths (0 = a zero-length padding row)."""
    bj = j_pack(utts, pad_multiple=8, dtype=jnp.float64)
    bt = t_pack(utts, pad_multiple=8, dtype=torch.float64)
    if lengths is not None:
        bj = bj.replace(lengths=jnp.asarray(lengths, jnp.int32))
        bt = type(bt)(bt.features, torch.tensor(lengths, dtype=torch.int32))
    return bj, bt


def _sampled(trans, streams, n, seed, T=24):
    rng = np.random.default_rng(seed)
    per_utt = [sample_utterance(rng, trans, streams, T + 3 * i) for i in range(n)]
    return [[u[p] for u in per_utt] for p in range(len(streams))]


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-300))


def _assert_stats(got, want, rtol=RTOL):
    for name in ("num_trans", "den_trans", "den_mix", "log_prob", "num_valid"):
        _close(getattr(got, name), getattr(want, name), rtol)
    for gs, ws in zip(got.streams, want.streams):
        for name in ("w", "x", "xx"):
            _close(getattr(gs, name), getattr(ws, name), rtol)


def _assert_models(got, want, rtol=RTOL):
    _close(got.trans, want.trans, rtol)
    for gs, ws in zip(got.streams, want.streams):
        for name in ("weights", "means", "inv_cov", "log_det"):
            _close(getattr(gs, name), getattr(ws, name), rtol)


@pytest.mark.parametrize(
    "cov,mixes_dims,delta",
    [("diag", [(3, 4)], 1), ("full", [(2, 3)], 2), ("diag", [(2, 4), (2, 2)], 1)],
)
def test_e_step_matches_jax(cov, mixes_dims, delta):
    trans, streams = rand_word(20, 5, mixes_dims, cov, delta)
    jm, tm_ = both_models(trans, streams)
    per_stream = _sampled(trans, streams, 5, seed=21)
    lengths = [len(u) for u in per_stream[0]][:4] + [0]  # a zero-length row
    pairs = [_batches(utts, lengths) for utts in per_stream]
    bj = pairs[0][0] if len(pairs) == 1 else tuple(p[0] for p in pairs)
    bt = pairs[0][1] if len(pairs) == 1 else tuple(p[1] for p in pairs)
    want = j_em.e_step(jm, bj)
    got = t_em.e_step(tm_, bt)
    assert float(got.num_valid) == 4.0
    _assert_stats(got, want)


@functools.cache
def _stats_pair(cov, seed, S=4, mixes_dims=((3, 3),)):
    trans, streams = rand_word(seed, S, list(mixes_dims), cov)
    jm, tm_ = both_models(trans, streams)
    per_stream = _sampled(trans, streams, 6, seed=seed + 1)
    bj, bt = _batches(per_stream[0])
    return jm, tm_, j_em.e_step(jm, bj), t_em.e_step(tm_, bt)


def _with_stream_stats(st_j, st_t, w=None, x=None, xx=None):
    """Copies of both stats with the first stream's w / x / xx replaced."""
    s_j, s_t = st_j.streams[0], st_t.streams[0]
    new_j = s_j.replace(**{k: jnp.asarray(v) for k, v in (("w", w), ("x", x), ("xx", xx)) if v is not None})
    new_t = t_em.StreamStats(
        w=torch.from_numpy(w) if w is not None else s_t.w,
        x=torch.from_numpy(x) if x is not None else s_t.x,
        xx=torch.from_numpy(xx) if xx is not None else s_t.xx,
    )
    st_t = t_em.SuffStats(st_t.num_trans, st_t.den_trans, st_t.den_mix, (new_t,), st_t.log_prob, st_t.num_valid)
    return st_j.replace(streams=(new_j,)), st_t


@pytest.mark.parametrize(
    "cov,case",
    [(c, k) for c in ("diag", "full") for k in ("plain", "collapsed", "abs_floor")] + [("full", "non_pd")],
)
def test_m_step_matches_jax(cov, case):
    # non_pd: one mixture per state, so no donor can repair it
    mixes_dims = ((1, 3),) if case == "non_pd" else ((3, 3),)
    jm, tm_, st_j, st_t = _stats_pair(cov, seed=30 + (cov == "full"), mixes_dims=mixes_dims)
    kwargs_j, kwargs_t = {}, {}
    if case == "collapsed":
        # mixture 1 of state 2 keeps no occupancy: its variances floor to
        # 1e-5, its determinant collapses below 1e-20 and the state's
        # largest-determinant mixture donates (treat_zero_det)
        w = np.asarray(st_j.streams[0].w).copy()
        x = np.asarray(st_j.streams[0].x).copy()
        xx = np.asarray(st_j.streams[0].xx).copy()
        w[2, 1] = 1e-12
        x[2, 1] = np.asarray(jm.streams[0].means)[2, 1] * 1e-12
        xx[2, 1] = (x[2, 1, :, None] * x[2, 1, None, :] / 1e-12) if cov == "full" else x[2, 1] ** 2 / 1e-12
        st_j, st_t = _with_stream_stats(st_j, st_t, w=w, x=x, xx=xx)
    elif case == "non_pd":
        # a second moment below the mean's outer product: the recovered
        # covariance is indefinite, Cholesky fails, no mixture of the state
        # can donate, and the mixture falls back to its (floored) diagonal
        # covariance
        xx = np.asarray(st_j.streams[0].xx).copy()
        xx[1, 0] = -xx[1, 0]
        st_j, st_t = _with_stream_stats(st_j, st_t, xx=xx)
    elif case == "abs_floor":
        std = np.array([0.5, 3.0, 1e-3])
        floor = 1e-5 / std**2
        zd = float(np.log(1e-20) - 2.0 * np.log(std).sum())
        kwargs_j = {"abs_floors": (jnp.asarray(floor),), "zero_det_thresholds": (zd,)}
        kwargs_t = {"abs_floors": (torch.from_numpy(floor),), "zero_det_thresholds": (zd,)}
    want = j_em.m_step(jm, st_j, **kwargs_j)
    got = t_em.m_step(tm_, st_t, **kwargs_t)
    _assert_models(got, want)
    assert np.isfinite(got.streams[0].log_det.numpy()).all()
    if case == "non_pd":
        ic = got.streams[0].inv_cov.numpy()[1, 0]
        assert (ic == np.diag(np.diag(ic))).all()
    # update_stream alone, with a variance floor
    ws = j_em.update_stream(jm.streams[0], st_j.streams[0], st_j.den_mix, 0.05)
    ts = t_em.update_stream(tm_.streams[0], st_t.streams[0], st_t.den_mix, 0.05)
    for name in ("weights", "means", "inv_cov", "log_det", "det"):
        _close(getattr(ts, name), getattr(ws, name))


def test_repair_degenerate_tie_takes_first_donor():
    log_det = np.array([[-60.0, 2.0, 2.0], [1.0, 1.0, -70.0]])
    weights = np.array([[0.2, 0.3, 0.5], [0.6, 0.3, 0.1]])
    means = np.arange(18, dtype=np.float64).reshape(2, 3, 3)
    inv = np.arange(18, dtype=np.float64).reshape(2, 3, 3) + 1.0
    want = j_em._repair_degenerate(*(jnp.asarray(a) for a in (weights, means, inv, log_det)), "diag")
    got = t_em._repair_degenerate(*(torch.from_numpy(a) for a in (weights, means, inv, log_det)), "diag")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the first of the tied mixtures donated
    np.testing.assert_array_equal(got[1][0, 1].numpy(), means[0, 1] * 0.95)
    np.testing.assert_array_equal(got[1][1, 0].numpy(), means[1, 0] * 0.95)


def _scan_case(cov, seed):
    trans, streams = rand_word(seed, 4, [(2, 3)], cov)
    jm, tm_ = both_models(trans, streams)
    per_stream = _sampled(trans, streams, 6, seed=seed + 1, T=20)
    bj, bt = _batches(per_stream[0])
    return jm, tm_, bj, bt


@pytest.mark.parametrize("cov", ["diag", "full"])
def test_em_train_scan_matches_jax(cov):
    jm, tm_, bj, bt = _scan_case(cov, 40)
    fj, lps_j, nvs_j = j_em.em_train_scan(jm, bj, 4, fused=False)
    ft, lps_t, nvs_t = t_em.em_train_scan(tm_, bt, 4, fused=False)
    _close(lps_t, lps_j)
    _close(nvs_t, nvs_j)
    _assert_models(ft, fj)
    # one em_step is the first iteration of the scan
    m1, lp1, nv1 = t_em.em_step(tm_, bt)
    assert float(lp1) == float(lps_t[0]) and float(nv1) == 6.0
    assert t_em.em_train_scan(tm_, bt, 0, fused=False)[1].shape == (0,)


@pytest.mark.parametrize("cov", ["diag", "full"])
def test_train_fast_matches_jax(cov):
    jm, tm_, bj, bt = _scan_case(cov, 50)
    rj = j_em.train_fast(jm, bj, threshold=1e-4, max_iterations=12, chunk=3)
    rt = t_em.train_fast(tm_, bt, threshold=1e-4, max_iterations=12, chunk=3)
    assert rt.iterations == rj.iterations
    assert rt.exemplar_count == rj.exemplar_count
    np.testing.assert_allclose(rt.log_prob_history, rj.log_prob_history, rtol=RTOL)
    np.testing.assert_allclose(rt.mean_log_prob, rj.mean_log_prob, rtol=RTOL)
    _assert_models(rt.model, rj.model)


class _Script:
    """A deterministic stand-in for em_train_scan: the state is the number
    of updates so far, and lps[j] is a scripted log prob of state + j."""

    def __init__(self, history, as_tensor):
        self.history, self.as_tensor, self.calls = history, as_tensor, []

    def __call__(self, state, k):
        self.calls.append((state, k))
        lps = np.asarray(self.history[state : state + k], np.float64)
        nvs = np.full(k, 7.0)
        if self.as_tensor:
            lps, nvs = torch.from_numpy(lps), torch.from_numpy(nvs)
        return state + k, lps, nvs


@pytest.mark.parametrize(
    "history,threshold,max_it,chunk",
    [
        ([-100.0, -50.0, -40.0, -39.99, -39.98, -39.97, -39.96], 1e-3, 7, 2),  # mid-chunk convergence
        ([-100.0, -50.0, -40.0, -39.99, -39.98, -39.97, -39.96], 1e-3, 7, 3),  # first entry of a chunk
        ([-90.0, -80.0, -70.0, -60.0, -50.0], 1e-6, 5, 2),  # the budget runs out
        ([1.0, 2.0, 3.0], 0.5, 3, 8),  # converges on the first fetched value (old = 1.0)
    ],
)
def test_chunked_driver_matches_jax(history, threshold, max_it, chunk):
    want = j_driver.chunked_convergence_train(0, _Script(history, False), threshold, max_it, chunk,
                                              log_prob_offset=0.5)
    script = _Script(history, True)
    got = t_driver.chunked_convergence_train(0, script, threshold, max_it, chunk, log_prob_offset=0.5)
    assert got == want
    # checkpoint=: both drivers save the same states with the same bookkeeping
    saves = []
    for driver, run in ((j_driver, _Script(history, False)), (t_driver, _Script(history, True))):
        rec = _SaveRecorder()
        out = driver.chunked_convergence_train(0, run, threshold, max_it, chunk, log_prob_offset=0.5,
                                               checkpoint=rec)
        saves.append((out, rec.saves))
    assert saves[1] == saves[0] and saves[1][0] == want and saves[1][1]


class _SaveRecorder:
    """A checkpoint manager with nothing to resume that records the saves."""

    def __init__(self):
        self.saves = []

    def latest(self, template):
        return None

    def save(self, state, ck):
        self.saves.append((state, ck.iteration, ck.old_log_prob, list(ck.history)))


@pytest.mark.parametrize("cov,mixes_dims", [("full", [(1, 3)]), ("diag", [(2, 3), (1, 2)])])
def test_train_word_parity_matches_jax(cov, mixes_dims):
    trans, streams = rand_word(60, 4, mixes_dims, cov)
    per_stream = _sampled(trans, streams, 4, seed=61, T=20)
    init_j, init_t = both_models(trans, streams, "w")
    rj = j_parity.train_word_parity(per_stream, init_j, max_iterations=6)
    rt = t_parity.train_word_parity(per_stream, init_t, max_iterations=6)
    assert rt.iterations == rj.iterations and rt.exemplar_count == rj.exemplar_count
    assert rt.log_prob_history == rj.log_prob_history and rt.mean_log_prob == rj.mean_log_prob
    assert rt.model.word == "w"
    assert_same_leaves(rj.model, rt.model)
