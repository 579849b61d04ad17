"""The training slice's building blocks against the JAX package.

Same numpy inputs through srhmm_tpu and srhmm_tpu_torch: the numpy ports
(linalg_parity, segmentation, LBG create_initial_model) must agree exactly;
log_mixture_posteriors, log_forward_full, log_backward_full,
scaled_backward_parity, denormalize_* and global_cmvn_stats in float64 at
rtol 1e-10 (the same arithmetic, summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srhmm_tpu.features.frontend as j_front
import srhmm_tpu.init.lbg as j_lbg
import srhmm_tpu.init.segmentation as j_seg
import srhmm_tpu.models.gmm_hmm as j_models
import srhmm_tpu.ops.emission as j_em
import srhmm_tpu.ops.forward_backward as j_fb
import srhmm_tpu.ops.linalg_parity as j_lin
import srhmm_tpu_torch.features.frontend as t_front
import srhmm_tpu_torch.init.lbg as t_lbg
import srhmm_tpu_torch.init.segmentation as t_seg
import srhmm_tpu_torch.models.gmm_hmm as t_models
import srhmm_tpu_torch.ops.emission as t_em
import srhmm_tpu_torch.ops.forward_backward as t_fb
import srhmm_tpu_torch.ops.linalg_parity as t_lin
from torch_port_utils import assert_same_leaves, both_models, rand_word

RTOL = 1e-10


def _spd(rng, D):
    a = rng.normal(size=(D, D))
    return a @ a.T + D * np.eye(D)


def test_linalg_parity_is_the_same_computation():
    rng = np.random.default_rng(0)
    for D in (1, 2, 5, 9):
        cov = _spd(rng, D)
        for name in ("decomposition", "inv_cov_matrix"):
            got, want = getattr(t_lin, name)(cov.copy()), getattr(j_lin, name)(cov.copy())
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        d, t = t_lin.decomposition(cov)
        np.testing.assert_array_equal(t_lin.inv_triang_matrix(t), j_lin.inv_triang_matrix(t))
        assert t_lin.calc_det(d) == j_lin.calc_det(d)
    singular = np.zeros((3, 3))
    np.testing.assert_array_equal(t_lin.inv_cov_matrix(singular)[0], j_lin.inv_cov_matrix(singular)[0])


@pytest.mark.parametrize("T,S", [(10, 3), (7, 6), (103, 6), (5, 8)])
def test_segmentation_matches_jax(T, S):
    np.testing.assert_array_equal(t_seg.segment_bounds(T, S), j_seg.segment_bounds(T, S))
    np.testing.assert_array_equal(t_seg.segment_ids(T, S), j_seg.segment_ids(T, S))


def _utterances(seed, n, D, t_lo=18, t_hi=40):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(int(rng.integers(t_lo, t_hi)), D)) * 3 + np.arange(D) for _ in range(n)]


@pytest.mark.parametrize(
    "cov,mixes,dims",
    [("full", [1], [9]), ("diag", [3], [5]), ("full", [4], [3]), ("diag", [2, 3], [4, 2])],
)
def test_create_initial_model_matches_jax_exactly(cov, mixes, dims):
    per_stream = [_utterances(10 + p, 7, D) for p, D in enumerate(dims)]
    S = 4
    want = j_lbg.create_initial_model(per_stream, S, mixes, word="w", cov_type=cov)
    got = t_lbg.create_initial_model(per_stream, S, mixes, word="w", cov_type=cov)
    assert got.word == "w" and [s.cov_type for s in got.streams] == [cov] * len(dims)
    assert_same_leaves(want, got)


def test_init_mix_mean_lbg_split_matches_jax():
    utts = _utterances(3, 5, 3)
    np.testing.assert_array_equal(t_lbg.init_mix_mean(utts, 3, 5), j_lbg.init_mix_mean(utts, 3, 5))


@pytest.mark.parametrize("cov", ["diag", "full"])
def test_log_mixture_posteriors_matches_jax(cov):
    jm, tm_ = both_models(*rand_word(5, 5, [(3, 4)], cov))
    rng = np.random.default_rng(1)
    frames = rng.normal(size=(2, 11, 4)) * 2
    lb_t, post_t = t_em.log_mixture_posteriors(torch.from_numpy(frames), tm_.streams[0])
    for i in range(2):
        lb_j, post_j = j_em.log_mixture_posteriors(jnp.asarray(frames[i]), jm.streams[0])
        np.testing.assert_allclose(lb_t[i].numpy(), np.asarray(lb_j), rtol=RTOL)
        np.testing.assert_allclose(post_t[i].numpy(), np.asarray(post_j), rtol=RTOL, atol=1e-300)
    # a state whose mixtures all have det == 0 has zero total likelihood
    trans, streams = rand_word(6, 3, [(2, 4)], cov)
    streams[0]["det"][1] = 0.0
    jm, tm_ = both_models(trans, streams)
    lb_t, post_t = t_em.log_mixture_posteriors(torch.from_numpy(frames[0]), tm_.streams[0])
    lb_j, post_j = j_em.log_mixture_posteriors(jnp.asarray(frames[0]), jm.streams[0])
    assert np.isneginf(lb_t[:, 1].numpy()).all() and (post_t[:, 1].numpy() == 0).all()
    np.testing.assert_allclose(post_t.numpy(), np.asarray(post_j), rtol=RTOL)


@pytest.mark.parametrize("delta", [1, 2])
def test_log_forward_backward_full_match_jax(delta):
    rng = np.random.default_rng(2)
    S, T = 5, 13
    trans = t_models.init_left_right_trans(S, delta).numpy()
    with np.errstate(divide="ignore"):
        log_trans = np.log(trans)
    log_b = rng.normal(size=(4, T, S)) * 3 - 10
    lengths = np.array([13, 7, 1, 0])
    la_t = t_fb.log_forward_full(torch.from_numpy(log_b), torch.from_numpy(log_trans), torch.from_numpy(lengths))
    lbw_t = t_fb.log_backward_full(torch.from_numpy(log_b), torch.from_numpy(log_trans), torch.from_numpy(lengths))
    for i in range(4):
        la_j = j_fb.log_forward_full(jnp.asarray(log_b[i]), jnp.asarray(log_trans), jnp.asarray(lengths[i]))
        lbw_j = j_fb.log_backward_full(jnp.asarray(log_b[i]), jnp.asarray(log_trans), jnp.asarray(lengths[i]))
        np.testing.assert_allclose(la_t[i].numpy(), np.asarray(la_j), rtol=RTOL)
        np.testing.assert_allclose(lbw_t[i].numpy(), np.asarray(lbw_j), rtol=RTOL)
    # no lengths, and the all-zero initial condition
    la_j = j_fb.log_forward_full(jnp.asarray(log_b[0]), jnp.asarray(log_trans))
    np.testing.assert_allclose(
        t_fb.log_forward_full(torch.from_numpy(log_b[0]), torch.from_numpy(log_trans)).numpy(),
        np.asarray(la_j), rtol=RTOL,
    )
    lbw_j = j_fb.log_backward_full(jnp.asarray(log_b[0]), jnp.asarray(log_trans), final_state_only=False)
    lbw_t = t_fb.log_backward_full(torch.from_numpy(log_b[0]), torch.from_numpy(log_trans), final_state_only=False)
    np.testing.assert_allclose(lbw_t.numpy(), np.asarray(lbw_j), rtol=RTOL)


def test_scaled_backward_parity_matches_jax():
    rng = np.random.default_rng(3)
    trans = t_models.init_left_right_trans(4, 1).numpy()
    b = rng.uniform(1e-3, 1.0, size=(9, 4))
    b[3, 2] = 1e-300  # drive the scaled values toward the 1e200 clamp
    alpha_j, scaling_j = j_fb.scaled_forward_parity(jnp.asarray(b), jnp.asarray(trans))
    beta_j = j_fb.scaled_backward_parity(jnp.asarray(b), jnp.asarray(trans), scaling_j)
    _, scaling_t = t_fb.scaled_forward_parity(torch.from_numpy(b), torch.from_numpy(trans))
    beta_t = t_fb.scaled_backward_parity(torch.from_numpy(b), torch.from_numpy(trans), scaling_t)
    np.testing.assert_allclose(scaling_t.numpy(), np.asarray(scaling_j), rtol=RTOL)
    np.testing.assert_allclose(beta_t.numpy(), np.asarray(beta_j), rtol=RTOL)


@pytest.mark.parametrize("cov", ["diag", "full"])
def test_denormalize_and_validate_match_jax(cov):
    jm, tm_ = both_models(*rand_word(8, 4, [(2, 3)], cov))
    mean, std = np.array([1.5, -2.0, 30.0]), np.array([0.5, 2.0, 40.0])
    want = j_models.denormalize_model(jm, (mean, std))
    got = t_models.denormalize_model(tm_, (mean, std))
    for a, b in zip(
        [want.streams[0].means, want.streams[0].inv_cov, want.streams[0].log_det, want.streams[0].det],
        [got.streams[0].means, got.streams[0].inv_cov, got.streams[0].log_det, got.streams[0].det],
    ):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL)
    # float32 models keep float32 leaves, as in JAX
    got32 = t_models.denormalize_stream(tm_.astype(torch.float32).streams[0], mean, std)
    want32 = j_models.denormalize_stream(jm.astype(jnp.float32).streams[0], mean, std)
    assert got32.means.dtype == torch.float32
    np.testing.assert_allclose(got32.log_det.numpy(), np.asarray(want32.log_det), rtol=1e-6)
    assert t_models.validate_model(tm_) == j_models.validate_model(jm) == []
    trans, streams = rand_word(8, 4, [(2, 3)], cov)
    trans[1, 1] = 0.9
    streams[0]["weights"][2] = [0.3, 0.3]
    jm, tm_ = both_models(trans, streams)
    assert t_models.validate_model(tm_) == j_models.validate_model(jm)
    assert len(t_models.validate_model(tm_)) == 2


def test_global_cmvn_stats_matches_jax():
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(5, 12, 3)) * np.array([1.0, 30.0, 0.01]) + 100.0
    lengths = np.array([12, 4, 0, 9, 1])
    for args in ((feats, lengths), (feats,), (feats[0],)):
        want = j_front.global_cmvn_stats(*(jnp.asarray(a) for a in args))
        got = t_front.global_cmvn_stats(*(torch.from_numpy(a) for a in args))
        for g, w in zip(got, want):
            assert g.dtype == np.float64
            np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL)
