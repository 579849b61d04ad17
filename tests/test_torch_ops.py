"""srhmm_tpu_torch.ops against srhmm_tpu.ops on the same numpy inputs:
emissions, the log forward recursion and Viterbi (rtol 1e-10 in float64,
1e-5 in float32), and the float64 parity path (rtol 1e-10)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srhmm_tpu.ops as jops
import srhmm_tpu_torch.ops as tops
from torch_port_utils import both_models, rand_word

RTOL = {"float64": 1e-10, "float32": 1e-5}


def _pair(cov, S=5, mixes_dims=((3, 4),), seed=0):
    jmod, tmod = both_models(*rand_word(seed, S, list(mixes_dims), cov))
    return jmod, tmod


def _frames(rng, T, D, scale=2.0):
    return rng.normal(size=(T, D)) * scale


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("cov", ["diag", "full"])
def test_log_gauss_and_state_emission_match_jax(cov, dtype):
    jmod, tmod = _pair(cov, mixes_dims=((3, 4), (2, 3)))
    if dtype == "float32":
        jmod, tmod = jmod.astype(jnp.float32), tmod.astype(torch.float32)
    rng = np.random.default_rng(1)
    fr = [_frames(rng, 12, 4).astype(dtype), _frames(rng, 12, 3).astype(dtype)]
    for p in range(2):
        want = np.asarray(jops.log_gauss(jnp.asarray(fr[p]), jmod.streams[p]))
        got = tops.log_gauss(torch.from_numpy(fr[p]), tmod.streams[p]).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=RTOL[dtype], atol=0)
    want = np.asarray(jops.log_state_emission(tuple(map(jnp.asarray, fr)), jmod.streams))
    got = tops.log_state_emission(tuple(map(torch.from_numpy, fr)), tmod.streams).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype], atol=0)


def test_log_gauss_degenerate_and_clamped_mixtures():
    trans, streams = rand_word(0, 2, [(2, 3)], "full")
    streams[0]["det"][0, 1] = 0.0  # degenerate -> -inf
    streams[0]["inv_cov"][1, 0] = -np.eye(3) * 50.0  # indefinite -> clamp
    jmod, tmod = both_models(trans, streams)
    fr = _frames(np.random.default_rng(2), 6, 3)
    want = np.asarray(jops.log_gauss(jnp.asarray(fr), jmod.streams[0]))
    got = tops.log_gauss(torch.from_numpy(fr), tmod.streams[0]).numpy()
    assert np.isneginf(got[:, 0, 1]).all() and np.allclose(got[:, 1, 0], np.log(1e20))
    np.testing.assert_allclose(got, want, rtol=1e-10)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_log_forward_matches_jax(dtype):
    jmod, tmod = _pair("diag", S=6, mixes_dims=((2, 3),))
    rng = np.random.default_rng(3)
    log_b = rng.normal(size=(20, 6)).astype(dtype) * 3
    lt_j, lt_t = jmod.log_trans().astype(dtype), tmod.log_trans().to(getattr(torch, dtype))
    for length in (None, 20, 13, 1):
        want = np.asarray(jops.log_forward(jnp.asarray(log_b), lt_j, length))
        got = tops.log_forward(torch.from_numpy(log_b), lt_t, length).numpy()
        fin = np.isfinite(want)
        assert (np.isfinite(got) == fin).all()
        np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL[dtype], atol=0)
        np.testing.assert_allclose(
            tops.score_total(torch.from_numpy(got)).numpy(),
            np.asarray(jops.score_total(jnp.asarray(want))), rtol=RTOL[dtype],
        )


def test_viterbi_matches_jax():
    jmod, tmod = _pair("diag", S=5, mixes_dims=((2, 3),))
    rng = np.random.default_rng(4)
    for length, fso in ((None, True), (30, False), (17, True)):
        log_b = rng.normal(size=(30, 5)) * 2
        sj, pj = jops.viterbi(jnp.asarray(log_b), jmod.log_trans(), length, fso)
        st, pt = tops.viterbi(torch.from_numpy(log_b), tmod.log_trans(), length, fso)
        np.testing.assert_allclose(float(st), float(sj), rtol=1e-10)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    lbb = rng.normal(size=(3, 12, 5))
    lens = np.array([12, 7, 1], np.int32)
    sj, pj = jops.viterbi_batch(jnp.asarray(lbb), jmod.log_trans(), jnp.asarray(lens))
    st, pt = tops.viterbi_batch(torch.from_numpy(lbb), tmod.log_trans(), torch.from_numpy(lens))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-10)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


@pytest.mark.parametrize("cov", ["diag", "full"])
def test_parity_path_matches_jax(cov):
    trans, streams = rand_word(5, 4, [(2, 3), (1, 2)], cov)
    streams[0]["det"][1, 1] = 0.0  # det == 0 -> zero likelihood
    jmod, tmod = both_models(trans, streams)
    rng = np.random.default_rng(6)
    fr = [_frames(rng, 15, 3, 1.0), _frames(rng, 15, 2, 1.0)]
    gj = np.asarray(jops.prob_gauss_parity(jnp.asarray(fr[0]), jmod.streams[0]))
    gt = tops.prob_gauss_parity(torch.from_numpy(fr[0]), tmod.streams[0]).numpy()
    assert (gt[:, 1, 1] == 0).all()
    np.testing.assert_allclose(gt, gj, rtol=1e-10)
    bj, postj = jops.prob_state_emission_parity(jnp.asarray(fr[0]), jmod.streams[0])
    bt, postt = tops.prob_state_emission_parity(torch.from_numpy(fr[0]), tmod.streams[0])
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-10)
    np.testing.assert_allclose(postt.numpy(), np.asarray(postj), rtol=1e-10)
    bj = jops.prob_emission_parity([jnp.asarray(f) for f in fr], jmod.streams)
    bt = tops.prob_emission_parity([torch.from_numpy(f) for f in fr], tmod.streams)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-10)
    aj, cj = jops.scaled_forward_parity(bj, jmod.trans)
    at, ct = tops.scaled_forward_parity(bt, tmod.trans)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-10)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-10)
    np.testing.assert_allclose(
        tops.parity_score_total(ct).numpy(), np.asarray(jops.parity_score_total(cj)), rtol=1e-10
    )
    np.testing.assert_allclose(
        tops.parity_score_final_state(ct, at).numpy(),
        np.asarray(jops.parity_score_final_state(cj, aj)), rtol=1e-10,
    )
