"""Embedded training, part 2: srhmm_tpu_torch/train/embedded.py against
srhmm_tpu/train/embedded.py on the same numpy inputs (CPU).

Tolerances: the plain E-step in float64 to 1e-9 relative (the same
operations, other summation orders); float32 paths to 5e-4 relative, the
JAX package's own fused-vs-XLA bound (tests/test_embedded.py:158); EM
steps and trajectories as the JAX package holds its fused path to its XLA
path (tests/test_embedded.py:224-232, 251-258).  The port's fused path runs
its kernels' plain twins here (CPU tensors, fused=True forced).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srhmm_tpu.models as jm
import srhmm_tpu.train.embedded as je
import srhmm_tpu_torch.models as tmods
import srhmm_tpu_torch.train.embedded as te
from torch_port_utils import both_models, rand_word, sample_utterance

P, S, M, D = 4, 3, 2, 5


def _units(cov="diag", mixes_dims=((M, D),), delta=1, seed=0):
    words = [rand_word(seed + i, S, list(mixes_dims), cov, delta, scale=3.0) for i in range(P)]
    pairs = [both_models(*w, f"u{i}") for i, w in enumerate(words)]
    return words, jm.stack_models([p[0] for p in pairs]), tmods.stack_models([p[1] for p in pairs])


def _batch(seed, B=4, T=32, L=3, dim=D):
    rng = np.random.default_rng(seed)
    trs = rng.integers(0, P, size=(B, L)).astype(np.int32)
    trs[0, 1] = trs[0, 0]  # a transcript that repeats a unit
    feats = rng.normal(size=(B, T, dim)) * 2.0
    lens = np.asarray([T, T - 13, max(L * S, 3), 1][:B], np.int32)
    return trs, feats, lens


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, float(np.abs(want).max())))


def _stats_close(got, ref, rtol):
    """Every statistic within rtol; log_prob within 1e-5 for float32
    (tests/test_embedded.py:129-130)."""
    for name in ("num_trans", "den_trans", "den_mix"):
        _close(getattr(got, name), getattr(ref, name), rtol)
    np.testing.assert_allclose(float(got.log_prob), float(ref.log_prob), rtol=min(rtol, 1e-5))
    assert float(got.num_valid) == float(ref.num_valid)
    for gs, rs in zip(got.streams, ref.streams):
        for f in ("w", "x", "xx"):
            _close(getattr(gs, f), getattr(rs, f), rtol)


@pytest.mark.parametrize("cov,mixes_dims,delta", [
    ("diag", ((M, D),), 1),
    ("full", ((M, 4),), 1),
    ("diag", ((2, 4), (3, 4)), 2),
])
def test_batch_stats_matches_jax_float64(cov, mixes_dims, delta):
    _, jmod, tmod = _units(cov, mixes_dims, delta)
    trs, feats, lens = _batch(1, dim=mixes_dims[0][1])
    ref = je.batch_stats(jmod, jnp.asarray(trs), jnp.asarray(feats), jnp.asarray(lens))
    got = te.batch_stats(tmod, torch.as_tensor(trs), torch.as_tensor(feats), torch.as_tensor(lens))
    _stats_close(got, ref, 1e-9)


def test_batch_stats_matches_jax_float32():
    _, jmod, tmod = _units()
    trs, feats, lens = _batch(2)
    f32 = feats.astype(np.float32)
    ref = je.batch_stats(jmod.astype(jnp.float32), jnp.asarray(trs), jnp.asarray(f32), jnp.asarray(lens))
    got = te.batch_stats(tmod.astype(torch.float32), torch.as_tensor(trs), torch.as_tensor(f32),
                         torch.as_tensor(lens))
    _stats_close(got, ref, 5e-4)


def test_utterance_stats_single_unit_is_the_isolated_e_step():
    """A 1-unit transcript reduces embedded statistics to the isolated E-step."""
    from srhmm_tpu_torch.io.dataset import UtteranceBatch
    from srhmm_tpu_torch.train.em import e_step

    _, _, tmod = _units()
    feats = torch.as_tensor(np.random.default_rng(3).normal(size=(40, D)))
    emb = te.utterance_stats(tmod, [1], feats, 40)
    unit1 = tmods.GmmHmm(trans=tmod.trans[1], streams=[_unit_stream(tmod, 1)])
    iso = e_step(unit1, UtteranceBatch(feats[None], torch.as_tensor([40])))
    np.testing.assert_allclose(float(emb.log_prob), float(iso.log_prob), rtol=1e-10)
    np.testing.assert_allclose(emb.num_trans[1].numpy(), iso.num_trans.numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(emb.streams[0].w[1].numpy(), iso.streams[0].w.numpy(), rtol=1e-9)
    assert float(emb.streams[0].w[0].sum()) == 0.0 and float(emb.streams[0].w[2:].sum()) == 0.0


def _unit_stream(tmod, u):
    st = tmod.streams[0]
    return tmods.GmmStream(weights=st.weights[u], means=st.means[u], inv_cov=st.inv_cov[u], det=st.det[u],
                           cov_type=st.cov_type, log_det=st.log_det[u])


@pytest.fixture(scope="module")
def fused_reference():
    """The JAX package's fused composed E-step (Pallas interpret mode; it
    pads B to 128 and T to 128) once, diagonal and full covariance."""
    out = {}
    for cov, dim in (("diag", D), ("full", 4)):
        _, jmod, tmod = _units(cov, ((M, dim),))
        trs, feats, lens = _batch(4, dim=dim)
        f32 = feats.astype(np.float32)
        jmod32 = jmod.astype(jnp.float32)
        ref = je.batch_stats_fused(jmod32, jnp.asarray(trs), jnp.asarray(f32), jnp.asarray(lens), k_block=8)
        out[cov] = (tmod.astype(torch.float32), trs, f32, lens, ref)
    return out


@pytest.mark.parametrize("gamma_lattice", [True, False])
@pytest.mark.parametrize("cov", ["diag", "full"])
def test_batch_stats_fused_matches_jax_fused(fused_reference, cov, gamma_lattice):
    tmod, trs, f32, lens, ref = fused_reference[cov]
    got = te.batch_stats_fused(tmod, torch.as_tensor(trs), torch.as_tensor(f32), torch.as_tensor(lens),
                               gamma_lattice=gamma_lattice)
    _stats_close(got, ref, 5e-4)


def test_embedded_em_step_matches_jax():
    """Two EM iterations: the port's fused (twins) and plain steps against
    the JAX package's XLA step (test_embedded.py:224-232 bounds)."""
    _, jmod, tmod = _units(seed=7)
    trs, feats, lens = _batch(7, B=3, T=24)
    f32 = feats.astype(np.float32)
    mj = jmod.astype(jnp.float32)
    for _ in range(2):
        mj, lpj, _ = je.embedded_em_step(mj, jnp.asarray(trs), jnp.asarray(f32), jnp.asarray(lens), fused=False)
    for fused in (True, False):
        mt = tmod.astype(torch.float32)
        for _ in range(2):
            mt, lpt, nvt = te.embedded_em_step(mt, torch.as_tensor(trs), torch.as_tensor(f32),
                                               torch.as_tensor(lens), fused=fused)
        np.testing.assert_allclose(float(lpt), float(lpj), rtol=1e-5)
        np.testing.assert_allclose(mt.trans.numpy(), np.asarray(mj.trans), rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(mt.streams[0].means.numpy(), np.asarray(mj.streams[0].means),
                                   rtol=1e-3, atol=1e-3)
        assert int(nvt) == 3


def _training_set(words, seed=5, n=6):
    rng = np.random.default_rng(seed)
    transcripts = [[0, 1, 2], [2, 3, 0], [1, 0, 3], [3, 2, 1], [0, 2, 1, 3], [1, 3, 0, 2]][:n]
    utts = []
    for tr in transcripts:
        utts.append(np.concatenate([sample_utterance(rng, *words[u], 3 * S)[0] for u in tr]))
    return utts, transcripts


def test_train_embedded_trajectory_matches_jax():
    words, jmod, tmod = _units(seed=20)
    utts, transcripts = _training_set(words)
    rng = np.random.default_rng(5)
    noise = rng.normal(size=(P, S, M, D)) * 0.5
    jst = jmod.streams[0]
    jpert = jmod.replace(streams=(jst.replace(means=jst.means + noise),)).astype(jnp.float32)
    tst = tmod.streams[0]
    tpert = tmods.GmmHmm(trans=tmod.trans, streams=[tmods.GmmStream(
        tst.weights, tst.means + torch.as_tensor(noise), tst.inv_cov, tst.det, tst.cov_type, tst.log_det)],
        word=tmod.word).astype(torch.float32)
    r_j = je.train_embedded(jpert, utts, transcripts, threshold=1e-4, max_iterations=5, fused=False)
    for fused in (False, True):
        r_t = te.train_embedded(tpert, utts, transcripts, threshold=1e-4, max_iterations=5, fused=fused)
        assert r_t.iterations == r_j.iterations
        assert r_t.exemplar_count == r_j.exemplar_count == len(utts)
        np.testing.assert_allclose(r_t.log_prob_history, r_j.log_prob_history, rtol=2e-4)
        np.testing.assert_allclose(r_t.model.streams[0].means.numpy(), np.asarray(r_j.model.streams[0].means),
                                   rtol=2e-3, atol=2e-3)


def test_packers_and_unported_options():
    _, _, tmod = _units()
    st = tmod.streams[0]
    a, bias = te.pack_position_bank(st.means, st.inv_cov, st.weights, st.log_abs_det(), D)
    ja, jbias = je.pack_position_bank(jnp.asarray(st.means.numpy()), jnp.asarray(st.inv_cov.numpy()),
                                      jnp.asarray(st.weights.numpy()), jnp.asarray(st.log_abs_det().numpy()), D)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-12)
    np.testing.assert_allclose(bias.numpy(), np.asarray(jbias), rtol=1e-12)
    rec = te.pack_position_bank_diag(st.means, st.inv_cov, st.weights, st.log_abs_det(), D)
    assert rec.shape == (P * S, M, 2 * 8 + 4) and rec.dtype == torch.float32
    with pytest.raises(NotImplementedError, match="mesh"):
        te.train_embedded(tmod, [np.zeros((9, D))], [[0]], mesh=object())
    with pytest.raises(NotImplementedError, match="checkpoint_dir"):
        te.train_embedded(tmod, [np.zeros((9, D))], [[0]], checkpoint_dir="ck")
    assert not te._embedded_fused_eligible(tmod.astype(torch.float32), torch.zeros((2, 3), dtype=torch.int32),
                                           torch.zeros((2, 9, D)))  # CPU tensors
