"""Tied-state training, part 3: srhmm_tpu_torch's models/tying.py,
models/decision_tree.py and train/tied.py against the JAX package's on the
same numpy inputs (CPU).

Tolerances: tying and clustering exact (the same float64 numpy
arithmetic); the plain E-step in float64 to 1e-9 relative; float32 and the
fused path (the kernels' twins) to 5e-4, the JAX package's fused-vs-XLA
bound (tests/test_tied.py:183-191); the train_tied trajectory to 2e-4
(tests/test_tied.py:246-253).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srhmm_tpu.models as jm
import srhmm_tpu.models.decision_tree as jdt
import srhmm_tpu.models.tying as jty
import srhmm_tpu.train.embedded as je
import srhmm_tpu.train.tied as jt
import srhmm_tpu_torch.models as tmods
import srhmm_tpu_torch.models.decision_tree as tdt
import srhmm_tpu_torch.train.embedded as te
import srhmm_tpu_torch.train.tied as tt
from torch_port_utils import both_models, rand_word, sample_utterance

P, S, M, D = 6, 3, 2, 5


def _units(cov="diag", dim=D, seed=100):
    words = [rand_word(seed + i, S, [(M, dim)], cov, scale=3.0) for i in range(P)]
    pairs = [both_models(*w, f"t{i}") for i, w in enumerate(words)]
    return words, jm.stack_models([p[0] for p in pairs]), tmods.stack_models([p[1] for p in pairs])


def _state_map(seed=0, N=10):
    rng = np.random.default_rng(seed)
    sm = rng.integers(0, N, size=(P, S)).astype(np.int32)
    sm[:4] = np.minimum(np.arange(4 * S).reshape(-1, S), N - 1)  # every senone used
    return sm


def _tied_pair(cov="diag", dim=D, dtype=None):
    _, jmod, tmod = _units(cov, dim)
    sm = _state_map()
    jtd, ttd = jty.tie_from_models(jmod, sm), tmods.tie_from_models(tmod, sm)
    if dtype == "f32":
        jtd, ttd = jtd.astype(jnp.float32), ttd.astype(torch.float32)
    return jtd, ttd


def _leaves_equal(jtd, ttd, rtol=0.0):
    js, ts = jtd.senones, ttd.senones
    for a, b in ((js.weights, ts.weights), (js.means, ts.means), (js.inv_cov, ts.inv_cov), (js.det, ts.det),
                 (js.log_abs_det(), ts.log_abs_det()), (jtd.trans, ttd.trans)):
        b = b.numpy()
        a = np.asarray(a)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(b, a, rtol=rtol, atol=0)
    np.testing.assert_array_equal(ttd.state_map.numpy(), np.asarray(jtd.state_map))


@pytest.mark.parametrize("cov", ["diag", "full"])
def test_tie_from_models_and_untied_map_are_exact(cov):
    _, jmod, tmod = _units(cov, 4)
    np.testing.assert_array_equal(tmods.untied_state_map(P, S).numpy(), np.asarray(jty.untied_state_map(P, S)))
    sm = _state_map()
    jtd, ttd = jty.tie_from_models(jmod, sm), tmods.tie_from_models(tmod, sm)
    assert ttd.num_senones == jtd.num_senones and ttd.num_units == P and ttd.num_states == S
    _leaves_equal(jtd, ttd)
    mat_j, mat_t = jtd.materialize(), ttd.materialize()
    np.testing.assert_array_equal(mat_t.streams[0].means.numpy(), np.asarray(mat_j.streams[0].means))
    assert mat_t.trans.shape == (P, S, S) and tuple(mat_t.word) == tuple(mat_j.word)
    # the converter builds the same set from the JAX set's numpy leaves
    js = jtd.senones
    conv = tmods.tied_hmm_set_from_numpy(
        {"weights": np.asarray(js.weights), "means": np.asarray(js.means), "inv_cov": np.asarray(js.inv_cov),
         "det": np.asarray(js.det), "log_det": None, "cov_type": js.cov_type},
        np.asarray(jtd.trans), np.asarray(jtd.state_map), jtd.unit_names)
    _leaves_equal(jtd, conv)
    assert conv.unit_names == jtd.unit_names


def _cluster_inputs():
    """Triphone units over 4 phones, per-(unit, state) single-Gaussian
    statistics whose means depend strongly on the left context and weakly
    on the right: the split gains are far apart (no near ties)."""
    phones = ["a", "b", "c", "d"]
    units = [(l, c, r) for c in phones[:2] for l in phones for r in phones[:3]]
    rng = np.random.default_rng(3)
    n = len(units)
    occ = rng.uniform(200.0, 400.0, size=(n, S))
    mean = np.zeros((n, S, D))
    for i, (l, c, r) in enumerate(units):
        mean[i] = 4.0 * phones.index(l) + 1.3 * phones.index(r) * np.arange(1, S + 1)[:, None] \
            + 0.1 * rng.normal(size=(S, D))
    var = rng.uniform(0.5, 1.5, size=(n, S, D))
    x = occ[..., None] * mean
    xx = occ[..., None] * (var + mean * mean)
    return units, occ, x, xx


def test_cluster_states_gives_the_same_map():
    units, occ, x, xx = _cluster_inputs()
    for kw in ({}, {"max_senones": 9}, {"min_gain": 5e3}):
        jr = jdt.cluster_states(units, occ, x, xx, min_occ=100.0, **kw)
        tr = tdt.cluster_states(units, occ, x, xx, min_occ=100.0, **kw)
        np.testing.assert_array_equal(tr.state_map, jr.state_map)
        assert tr.num_senones == jr.num_senones > 2 * S
        for u in [("d", "a", "b"), ("a", "b", "a"), ("x", "e", "y")]:  # seen, and unseen ones
            assert tr.senone_for(u, 1) == jr.senone_for(u, 1)
    qs = {"V": ["a", "b"], "C": ["c", "d"]}
    assert [(q.name, q.side, q.phones) for q in tdt.questions_from_classes(qs)] == \
        [(q.name, q.side, q.phones) for q in jdt.questions_from_classes(qs)]


def test_state_stats_from_suffstats_matches_jax():
    _, jmod, tmod = _units()
    rng = np.random.default_rng(4)
    trs = rng.integers(0, P, size=(3, 3)).astype(np.int32)
    feats = rng.normal(size=(3, 30, D)) * 2
    lens = np.asarray([30, 21, 12], np.int32)
    ref = je.batch_stats(jmod, jnp.asarray(trs), jnp.asarray(feats), jnp.asarray(lens))
    got = te.batch_stats(tmod, torch.as_tensor(trs), torch.as_tensor(feats), torch.as_tensor(lens))
    for a, b in zip(tdt.state_stats_from_suffstats(got), jdt.state_stats_from_suffstats(ref)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


def _tied_batch(seed=0, B=4, T=32, L=3):
    rng = np.random.default_rng(seed)
    trs = rng.integers(0, P, size=(B, L)).astype(np.int32)
    feats = rng.normal(size=(B, T, D))
    lens = np.asarray([T, 20, T, 9][:B], np.int32)
    return trs, feats, lens


def _tied_close(got, ref, rtol):
    for f in ("w", "x", "xx"):
        a = np.asarray(getattr(ref[0], f))
        b = getattr(got[0], f).numpy()
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * max(1.0, np.abs(a).max()))
    for i in (1, 2, 3):
        a, b = np.asarray(ref[i]), got[i].numpy()
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * max(1.0, np.abs(a).max()))
    np.testing.assert_allclose(float(got[4]), float(ref[4]), rtol=min(rtol, 1e-5))
    assert float(got[5]) == float(ref[5])


def test_tied_batch_stats_matches_jax_float64():
    jtd, ttd = _tied_pair()
    trs, feats, lens = _tied_batch()
    ref = jt.tied_batch_stats(jtd, jnp.asarray(trs), jnp.asarray(feats), jnp.asarray(lens))
    got = tt.tied_batch_stats(ttd, torch.as_tensor(trs), torch.as_tensor(feats), torch.as_tensor(lens))
    _tied_close(got, ref, 1e-9)


@pytest.fixture(scope="module")
def fused_reference():
    """The JAX package's fused tied E-step (Pallas interpret mode) once."""
    jtd, ttd = _tied_pair(dtype="f32")
    trs, feats, lens = _tied_batch(1)
    f32 = feats.astype(np.float32)
    ref = jt.tied_batch_stats_fused(jtd, jnp.asarray(trs), jnp.asarray(f32), jnp.asarray(lens), k_block=8)
    return jtd, ttd, trs, f32, lens, ref


@pytest.mark.parametrize("fn", ["plain", "fused", "fused_bst"])
def test_tied_batch_stats_float32_matches_jax_fused(fused_reference, fn):
    _, ttd, trs, f32, lens, ref = fused_reference
    args = (ttd, torch.as_tensor(trs), torch.as_tensor(f32), torch.as_tensor(lens))
    if fn == "plain":
        got = tt.tied_batch_stats(*args)
    else:
        got = tt.tied_batch_stats_fused(*args, gamma_lattice=fn == "fused")
    _tied_close(got, ref, 5e-4)


def test_tied_batch_stats_fused_full_cov_matches_jax():
    jtd, ttd = _tied_pair("full", 4, dtype="f32")
    trs, _, lens = _tied_batch(3, B=3, T=24)
    feats = (np.random.default_rng(3).normal(size=(3, 24, 4)) * 2).astype(np.float32)
    ref = jt.tied_batch_stats(jtd, jnp.asarray(trs), jnp.asarray(feats), jnp.asarray(lens))
    got = tt.tied_batch_stats_fused(ttd, torch.as_tensor(trs), torch.as_tensor(feats), torch.as_tensor(lens))
    _tied_close(got, ref, 5e-4)


def test_untied_set_equals_embedded():
    """With the identity map, tied statistics equal embedded statistics."""
    _, _, tmod = _units()
    ttd = tmods.tie_from_models(tmod, tmods.untied_state_map(P, S))
    trs, feats, lens = _tied_batch(5, B=2, T=30)
    args = (torch.as_tensor(trs), torch.as_tensor(feats), torch.as_tensor(lens))
    sen, den_mix, num_trans, den_trans, lp, nv = tt.tied_batch_stats(ttd, *args)
    emb = te.batch_stats(tmod, *args)
    np.testing.assert_allclose(float(lp), float(emb.log_prob), rtol=1e-9)
    np.testing.assert_allclose(num_trans.numpy(), emb.num_trans.numpy(), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(den_trans.numpy(), emb.den_trans.numpy(), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(sen.w.numpy().reshape(P, S, M), emb.streams[0].w.numpy(), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(den_mix.numpy().reshape(P, S), emb.den_mix.numpy(), rtol=1e-8, atol=1e-10)


def test_train_tied_trajectory_matches_jax():
    words, jmod, tmod = _units(seed=140)
    rng = np.random.default_rng(6)
    transcripts = [[0, 1, 2], [2, 3, 0], [1, 0, 3], [4, 5, 1], [5, 4, 2, 3]]
    utts = [np.concatenate([sample_utterance(rng, *words[u], 3 * S)[0] for u in tr]) for tr in transcripts]
    sm = (np.arange(P * S).reshape(P, S) % (P * S // 2)).astype(np.int32)  # 2-way sharing
    jtd = jty.tie_from_models(jmod, sm).astype(jnp.float32)
    ttd = tmods.tie_from_models(tmod, sm).astype(torch.float32)
    r_j = jt.train_tied(jtd, utts, transcripts, threshold=1e-4, max_iterations=4, fused=False)
    for fused in (False, True):
        r_t = tt.train_tied(ttd, utts, transcripts, threshold=1e-4, max_iterations=4, fused=fused)
        assert r_t.iterations == r_j.iterations
        np.testing.assert_allclose(r_t.log_prob_history, r_j.log_prob_history, rtol=2e-4)
        np.testing.assert_allclose(r_t.model.senones.means.numpy(), np.asarray(r_j.model.senones.means),
                                   rtol=2e-3, atol=2e-3)
    # one tied EM step keeps the senone weights normalized
    trs = np.asarray([tr[:3] for tr in transcripts], np.int32)
    T = max(len(u) for u in utts)
    feats = np.zeros((len(utts), T, D), np.float32)
    for i, u in enumerate(utts):
        feats[i, : len(u)] = u
    lens = torch.as_tensor([len(u) if len(tr) == 3 else 9 * S for u, tr in zip(utts, transcripts)])
    new, lp, nv = tt.tied_em_step(ttd, torch.as_tensor(trs), torch.as_tensor(feats), lens)
    np.testing.assert_allclose(new.senones.weights.sum(-1).numpy(), 1.0, rtol=1e-6)
    assert int(nv) == len(utts) and np.isfinite(float(lp))
    with pytest.raises(TypeError, match="mesh"):  # a Mesh of parallel/mesh.py is wanted
        tt.train_tied(ttd, utts, transcripts, mesh=object())
