"""The end-to-end pipeline: srhmm_tpu_torch/pipeline.py and
models.concat_models against srhmm_tpu on the same configuration (CPU).

Exactly equal: the lexicon, the synthesized waveforms (bitwise), the
triphone inventory, concat_models and clone_monophones_to_units (float64
leaves), the LBG flat start from the same features, and run_pipeline's
global CMVN on the same float32 features.  estimate_bigram to rtol 1e-12.
mfcc_features on the CPU (both packages run the float32 frontend) at
rtol = atol = 2e-3, the MFCC twin's bound (tests/test_torch_frontend.py):
the same float32 products in other summation orders differ by up to
~4e-4 in the weak mel bands of the synthetic speech.  The
whole chain at tests/test_pipeline.py's TINY configuration with the JAX
test's gates, and its hypotheses and senone count equal to one JAX run
(the mean log probabilities, float32 EM in other summation orders, to
rtol 1e-4).  _bucketed_embedded_stats through the composed kernels' twins
against the plain E-step within 5e-4 (tests/test_torch_embedded.py's
fused-vs-plain bound).
"""

import dataclasses

import numpy as np
import pytest
import torch

import srhmm_tpu.features.frontend as jf
import srhmm_tpu.models as jm
import srhmm_tpu.pipeline as jp
import srhmm_tpu_torch.models as tmods
import srhmm_tpu_torch.pipeline as tp
from torch_port_utils import assert_same_leaves, both_models, rand_word

TINY = tp.PipelineConfig(
    n_words=6,
    phones=("aa", "iy", "uw", "eh", "ow", "ae"),
    phones_per_word=2,
    min_words=2,
    max_words=3,
)
STAGES = ("synthesize", "mfcc", "lbg_init", "monophone_em", "tree_cluster", "tied_em", "materialize",
          "decode", "wer")


def _jax_cfg(cfg: tp.PipelineConfig) -> jp.PipelineConfig:
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "frontend"}
    return jp.PipelineConfig(frontend=jf.FrontendConfig(**dataclasses.asdict(cfg.frontend)), **kw)


@pytest.mark.parametrize("cfg", [
    TINY,
    dataclasses.replace(TINY, phones_per_word=(2, 3), snr_db=10.0, seed=3),
    tp.PipelineConfig(min_words=3, max_words=3),
])
def test_lexicon_synthesis_and_inventory_equal_jax(cfg):
    jcfg = _jax_cfg(cfg)
    lex = tp.make_lexicon(cfg)
    assert lex == jp.make_lexicon(jcfg)
    got = tp.synthesize_dataset(cfg, n_train=7, n_test=3)
    want = jp.synthesize_dataset(jcfg, n_train=7, n_test=3)
    for g_waves, w_waves in ((got[0], want[0]), (got[2], want[2])):
        assert len(g_waves) == len(w_waves)
        for g, w in zip(g_waves, w_waves):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)
    assert got[1] == want[1] and got[3] == want[3]
    assert tp.build_inventory(cfg, lex) == jp.build_inventory(jcfg, lex)
    for _, ph in lex:
        assert tp.word_triphones(cfg.phones, ph) == jp.word_triphones(jcfg.phones, ph)


def test_estimate_bigram_and_global_cmvn_equal_jax():
    refs = [[0, 1, 2], [2, 2], [], [1], [3, 0, 1, 1]]
    for a, b in zip(tp.estimate_bigram(refs, 4), jp.estimate_bigram(refs, 4)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    rng = np.random.default_rng(2)
    train = [(rng.normal(size=(n, 13)) * 5 + 3).astype(np.float32) for n in (40, 17, 63)]
    test = [(rng.normal(size=(n, 13)) * 5 + 3).astype(np.float32) for n in (22, 9)]
    got_train, got_test = tp.global_cmvn(train, test)
    # srhmm_tpu/pipeline.py run_pipeline's CMVN lines, verbatim
    allf = np.concatenate(train, axis=0)
    g_mean = allf.mean(0)
    g_std = np.maximum(allf.std(0), 1e-6)
    norm = lambda fs: [((f - g_mean) / g_std).astype(np.float32) for f in fs]
    for g, w in zip(got_train + got_test, norm(train) + norm(test)):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def _inventory(P=5, S=3, seed=0):
    words = [rand_word(seed + i, S, [(2, 4)], "diag", scale=2.0) for i in range(P)]
    pairs = [both_models(*w, f"u{i}") for i, w in enumerate(words)]
    return jm.stack_models([p[0] for p in pairs]), tmods.stack_models([p[1] for p in pairs])


def test_concat_models_equals_jax():
    j_units, t_units = _inventory()
    for ids in ([2, 0, 2, 4], [1], [3, 3]):
        got = tmods.concat_models(t_units, ids, word="w")
        want = jm.concat_models(j_units, ids, word="w")
        assert_same_leaves(want, got)
        assert got.word == "w" and got.num_states == 3 * len(ids)


def test_clone_monophones_and_flat_start_equal_jax():
    j_mono, t_mono = _inventory(P=3)
    phones = ("a", "b", "c")
    units = [("#", "b", "c"), ("b", "c", "#"), ("#", "a", "b"), ("c", "a", "#")]
    got = tp.clone_monophones_to_units(t_mono, units, phones)
    want = jp.clone_monophones_to_units(j_mono, units, phones)
    assert_same_leaves(want, got)
    assert got.word == want.word == ("#-b-c", "b-c-#", "#-a-b", "c-a-#")

    cfg = dataclasses.replace(TINY, phones=phones, n_words=3)
    rng = np.random.default_rng(9)
    feats = [rng.normal(size=(int(n), 5)).astype(np.float32) * 2 for n in rng.integers(30, 60, size=8)]
    seqs = [rng.integers(0, 3, size=int(L)).tolist() for L in rng.integers(2, 5, size=8)]
    seqs[0] = [0, 1, 2]
    assert_same_leaves(jp.flat_start_monophones(_jax_cfg(cfg), feats, seqs),
                       tp.flat_start_monophones(cfg, feats, seqs))


def test_mfcc_features_match_jax_on_the_cpu():
    waves = tp.synthesize_dataset(TINY, n_train=3, n_test=0)[0]
    got = tp.mfcc_features(waves, TINY.frontend, device="cpu")
    want = jp.mfcc_features(waves, jf.FrontendConfig())
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-3)


def test_bucketed_stats_fused_twins_match_plain():
    """The composed kernels' twins (fused=True forced on CPU tensors)
    against the plain batch_stats, over several shape buckets."""
    _, units = _inventory(P=5, S=3)
    units = units.astype(torch.float32)
    rng = np.random.default_rng(4)
    utts = [rng.normal(size=(int(n), 4)) * 2 for n in rng.integers(20, 90, size=10)]
    trs = [rng.integers(0, 5, size=int(L)).tolist() for L in rng.integers(1, 4, size=10)]
    got = tp._bucketed_embedded_stats(units, utts, trs, fused=True)
    want = tp._bucketed_embedded_stats(units, utts, trs)  # CPU: not eligible, plain
    pairs = [(got.num_trans, want.num_trans), (got.den_trans, want.den_trans), (got.den_mix, want.den_mix)]
    pairs += [(getattr(g, f), getattr(w, f)) for g, w in zip(got.streams, want.streams) for f in ("w", "x", "xx")]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-4, atol=5e-4 * float(b.abs().max()))
    np.testing.assert_allclose(float(got.log_prob), float(want.log_prob), rtol=1e-5)
    assert float(got.num_valid) == float(want.num_valid) == 10


@pytest.fixture(scope="module")
def jax_clean():
    return jp.run_pipeline(_jax_cfg(TINY), n_train=24, n_test=8, max_iterations=4, tied_iterations=4)


@pytest.fixture(scope="module")
def port_clean():
    return tp.run_pipeline(TINY, n_train=24, n_test=8, max_iterations=4, tied_iterations=4, device="cpu")


def test_pipeline_end_to_end_clean(port_clean):
    """tests/test_pipeline.py's gates on the port's chain."""
    res = port_clean
    assert res.wer.num_ref_words > 10
    assert res.wer.wer <= 0.10, (res.wer, res.hyps, res.refs)
    assert res.n_senones < res.n_units * TINY.states_per_phone
    assert res.n_senones >= TINY.states_per_phone
    assert res.mono_iterations >= 1 and res.tied_iterations >= 1
    assert np.isfinite(res.mono_log_prob) and np.isfinite(res.tied_log_prob)
    assert set(STAGES) <= set(res.stage_seconds)


def test_pipeline_hypotheses_equal_jax(port_clean, jax_clean):
    assert port_clean.refs == jax_clean.refs
    assert port_clean.hyps == jax_clean.hyps
    assert port_clean.n_senones == jax_clean.n_senones and port_clean.n_units == jax_clean.n_units
    assert port_clean.words == jax_clean.words
    np.testing.assert_allclose(port_clean.mono_log_prob, jax_clean.mono_log_prob, rtol=1e-4)
    np.testing.assert_allclose(port_clean.tied_log_prob, jax_clean.tied_log_prob, rtol=1e-4)


def test_pipeline_noisy_degrades_gracefully():
    res = tp.run_pipeline(dataclasses.replace(TINY, snr_db=0.0), n_train=24, n_test=8, max_iterations=3,
                          tied_iterations=3, device="cpu")
    assert res.wer.wer <= 0.5, (res.wer, res.hyps, res.refs)


def test_pipeline_variable_word_lengths():
    cfg = dataclasses.replace(TINY, phones_per_word=(2, 3))
    assert len({len(ph) for _, ph in tp.make_lexicon(cfg)}) > 1
    res = tp.run_pipeline(cfg, n_train=24, n_test=8, max_iterations=4, tied_iterations=4, device="cpu")
    assert res.wer.wer <= 0.10, (res.wer, res.hyps, res.refs)


def test_pipeline_refuses_a_mesh():
    """mesh= takes a srhmm_tpu_torch.parallel.Mesh with a data axis; anything
    else is refused before any work (test_pipeline_data_parallel_mesh runs a
    real one)."""
    with pytest.raises(TypeError, match="mesh"):
        tp.run_pipeline(TINY, n_train=2, n_test=1, mesh=object(), device="cpu")


def test_tree_cluster_on_a_mesh_reads_all_reduced_statistics(tmp_path):
    """Under a mesh of 2 gloo ranks the clustering statistics are summed over
    the ranks' rows: with rank 1's copy of the features one ulp off, the
    ranks' own whole-batch statistics differ, but the sums the tree reads
    are bitwise the same on both ranks and within the file's float32
    bucketed-statistics bound (5e-4) of the one-process statistics, and so
    is the state map."""
    import torch_dist_workers as w
    from srhmm_tpu_torch.models.decision_tree import state_stats_from_suffstats
    from srhmm_tpu_torch.parallel import distributed

    lex = tp.make_lexicon(TINY)
    waves, refs, _, _ = tp.synthesize_dataset(TINY, n_train=12, n_test=0)
    feats, _ = tp.global_cmvn(tp.mfcc_features(waves, TINY.frontend, "cpu"), [])
    mono = tp.flat_start_monophones(TINY, feats, [[p for w_ in ids for p in lex[w_][1]] for ids in refs])
    units, word_unit_ids = tp.build_inventory(TINY, lex)
    tri = tp.clone_monophones_to_units(mono.astype(torch.float32), units, TINY.phones)
    trs = [[u for w_ in ids for u in word_unit_ids[w_]] for ids in refs]
    kw = dict(min_occ=10.0, min_gain=20.0)
    one_stats = state_stats_from_suffstats(tp._bucketed_embedded_stats(tri, feats, trs))
    one_map = tp.tree_cluster(tri, feats, trs, units, **kw).state_map
    assert len(np.unique(one_map)) > len(TINY.phones) * tri.num_states  # the tree splits
    r0, r1 = distributed.spawn(w.tree_case, 2, args=(tri, feats, trs, units, kw), device="cpu",
                               timeout_s=w.TIMEOUT_S, workdir=tmp_path)
    assert any(not np.array_equal(a, b) for a, b in zip(r0["own"], r1["own"]))
    for a, b, want in zip(r0["shared"], r1["shared"], one_stats):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, np.asarray(want), rtol=5e-4, atol=5e-4 * float(np.abs(want).max()))
    np.testing.assert_array_equal(r0["state_map"], r1["state_map"])
    np.testing.assert_array_equal(r0["state_map"], one_map)


def test_pipeline_data_parallel_mesh(port_clean, tmp_path):
    """tests/test_pipeline.py test_pipeline_data_parallel_mesh on the port:
    the same chain with both EM stages on a mesh of 2 gloo ranks (spawned,
    killed after torch_dist_workers.TIMEOUT_S) gives the one-rank run's
    hypotheses on every rank, at WER <= 0.10."""
    import torch_dist_workers as w
    from srhmm_tpu_torch.parallel import distributed

    kw = dict(n_train=24, n_test=8, max_iterations=4, tied_iterations=4)
    ranks = distributed.spawn(w.pipeline_case, 2, args=(TINY, kw), device="cpu", timeout_s=w.TIMEOUT_S,
                              workdir=tmp_path)
    for res in ranks:
        assert res["wer"] <= 0.10, res
        assert res["refs"] == port_clean.refs
        assert res["hyps"] == port_clean.hyps
        assert res["n_senones"] == port_clean.n_senones
        np.testing.assert_allclose(res["mono_log_prob"], port_clean.mono_log_prob, rtol=1e-4)
