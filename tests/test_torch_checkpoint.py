"""Checkpoint / resume: srhmm_tpu_torch/train/checkpoint.py and the chunked
driver's checkpoints against srhmm_tpu's, on the same numpy inputs (CPU).

train_fast_resumable stopped after two iterations and resumed: against the
JAX package's, in float64, at rtol 1e-12 (tests/test_checkpoint.py:18's
bound), and bitwise against the port's own uninterrupted run.  The manager:
keep= and latest() as tests/test_checkpoint.py:43, a payload without its
sidecar ignored, a template whose keys, shapes or dtypes differ raising
before anything is copied.  The driver: the same saves as the JAX driver's
on a scripted run, and a run that dies with a speculative chunk in flight
(pipeline=2) resuming to the uninterrupted run's result.  train_embedded /
train_tied stopped and resumed against the JAX package's uninterrupted run
at tests/test_checkpoint.py:101-150's bounds (in float64), and bitwise
against the port's own uninterrupted run.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srhmm_tpu.models as jm
import srhmm_tpu.models.tying as jty
import srhmm_tpu.train.checkpoint as jc
import srhmm_tpu.train.driver as j_driver
import srhmm_tpu.train.embedded as je
import srhmm_tpu.train.tied as jt
import srhmm_tpu_torch.models as tmods
import srhmm_tpu_torch.train.checkpoint as tc
import srhmm_tpu_torch.train.driver as t_driver
import srhmm_tpu_torch.train.embedded as te
import srhmm_tpu_torch.train.tied as tt
from srhmm_tpu.io.dataset import pack_utterances as j_pack
from srhmm_tpu_torch.io.dataset import pack_utterances as t_pack
from srhmm_tpu_torch.train.em import em_train_scan
from torch_port_utils import both_models, rand_word, sample_utterance


def _word(cov, seed=5):
    trans, streams = rand_word(seed, 5, [(2, 4) if cov == "diag" else (2, 3)], cov)
    jmod, tmod = both_models(trans, streams, "w")
    rng = np.random.default_rng(seed + 1)
    utts = [sample_utterance(rng, trans, streams, 40 + 3 * i)[0] for i in range(8)]
    return jmod, tmod, utts


def _leaves(model) -> list[np.ndarray]:
    return [t.detach().cpu().numpy() for t in model.state_dict().values()]


def _assert_bitwise(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("cov", ["diag", "full"])
def test_train_fast_resumable_matches_jax(tmp_path, cov):
    jmod, tmod, utts = _word(cov)
    bj = j_pack(utts, pad_multiple=8, dtype=jnp.float64)
    bt = t_pack(utts, pad_multiple=8, dtype=torch.float64)

    jc.train_fast_resumable(jmod, bj, tmp_path / "j", max_iterations=2)
    rj = jc.train_fast_resumable(jmod, bj, tmp_path / "j")
    r1 = tc.train_fast_resumable(tmod, bt, tmp_path / "t", max_iterations=2)
    assert r1.iterations == 2 and len(list((tmp_path / "t").glob("ckpt_*.json"))) == 2
    rt = tc.train_fast_resumable(tmod, bt, tmp_path / "t")
    ru = tc.train_fast_resumable(tmod, bt, tmp_path / "u")

    assert rt.iterations == rj.iterations == ru.iterations > 2
    np.testing.assert_allclose(rt.log_prob_history, rj.log_prob_history, rtol=1e-12)
    np.testing.assert_allclose(rt.mean_log_prob, rj.mean_log_prob, rtol=1e-12)
    np.testing.assert_allclose(rt.model.trans.numpy(), np.asarray(rj.model.trans), rtol=1e-12, atol=1e-300)
    for name in ("weights", "means", "inv_cov", "log_det"):
        want = np.asarray(getattr(rj.model.streams[0], name))
        np.testing.assert_allclose(getattr(rt.model.streams[0], name).numpy(), want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())
    # the resumed run is the uninterrupted run, bit for bit
    assert rt.log_prob_history == ru.log_prob_history and rt.exemplar_count == ru.exemplar_count
    _assert_bitwise(rt.model, ru.model)
    assert rt.model.word == "w" and rt.model.streams[0].cov_type == cov


def _toy_model():
    return tmods.GmmHmm(
        trans=tmods.init_left_right_trans(3),
        streams=[tmods.GmmStream(weights=torch.ones((3, 1)), means=torch.zeros((3, 1, 2)),
                                 inv_cov=torch.ones((3, 1, 2)), det=torch.ones((3, 1)), cov_type="diag")],
        word="toy",
    )


def test_manager_gc_and_latest(tmp_path):
    jmodel = jm.GmmHmm(
        trans=jm.init_left_right_trans(3),
        streams=(jm.GmmStream(weights=jnp.ones((3, 1)), means=jnp.zeros((3, 1, 2)), inv_cov=jnp.ones((3, 1, 2)),
                              det=jnp.ones((3, 1)), cov_type=jm.DIAG),),
    )
    model = _toy_model()
    jmgr = jc.CheckpointManager(tmp_path / "j", keep=2)
    mgr = tc.CheckpointManager(tmp_path / "t", keep=2)
    for i in range(1, 5):
        jmgr.save(jmodel, jc.EmDriverState(iteration=i, old_log_prob=-float(i), history=[-float(i)]))
        saved = tmods.GmmHmm(trans=model.trans * 1.0 + i, streams=list(model.streams), word="toy")
        mgr.save(saved, tc.EmDriverState(iteration=i, old_log_prob=-float(i), history=[-float(i)]))
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == ["ckpt_000003.json", "ckpt_000003.pt", "ckpt_000004.json", "ckpt_000004.pt"]
    assert sorted(p.name for p in (tmp_path / "j").glob("*.json")) == names[::2]
    got, state = mgr.latest(model)
    _, jstate = jmgr.latest(jmodel)
    assert (state.iteration, state.old_log_prob, state.history) == (jstate.iteration, jstate.old_log_prob,
                                                                     jstate.history) == (4, -4.0, [-4.0])
    assert torch.equal(got.trans, model.trans + 4) and got.word == "toy" and got is not model
    # the sidecars carry the JAX package's fields
    jmeta = json.loads((tmp_path / "j" / "ckpt_000004.json").read_text())
    meta = json.loads((tmp_path / "t" / "ckpt_000004.json").read_text())
    assert sorted(meta) == sorted(jmeta) and meta["cov_types"] == jmeta["cov_types"] == ["diag"]
    assert meta["word"] == "toy"


def test_a_payload_without_its_sidecar_is_ignored(tmp_path):
    model = _toy_model()
    mgr = tc.CheckpointManager(tmp_path)
    assert mgr.latest(model) is None
    for i in (1, 2):
        mgr.save(tmods.GmmHmm(trans=model.trans + i, streams=list(model.streams)),
                 tc.EmDriverState(iteration=i, old_log_prob=-1.0, history=[]))
    # a crash between the payload and the sidecar leaves a payload alone
    (tmp_path / "ckpt_000002.json").unlink()
    torch.save(model.state_dict(), tmp_path / "ckpt_000003.pt")
    got, state = mgr.latest(model)
    assert state.iteration == 1 and torch.equal(got.trans, model.trans + 1)
    # and a sidecar whose payload is missing is skipped
    (tmp_path / "ckpt_000004.json").write_text(json.dumps({"iteration": 4, "old_log_prob": 0.0, "history": []}))
    assert mgr.latest(model)[1].iteration == 1


@pytest.mark.parametrize("change", ["shape", "dtype", "keys"])
def test_a_template_mismatch_raises(tmp_path, change):
    model = _toy_model()
    mgr = tc.CheckpointManager(tmp_path)
    mgr.save(model, tc.EmDriverState(iteration=1, old_log_prob=1.0, history=[]))
    if change == "shape":
        other = tmods.GmmHmm(trans=tmods.init_left_right_trans(4), streams=[
            tmods.GmmStream(weights=torch.ones((4, 1)), means=torch.zeros((4, 1, 2)), inv_cov=torch.ones((4, 1, 2)),
                            det=torch.ones((4, 1)), cov_type="diag")])
    elif change == "dtype":
        other = model.astype(torch.float32)
    else:
        other = tmods.GmmHmm(trans=model.trans, streams=[model.streams[0], model.streams[0]])
    before = _leaves(other)
    with pytest.raises(ValueError, match="template"):
        mgr.latest(other)
    for a, b in zip(before, _leaves(other)):
        np.testing.assert_array_equal(a, b)


class _Recorder:
    """A checkpoint manager that records the driver's saves and resumes from
    a scripted state."""

    def __init__(self, resume=None):
        self.resume, self.saves = resume, []

    def latest(self, template):
        return self.resume

    def save(self, state, ck):
        self.saves.append((state, ck.iteration, ck.old_log_prob, list(ck.history)))


def _scripted(history):
    """run_chunk over integer states: state s runs iterations s+1..s+k, whose
    log probs are history[s..s+k)."""
    def run(s, k):
        return s + k, np.asarray(history[s : s + k]), np.full(k, 3.0)
    return run


@pytest.mark.parametrize("resume_at,threshold,chunk", [(None, 1e-3, 2), (2, 1e-3, 2), (3, 1e-3, 3), (None, 1e-9, 2)])
def test_driver_saves_what_the_jax_driver_saves(resume_at, threshold, chunk):
    history = [-100.0, -50.0, -40.0, -39.99, -39.98, -39.97, -39.96]
    saves = []
    for driver, state_cls in ((j_driver, jc.EmDriverState), (t_driver, tc.EmDriverState)):
        resume = None
        if resume_at is not None:
            old = history[resume_at - 1] + 0.5
            resume = (resume_at, state_cls(iteration=resume_at, old_log_prob=old,
                                           history=[h + 0.5 for h in history[:resume_at]]))
        rec = _Recorder(resume)
        out = driver.chunked_convergence_train(0, _scripted(history), threshold, 7, chunk, log_prob_offset=0.5,
                                               checkpoint=rec)
        saves.append((out, rec.saves))
    assert saves[1] == saves[0] and saves[1][1]


def _em_case():
    trans, streams = rand_word(8, 4, [(2, 3)], "diag")
    _, tmod = both_models(trans, streams, "w")
    rng = np.random.default_rng(9)
    utts = [sample_utterance(rng, trans, streams, 20 + 2 * i)[0] for i in range(5)]
    return tmod.astype(torch.float32), t_pack(utts, pad_multiple=4, dtype=torch.float32)


def test_driver_resumes_a_run_that_died_with_a_chunk_in_flight(tmp_path):
    model, batch = _em_case()

    def run(m, k):
        return em_train_scan(m, batch, k, fused=False)

    kw = dict(threshold=1e-7, max_iterations=9, chunk=2, pipeline=2)
    want = t_driver.chunked_convergence_train(model, run, **kw, checkpoint=tc.CheckpointManager(tmp_path / "a"))

    calls = []

    def dies_on_third_chunk(m, k):
        calls.append(k)
        if len(calls) == 3:
            raise RuntimeError("killed")
        return run(m, k)

    mgr = tc.CheckpointManager(tmp_path / "b")
    with pytest.raises(RuntimeError, match="killed"):
        t_driver.chunked_convergence_train(model, dies_on_third_chunk, **kw, checkpoint=mgr)
    # chunk 1 was fetched and saved; chunk 2 was in flight and is not
    assert [p.name for p in sorted((tmp_path / "b").glob("*.json"))] == ["ckpt_000002.json"]
    got = t_driver.chunked_convergence_train(model, run, **kw, checkpoint=mgr)
    assert got[1:] == want[1:] and got[1] == 9
    _assert_bitwise(got[0], want[0])


P, S, M, D = 3, 4, 2, 6


def _units():
    """Float64 units: the two packages then differ by summation order only,
    far inside the JAX test's own bounds (in float32 the trajectories of
    two summation orders part by ~1.4e-6 over six iterations)."""
    words = [rand_word(20 + i, S, [(M, D)], "diag", scale=3.0) for i in range(P)]
    pairs = [both_models(*w, f"u{i}") for i, w in enumerate(words)]
    return jm.stack_models([p[0] for p in pairs]), tmods.stack_models([p[1] for p in pairs]), words


def _embedded_data(words, seed):
    rng = np.random.default_rng(seed)
    trs = [rng.integers(0, P, 2 + (i % 2)).tolist() for i in range(8)]
    utts = [np.concatenate([sample_utterance(rng, *words[u], 3 * S)[0] for u in tr]) for tr in trs]
    return utts, trs


def test_embedded_resume_matches_jax(tmp_path):
    jmod, tmod, words = _units()
    utts, trs = _embedded_data(words, 5)
    ref = je.train_embedded(jmod, utts, trs, max_iterations=6, chunk=2)
    te.train_embedded(tmod, utts, trs, max_iterations=2, chunk=2, checkpoint_dir=tmp_path / "e")
    assert len(list((tmp_path / "e").glob("ckpt_*.json"))) >= 1
    got = te.train_embedded(tmod, utts, trs, max_iterations=6, chunk=2, checkpoint_dir=tmp_path / "e")
    whole = te.train_embedded(tmod, utts, trs, max_iterations=6, chunk=2)
    assert got.iterations == ref.iterations == whole.iterations
    np.testing.assert_allclose(got.log_prob_history, ref.log_prob_history, rtol=1e-6)
    np.testing.assert_allclose(got.model.trans.numpy(), np.asarray(ref.model.trans), rtol=1e-5)
    assert got.log_prob_history == whole.log_prob_history
    _assert_bitwise(got.model, whole.model)


def test_tied_resume_matches_jax(tmp_path):
    jmod, tmod, words = _units()
    utts, trs = _embedded_data(words, 9)
    sm = (np.arange(P * S) // 2).reshape(P, S)
    jtied, ttied = jty.tie_from_models(jmod, sm), tmods.tie_from_models(tmod, sm)
    ref = jt.train_tied(jtied, utts, trs, max_iterations=6, chunk=2)
    tt.train_tied(ttied, utts, trs, max_iterations=2, chunk=2, checkpoint_dir=tmp_path / "t")
    assert len(list((tmp_path / "t").glob("ckpt_*.json"))) >= 1
    got = tt.train_tied(ttied, utts, trs, max_iterations=6, chunk=2, checkpoint_dir=tmp_path / "t")
    whole = tt.train_tied(ttied, utts, trs, max_iterations=6, chunk=2)
    assert got.iterations == ref.iterations == whole.iterations
    np.testing.assert_allclose(got.log_prob_history, ref.log_prob_history, rtol=1e-6)
    np.testing.assert_allclose(got.model.senones.means.numpy(), np.asarray(ref.model.senones.means), rtol=1e-5)
    assert got.log_prob_history == whole.log_prob_history
    _assert_bitwise(got.model, whole.model)
    assert got.model.unit_names == ttied.unit_names
