"""Data- and mixture-parallel EM and scoring of srhmm_tpu_torch/parallel
against srhmm_tpu's sharded functions (CPU).

One group of 4 gloo ranks (spawned, file rendezvous, killed after
torch_dist_workers.TIMEOUT_S) runs every case of torch_dist_workers.py
mesh_cases; the tests compare rank 0's results with the JAX package on a
mesh of the first 4 of tests/conftest.py's 8 virtual CPU devices, and the
ranks' results with each other where every rank must hold the same.

Bounds are the JAX tests' own (tests/test_sharding.py): em_step_sharded in
float64 on meshes (4, 1), (2, 2) and (1, 4), the models rtol 1e-9 / atol
1e-12, log prob rtol 1e-12, num_valid exact; sharded scoring rtol 1e-12;
the fused E-step rtol 2e-3 / atol 2e-4 max; em_train_scan_sharded against
the per-step sharded loop, histories rtol 1e-6, models rtol 1e-3; the
composed E-steps rtol 1e-4 / atol 1e-4 max and their scans, histories
rtol 1e-5, models rtol 2e-3 / atol 1e-4.  Where the port's data-parallel
trainers meet the JAX package's (train_embedded / train_tied with mesh=,
every bucket padded to the axis), the cross-package trajectory bound of
tests/test_torch_embedded.py: histories rtol 2e-4, means rtol / atol 2e-3.
On the CPU the port's kernel wrappers run their plain twins.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import srhmm_tpu.models as jm
import torch_dist_workers as w
from srhmm_tpu.io.dataset import pack_utterances
from srhmm_tpu.parallel import make_mesh, replicate, shard_batch, shard_model
from srhmm_tpu_torch.parallel import distributed
from torch_port_utils import jax_model, leaves_jax


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return distributed.spawn(w.mesh_cases, 4, device="cpu", timeout_s=w.TIMEOUT_S,
                             workdir=tmp_path_factory.mktemp("mesh"))


@pytest.fixture(scope="module")
def got(ranks):
    return ranks[0]


def jmesh(n_data, n_model=1):
    return make_mesh(n_data=n_data, n_model=n_model, devices=jax.devices()[:4])


def jax_toy(dtype=jnp.float64):
    trans, streams, utts = w.toy()
    return jax_model(trans, streams).astype(dtype), pack_utterances(utts, pad_multiple=16, dtype=dtype)


def jax_stats(st) -> dict:
    if isinstance(st, tuple):
        vals = (st[0].w, st[0].x, st[0].xx) + tuple(st[1:])
        return {k: np.asarray(v) for k, v in zip(w.TIED_STAT_NAMES, vals)}
    out = {k: np.asarray(getattr(st, k)) for k in w.STAT_NAMES}
    for i, s in enumerate(st.streams):
        out.update({f"w{i}": np.asarray(s.w), f"x{i}": np.asarray(s.x), f"xx{i}": np.asarray(s.xx)})
    return out


def close_stats(got_st: dict, want: dict, rtol, atol_rel):
    assert set(got_st) == set(want)
    for k, a in want.items():
        np.testing.assert_allclose(got_st[k], a, rtol=rtol, atol=atol_rel * max(np.abs(a).max(), 1.0), err_msg=k)


def close_leaves(a, b, rtol, atol):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x, np.float64), np.asarray(y, np.float64), rtol=rtol, atol=atol)


@pytest.mark.parametrize("shape", w.MESH_SHAPES)
def test_em_step_sharded_matches_jax(got, shape):
    model, batch = jax_toy()
    mesh = jmesh(*shape)
    ref_model, ref_lp, ref_nv = jm_em_step(shard_model(model, mesh), shard_batch(batch, mesh))
    leaves, lp, nv = got[f"em_{shape}"]
    np.testing.assert_allclose(lp, float(ref_lp), rtol=1e-12)
    assert nv == float(ref_nv)
    close_leaves(leaves, leaves_jax(ref_model), rtol=1e-9, atol=1e-12)


def jm_em_step(model, batch):
    from srhmm_tpu.train.em import em_step

    return em_step(model, batch)


def test_every_rank_holds_the_same_results(ranks):
    for r in ranks[1:]:
        for shape in w.MESH_SHAPES:
            close_leaves(r[f"em_{shape}"][0], ranks[0][f"em_{shape}"][0], 0.0, 0.0)
        np.testing.assert_array_equal(r["scores"], ranks[0]["scores"])
        for key in ("scan", "embedded_scan", "tied_scan"):
            np.testing.assert_array_equal(r[key][0], ranks[0][key][0])
        for key in ("train_fast", "train_embedded", "train_tied"):
            np.testing.assert_array_equal(r[key][0]["history"], ranks[0][key][0]["history"])
    assert all(r["indivisible_raises"] for r in ranks)


def test_sharded_scoring_matches_jax(got):
    from srhmm_tpu.decode.scorer import score_batch_log

    model, batch = jax_toy()
    vocab = jm.stack_models([model.replace(word=f"w{i}") for i in range(8)])
    mesh = jmesh(4)
    ref = np.asarray(score_batch_log(replicate(vocab, mesh), shard_batch(batch, mesh)))
    assert got["scores"].shape == ref.shape == (16, 8)
    np.testing.assert_allclose(got["scores"], ref, rtol=1e-12)


def test_fused_lane_sharded_matches_jax(got):
    from srhmm_tpu.train.em import e_step_fused_lane_sharded

    model, batch = jax_toy(jnp.float32)
    ref = e_step_fused_lane_sharded(model, batch, jmesh(4), k_block=8)
    close_stats(got["fused_lane"], jax_stats(ref), rtol=2e-3, atol_rel=2e-4)


def test_sharded_scan_matches_per_step_loop(got):
    lps, nvs, final, ref_lps, ref_final = got["scan"]
    np.testing.assert_allclose(lps, ref_lps, rtol=1e-6)
    assert (nvs == 16).all()
    for a, b in zip(final, ref_final):
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-3 * max(1.0, np.abs(a).max()))


def test_train_fast_data_mesh_matches_one_rank(got):
    (dp, dp_leaves, one, one_leaves) = got["train_fast"]
    assert dp["iterations"] == one["iterations"] and dp["num_valid"] == one["num_valid"] == 16
    np.testing.assert_allclose(dp["history"], one["history"], rtol=1e-6)
    close_leaves(dp_leaves, one_leaves, rtol=1e-3, atol=1e-4)


def _jax_units(units):
    return jm.stack_models([jax_model(t, s, f"u{i}") for i, (t, s) in enumerate(units)]).astype(jnp.float32)


def test_composed_sharded_matches_jax(got):
    from srhmm_tpu.models.tying import tie_from_models
    from srhmm_tpu.train.embedded import batch_stats_fused_sharded
    from srhmm_tpu.train.tied import tied_batch_stats_fused_sharded

    units, trs, feats, lengths, sm = w.composed_inputs()
    models = _jax_units(units)
    mesh = jmesh(4)
    args = (jnp.asarray(trs), jnp.asarray(feats), jnp.asarray(lengths), mesh)
    close_stats(got["composed"], jax_stats(batch_stats_fused_sharded(models, *args, k_block=8)), 1e-4, 1e-4)
    tied = tie_from_models(models, sm).astype(jnp.float32)
    close_stats(got["tied_composed"], jax_stats(tied_batch_stats_fused_sharded(tied, *args, k_block=8)),
                1e-4, 1e-4)


@pytest.mark.parametrize("key", ["embedded_scan", "tied_scan"])
def test_composed_sharded_scans_match_one_rank(got, key):
    lps, final, ref_lps, ref_final = got[key]
    np.testing.assert_allclose(lps, ref_lps, rtol=1e-5)
    close_leaves(final, ref_final, rtol=2e-3, atol=1e-4)


def _jax_start():
    words, noise, utts, transcripts = w.train_inputs()
    models = []
    for i, (trans, streams) in enumerate(words):
        models.append(jax_model(trans, [dict(streams[0], means=streams[0]["means"] + noise[i])], f"u{i}"))
    return jm.stack_models(models).astype(jnp.float32), utts, transcripts


def test_train_embedded_mesh_matches_jax(got):
    from srhmm_tpu.train.embedded import train_embedded

    start, utts, transcripts = _jax_start()
    ref = train_embedded(start, utts, transcripts, threshold=-1.0, max_iterations=3, mesh=jmesh(4))
    hist, leaves = got["train_embedded"]
    assert hist["iterations"] == ref.iterations and hist["num_valid"] == ref.exemplar_count == len(utts)
    np.testing.assert_allclose(hist["history"], ref.log_prob_history, rtol=2e-4)
    np.testing.assert_allclose(leaves[2], np.asarray(ref.model.streams[0].means), rtol=2e-3, atol=2e-3)


def test_train_tied_mesh_matches_jax(got):
    from srhmm_tpu.models.tying import tie_from_models
    from srhmm_tpu.train.tied import train_tied

    start, utts, transcripts = _jax_start()
    tied0 = tie_from_models(start, w.TIE_MAP).astype(jnp.float32)
    ref = train_tied(tied0, utts, transcripts, threshold=-1.0, max_iterations=3, mesh=jmesh(4))
    hist, leaves = got["train_tied"]
    assert hist["iterations"] == ref.iterations and hist["num_valid"] == ref.exemplar_count == len(utts)
    np.testing.assert_allclose(hist["history"], ref.log_prob_history, rtol=2e-4)
    np.testing.assert_allclose(leaves[2], np.asarray(ref.model.senones.means), rtol=2e-3, atol=2e-3)
