"""Time-axis sequence parallelism of srhmm_tpu_torch/parallel/sequence.py
and log_forward_assoc against srhmm_tpu (CPU).

One group of 4 gloo ranks (spawned, file rendezvous, killed after
torch_dist_workers.TIMEOUT_S) runs torch_dist_workers.py sequence_cases;
rank 0's lattices, statistics and trajectories are held against the JAX
package's single-device functions at tests/test_sequence_parallel.py's
bounds: lattices rtol / atol 1e-9 (the -inf positions equal), scores rtol
1e-12, e_step_time_sharded against e_step rtol 1e-9 / atol 1e-12 (float64;
lengths that end on a block edge, inside a middle block and inside the
first one), train_fast(time_mesh=) the same trajectory, the float32 scan
against its per-step loop (histories rtol 1e-6, models rtol 2e-5 / atol
1e-5).  log_forward_assoc (no ranks) against JAX's at rtol 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as w
from srhmm_tpu.io.dataset import pack_utterances
from srhmm_tpu.ops.forward_backward import (
    log_backward_full,
    log_forward_assoc,
    log_forward_full,
    score_final_state,
    score_total,
)
from srhmm_tpu_torch.ops.forward_backward import log_forward_assoc as t_log_forward_assoc
from srhmm_tpu_torch.parallel import distributed
from torch_port_utils import jax_model, leaves_jax


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return distributed.spawn(w.sequence_cases, 4, device="cpu", timeout_s=w.TIMEOUT_S,
                             workdir=tmp_path_factory.mktemp("sequence"))


@pytest.fixture(scope="module")
def got(ranks):
    return ranks[0]


def assert_lattice(got_l, ref):
    ref = np.asarray(ref)
    assert got_l.shape == ref.shape
    assert ((ref == -np.inf) == (got_l == -np.inf)).all()
    f = np.isfinite(ref)
    np.testing.assert_allclose(got_l[f], ref[f], rtol=1e-9, atol=1e-9)


def test_forward_and_backward_match_jax(got):
    lb, lt = w.sequence_problem(0, 160, 6)
    assert_lattice(got["forward"], log_forward_full(jnp.asarray(lb), jnp.asarray(lt)))
    lb, lt = w.sequence_problem(1, 160, 6)
    assert_lattice(got["backward"], log_backward_full(jnp.asarray(lb), jnp.asarray(lt)))


def test_padding_semantics_and_scores(got):
    lb, lt = w.sequence_problem(2, 131, 5)
    lb_pad = jnp.pad(jnp.asarray(lb), ((0, 160 - 131), (0, 0)))
    ref_a = log_forward_full(lb_pad, jnp.asarray(lt), jnp.asarray(131))
    ref_b = log_backward_full(lb_pad, jnp.asarray(lt), jnp.asarray(131))
    got_a, got_b = got["padded"]
    assert_lattice(got_a, ref_a)
    assert_lattice(got_b, ref_b)
    np.testing.assert_allclose(float(score_total(jnp.asarray(got_a[-1]))), float(score_total(ref_a[-1])),
                               rtol=1e-12)
    np.testing.assert_allclose(float(score_final_state(jnp.asarray(got_a[-1]))),
                               float(score_final_state(ref_a[-1])), rtol=1e-12)


def test_batched_lengths_across_blocks(got):
    """Rows whose lengths end on the last frame, inside the last block,
    inside the first block and on frame 1."""
    lb, lt = w.sequence_problem(6, 160, 6, B=4)
    got_a, got_b = got["batched"]
    for i, n in enumerate((160, 131, 17, 1)):
        assert_lattice(got_a[i], log_forward_full(jnp.asarray(lb[i]), jnp.asarray(lt), jnp.asarray(n)))
        assert_lattice(got_b[i], log_backward_full(jnp.asarray(lb[i]), jnp.asarray(lt), jnp.asarray(n)))


def test_indivisible_time_axis_raises(ranks):
    assert all(r["indivisible_raises"] for r in ranks)


def test_e_step_time_sharded_matches_jax(ranks):
    from srhmm_tpu.train.em import e_step

    trans, streams, utts = w.sequence_toy()
    ref = e_step(jax_model(trans, streams), pack_utterances(utts, pad_multiple=96, dtype=jnp.float64))
    want = {k: np.asarray(getattr(ref, k)) for k in w.STAT_NAMES}
    want.update({"w0": np.asarray(ref.streams[0].w), "x0": np.asarray(ref.streams[0].x),
                 "xx0": np.asarray(ref.streams[0].xx)})
    for r in ranks:  # every rank holds the whole statistics
        assert set(r["e_step"]) == set(want)
        for k, a in want.items():
            np.testing.assert_allclose(r["e_step"][k], a, rtol=1e-9, atol=1e-12, err_msg=k)


def test_train_fast_time_mesh_trajectory_matches_jax(got):
    from srhmm_tpu.train.em import train_fast

    trans, streams, utts = w.sequence_toy(seed=5, lengths=w.SEQ_LENGTHS[:3])
    ref = train_fast(jax_model(trans, streams), pack_utterances(utts, pad_multiple=96, dtype=jnp.float64),
                     max_iterations=4)
    hist, leaves = got["train_fast"]
    assert hist["iterations"] == ref.iterations
    np.testing.assert_allclose(hist["history"], ref.log_prob_history, rtol=1e-9)
    for a, b in zip(leaves_jax(ref.model), leaves):
        np.testing.assert_allclose(b, a, rtol=1e-8, atol=1e-10)


def test_time_sharded_scan_matches_per_iteration_loop(got):
    lps, lps_loop, final, loop_final, sp, sp_mean, sd, sd_mean = got["scan"]
    np.testing.assert_allclose(lps, lps_loop, rtol=1e-6)
    for a, b in zip(final, loop_final):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=2e-5, atol=1e-5)
    assert sp["iterations"] == sd["iterations"]
    np.testing.assert_allclose(sp_mean, sd_mean, rtol=1e-4)


@pytest.mark.parametrize("T,lengths", [(1, None), (2, None), (37, None), (64, [64, 40, 1, 33])])
def test_log_forward_assoc_matches_jax(T, lengths):
    lb, lt = w.sequence_problem(7 + T, T, 5, B=None if lengths is None else len(lengths))
    if lengths is None:
        ref = np.asarray(log_forward_assoc(jnp.asarray(lb), jnp.asarray(lt)))
        got_l = t_log_forward_assoc(torch.as_tensor(lb), torch.as_tensor(lt)).numpy()
    else:
        ref = np.stack([np.asarray(log_forward_assoc(jnp.asarray(lb[i]), jnp.asarray(lt), jnp.asarray(n)))
                        for i, n in enumerate(lengths)])
        got_l = t_log_forward_assoc(torch.as_tensor(lb), torch.as_tensor(lt), torch.as_tensor(lengths)).numpy()
    assert got_l.shape == ref.shape
    assert ((ref == -np.inf) == (got_l == -np.inf)).all()
    f = np.isfinite(ref)
    np.testing.assert_allclose(got_l[f], ref[f], rtol=1e-10)
    # and the recursion's final row, which the associative form must equal
    from srhmm_tpu_torch.ops.forward_backward import log_forward

    seq = log_forward(torch.as_tensor(lb), torch.as_tensor(lt),
                      None if lengths is None else torch.as_tensor(lengths)).numpy()
    np.testing.assert_allclose(got_l[f], seq[f], rtol=1e-10)

