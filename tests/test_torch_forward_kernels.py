"""The batched forward / Viterbi kernel module against the JAX package, on
the CPU.

log_forward_batch (TPU kernel #15, shared (S, S) and per-row (B, S, S)
transitions) and viterbi_batch (#16) run their plain twins here; the same
numpy inputs go through srhmm_tpu's Pallas kernels in interpret mode:
scores max |port - jax| / max(|jax|, 1) <= 1e-5 with equal masks of values
above NEG_INF/2, backpointers and backtrace paths equal.  Zero-length and
length-1 rows are included, S = 33 and 64 for the Viterbi (two states a
lane of the CUDA kernel), and a tie case (two identical states) where the
backpointers must be identical (ties go to the lowest source).  The
twins also hold srhmm_tpu's float64 log_forward / viterbi to 1e-4 and the
paths exactly, as tests/test_pallas_kernels.py:42-81 holds the Pallas
kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srhmm_tpu.ops.pallas.forward_pallas as jf
from srhmm_tpu.models import init_left_right_trans as j_init_trans
from srhmm_tpu.ops import log_forward as j_log_forward
from srhmm_tpu.ops import viterbi as j_viterbi
from srhmm_tpu_torch.ops.kernels import forward as kf
from torch_port_utils import assert_log_close, log_trans_np

LENS = (48, 40, 25, 1, 0)


def _log_b(B, T, S, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(B, T, S)) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _j(x):
    return jnp.asarray(x)


@pytest.mark.parametrize("kind", ["delta1", "delta2", "dense"])
def test_log_forward_batch_shared_matches_pallas(kind):
    S, T = 8, 48
    lb = _log_b(len(LENS), T, S, seed=1)
    lt = log_trans_np(S, kind, seed=3)
    lens = np.asarray(LENS, np.int32)
    got = kf.log_forward_batch(_t(lb), _t(lt), _t(lens)).numpy()
    want = np.asarray(jf.log_forward_batch_pallas(_j(lb), _j(lt), _j(lens), interpret=True))
    assert got.shape == (len(LENS), S)
    assert_log_close(got, want)


def test_log_forward_batch_per_row_matches_pallas():
    """Per-row transitions (vocabulary scoring: every (utterance, word) row
    its own matrix)."""
    S, T, B = 6, 40, 7
    lb = _log_b(B, T, S, seed=2)
    lt = np.stack([log_trans_np(S, ("delta1", "delta2", "dense")[b % 3], seed=b) for b in range(B)])
    lens = np.asarray([40, 33, 12, 1, 0, 40, 7], np.int32)
    got = kf.log_forward_batch(_t(lb), _t(lt), _t(lens)).numpy()
    want = np.asarray(jf.log_forward_batch_pallas(_j(lb), _j(lt), _j(lens), interpret=True))
    assert_log_close(got, want)
    # each row equals the shared-transition call on that row alone
    for b in (0, 2):
        one = kf.log_forward_batch(_t(lb[b : b + 1]), _t(lt[b]), _t(lens[b : b + 1])).numpy()
        np.testing.assert_array_equal(got[b : b + 1], one)


@pytest.mark.parametrize("S", [33, 64])
def test_log_forward_batch_per_row_matches_pallas_past_32_states(S):
    """Per-row transitions past 32 states (two states a lane of the CUDA
    kernel, the block's matrices in shared memory): the twin against the
    Pallas kernel."""
    T, B = 40, 5
    lb = _log_b(B, T, S, seed=S)
    lt = np.stack([log_trans_np(S, ("delta1", "delta2", "dense")[b % 3], seed=b) for b in range(B)])
    lens = np.asarray([40, 17, 1, 0, 33], np.int32)
    got = kf.log_forward_batch(_t(lb), _t(lt), _t(lens)).numpy()
    want = np.asarray(jf.log_forward_batch_pallas(_j(lb), _j(lt), _j(lens), interpret=True))
    assert_log_close(got, want)


def test_log_forward_batch_matches_the_jax_scan():
    """The twin against srhmm_tpu's float64 log_forward (mirrors
    tests/test_pallas_kernels.py::test_forward_kernel_matches_scan)."""
    B, T, S = 4, 64, 8
    lb = _log_b(B, T, S, seed=1)
    trans = np.asarray(j_init_trans(S), np.float32)
    with np.errstate(divide="ignore"):
        lt = np.where(trans > 0, np.log(np.maximum(trans, 1e-30)), -np.inf).astype(np.float32)
    lens = np.asarray([64, 50, 33, 1], np.int32)
    out = kf.log_forward_batch(_t(lb), _t(lt), _t(lens)).numpy()
    for i in range(B):
        ref = np.asarray(j_log_forward(_j(lb[i]).astype(jnp.float64), _j(lt).astype(jnp.float64), int(lens[i])))
        fin = np.isfinite(ref)
        np.testing.assert_allclose(out[i][fin], ref[fin], rtol=1e-4, atol=1e-4)
        assert (out[i][~fin] < -1e29).all()


@pytest.mark.parametrize("kind", ["delta1", "delta2", "dense"])
def test_viterbi_batch_matches_pallas(kind):
    S, T = 6, 48
    lb = _log_b(len(LENS), T, S, seed=4, scale=2.0)
    lt = log_trans_np(S, kind, seed=5)
    lens = np.asarray(LENS, np.int32)
    scores, bptr = kf.viterbi_batch(_t(lb), _t(lt), _t(lens))
    j_scores, j_bptr = jf.viterbi_batch_pallas(_j(lb), _j(lt), _j(lens), interpret=True)
    assert bptr.dtype == torch.int32 and tuple(bptr.shape) == (len(LENS), T, S)
    assert_log_close(scores.numpy(), np.asarray(j_scores))
    np.testing.assert_array_equal(bptr.numpy(), np.asarray(j_bptr))
    paths = kf.backtrace(bptr, _t(lens), S - 1).numpy()
    np.testing.assert_array_equal(paths, np.asarray(jf.backtrace(j_bptr, _j(lens), S - 1)))


@pytest.mark.parametrize("S", [33, 64])
def test_viterbi_batch_matches_pallas_past_32_states(S):
    """Past 32 states a lane of the CUDA Viterbi kernel holds two states
    (the transitions in shared memory, the best source by a strict > over
    64 slots): the twin there against the Pallas kernel, scores, backpointers
    and backtraces."""
    T, B = 40, 5
    lb = _log_b(B, T, S, seed=40 + S, scale=2.0)
    lt = log_trans_np(S, "dense" if S == 33 else "delta2", seed=S)
    lens = np.asarray([40, 33, 9, 1, 0], np.int32)
    scores, bptr = kf.viterbi_batch(_t(lb), _t(lt), _t(lens))
    j_scores, j_bptr = jf.viterbi_batch_pallas(_j(lb), _j(lt), _j(lens), interpret=True)
    assert_log_close(scores.numpy(), np.asarray(j_scores))
    np.testing.assert_array_equal(bptr.numpy(), np.asarray(j_bptr))
    paths = kf.backtrace(bptr, _t(lens), S - 1).numpy()
    np.testing.assert_array_equal(paths, np.asarray(jf.backtrace(j_bptr, _j(lens), S - 1)))


def test_viterbi_ties_go_to_the_lowest_source():
    """States 1 and 2 are duplicates (equal log b columns, equal rows and
    columns of the transitions): every candidate pair from them ties
    exactly, and both packages pick state 1."""
    S, T = 5, 40
    rng = np.random.default_rng(6)
    p = rng.uniform(0.1, 1.0, size=(S, S))
    p[2, :] = p[1, :]
    p[:, 2] = p[:, 1]
    lt = np.log(p / p.sum(-1, keepdims=True)).astype(np.float32)
    lb = _log_b(len(LENS), T, S, seed=7, scale=2.0)
    lb[..., 2] = lb[..., 1]
    lens = np.asarray((40, 33, 12, 1, 0), np.int32)
    scores, bptr = kf.viterbi_batch(_t(lb), _t(lt), _t(lens))
    j_scores, j_bptr = jf.viterbi_batch_pallas(_j(lb), _j(lt), _j(lens), interpret=True)
    bp = bptr.numpy()
    np.testing.assert_array_equal(bp, np.asarray(j_bptr))
    assert_log_close(scores.numpy(), np.asarray(j_scores))
    # past frame 0, no destination ever takes source 2 (it ties source 1)
    live = np.arange(T)[None, :] < lens[:, None]
    live[:, 0] = False
    assert (bp[live] != 2).all() and (bp[live] == 1).any()


def test_backtrace_and_scores_match_the_jax_viterbi():
    """Mirrors tests/test_pallas_kernels.py::test_viterbi_kernel_matches_reference:
    the final-state score and the path against srhmm_tpu's float64
    viterbi."""
    B, T, S = 3, 48, 6
    lb = _log_b(B, T, S, seed=2)
    trans = np.asarray(j_init_trans(S, delta=2), np.float32)
    with np.errstate(divide="ignore"):
        lt = np.where(trans > 0, np.log(np.maximum(trans, 1e-30)), -np.inf).astype(np.float32)
    lens = np.asarray([48, 40, 25], np.int32)
    scores, bptr = kf.viterbi_batch(_t(lb), _t(lt), _t(lens))
    paths = kf.backtrace(bptr, _t(lens), S - 1).numpy()
    for i in range(B):
        ref_score, ref_path = j_viterbi(_j(lb[i]).astype(jnp.float64), _j(lt).astype(jnp.float64), int(lens[i]))
        np.testing.assert_allclose(scores[i, S - 1].item(), float(ref_score), rtol=1e-4)
        L = int(lens[i])
        np.testing.assert_array_equal(paths[i][:L], np.asarray(ref_path)[:L])


def test_cpu_tensors_run_the_twins():
    lb = _log_b(2, 8, 4, seed=1)
    lt = log_trans_np(4, "delta1")
    lens = np.asarray([8, 3], np.int32)
    before = kf.log_forward_batch.launches, kf.viterbi_batch.launches
    kf.log_forward_batch(_t(lb), _t(lt), _t(lens))
    kf.viterbi_batch(_t(lb), _t(lt), _t(lens))
    assert (kf.log_forward_batch.launches, kf.viterbi_batch.launches) == before
    with pytest.raises(ValueError, match="no implementation"):
        kf.log_forward_batch(torch.empty((2, 8, 4), device="meta"), _t(lt), _t(lens))
