"""The lattice kernels past 64 states against the JAX package, on the CPU.

Past 64 states csrc/lattice.cu runs its block-wide mode (one utterance a
block); the wrappers run their plain twins here.  The same numpy inputs go
through srhmm_tpu's Pallas kernels in interpret mode at S = 65, 96 and 130
(banded and dense, rows of length 0 and 1, -inf entries of log b):
forward_lattice and its blocked form against forward_lattice_pallas(_blocked),
backward_lattice(_blocked) against backward_lattice_pallas(_blocked),
log_forward_batch (shared and per-row transitions) against
log_forward_batch_pallas, viterbi_batch against viterbi_batch_pallas:
per element max |port - jax| / max(|jax|, 1) <= 1e-5 with equal masks of
values above NEG_INF/2 (tests/test_pallas_kernels.py's float32 bound for
these kernels), backpointers and backtraces equal, a duplicated-state tie
going to the lowest source.  e_step_lane_major(lattices="pallas") at S = 96
against JAX's (rtol 2e-3, atol 2e-4 max, log prob rtol 1e-5: the fused
float32 statistics bound of tests/test_pallas_kernels.py).  The
block-wide launch shape (_wide_block) at every S of
torch_port_utils.WIDE_LATTICE_CASES and beyond, its shared memory re-derived
here from csrc/lattice.cu's block_floats; the wrappers' refusal past
MAX_STATES on meta tensors.  The CUDA kernels are held against the twins on
the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srhmm_tpu.ops.pallas.forward_pallas as jf
import srhmm_tpu.ops.pallas.lattice_pallas as jl
import srhmm_tpu.train.em as j_em
import srhmm_tpu_torch.train.em as t_em
from srhmm_tpu.io.dataset import pack_utterances as j_pack
from srhmm_tpu_torch.io.dataset import pack_utterances as t_pack
from srhmm_tpu_torch.ops.kernels import forward as kf
from srhmm_tpu_torch.ops.kernels import lattice as kl
from torch_port_utils import (
    WIDE_LATTICE_CASES,
    assert_log_close,
    both_models,
    lattice_ranges,
    log_trans_np,
    rand_word,
)

LENS = (40, 33, 9, 1, 0)
CASES = [(65, "delta1"), (96, "dense"), (130, "delta2"), (130, "dense")]


def _inputs(S, kind, T=40, seed=0):
    rng = np.random.default_rng(seed + S)
    lb = (rng.normal(size=(T, S, len(LENS))) * 2).astype(np.float32)
    idx = rng.integers(0, [T, S, len(LENS)], size=(5, 3))
    lb[idx[:, 0], idx[:, 1], idx[:, 2]] = -np.inf
    return lb, log_trans_np(S, kind, seed=S), np.asarray(LENS, np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _j(x):
    return jnp.asarray(x)


@pytest.mark.parametrize("S,kind", CASES)
def test_lattices_match_pallas_past_64_states(S, kind):
    lb, lt, lens = _inputs(S, kind)
    fwd = kl.forward_lattice(_t(lb), _t(lt), _t(lens)).numpy()
    bwd = kl.backward_lattice(_t(lb), _t(lt), _t(lens)).numpy()
    assert_log_close(fwd, np.asarray(jl.forward_lattice_pallas(_j(lb), _j(lt), _j(lens), interpret=True)))
    assert_log_close(bwd, np.asarray(jl.backward_lattice_pallas(_j(lb), _j(lt), _j(lens), interpret=True)))
    if kind == "delta1":  # the time-blocked forms, once
        assert_log_close(kl.forward_lattice_blocked(_t(lb), _t(lt), _t(lens), k_block=8).numpy(), np.asarray(
            jl.forward_lattice_pallas_blocked(_j(lb), _j(lt), _j(lens), k_block=8, interpret=True)))
        assert_log_close(kl.backward_lattice_blocked(_t(lb), _t(lt), _t(lens), k_block=8).numpy(), np.asarray(
            jl.backward_lattice_pallas_blocked(_j(lb), _j(lt), _j(lens), k_block=8, interpret=True)))


@pytest.mark.parametrize("S,kind", CASES)
def test_forward_batch_and_viterbi_match_pallas_past_64_states(S, kind):
    lb, lt, lens = _inputs(S, kind, seed=7)
    lb = np.ascontiguousarray(lb.transpose(2, 0, 1))  # (B, T, S)
    got = kf.log_forward_batch(_t(lb), _t(lt), _t(lens)).numpy()
    assert_log_close(got, np.asarray(jf.log_forward_batch_pallas(_j(lb), _j(lt), _j(lens), interpret=True)))
    rows = np.stack([log_trans_np(S, ("delta1", "dense")[b % 2], seed=b) for b in range(len(LENS))])
    got = kf.log_forward_batch(_t(lb), _t(rows), _t(lens)).numpy()
    assert_log_close(got, np.asarray(jf.log_forward_batch_pallas(_j(lb), _j(rows), _j(lens), interpret=True)))
    scores, bptr = kf.viterbi_batch(_t(lb), _t(lt), _t(lens))
    j_scores, j_bptr = jf.viterbi_batch_pallas(_j(lb), _j(lt), _j(lens), interpret=True)
    assert_log_close(scores.numpy(), np.asarray(j_scores))
    np.testing.assert_array_equal(bptr.numpy(), np.asarray(j_bptr))
    np.testing.assert_array_equal(kf.backtrace(bptr, _t(lens), S - 1).numpy(),
                                  np.asarray(jf.backtrace(j_bptr, _j(lens), S - 1)))


def test_viterbi_tie_goes_to_the_lowest_source_past_64_states():
    """States 40 and 41 duplicated (their transitions and log b): every
    candidate from them ties exactly, and the lower one wins, as in JAX."""
    S, T = 96, 30
    rng = np.random.default_rng(5)
    p = rng.uniform(0.1, 1.0, size=(S, S))
    p[41, :] = p[40, :]
    p[:, 41] = p[:, 40]
    lt = np.log(p / p.sum(-1, keepdims=True)).astype(np.float32)
    lb = (rng.normal(size=(3, T, S)) * 2).astype(np.float32)
    lb[..., 41] = lb[..., 40]
    lens = np.asarray([T, 17, 2], np.int32)
    _, bptr = kf.viterbi_batch(_t(lb), _t(lt), _t(lens))
    _, j_bptr = jf.viterbi_batch_pallas(_j(lb), _j(lt), _j(lens), interpret=True)
    np.testing.assert_array_equal(bptr.numpy(), np.asarray(j_bptr))
    assert (bptr.numpy()[:, 1:] == 40).any() and not (bptr.numpy()[0, 1:] == 41).any()


def test_lane_major_pallas_lattices_match_jax_past_64_states():
    """e_step_lane_major(lattices="pallas") on a 32-unit left-right chain of
    S = 96 states (the align_s96 shape, cut to 4 utterances) against JAX's,
    float32.  At 96 states either package's float32 statistics stray from
    float64 by up to 1.3e-3 of their scale (both alike), past
    tests/test_em_fast.py's 2e-4 for S = 5; the bound is the one
    tests/test_pallas_kernels.py holds fused float32 statistics to: rtol
    2e-3, atol 2e-4 max |jax|."""
    jm, tm = both_models(*rand_word(11, 96, [(1, 3)], "diag", 1))
    jm, tm = jm.astype(jnp.float32), tm.astype(torch.float32)
    rng = np.random.default_rng(12)
    utts = [rng.normal(size=(n, 3)) for n in (120, 97, 100, 131)]
    jb = j_pack(utts, pad_multiple=16, dtype=jnp.float32)
    tb = t_pack(utts, pad_multiple=16, dtype=torch.float32)
    ref = j_em.e_step_lane_major(jm, jb, lattices="pallas")
    got = t_em.e_step_lane_major(tm, tb, lattices="pallas")
    pairs = [(getattr(got, n).numpy(), np.asarray(getattr(ref, n))) for n in ("num_trans", "den_trans", "den_mix")]
    pairs += [(getattr(gs, n).numpy(), np.asarray(getattr(rs, n)))
              for gs, rs in zip(got.streams, ref.streams) for n in ("w", "x", "xx")]
    for a, b in pairs:
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4 * max(np.abs(b).max(), 1.0))
    np.testing.assert_allclose(float(got.log_prob), float(ref.log_prob), rtol=1e-5)
    assert float(got.num_valid) == float(ref.num_valid)


def _block_floats(kind, S, TT, layout, lt_cap):
    """csrc/lattice.cu block_floats, written out again: rows 2 S, log b two
    slots, the output two slots, 2 S + 1 ints, each rounded up to 4, and
    the transitions."""
    r4 = lambda n: -(-n // 4) * 4  # noqa: E731
    run = r4(TT * S) + 4  # forward_run_pitch: a run of TT S floats at a pitch rounded up to 4, + 4
    if kind == "backward":
        tile, out = r4(TT * S), r4(TT * S)
    elif kind == "viterbi":
        tile, out = run, run
    else:
        tile, out = (r4(TT * S), r4(TT * S)) if layout == "tsb" else (run, 0)
    return r4(2 * S) + 2 * tile + 2 * out + r4(2 * S + 1) + lt_cap


def test_wide_block_shapes_mirror_the_kernel():
    """Every S of 65-4096 the block-wide shapes take: S rounded up to whole
    warps (at most 512) recursion threads of at most 8 states each, a tile
    of FORWARD_TILES, lt_cap a multiple of 4 within S S rounded up, shared
    memory as csrc/lattice.cu computes it and within a block's limit; the
    dense matrix packs wherever it fits beside the largest tile; past
    MAX_STATES every rule refuses."""
    for S in sorted({65, 66, 95, 96, 127, 128, 129, 257, 511, 512, 513, 1024, 2048, 4095, 4096}
                    | {c[0] for c in WIDE_LATTICE_CASES}):
        shapes = {("forward", "tsb"): kl.forward_block(S, 37, "tsb"),
                  ("forward", "bts"): kl.forward_block(S, 37, "bts", per_row=True),
                  ("backward", "tsb"): kl.backward_block(S, 37),
                  ("viterbi", "bts"): kl.viterbi_block(S, 37)}
        for (kind, layout), sh in shapes.items():
            rec, TT, cap = sh["rec_threads"], sh["tile"], sh["lt_cap"]
            assert rec == min(512, -(-S // 32) * 32) and sh["states_per_thread"] == -(-S // rec) <= 8
            assert (sh["utts"], sh["utts_per_warp"], sh["blocks"]) == (1, 0, 37) and TT in kl.FORWARD_TILES
            assert cap % 4 == 0 and 0 < cap <= -(-S * S // 4) * 4
            assert sh["smem_bytes"] == 4 * _block_floats(kind, S, TT, layout, cap) <= kl.SMEM_LIMIT
            if 4 * _block_floats(kind, S, kl.FORWARD_TILES[0], layout, -(-S * S // 4) * 4) <= kl.SMEM_LIMIT:
                assert TT == kl.FORWARD_TILES[0] and cap >= S * S
    for rule in (lambda S: kl.forward_block(S, 1, "tsb"), lambda S: kl.backward_block(S, 1),
                 lambda S: kl.viterbi_block(S, 1)):
        with pytest.raises(ValueError, match="4096"):
            rule(kl.MAX_STATES + 1)


@pytest.mark.parametrize("i", range(len(WIDE_LATTICE_CASES)))
def test_wide_cases_reach_their_transition_placement(i):
    """Where each case of WIDE_LATTICE_CASES keeps its transitions: packed in
    shared memory where the widest range times S fits lt_cap, else read
    through L2; the set reaches both, banded and dense."""
    S, kind, B, T = WIDE_LATTICE_CASES[i]
    lt = log_trans_np(S, kind, seed=S)
    for sh, rows in ((kl.forward_block(S, B, "tsb"), False), (kl.backward_block(S, B), True),
                     (kl.viterbi_block(S, B), False)):
        W = int(lattice_ranges(lt, rows).max())
        assert W == (S if kind == "dense" else {"delta1": 2, "delta2": 3}[kind])
        packed = W * S <= sh["lt_cap"]
        assert packed == (kind != "dense" or S <= 127), (S, kind, W, sh["lt_cap"])


def test_wrappers_take_past_64_states_and_refuse_past_the_bound():
    meta = dict(device="meta", dtype=torch.float32)
    lens = torch.empty((37,), device="meta", dtype=torch.int32)
    for S in (65, 4096):
        ln = kl.LatticeLaunch("log_forward_batch", torch.empty((37, 95, S), **meta),
                              torch.empty((37, S, S), **meta), lens, "bts", per_row_ok=True)
        assert (ln.B, ln.T, ln.S, ln.per_row) == (37, 95, S, 1)
    S = kl.MAX_STATES + 1
    for layout, shape in (("tsb", (95, S, 37)), ("bts", (37, 95, S))):
        with pytest.raises(ValueError, match="4096 states"):
            kl.LatticeLaunch("forward_lattice", torch.empty(shape, **meta), torch.empty((S, S), **meta), lens, layout)
