"""Full covariance past D = 16 in the E-step and composed kernels, against
the JAX package, on the CPU.

csrc/fused_em.cu (#2-#5) and csrc/composed.cu (#9, #12 / #13) take full
covariance up to the compiled bound D = 64; here the wrappers run their
plain twins.  e_step_fused_lane(_multi) (emit_forward_plain and
backward_stats_plain) against srhmm_tpu's e_step_fused_lane(_multi) with
its Pallas kernels in interpret mode, and the composed batch_stats_fused
(the bank twins) against srhmm_tpu's batch_stats_fused (interpret), at
full D = 20 and 39: every statistic rtol 2e-3, atol 2e-4 max |jax| (the
fused float32 statistics bound of tests/test_pallas_kernels.py), log prob
rtol 1e-5.  The shape rules at every case of
torch_port_utils.EM_FULL_WIDE_CASES / BANK_FULL_WIDE_CASES: fused_em.fits
and composed.fused_eligible take them, the backward-stats block keeps its
constants in device memory and its accumulators in the partials exactly
where csrc/fused_em.cu's backward_floats (written out again here) puts
them past shared memory, the bank kernels' z-GEMM blocks take the shared
memory csrc/composed.cu reckons (written out again), whatever M, and the
sets reach each of their launch shapes; the wrappers' own checks on meta
tensors take D = 64 and refuse D = 65.  At the bank cases that reach a
padded n tile, two streams of different mixture groups and one mixture,
the composed batch_stats_fused twins against JAX's as above.  The CUDA kernels are held
against the twins on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srhmm_tpu.models as jm
import srhmm_tpu.train.em as j_em
import srhmm_tpu.train.embedded as je
import srhmm_tpu_torch.models as tmods
import srhmm_tpu_torch.train.em as t_em
import srhmm_tpu_torch.train.embedded as te
from srhmm_tpu.io.dataset import pack_utterances as j_pack
from srhmm_tpu_torch.io.dataset import UtteranceBatch
from srhmm_tpu_torch.ops.kernels import composed as kc
from srhmm_tpu_torch.ops.kernels import fused_em as fe
from torch_port_utils import (
    BANK_FULL_WIDE_CASES,
    BANK_WIDE_PLACEMENTS,
    EM_FULL_WIDE_CASES,
    bank_wide_placements,
    both_models,
    rand_word,
)

LENS = [21, 29, 0, 17, 1]
T = 29


def _stats_close(got, want):
    pairs = [(getattr(got, n).numpy(), np.asarray(getattr(want, n))) for n in ("num_trans", "den_trans", "den_mix")]
    pairs += [(getattr(g, n).numpy(), np.asarray(getattr(w, n)))
              for g, w in zip(got.streams, want.streams) for n in ("w", "x", "xx")]
    for a, b in pairs:
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4 * max(np.abs(b).max(), 1.0))
    np.testing.assert_allclose(float(got.log_prob), float(want.log_prob), rtol=1e-5)
    assert float(got.num_valid) == float(want.num_valid)


@pytest.mark.parametrize("mixes_dims", [[(2, 20)], [(2, 39)]])
def test_fused_e_step_matches_jax_at_wide_full_covariance(mixes_dims):
    """Odd B (5) and T (29), a zero-length and a length-1 row; S = 4,
    band 1 (two streams run on the card: chip_smoke.py kernel_em_wide)."""
    _, streams = rand_word(3, 4, mixes_dims, "full", scale=2.0)
    trans = np.zeros((4, 4))
    for i in range(4):
        trans[i, i : i + 2] = (0.6, 0.4) if i < 3 else (1.0,)
    jmod, tmod = both_models(trans, streams)
    jmod, tmod = jmod.astype(jnp.float32), tmod.astype(torch.float32)
    rng = np.random.default_rng(8)
    bj, bt = [], []
    for _, D in mixes_dims:
        feats = (rng.normal(size=(len(LENS), T, D)) * 2).astype(np.float32)
        bj.append(j_pack([f for f in feats], pad_multiple=1, dtype=jnp.float32).replace(
            lengths=jnp.asarray(LENS, jnp.int32)))
        bt.append(UtteranceBatch(torch.from_numpy(feats), torch.tensor(LENS, dtype=torch.int32)))
    if len(bt) == 1:
        want = j_em.e_step_fused_lane(jmod, bj[0], k_block=8, band=1, interpret=True)
        got = t_em.e_step_fused_lane(tmod, bt[0], band=1)
    else:
        want = j_em.e_step_fused_lane_multi(jmod, tuple(bj), k_block=8, band=1, interpret=True)
        got = t_em.e_step_fused_lane_multi(tmod, tuple(bt), band=1)
    _stats_close(got, want)


@pytest.mark.parametrize("D", [20, 39])
def test_composed_batch_stats_match_jax_at_wide_full_covariance(D):
    """Three units of S = 3 states, M = 2, transcripts of two units (one
    repeated), B = 4, T = 32: the port's batch_stats_fused (the bank and
    lattice twins) against the JAX package's (Pallas interpret mode)."""
    words = [rand_word(20 + i, 3, [(2, D)], "full", 1, scale=3.0) for i in range(3)]
    pairs = [both_models(*w, f"u{i}") for i, w in enumerate(words)]
    jmod = jm.stack_models([p[0] for p in pairs]).astype(jnp.float32)
    tmod = tmods.stack_models([p[1] for p in pairs]).astype(torch.float32)
    rng = np.random.default_rng(D)
    trs = np.asarray([[0, 0], [1, 2], [2, 1], [0, 2]], np.int32)
    feats = (rng.normal(size=(4, 32, D)) * 2).astype(np.float32)
    lens = np.asarray([32, 19, 6, 1], np.int32)
    want = je.batch_stats_fused(jmod, jnp.asarray(trs), jnp.asarray(feats), jnp.asarray(lens), k_block=8,
                                interpret=True)
    got = te.batch_stats_fused(tmod, torch.as_tensor(trs), torch.as_tensor(feats), torch.as_tensor(lens))
    _stats_close(got, want)


def _backward_floats(C, S, ds, ms, nslots, U, TT, warps, acc_global, consts_global):
    """csrc/fused_em.cu backward_floats + backward_ints in bytes, written out
    again: the constants (unless in device memory), a ring of three tiles
    of log-alpha, log b and the features, two gamma tiles, two exchange
    rows, xi past 8 slots, the weights (S max M, KS) and features (max D,
    KS), the accumulators (unless in the partials), the kept columns and
    the warps' counts."""
    nt, cols = S * U, TT * U
    ks = -(-cols // 8) * 8 + (4 if cols > 8 else 0)
    mom = sum(M * (D + D * D + 1) for D, M in zip(ds, ms))
    floats = ((0 if consts_global else C) + 3 * TT * U * (2 * S + sum(ds)) + 2 * TT * nt + 2 * nt
              + max(nslots - 8, 0) * nt + (S * max(ms) + max(ds)) * ks + (0 if acc_global else S * mom))
    return 4 * floats + 4 * (cols + warps)


@pytest.mark.parametrize("i", range(len(EM_FULL_WIDE_CASES)))
def test_em_kernels_take_every_wide_full_case(i):
    md = EM_FULL_WIDE_CASES[i]
    ms, ds = tuple(m for m, _ in md), tuple(d for _, d in md)
    for S, band in ((6, 1), (6, None), (8, 2)):
        assert fe.fits(ds, ms, True, S, band) and fe.refusal(ds, ms, True, S, band) is None
        dmax = fe.em_dmax(ds, True, "test")
        assert dmax == next(b for b in (32, 40, 64) if b >= max(ds))
        C = fe.constant_floats(ds, ms, True, S, dmax)
        nslots = S if band is None else band + 1
        U, TT, warps, acc_global, consts_global = fe.backward_shape(C, S, ds, ms, nslots, True)
        smem = _backward_floats(C, S, ds, ms, nslots, U, TT, warps, acc_global, consts_global)
        assert smem == fe.backward_smem_bytes(C, S, ds, ms, nslots, True, U, TT, warps, acc_global, consts_global)
        assert smem <= fe.SMEM_LIMIT
        # the constants leave shared memory only where no shape fits with them
        in_shared = [_backward_floats(C, S, ds, ms, nslots, u, tt, fe._backward_stat_warps(S, u), g, False)
                     for u in (16, 8, 4, 2, 1) for tt in fe.BACKWARD_TILES for g in (False, True)
                     if u <= max(1, min(16, 128 // S))]
        assert consts_global == (min(in_shared) > fe.SMEM_LIMIT)
        emit = fe.emit_block(S, 2048, C, ds, 132)
        assert fe.emit_smem_bytes(C, S, sum(ds), emit["utts"], emit["tile"], emit["consts_global"]) <= fe.SMEM_LIMIT
    # the set reaches the records past shared memory and the accumulators in the partials
    if md in ([(16, 39)], [(4, 64)]):
        C = fe.constant_floats(ds, ms, True, 6, fe.em_dmax(ds, True, "test"))
        assert fe.backward_shape(C, 6, ds, ms, 2, True)[3:] == (True, True)


# shared memory an SM offers blocks (228 KB), and what it keeps a block (1 KB)
_SM_SMEM, _BLOCK_RESERVED = 233472, 1024


def _wide_bytes(D, which):
    """csrc/composed.cu wide_emission_floats (which 0) and wide_moments_floats
    / wide_moments_ints (1) in bytes, written out again: the features of 128
    frames at pitch RB + 4, two slices of two mixtures (RB rows of L^T at
    that pitch, c, bias and log w) and their q; then the 8 mixtures'
    weights (pitch 132), 36 queued gamma tiles of 32, and as ints the lift
    table (16 a m tile), the queue, the votes and the chunk's 16 pairs."""
    rb = next(b for b in (24, 32, 40, 48, 64) if b >= -(-D // 4) * 4)
    floats = 128 * (rb + 4) + 2 * 2 * (rb * (rb + 4) + rb + 4 + 128)
    if which == 0:
        return 4 * floats
    rows = D + D * (D + 1) // 2 + 1
    return 4 * (floats + 8 * 132 + 36 * 32) + 4 * (16 * -(-rows // 16) + 2 * 36 + 2 * 8 + 4 * 16 + 1)


@pytest.mark.parametrize("i", range(len(BANK_FULL_WIDE_CASES)))
def test_bank_kernels_take_every_wide_full_case(i):
    """Every case rides the z-GEMM blocks: fused_eligible, the moments'
    shape (4 tiles a batch, records and accumulators on the chip) and both
    blocks' shared memory as csrc/composed.cu reckons it, within
    SMEM_LIMIT whatever M; two blocks of each an SM at (8, 39)."""
    md = BANK_FULL_WIDE_CASES[i]
    mixes, D = [m for m, _ in md], md[0][1]
    feats = types.SimpleNamespace(device=torch.device("cuda"), dtype=torch.float32, shape=(512, 512, D))
    assert kc.fused_eligible(feats, ["full"] * len(mixes), [D] * len(mixes), mixes, 3, 36, 512)
    assert kc.wide_full(D, True) and kc.moments_shape(mixes, D, True) == (kc.WIDE_TILES, False, False)
    for which in (0, 1):
        assert kc.wide_smem_bytes(D, which) == _wide_bytes(D, which) <= kc.SMEM_LIMIT
    assert kc.moments_smem_bytes(mixes, D, True) == _wide_bytes(D, 1)
    assert kc.moments_smem_bytes(mixes * 100, D, True) == _wide_bytes(D, 1)  # no growth with M
    if md == [(8, 39)]:
        assert all(2 * (_wide_bytes(D, w) + _BLOCK_RESERVED) <= _SM_SMEM for w in (0, 1))


def test_the_wide_sets_reach_every_placement():
    """Every launch shape of the z-GEMM blocks (torch_port_utils
    BANK_WIDE_PLACEMENTS: every full register bound 24-64, two streams of
    different M and groups, one and several slices, a partial slice, one to
    three mixture groups, the n tile whole and padded) is reached by
    BANK_FULL_WIDE_CASES, and every E-step bound 32, 40, 64 by
    EM_FULL_WIDE_CASES."""
    reached = set().union(*(bank_wide_placements(md) for md in BANK_FULL_WIDE_CASES))
    assert reached == BANK_WIDE_PLACEMENTS
    assert {fe.em_dmax([d for _, d in md], True, "t") for md in EM_FULL_WIDE_CASES} == {32, 40, 64}


@pytest.mark.parametrize("mixes_dims", [[(9, 39)], [(9, 17), (2, 17)], [(1, 45)]])
def test_composed_batch_stats_match_jax_at_new_bank_wide_cases(mixes_dims):
    """The composed batch_stats_fused (the bank and lattice twins) against
    the JAX package's (Pallas interpret mode) at the cases of
    BANK_FULL_WIDE_CASES that reach a padded n tile of 9 mixtures, two
    streams of different mixture groups and one mixture: three units of
    S = 3, B = 4, T = 32."""
    D = mixes_dims[0][1]
    words = [rand_word(60 + i, 3, mixes_dims, "full", 1, scale=3.0) for i in range(3)]
    pairs = [both_models(*w, f"u{i}") for i, w in enumerate(words)]
    jmod = jm.stack_models([p[0] for p in pairs]).astype(jnp.float32)
    tmod = tmods.stack_models([p[1] for p in pairs]).astype(torch.float32)
    rng = np.random.default_rng(D + len(mixes_dims))
    trs = np.asarray([[0, 0], [1, 2], [2, 1], [0, 2]], np.int32)
    feats = (rng.normal(size=(4, 32, D)) * 2).astype(np.float32)
    lens = np.asarray([32, 19, 6, 1], np.int32)
    want = je.batch_stats_fused(jmod, jnp.asarray(trs), jnp.asarray(feats), jnp.asarray(lens), k_block=8,
                                interpret=True)
    got = te.batch_stats_fused(tmod, torch.as_tensor(trs), torch.as_tensor(feats), torch.as_tensor(lens))
    _stats_close(got, want)


def test_wrappers_take_d64_and_refuse_d65_on_meta_tensors():
    m = dict(device="meta", dtype=torch.float32)
    S, B, M = 6, 3, 4
    for D, ok in ((64, True), (65, False)):
        feats = (torch.empty((4, D, B), **m),)
        packed = ((torch.empty((M * S * D, D), **m), torch.empty((M * S * D, 1), **m),
                   torch.empty((M * S, 1), **m), torch.empty((M * S, 1), **m)),)
        args = (feats, packed, (torch.empty(D, **m),), torch.empty((S, S), **m),
                torch.empty(B, dtype=torch.int32, device="meta"), 1)
        if ok:
            ln = fe._Launch("emit_forward", *args)
            assert (ln.dmax, ln.full) == (64, True)
            assert ln.block(1)[3:] == (True, True)
        else:
            with pytest.raises(ValueError, match="exceeds 64"):
                fe._Launch("emit_forward", *args)
        bank = torch.empty((9, M, D * 64 + 68), **m)
        ids = torch.empty((B, 6), dtype=torch.int32, device="meta")
        if ok:
            assert kc._BankLaunch("bank_emission", ids, bank, torch.empty((B, 4, D), **m), True).dmax == 64
        else:
            with pytest.raises(ValueError, match="exceeds 64"):
                kc._BankLaunch("bank_emission", ids, bank, torch.empty((B, 4, D), **m), True)
