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
and composed.fused_eligible take them, the E-step kernels take their
z-GEMM blocks (the emission and moments at the shared memory
csrc/fused_em.cu reckons, and the recursions' blocks without features or
statistics, each written out again here), and so do the bank kernels
(csrc/composed.cu, written out again), whatever M, and the sets reach
each of their launch shapes; at P = 1 to 6 streams of D = 17, 39 and 64,
banded and dense, the E-step takes the z-GEMM path within shared memory,
and fits admits exactly the shapes the rule before the z-GEMM blocks
admitted (written out again); the wrappers' own checks on meta tensors
take D = 64 and refuse D = 65.  At the bank cases that reach a
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
    """csrc/fused_em.cu backward_floats + backward_ints in bytes before the
    z-GEMM blocks, written out again: the constants (unless in device
    memory), a ring of three tiles of log-alpha, log b and the features,
    two gamma tiles, two exchange rows, xi past 8 slots, the weights (S max
    M, KS) and features (max D, KS), the accumulators (unless in the
    partials), the kept columns and the warps' counts."""
    nt, cols = S * U, TT * U
    ks = -(-cols // 8) * 8 + (4 if cols > 8 else 0)
    mom = sum(M * (D + D * D + 1) for D, M in zip(ds, ms))
    floats = ((0 if consts_global else C) + 3 * TT * U * (2 * S + sum(ds)) + 2 * TT * nt + 2 * nt
              + max(nslots - 8, 0) * nt + (S * max(ms) + max(ds)) * ks + (0 if acc_global else S * mom))
    return 4 * floats + 4 * (cols + warps)


def _wide_backward_bytes(S, nslots, U, TT):
    """csrc/fused_em.cu backward_floats of a wide block (full covariance
    past D = 16), written out again: a ring of three tiles of log-alpha and
    log b (no features), two gamma tiles, two exchange rows, xi past 8
    slots; the log transitions in device memory and no statistics."""
    nt = S * U
    return 4 * (3 * TT * U * 2 * S + 2 * TT * nt + 2 * nt + max(nslots - 8, 0) * nt)


def _wide_em_bytes(rb, which):
    """csrc/fused_em.cu wide_smem, written out again: the z-GEMM emission
    (which 0) the features of 128 columns at pitch rb + 4, two slices of
    two mixtures and their q; the moments (1) that plus the 8 rows of
    weights (pitch 132), the gamma of up to 8 states at 128 columns, and as
    ints the lift table (16 a m tile at rb), 384 queued columns and two
    rows of 8 vote counts."""
    floats = 128 * (rb + 4) + 2 * 2 * (rb * (rb + 4) + rb + 4 + 128)
    if which == 0:
        return 4 * floats
    rows = rb + rb * (rb + 1) // 2 + 1
    return 4 * (floats + 8 * 132 + 8 * 128) + 4 * (16 * -(-rows // 16) + 384 + 16)


def _moment_group(S, M, g):
    """csrc/fused_em.cu em_moments_wide_kernel's group g of a stream of M
    mixtures, written out again: the mixtures [lo, hi) of its states'
    logsumexps (state-major) and the rows [keep, keep + nm) it contracts."""
    if M <= 8:
        per = 8 // M
        lo, hi = g * per * M, min(S, (g + 1) * per) * M
        return lo, hi, lo, hi - lo
    mg = -(-M // 8)
    s = g // mg
    keep = s * M + (g - s * mg) * 8
    return s * M, s * M + M, keep, min(8, s * M + M - keep)


def _check_wide_launch(ds, ms, S, band, B=2048, sms=132):
    """The E-step's z-GEMM path at these shapes: chosen, every block within
    shared memory as csrc/fused_em.cu reckons it, the moments' row groups
    covering the S M rows of each stream once and its ranges covering B."""
    assert fe.fits(ds, ms, True, S, band) and fe.wide_full(ds, True)
    dmax = fe.em_dmax(ds, True, "test")
    assert dmax == next(b for b in (32, 40, 64) if b >= max(ds))
    C = fe.constant_floats(ds, ms, True, S, dmax)
    nslots = S if band is None else band + 1
    U, TT, warps, acc_global, consts_global = fe.backward_shape(C, S, ds, ms, nslots, True)
    assert (warps, acc_global, consts_global) == (fe.WIDE_STAT_WARPS, False, True)
    smem = _wide_backward_bytes(S, nslots, U, TT)
    assert smem == fe.backward_smem_bytes(C, S, ds, ms, nslots, True, U, TT, warps, False, True, True) <= fe.SMEM_LIMIT
    utts = [max(1, min(16, 128 // S))]
    while utts[-1] > 1:
        utts.append(utts[-1] // 2)
    assert (U, TT) == next((u, tt) for u in utts for tt in fe.BACKWARD_TILES
                           if _wide_backward_bytes(S, nslots, u, tt) <= fe.SMEM_LIMIT)
    emit = fe.emit_block(S, B, C, ds, sms, wide=True)
    assert emit["consts_global"]
    assert emit["smem_bytes"] == 4 * 2 * emit["tile"] * emit["utts"] * 2 * S <= fe.SMEM_LIMIT
    for which in (0, 1):
        assert fe.wide_smem_bytes(dmax, which) == _wide_em_bytes(dmax, which) <= fe.SMEM_LIMIT
    for M in ms:
        kept = []
        for g in range(fe.moment_groups(S, M)):
            lo, hi, keep, nm = _moment_group(S, M, g)
            assert lo % M == hi % M == 0 and 1 <= (hi - lo) // M <= 8 and 1 <= nm <= 8
            assert lo <= keep and keep + nm <= hi
            kept += range(keep, keep + nm)
        assert kept == list(range(S * M))  # every row of W once, in order
    groups = sum(fe.moment_groups(S, M) for M in ms)
    R = fe.moment_ranges(B, groups, sms)
    per = -(-B // R)
    assert 1 <= R <= B and (R - 1) * per < B <= R * per and groups <= 65535
    return U, TT, groups, R


@pytest.mark.parametrize("i", range(len(EM_FULL_WIDE_CASES)))
def test_em_kernels_take_every_wide_full_case(i):
    """Every case takes the E-step's z-GEMM path within shared memory
    (_check_wide_launch) at S = 6 banded and dense and S = 8 with a band of
    2; the set reaches mixtures past one n tile (M = 16: two groups a
    state), several states a group, two and six streams, each bound."""
    md = EM_FULL_WIDE_CASES[i]
    ms, ds = tuple(m for m, _ in md), tuple(d for _, d in md)
    for S, band in ((6, 1), (6, None), (8, 2)):
        assert fe.refusal(ds, ms, True, S, band) is None
        _check_wide_launch(ds, ms, S, band)
    if md == [(16, 39)]:
        assert fe.moment_groups(6, 16) == 12
    if md == [(4, 39)]:
        assert fe.moment_groups(6, 4) == 3


@pytest.mark.parametrize("D", [17, 39, 64])
@pytest.mark.parametrize("P", range(1, 7))
def test_em_wide_launch_rule_at_every_stream_count(P, D):
    """P streams of D = 17, 39 or 64 (M of 1 to 16 and dims down to 17 in
    turn), banded and dense, S = 6 and 40: the z-GEMM path, within shared
    memory (_check_wide_launch)."""
    ms = tuple((1, 4, 16, 3, 9, 2)[:P])
    ds = tuple([D] + [max(17, D - 3 * q) for q in range(1, P)])
    for S in (6, 40):
        for band in (1, None):
            U, TT, groups, R = _check_wide_launch(ds, ms, S, band)
            assert groups == sum(fe.moment_groups(S, M) for M in ms) and U >= 1 and TT >= 1


def _parent_refusal(ds, ms, S, band):
    """fused_em.refusal for full covariance before the z-GEMM blocks,
    written out again: 1 to 6 streams, a band inside the model, at most 256
    states, D up to 64, and a backward-stats block of one utterance and one
    frame (the features staged, the constants in device memory, the
    accumulators in the partials) within shared memory."""
    if not 1 <= len(ds) <= 6 or (band is not None and not 0 <= band < S) or S > 256 or max(ds) > 64:
        return True
    nslots = S if band is None else band + 1
    warps = max(2, (512 - -(-S // 32) * 32) // 32)
    return _backward_floats(0, S, ds, ms, nslots, 1, 1, warps, True, True) > fe.SMEM_LIMIT


def test_fits_admits_the_set_it_admitted_before():
    """fits at full covariance over streams, states, mixtures, dims and
    bands, D = 64 admitted and D = 65 refused: exactly the rule before the
    z-GEMM blocks, and every admitted shape past D = 16 launches within
    shared memory."""
    taken = refused = 0
    for ds in ((17,), (39,), (64,), (65,), (39, 20), (64,) * 6, (17,) * 7):
        for ms in ((1,) * len(ds), (4,) * len(ds), (40,) * len(ds), (300,) * len(ds)):
            for S in (3, 6, 40, 256, 257):
                for band in (0, 1, 2, None, S):
                    ok = fe.fits(ds, ms, True, S, band)
                    assert ok == (not _parent_refusal(ds, ms, S, band)), (ds, ms, S, band)
                    if ok:
                        _check_wide_launch(ds, ms, S, band)
                    taken, refused = taken + ok, refused + (not ok)
    assert taken and refused
    assert fe.fits((64,), (4,), True, 6, 1) and not fe.fits((65,), (4,), True, 6, 1)


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


def test_plain_emit_forward_stores_q_whose_logsumexp_is_log_b():
    """emit_forward's twin with q_out at two streams of full D = 20 and 17
    (S = 4, M = 3 and 2): per stream (T, M S, B) rows m S + s, whose
    mixture logsumexps summed over the streams are log b (rtol 1e-5)."""
    _, streams = rand_word(5, 4, [(3, 20), (2, 17)], "full", scale=2.0)
    trans = np.zeros((4, 4))
    for i in range(4):
        trans[i, i : i + 2] = (0.6, 0.4) if i < 3 else (1.0,)
    model = tmods.gmm_hmm_from_numpy(trans, streams).astype(torch.float32)
    rng = np.random.default_rng(12)
    feats = tuple(torch.as_tensor(rng.normal(size=(T, D, len(LENS))) * 2, dtype=torch.float32) for D in (20, 17))
    origins = tuple(st.means.mean(dim=(0, 1)) for st in model.streams)
    packed = tuple(fe.pack_lane_constants(st, origin=o) for st, o in zip(model.streams, origins))
    q = tuple(torch.full((T, M * 4, len(LENS)), np.nan) for M in (3, 2))
    lengths = torch.tensor(LENS, dtype=torch.int32)
    log_b, _ = fe.emit_forward(feats, packed, origins, model.trans, lengths, 1, q_out=q)
    lse = sum(torch.logsumexp(qp.reshape(T, M, 4, len(LENS)), dim=1) for qp, M in zip(q, (3, 2)))
    np.testing.assert_allclose(lse.numpy(), log_b.numpy(), rtol=1e-5)


def test_stored_q_rule():
    """emit_forward stores the per-mixture q at full covariance past D = 16
    where it takes at most STORED_Q_SHARE of the card's memory
    (stored_q_refusal names both past that); stored_q_buffers stores none
    on the CPU; the wrappers refuse a q on other shapes (meta tensors)."""
    need = fe.stored_q_bytes(256, 6, 2048, (4,))
    assert need == 50331648
    card = int(need / fe.STORED_Q_SHARE)
    assert fe.stored_q_refusal((39,), (4,), True, 6, 256, 2048) is None
    assert fe.stored_q_refusal((39,), (4,), True, 6, 256, 2048, device_bytes=card) is None
    small = fe.stored_q_refusal((39,), (4,), True, 6, 256, 2048, device_bytes=card - 1)
    assert str(need) in small and str(card - 1) in small
    assert "past D = 16" in fe.stored_q_refusal((16,), (4,), True, 6, 256, 2048, device_bytes=1 << 40)
    assert "past D = 16" in fe.stored_q_refusal((39,), (4,), False, 6, 256, 2048, device_bytes=1 << 40)
    assert fe.stored_q_buffers((torch.zeros((4, 39, 3)),), (4,), 6, True) is None
    m = dict(device="meta", dtype=torch.float32)
    S, M, T, B = 6, 4, 4, 3
    for D, why in ((39, None), (16, "past D = 16")):
        feats = (torch.empty((T, D, B), **m),)
        packed = ((torch.empty((M * S * D, D), **m), torch.empty((M * S * D, 1), **m),
                   torch.empty((M * S, 1), **m), torch.empty((M * S, 1), **m)),)
        ln = fe._Launch("emit_forward", feats, packed, (torch.empty(D, **m),), torch.empty((S, S), **m),
                        torch.empty(B, dtype=torch.int32, device="meta"), 1)
        q = (torch.empty((T, M * S, B), **m),)
        if why is None:
            assert ln.stored_q(q) is not None
            with pytest.raises(ValueError, match="T, M_p\\*S, B"):
                ln.stored_q((torch.empty((T, M * S + 1, B), **m),))
        else:
            with pytest.raises(ValueError, match=why):
                ln.stored_q(q)


def test_em_bounds_read_the_stored_q_at_kept_columns():
    """chip_smoke.em_bounds: where emit_forward stores the per-mixture q,
    its bound writes the whole (T, M S, B) buffer and backward_stats'
    bound reads it at the columns of valid utterances' frames only."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    S, M, D, T = 6, 4, 39, 29
    lengths = torch.tensor(LENS, dtype=torch.int32)
    valid = torch.tensor([True, True, False, False, True])
    kept = 21 + 29 + 1
    packed = ((torch.zeros((M * S * D, D)), torch.zeros((M * S * D, 1)), torch.zeros((M * S, 1)),
               torch.zeros((M * S, 1))),)
    out = {}
    for stored in (False, True):
        rows = {"emit_forward": {"ms": 1e3}, "backward_stats": {"ms": 1e3}}
        cs.em_bounds(rows, T, [(D, M)], True, packed, torch.zeros((S, S)), lengths, valid, 1, stored)
        out[stored] = rows
    k1 = out[True]["emit_forward"]["bound_ms"] - out[False]["emit_forward"]["bound_ms"]
    np.testing.assert_allclose(k1, 4 * T * len(LENS) * S * M / cs.HBM_BYTES_PER_S * 1e3, rtol=1e-9)
    assert out[True]["backward_stats"]["stored_q_read_bytes"] == 4 * kept * S * M
    assert out[True]["backward_stats"]["bound_bytes"] - out[False]["backward_stats"]["bound_bytes"] == 4 * kept * S * M


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
            assert (ln.dmax, ln.full, ln.wide) == (64, True, True)
            assert ln.block(1)[2:] == (fe.WIDE_STAT_WARPS, False, True)
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
