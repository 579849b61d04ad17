"""Embedded / tied training, part 1: the plain twins of the composed-lattice
kernels (srhmm_tpu_torch/ops/kernels/composed.py) against the JAX package's
Pallas kernels (srhmm_tpu/ops/pallas/composed_pallas.py, interpret mode on
the CPU), fed the same inputs.

Each case builds one stacked unit inventory from a seed (both packages get
the same numpy leaves), transcripts of L units (utterance 0 repeats one
unit), features and ragged lengths with a zero-length and a length-1 row.
The JAX kernels run once per case in a module-scoped fixture.

Tolerances: log_b and log-alpha max|k-p| / max(|p|, 1) <= 1e-5 with equal
masks above NEG_INF/2 (the JAX package's compiled-vs-interpret bound);
gamma, xi, den_trans, den_mix and the moments max|k-p| <= 1e-4 max|p| (fp32
sums over frames taken in another order: the TPU kernels sum per 8-frame
block, the twins frame by frame).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srhmm_tpu.models as jm
from srhmm_tpu.ops.pallas import composed_pallas as cp
from srhmm_tpu.train import embedded as je
from srhmm_tpu_torch.models import stack_models
from srhmm_tpu_torch.ops.kernels import composed as kc
from srhmm_tpu_torch.ops.kernels.common import NEG_INF
from srhmm_tpu_torch.train import embedded as te
from torch_port_utils import BANK_DEPTH_CASES, both_models, rand_word

B, T, P = 8, 24, 5
LENS = [T, 0, 1, 17, 9, T - 1, 2, 13]

CASES = {
    "diag_S2_L1": ("diag", 2, 1, ((3, 4),)),
    "diag_S3_L3_2streams": ("diag", 3, 3, ((3, 4), (2, 4))),
    "full_S3_L5": ("full", 3, 5, ((2, 3),)),
    "diag_S4_L5": ("diag", 4, 5, ((3, 5),)),
    "full_S2_L3_2streams": ("full", 2, 3, ((2, 3), (1, 3))),
}


def _jax_bank(stream, D, full):
    pack = je.pack_position_bank_full if full else je.pack_position_bank_diag
    out = pack(stream.means, stream.inv_cov, stream.weights, stream.log_abs_det(), D)
    return out if full else (out, None)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    cov, S, L, mixes_dims = CASES[request.param]
    full = cov == "full"
    D = mixes_dims[0][1]
    words = [rand_word(40 + i, S, list(mixes_dims), cov, max(S - 1, 1), scale=2.0) for i in range(P)]
    pairs = [both_models(*w) for w in words]
    jmod = jm.stack_models([p[0] for p in pairs]).astype(jnp.float32)
    tmod = stack_models([p[1] for p in pairs]).astype(torch.float32)
    rng = np.random.default_rng(len(request.param))
    trs = rng.integers(0, P, size=(B, L))
    trs[0] = 1  # a transcript that repeats one unit
    feats = (rng.normal(size=(B, T, D)) * 2).astype(np.float32)
    lens = np.asarray(LENS, np.int32)
    band = max(S - 1, 1)
    LS = L * S
    ids = (trs[:, :, None] * S + np.arange(S)).reshape(B, LS).astype(np.int32)

    # JAX: banks and the five kernels (interpret mode)
    packs = [_jax_bank(st, D, full) for st in jmod.streams]
    banks = tuple(p[0] for p in packs)
    bias2 = tuple(p[1] for p in packs)
    mps = tuple(int(b.shape[1] // D if full else b.shape[1]) for b in banks)
    multi = len(banks) > 1
    bank_in = banks if multi else banks[0]
    bias_in = bias2 if multi else bias2[0]
    mp_in = mps if multi else mps[0]
    fb = jnp.asarray(np.transpose(feats, (0, 2, 1)))
    f_in = (fb,) * len(banks) if multi else fb
    jids = jnp.asarray(ids)
    lb = np.array(cp.bank_emission_pallas(jids, bank_in, bias_in, f_in, n_mix_p=mp_in, full=full,
                                            group=B, interpret=True))[:, :LS]
    pos_logt = tmod.log_trans().to(torch.float32)[torch.as_tensor(trs)]
    diag_row, diag_col = (a.numpy() for a in te._composed_diagonals(pos_logt, band))
    la = np.array(cp.composed_forward_pallas(jnp.asarray(lb), jnp.asarray(diag_col), jnp.asarray(lens),
                                               k_block=8, band=band, interpret=True))
    log_z = la[-1, LS - 1]
    valid = np.isfinite(log_z) & (log_z > NEG_INF / 2) & (lens > 0)
    safe_z = np.where(valid, log_z, 0.0).astype(np.float32)
    vmask = valid.astype(np.float32)
    bw = cp.composed_backward_stats_pallas(
        jnp.asarray(lb), jnp.asarray(la), jnp.asarray(diag_row), jnp.asarray(lens), jnp.asarray(safe_z),
        jnp.asarray(vmask), final=LS - 1, k_block=8, band=band, interpret=True)
    bw = tuple(np.array(a) for a in bw)
    gamma = bw[0]
    mom_lat = cp.bank_moments_lattice_pallas(jids, bank_in, bias_in, f_in, jnp.asarray(gamma), n_mix_p=mp_in,
                                             full=full, group=B, interpret=True)
    mom_bst = cp.bank_moments_pallas(jids, bank_in, bias_in, f_in, jnp.asarray(np.transpose(gamma, (2, 1, 0))),
                                     n_mix_p=mp_in, full=full, group=B, interpret=True)
    as_list = lambda m: [np.asarray(a) for a in (m if multi else (m,))]
    tbanks = tuple(te._pack_bank(st, D, full) for st in tmod.streams)
    return {
        "full": full, "D": D, "mixes": [M for M, _ in mixes_dims], "ids": torch.as_tensor(ids),
        "banks": tbanks if multi else tbanks[0], "feats": torch.as_tensor(feats),
        "lens": torch.as_tensor(lens), "diag_row": torch.as_tensor(diag_row),
        "diag_col": torch.as_tensor(diag_col), "safe_z": torch.as_tensor(safe_z),
        "vmask": torch.as_tensor(vmask), "lb": lb, "la": la, "bw": bw, "gamma": gamma,
        "mom_lat": as_list(mom_lat), "mom_bst": as_list(mom_bst),
    }


def _lattice_close(got, want):
    got = got.double().numpy()
    want = np.asarray(want, np.float64)
    mask = want > NEG_INF / 2
    assert ((got > NEG_INF / 2) == mask).all()
    rel = np.max(np.abs(got[mask] - want[mask]) / np.maximum(np.abs(want[mask]), 1.0))
    assert rel <= 1e-5, rel


def _stat_close(got, want):
    got = got.double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= 1e-4 * max(np.abs(want).max(), 1e-30)


def test_bank_emission_matches_pallas(case):
    got = kc.bank_emission(case["ids"], case["banks"], case["feats"], case["full"])
    assert got.shape == case["lb"].shape
    _lattice_close(got, case["lb"])


def test_composed_forward_matches_pallas(case):
    got = kc.composed_forward(torch.as_tensor(case["lb"]), case["diag_col"], case["lens"])
    _lattice_close(got, case["la"])


def test_composed_backward_stats_matches_pallas(case):
    got = kc.composed_backward_stats(torch.as_tensor(case["lb"]), torch.as_tensor(case["la"]),
                                     case["diag_row"], case["lens"], case["safe_z"], case["vmask"])
    for g, w in zip(got, case["bw"]):
        _stat_close(g, w)
    # gamma is masked to the valid frames of valid utterances
    assert float(got[0][:, :, 1].abs().sum()) == 0.0  # the zero-length row


def _moments_close(got, want_list, case):
    got = got if isinstance(got, tuple) else (got,)
    D = case["D"]
    for g, w, M in zip(got, want_list, case["mixes"]):
        w = w[:, :M]  # the TPU banks pad mixtures to a multiple of 8
        for part in (slice(0, D), slice(D, -1), slice(-1, None)):  # x, second moments, occupancy
            _stat_close(g[..., part], w[..., part])


def test_bank_moments_lattice_matches_pallas(case):
    got = kc.bank_moments_lattice(case["ids"], case["banks"], case["feats"], torch.as_tensor(case["gamma"]),
                                  case["lens"], case["full"])
    _moments_close(got, case["mom_lat"], case)


def test_bank_moments_matches_pallas(case):
    gamma_bst = torch.as_tensor(np.ascontiguousarray(np.transpose(case["gamma"], (2, 1, 0))))
    got = kc.bank_moments(case["ids"], case["banks"], case["feats"], gamma_bst, case["lens"], case["full"])
    _moments_close(got, case["mom_bst"], case)


def test_segment_sum_is_a_scatter_add():
    rng = np.random.default_rng(0)
    vals = torch.as_tensor(rng.normal(size=(50, 3, 2)))
    ids = torch.as_tensor(rng.integers(0, 7, size=50))
    want = torch.zeros((9, 3, 2), dtype=torch.float64).index_add_(0, ids, vals)
    np.testing.assert_allclose(kc.segment_sum(vals, ids, 9).numpy(), want.numpy(), rtol=1e-12, atol=1e-12)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    ids = torch.zeros((2, 3), dtype=torch.int32)
    bank = torch.zeros((4, 2, kc.record_stride(5, False)))
    with pytest.raises(ValueError, match="do not fit"):
        kc.bank_emission_plain(ids, bank, torch.zeros((2, 7, 9)))
    assert not kc.fused_eligible(torch.zeros((2, 7, 5)), ["diag"], [5], [2], 3, 9, 2)  # a CPU tensor
    with pytest.raises(ValueError, match="no implementation"):
        kc.composed_forward(torch.zeros((3, 2, 2), device="meta"), torch.zeros((2, 2, 2)), torch.zeros(2))


# ---------------------------------------------------------------------------
# the kernels' shared-memory plans: every batch shape that rode the composed
# kernels before their redesign still does
# ---------------------------------------------------------------------------


def _cuda_feats(B, T, D):
    """What fused_eligible reads of a CUDA float32 feature tensor (no card
    needed to decide)."""
    return types.SimpleNamespace(device=torch.device("cuda"), dtype=torch.float32, shape=(B, T, D))


# (mixes per stream, D, full, S, LS, B): emb_c4, tied_c5, pipe_c3, the
# chip_smoke.py COMPOSED_CASES, diagonal D=64 M=32 P=6, full D=16
ELIGIBLE_SHAPES = {
    "emb_c4": ([32], 13, False, 3, 36, 512),
    "tied_c5": ([16], 39, False, 3, 30, 1024),
    "pipe_c3": ([2], 13, False, 3, 27, 40),
    "case_diag_S2_L1": ([3], 9, False, 2, 2, 37),
    "case_diag_S3_L3_2streams": ([3, 2], 9, False, 3, 9, 37),
    "case_full_S3_L5": ([2], 6, True, 3, 15, 37),
    "case_diag_S4_L5": ([4], 13, False, 4, 20, 37),
    "case_full_S2_L3_2streams": ([3, 2], 4, True, 2, 6, 37),
    "case_diag_S3_L12_M32": ([32], 13, False, 3, 36, 37),
    "case_diag_S3_L10_M16_D39": ([16], 39, False, 3, 30, 37),
    "diag_D64_M32_P6": ([32] * 6, 64, False, 3, 30, 64),
    "full_D16_M16": ([16], 16, True, 3, 30, 64),
    "full_D16_M82": ([82], 16, True, 3, 30, 64),
}


@pytest.mark.parametrize("name", sorted(ELIGIBLE_SHAPES))
def test_main_path_shapes_stay_eligible(name):
    mixes, D, full, S, LS, B = ELIGIBLE_SHAPES[name]
    cov = ["full" if full else "diag"] * len(mixes)
    assert kc.fused_eligible(_cuda_feats(B, 100, D), cov, [D] * len(mixes), mixes, S, LS, B)
    assert kc.moments_smem_bytes(mixes, D, full) <= kc.SMEM_LIMIT
    strides = [kc.record_stride(D, full)] * len(mixes)
    assert kc.emission_ring(mixes, strides) * 4 * sum(m * s for m, s in zip(mixes, strides)) <= kc.SMEM_LIMIT


@pytest.mark.parametrize("cov,mixes_dims,nbuf,slots", BANK_DEPTH_CASES)
def test_bank_depth_cases_pick_their_depths(cov, mixes_dims, nbuf, slots):
    """The shapes tests/test_torch_cuda.py and chip_smoke.py use for the
    emission ring's and the moments batch's shallower depths are eligible
    and pick those depths."""
    mixes = [m for m, _ in mixes_dims]
    D, full = mixes_dims[0][1], cov == "full"
    assert kc.fused_eligible(_cuda_feats(19, 95, D), [cov] * len(mixes), [D] * len(mixes), mixes, 3, 12, 19)
    assert kc.emission_ring(mixes, [kc.record_stride(D, full)] * len(mixes)) == nbuf
    assert kc.moments_slots(mixes, D, full) == slots


def _moments_smem_before_redesign(mixes, D, full):
    """One moments block of csrc/composed.cu before its redesign: every
    stream's records and accumulators, posterior weights (max M, 129),
    features (128, D | 1)."""
    rec = sum(mixes) * kc.record_stride(D, full)
    acc = sum(mixes) * kc.moment_cols(D, full)
    return 4 * (rec + max(mixes) * 129 + 128 * (D | 1) + acc)


def test_no_shape_eligible_before_the_redesign_is_refused_now():
    """Over P = 1-6 streams of M = 1-96 mixtures (one M, and M, M-1, ...
    per stream), D = 1-64 diagonal and 1-16 full: the redesigned blocks
    fit wherever the old one did, and the emission's ring falls back to
    the old single buffer where a deeper one does not fit."""
    for full, dims in ((False, range(1, 65)), (True, range(1, 17))):
        for D in dims:
            stride = kc.record_stride(D, full)
            for P in range(1, 7):
                for M in range(1, 97):
                    for mixes in ([M] * P, [max(1, M - q) for q in range(P)]):
                        if _moments_smem_before_redesign(mixes, D, full) > kc.SMEM_LIMIT:
                            continue
                        assert kc.moments_smem_bytes(mixes, D, full) <= kc.SMEM_LIMIT, (mixes, D, full)
                        ring = kc.emission_ring(mixes, [stride] * P)
                        assert ring * 4 * sum(mixes) * stride <= kc.SMEM_LIMIT, (mixes, D, full)


# composed_backward_stats' launch shape (backward_block): (LS, B, nd) ->
# (rows a lane, warps an utterance, utterances a block, frames a tile) on
# 132 SMs, for emb_c4, tied_c5, pipe_c3 and the widest chains
BACKWARD_BLOCKS = {
    "emb_c4": ((36, 512, 3), (2, 1, 4, 16)),
    "tied_c5": ((30, 1024, 3), (1, 1, 8, 16)),
    "pipe_c3": ((27, 40, 3), (1, 1, 1, 16)),
    "LS64": ((64, 2048, 2), (2, 1, 8, 8)),
    "LS128_band15": ((128, 300, 16), (4, 1, 2, 16)),
    "LS1024_band15": ((1024, 64, 16), (4, 8, 1, 4)),
}


@pytest.mark.parametrize("name", sorted(BACKWARD_BLOCKS))
def test_backward_block_of_the_main_path_shapes(name):
    (LS, B, nd), want = BACKWARD_BLOCKS[name]
    blk = kc.backward_block(LS, B, nd, sms=132)
    assert (blk["rows_per_lane"], blk["warps"], blk["utts"], blk["tile"]) == want


# composed_forward's launch shape (forward_block): (LS, B, nd) -> (rows a
# lane, warps an utterance, utterances a block, frames a tile) on 132 SMs
FORWARD_BLOCKS = {
    "emb_c4": ((36, 512, 3), (2, 1, 4, 32)),
    "tied_c5": ((30, 1024, 3), (1, 1, 8, 32)),
    "pipe_c3": ((27, 40, 3), (1, 1, 1, 32)),
    "LS64": ((64, 2048, 2), (2, 1, 8, 16)),
    "LS128_band15": ((128, 300, 16), (4, 1, 2, 32)),
    "LS1024_band15": ((1024, 64, 16), (4, 8, 1, 8)),
}


@pytest.mark.parametrize("name", sorted(FORWARD_BLOCKS))
def test_forward_block_of_the_main_path_shapes(name):
    (LS, B, nd), want = FORWARD_BLOCKS[name]
    blk = kc.forward_block(LS, B, nd, sms=132)
    assert (blk["rows_per_lane"], blk["warps"], blk["utts"], blk["tile"]) == want


def test_forward_smem_bytes_mirrors_the_kernel():
    """forward_smem_bytes = csrc/composed.cu forward_floats(U, TT, LS) * 4:
    four (TT, LS, U) slots with the pitch LS U rounded up to 4; the largest
    tile that fits is taken."""
    for LS, U, TT in ((36, 4, 32), (30, 8, 32), (27, 1, 32), (5, 3, 7), (1024, 1, 8)):
        assert kc.forward_smem_bytes(U, TT, LS) == 4 * 4 * TT * (-(-LS * U // 4) * 4)
    blk = kc.forward_block(1024, 64, 16, sms=132)
    assert kc.forward_smem_bytes(blk["utts"], blk["tile"], 1024) <= kc.SMEM_LIMIT
    assert kc.forward_smem_bytes(blk["utts"], 2 * blk["tile"], 1024) > kc.SMEM_LIMIT


def test_no_chain_the_forward_took_before_is_refused_now():
    """Every (LS, band) that the thread-per-row forward accepted (LS up to
    1024 rows, 1 to 16 diagonals) gets a launch shape: 32 R W >= LS rows,
    at most 512 threads, four tiles that fit the shared memory, at any B;
    at least 3/4 of the SMs get a block where B allows."""
    for LS in range(1, 1025):
        for nd in (1, 2, 3, 4, 5, 8, 16):
            for B in (1, 37, 512, 4096):
                blk = kc.forward_block(LS, B, nd, sms=132)
                R, W, U, TT = blk["rows_per_lane"], blk["warps"], blk["utts"], blk["tile"]
                assert R in kc.ROWS_PER_LANE and 32 * R * W >= LS and 64 * W * U <= 512
                assert kc.forward_smem_bytes(U, TT, LS) <= kc.SMEM_LIMIT and TT in kc.FORWARD_TILES
                assert U == 1 or -(-B // U) >= 99
    with pytest.raises(ValueError, match="1024"):
        kc.forward_block(1025, 8, 3)
    with pytest.raises(ValueError, match="diagonals"):
        kc.forward_block(30, 8, 17)


def test_no_chain_the_lattice_kernels_took_before_is_refused_now():
    """Every (LS, band) that fused_eligible accepted before the
    warp-per-utterance kernel (LS up to 1024 rows, 1 to 16
    diagonals) gets a launch shape: 32 R W >= LS rows, at most 512 threads
    (recursion and statistics warps), a ring that fits the shared memory,
    at any B."""
    for LS in range(1, 1025):
        for nd in (1, 2, 3, 4, 5, 8, 16):
            for B in (1, 37, 512, 4096):
                blk = kc.backward_block(LS, B, nd, sms=132)
                R, W, U, TT = blk["rows_per_lane"], blk["warps"], blk["utts"], blk["tile"]
                assert R in kc.ROWS_PER_LANE and 32 * R * W >= LS and 64 * W * U <= 512
                assert kc.backward_smem_bytes(R, W, U, TT, LS) <= kc.SMEM_LIMIT and TT >= 1
    with pytest.raises(ValueError, match="1024"):
        kc.backward_block(1025, 8, 3)
    with pytest.raises(ValueError, match="diagonals"):
        kc.backward_block(30, 8, 17)
