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
from torch_port_utils import both_models, rand_word

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
