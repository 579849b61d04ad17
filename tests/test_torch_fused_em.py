"""The fused E-step kernel module against the JAX package, on the CPU.

pack_lane_constants against JAX's packer; the plain twins
emit_forward_plain / backward_stats_plain against JAX's Pallas kernels run
in interpret mode on the same packed arrays (band None / 1 / 2, diagonal /
full, one and two streams; log_b and log-alpha per element within 1e-5 of
max(|x|, 1) with equal masks above NEG_INF/2, statistics rtol 2e-3 and atol
2e-4 * max, the bounds tests/test_pallas_kernels.py holds the Pallas kernels
to); e_step_fused_lane(_multi) against JAX's e_step with padded, zero-length
and length-1 rows and odd B / T; padding invariance; exact dense xi; the
kernel's constant block read back the way csrc/fused_em.cu reads it; and the
dispatch on CPU tensors.  The CUDA kernels are held against the twins on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srhmm_tpu.ops.pallas.fused_em_pallas as jp
import srhmm_tpu.train.em as j_em
import srhmm_tpu_torch.train.em as t_em
from srhmm_tpu.io.dataset import pack_utterances as j_pack
from srhmm_tpu_torch.io.dataset import UtteranceBatch, pack_utterances
from srhmm_tpu_torch.ops.kernels import fused_em as fe
from srhmm_tpu_torch.ops.kernels.common import LOG_GAUS_CLAMP, NEG_INF
from torch_port_utils import both_models, rand_word

STAT_RTOL, STAT_ATOL = 2e-3, 2e-4


def _trans(S, band, seed=0):
    """A left-right transition matrix of the given band, or a dense one."""
    rng = np.random.default_rng(seed)
    if band is None:
        t = rng.uniform(0.1, 1.0, size=(S, S))
    else:
        t = np.zeros((S, S))
        for i in range(S):
            t[i, i : i + band + 1] = rng.uniform(0.2, 1.0, size=min(band + 1, S - i))
    return t / t.sum(-1, keepdims=True)


def _models(cov, band, mixes_dims, S=4, seed=1):
    _, streams = rand_word(seed, S, mixes_dims, cov)
    jm, tm_ = both_models(_trans(S, band, seed), streams)
    return jm.astype(jnp.float32), tm_.astype(torch.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("cov", ["diag", "full"])
def test_pack_lane_constants_matches_jax(cov):
    _, streams = rand_word(3, 4, [(2, 5)], cov)
    if cov == "full":  # a degenerate and a non-PD mixture take the bias rules
        streams[0]["det"][1, 0] = 0.0
        streams[0]["inv_cov"][2, 1] = -np.eye(5)
    jm, tm_ = both_models(_trans(4, 1), streams)
    origin = np.array([0.5, -1.0, 2.0, 0.0, 3.0], np.float32)
    for o in (None, origin):
        want = jp.pack_lane_constants(jm.streams[0], jnp.float32, origin=o)
        got = fe.pack_lane_constants(tm_.streams[0], torch.float32, origin=None if o is None else _t(o))
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and tuple(g.shape) == tuple(w.shape)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-30)
    if cov == "full":
        bias = got[2].numpy().reshape(2, 4)
        assert bias[0, 1] == np.float32(NEG_INF) and bias[1, 2] == np.float32(LOG_GAUS_CLAMP)


def _lattice_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mask = want > NEG_INF / 2
    assert ((got > NEG_INF / 2) == mask).all()
    np.testing.assert_allclose(got[mask], want[mask], rtol=1e-5, atol=1e-5)


def _stat_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=STAT_RTOL, atol=STAT_ATOL * max(np.abs(want).max(), 1e-6))


def _num_trans_jax(xi_or_uv, trans, band):
    return np.asarray(j_em._num_trans_from_xi(xi_or_uv, jnp.asarray(trans), band))


@pytest.mark.parametrize(
    "cov,band,mixes_dims",
    [
        ("diag", 1, [(3, 5)]),
        ("full", None, [(2, 4)]),
        ("full", 2, [(2, 4), (1, 3)]),
        ("diag", None, [(2, 4), (2, 3)]),
    ],
)
def test_twins_match_pallas_interpret(cov, band, mixes_dims):
    jm, _ = _models(cov, band, mixes_dims)
    rng = np.random.default_rng(4)
    T, lens = 16, [16, 11, 0, 1, 9]
    B = len(lens)
    feats = [(rng.normal(size=(T, D, B)) * 2).astype(np.float32) for _, D in mixes_dims]
    origins = [np.asarray(s.means).mean((0, 1)).astype(np.float32) for s in jm.streams]
    packs = [jp.pack_lane_constants(s, jnp.float32, origin=o) for s, o in zip(jm.streams, origins)]
    trans = np.asarray(jm.trans, np.float32)
    lengths = np.asarray(lens, np.int32)
    P = len(mixes_dims)
    if P == 1:
        lb_j, la_j = jp.emit_forward_pallas(
            jnp.asarray(feats[0]), *packs[0], jnp.asarray(trans), jnp.asarray(lengths),
            jnp.asarray(origins[0]), k_block=8, band=band, interpret=True)
    else:
        lb_j, la_j = jp.emit_forward_pallas_multi(
            tuple(jnp.asarray(f) for f in feats), *(tuple(pk[i] for pk in packs) for i in range(4)),
            jnp.asarray(trans), jnp.asarray(lengths), tuple(jnp.asarray(o) for o in origins),
            k_block=8, band=band, interpret=True)
    t_feats = tuple(_t(f) for f in feats)
    t_packs = tuple(tuple(_t(a) for a in pk) for pk in packs)
    t_origins = tuple(_t(o) for o in origins)
    lb_t, la_t = fe.emit_forward_plain(t_feats, t_packs, t_origins, _t(trans), _t(lengths), band)
    _lattice_close(lb_t.numpy(), lb_j)
    _lattice_close(la_t.numpy(), la_j)

    # both backward passes on the JAX lattices
    log_z = np.asarray(la_j)[-1, -1]
    valid = np.isfinite(log_z) & (log_z > NEG_INF / 2) & (lengths > 0)
    safe_z = np.where(valid, log_z, 0.0).astype(np.float32)
    vmask = valid.astype(np.float32)
    if P == 1:
        xi_j, dt_j, dm_j, mom_j = jp.backward_stats_pallas(
            jnp.asarray(feats[0]), lb_j, la_j, *packs[0], jnp.asarray(trans), jnp.asarray(lengths),
            jnp.asarray(safe_z), jnp.asarray(vmask), jnp.asarray(origins[0]),
            k_block=8, band=band, interpret=True)
        moms_j = (mom_j,)
    else:
        xi_j, dt_j, dm_j, moms_j = jp.backward_stats_pallas_multi(
            tuple(jnp.asarray(f) for f in feats), lb_j, la_j,
            *(tuple(pk[i] for pk in packs) for i in range(4)), jnp.asarray(trans),
            jnp.asarray(lengths), jnp.asarray(safe_z), jnp.asarray(vmask),
            tuple(jnp.asarray(o) for o in origins), k_block=8, band=band, interpret=True)
    xi_t, dt_t, dm_t, moms_t = fe.backward_stats_plain(
        t_feats, _t(lb_j), _t(la_j), t_packs, t_origins, _t(trans), _t(lengths), _t(safe_z),
        _t(vmask), band)
    nslots = band + 1 if band is not None else 4
    assert tuple(xi_t.shape) == (nslots, 4, B)
    if band is not None:
        _stat_close(xi_t.numpy(), xi_j)
    _stat_close(t_em._num_trans_from_xi(xi_t, band).numpy(), _num_trans_jax(xi_j, trans, band))
    _stat_close(dt_t.numpy(), dt_j)
    _stat_close(dm_t.numpy(), dm_j)
    assert len(moms_t) == P
    for g, w in zip(moms_t, moms_j):
        _stat_close(g.numpy(), w)


def _fused_case(cov, band, mixes_dims, lens, T, seed=5):
    jm, tm_ = _models(cov, band, mixes_dims, S=4, seed=seed)
    rng = np.random.default_rng(seed)
    bj, bt = [], []
    for _, D in mixes_dims:
        utts = [rng.normal(size=(max(L, 1), D)) * 2 for L in lens]
        b = j_pack(utts, pad_multiple=1, dtype=jnp.float32)
        b = b.replace(lengths=jnp.asarray(lens, jnp.int32))
        feats = np.zeros((len(lens), T, D), np.float32)
        feats[:, : b.features.shape[1]] = np.asarray(b.features)
        bj.append(b.replace(features=jnp.asarray(feats)))
        bt.append(UtteranceBatch(_t(feats), torch.tensor(lens, dtype=torch.int32)))
    return jm, tm_, tuple(bj), tuple(bt)


def _assert_fused_vs_jax(got, want):
    for name in ("num_trans", "den_trans", "den_mix", "log_prob", "num_valid"):
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        np.testing.assert_allclose(b, a, rtol=STAT_RTOL, atol=STAT_ATOL * max(np.abs(a).max(), 1.0))
    for gs, ws in zip(got.streams, want.streams):
        for name in ("w", "x", "xx"):
            a, b = np.asarray(getattr(ws, name)), getattr(gs, name).numpy()
            np.testing.assert_allclose(b, a, rtol=STAT_RTOL, atol=STAT_ATOL * max(np.abs(a).max(), 1e-6))


@pytest.mark.parametrize(
    "cov,band,mixes_dims",
    [("diag", 1, [(2, 5)]), ("full", None, [(2, 4)]), ("diag", 2, [(2, 5), (2, 3)]), ("full", 1, [(1, 4), (2, 2)])],
)
def test_e_step_fused_lane_matches_jax_e_step(cov, band, mixes_dims):
    # odd B (7) and T (53), a zero-length and a length-1 row, padded frames
    lens = [31, 42, 0, 53, 1, 20, 36]
    jm, tm_, bj, bt = _fused_case(cov, band, mixes_dims, lens, T=53)
    want = j_em.e_step(jm, bj[0] if len(bj) == 1 else bj)
    if len(bt) == 1:
        got = t_em.e_step_fused_lane(tm_, bt[0], band=band)
    else:
        got = t_em.e_step_fused_lane_multi(tm_, bt, band=band)
    assert float(got.num_valid) == float(want.num_valid)
    _assert_fused_vs_jax(got, want)


def test_fused_statistics_do_not_depend_on_padding():
    lens = [31, 42, 0, 25, 1]
    _, tm_, _, (bt,) = _fused_case("diag", 1, [(2, 5)], lens, T=42)
    base = t_em.e_step_fused_lane(tm_, bt, band=1)
    feats = torch.zeros((9, 57, 5))
    feats[:5, :42] = bt.features
    feats[:5, 42:] = 7.0  # garbage past every length is masked
    padded = UtteranceBatch(feats, torch.tensor(lens + [0, 0, 0, 0], dtype=torch.int32))
    got = t_em.e_step_fused_lane(tm_, padded, band=1)
    for name in ("num_trans", "den_trans", "den_mix", "log_prob", "num_valid"):
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(base, name).numpy(), rtol=1e-6)
    for name in ("w", "x", "xx"):
        np.testing.assert_allclose(getattr(got.streams[0], name).numpy(),
                                   getattr(base.streams[0], name).numpy(), rtol=1e-6, atol=1e-6)


def test_dense_xi_is_exact():
    """With a dense transition matrix the TPU kernel's U/V factorization
    caps v at exp(30); the port accumulates exact xi per (i, j), so it
    matches the plain e_step (held to JAX's at rtol 1e-10 in
    test_torch_em.py) even on frames that widen the forward range."""
    lens = [40, 33, 27]
    _, tm_, _, bt = _fused_case("diag", None, [(2, 4)], lens, T=40, seed=9)
    feats = bt[0].features.clone()
    feats[:, ::5] *= 6.0  # frames far from every mixture widen the per-frame spread
    batch = UtteranceBatch(feats, bt[0].lengths)
    got = t_em.e_step_fused_lane(tm_, batch, band=None)
    model64 = tm_.astype(torch.float64)
    want = t_em.e_step(model64, UtteranceBatch(feats.double(), bt[0].lengths))
    np.testing.assert_allclose(got.num_trans.numpy(), want.num_trans.numpy(), rtol=2e-3,
                               atol=2e-4 * float(want.num_trans.max()))
    # xi rows sum to the transition occupancy (mass conservation)
    np.testing.assert_allclose(got.num_trans.sum(-1).numpy(), got.den_trans.numpy(), rtol=1e-3)


def _emulate_kernel_q(consts, off, D, M, S, full, dmax, x):
    """csrc/emission.cuh's per-mixture q in numpy, reading the kernel's
    constant block at the offsets and strides csrc/fused_em.cu uses."""
    c = consts.numpy().astype(np.float64)
    stride = D * dmax + dmax + 4 if full else 2 * dmax + 4
    xp = np.zeros((dmax, x.shape[1]))
    xp[:D] = x
    q = np.zeros((M * S, x.shape[1]))
    for s in range(S):
        for m in range(M):
            r = c[off + (s * M + m) * stride :][:stride]
            if full:
                z = r[: D * dmax].reshape(D, dmax) @ xp + r[D * dmax : D * dmax + D, None]
                dens = np.minimum(-0.5 * (z * z).sum(0) + r[D * dmax + dmax], LOG_GAUS_CLAMP)
                q[m * S + s] = dens + r[D * dmax + dmax + 1]
            else:
                q[m * S + s] = r[:dmax] @ xp + r[dmax : 2 * dmax] @ (xp * xp) + r[2 * dmax] + r[2 * dmax + 1]
    return q


@pytest.mark.parametrize("cov,mixes_dims", [("diag", [(3, 5), (2, 3)]), ("full", [(2, 4), (1, 3)])])
def test_kernel_constant_block_reproduces_plain(cov, mixes_dims):
    _, tm_ = _models(cov, 1, mixes_dims, S=4)
    origins = tuple(s.means.mean(dim=(0, 1)) for s in tm_.streams)
    packed = tuple(fe.pack_lane_constants(s, origin=o) for s, o in zip(tm_.streams, origins))
    rng = np.random.default_rng(6)
    feats = tuple(torch.from_numpy(rng.normal(size=(3, D, 5)).astype(np.float32) * 2) for _, D in mixes_dims)
    ln = fe._Launch("layout", feats, packed, origins, tm_.trans, torch.tensor([3, 2, 1, 0, 3]), 1)
    assert ln.consts.numel() % 4 == 0 and all(o % 4 == 0 for o in (*ln.offs, *ln.origin_offs, ln.lt_off))
    c = ln.consts.numpy()
    np.testing.assert_array_equal(c[ln.lt_off : ln.lt_off + 16].reshape(4, 4), fe._lt_log(tm_.trans).numpy())
    full = cov == "full"
    for p, ((M, D), pk) in enumerate(zip(mixes_dims, packed)):
        np.testing.assert_array_equal(c[ln.origin_offs[p] : ln.origin_offs[p] + D], origins[p].numpy())
        x = feats[p][1] - origins[p][:, None]
        want = fe._stream_q(x, *pk, full).numpy()
        got = _emulate_kernel_q(ln.consts, ln.offs[p], D, M, 4, full, ln.dmax, x.numpy().astype(np.float64))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_wrappers_run_the_twins_on_cpu_and_count_nothing():
    _, tm_ = _models("diag", 1, [(2, 3)])
    origins = (tm_.streams[0].means.mean(dim=(0, 1)),)
    packed = (fe.pack_lane_constants(tm_.streams[0], origin=origins[0]),)
    feats = (torch.randn(6, 3, 4, generator=torch.Generator().manual_seed(0)),)
    lengths = torch.tensor([6, 3, 0, 1], dtype=torch.int32)
    counts = fe.emit_forward.launches, fe.backward_stats.launches
    args = (feats, packed, origins, tm_.trans, lengths, 1)
    lb, la = fe.emit_forward(*args)
    lb_p, la_p = fe.emit_forward_plain(*args)
    assert torch.equal(lb, lb_p) and torch.equal(la, la_p)
    z, vm = torch.zeros(4), torch.ones(4)
    rest = (feats, lb, la, packed, origins, tm_.trans, lengths, z, vm, 1)
    for a, b in zip(fe.backward_stats(*rest)[:3], fe.backward_stats_plain(*rest)[:3]):
        assert torch.equal(a, b)
    assert (fe.emit_forward.launches, fe.backward_stats.launches) == counts
    meta = (torch.empty((6, 3, 4), device="meta"),)
    with pytest.raises(ValueError, match="device"):
        fe.emit_forward(meta, *args[1:])


def test_em_step_dispatch_on_cpu():
    lens = [20, 13, 0]
    _, tm_, _, (bt,) = _fused_case("diag", 1, [(2, 3)], lens, T=20)
    assert not t_em._fused_lane_eligible(tm_, bt)  # CPU tensors: the plain path
    m_auto, lp_auto, _ = t_em.em_step(tm_, bt)
    m_plain, lp_plain, _ = t_em.em_step(tm_, bt, fused=False)
    assert float(lp_auto) == float(lp_plain)
    m_fused, lp_fused, nv = t_em.em_step(tm_, bt, fused=True)  # the twins, band from the model
    np.testing.assert_allclose(float(lp_fused), float(lp_plain), rtol=1e-5)
    np.testing.assert_allclose(m_fused.streams[0].means.numpy(), m_plain.streams[0].means.numpy(),
                               rtol=1e-3, atol=1e-3)
    assert float(nv) == 2.0
    with pytest.raises(NotImplementedError, match="bf16"):
        t_em.em_step(tm_, bt, bf16_stats=True)


def _consts_floats(S, ds, ms, full):
    """Floats of _Launch's constant block: per stream its records (stride
    from the compiled bound), per stream its origin, the (S, S) log
    transitions, each part padded to 4."""
    from srhmm_tpu_torch.ops.kernels.common import dmax_for

    r4 = lambda n: -(-n // 4) * 4
    dmax = dmax_for(ds, "test")
    stride = lambda D: D * dmax + dmax + 4 if full else 2 * dmax + 4
    return sum(r4(S * M * stride(D)) for D, M in zip(ds, ms)) + sum(r4(D) for D in ds) + r4(S * S)


# backward_stats' launch shape (backward_block) at the main-path shapes:
# (S, [(M, D) per stream], full, nslots) -> (U, TT, statistics warps,
# accumulators in the partials)
EM_BLOCKS = {
    "em_diag": ((8, [(3, 9)], False, 2), (16, 16, 12, False)),
    "em_full": ((6, [(1, 9)], True, 2), (16, 16, 13, False)),
    "em_diag_p2": ((8, [(3, 9), (2, 3)], False, 2), (16, 16, 12, False)),
    "full_D16_M16": ((6, [(16, 16)], True, 2), (16, 8, 13, True)),
}


@pytest.mark.parametrize("name", sorted(EM_BLOCKS))
def test_backward_block_of_the_main_path_shapes(name):
    (S, md, full, nslots), want = EM_BLOCKS[name]
    ms, ds = [m for m, _ in md], [d for _, d in md]
    got = fe.backward_block(_consts_floats(S, ds, ms, full), S, ds, ms, nslots, full)
    assert got == want
    U, TT, warps, acc_global = got
    assert -(-S * U // 32) * 32 + 32 * warps <= fe.BACKWARD_THREADS
    assert fe.backward_smem_bytes(_consts_floats(S, ds, ms, full), S, ds, ms, nslots, full, U, TT, warps,
                                  acc_global) <= fe.SMEM_LIMIT


def _smem_before_redesign(C, S, ds, ms, nslots, full, U):
    """One backward-stats block before its redesign: the constants, then per
    thread two exchange slots, max M q values, nslots xi sums and the
    moment accumulators."""
    return 4 * (C + (2 + max(ms) + nslots + fe.moment_floats(ds, ms, full)) * S * U)


def test_no_shape_taken_before_the_redesign_is_refused_now():
    """Over S = 1-16 states, P = 1, 2, 3, 6 streams of M = 1-64 mixtures,
    D = 1-64 diagonal and 1-16 full, band 1, 2 and dense: wherever the old
    block fitted at one utterance, the new one fits too."""
    for full, dims in ((False, range(1, 65)), (True, range(1, 17))):
        for D in dims:
            for S in range(1, 17):
                for P in (1, 2, 3, 6):
                    for M in (1, 2, 3, 4, 8, 16, 32, 64):
                        ds, ms = [D] * P, [M] * P
                        C = _consts_floats(S, ds, ms, full)
                        for nslots in sorted({min(2, S), min(3, S), S}):
                            if _smem_before_redesign(C, S, ds, ms, nslots, full, 1) > fe.SMEM_LIMIT:
                                continue
                            U, TT, w, g = fe.backward_block(C, S, ds, ms, nslots, full)
                            assert fe.backward_smem_bytes(C, S, ds, ms, nslots, full, U, TT, w, g) <= fe.SMEM_LIMIT


# emit_forward's launch shape (emit_block) on a card of 132 SMs: (S, [(M, D)
# per stream], full, B) -> (utterances a block, frames a tile, recursion
# warps, emission warps, warps an utterance, constants in device memory)
EMIT_BLOCKS = {
    "em_diag": ((8, [(3, 9)], False, 2048), (16, 32, 4, 15, 1, False)),
    "em_full": ((6, [(1, 9)], True, 2048), (16, 32, 4, 15, 1, False)),
    "em_diag_p2": ((8, [(3, 9), (2, 3)], False, 2048), (16, 32, 4, 15, 1, False)),
    "ragged_B1001": ((8, [(3, 9)], False, 1001), (8, 32, 2, 17, 1, False)),
    "small_B37": ((6, [(3, 9)], False, 37), (1, 32, 1, 18, 1, False)),
    "S40_two_warps": ((40, [(2, 9)], False, 37), (1, 32, 2, 17, 2, False)),
    "S200_seven_warps": ((200, [(1, 3)], False, 9), (1, 16, 7, 12, 7, False)),
    "S240_constants_past_shared_memory": ((240, [(1, 3)], False, 5), (1, 32, 8, 11, 8, True)),
}


@pytest.mark.parametrize("name", sorted(EMIT_BLOCKS))
def test_emit_block_of_the_main_path_shapes(name):
    (S, md, full, B), want = EMIT_BLOCKS[name]
    ms, ds = [m for m, _ in md], [d for _, d in md]
    C = _consts_floats(S, ds, ms, full)
    got = fe.emit_block(S, B, C, ds, 132)
    assert (got["utts"], got["tile"], got["rec_warps"], got["em_warps"], got["warps_per_utt"],
            got["consts_global"]) == want
    assert 32 * (got["rec_warps"] + got["em_warps"] + got["memory_warps"]) == got["threads"] == fe.EMIT_THREADS
    # the shared-memory mirror of csrc/fused_em.cu emit_floats: constants,
    # then two slots each of the features, log_b and log-alpha tiles
    U, TT = got["utts"], got["tile"]
    floats = (0 if got["consts_global"] else C) + 2 * TT * U * sum(ds) + 2 * 2 * TT * S * U
    assert got["smem_bytes"] == fe.emit_smem_bytes(C, S, sum(ds), U, TT, got["consts_global"]) == 4 * floats
    assert got["smem_bytes"] <= fe.SMEM_LIMIT


def test_emit_slots_unroll_the_narrow_bands():
    assert [fe.emit_slots(8, b) for b in (0, 1, 2, 3, 4, 7, 8)] == [2, 2, 4, 4, 8, 8, 0]
    assert fe.emit_slots(8, None) == 0


def _emit_accepted_before_redesign(C, S):
    """The emit-forward block rule of cd9fbaf: S <= 256 states, U =
    max(1, min(16, 256 // S)) utterances of S threads each, halved while
    4 (C + 2 S U) bytes exceed SMEM_LIMIT; refused if one utterance does
    not fit."""
    if S > 256:
        return False
    U = max(1, min(16, 256 // S))
    while U > 1 and 4 * (C + 2 * S * U) > fe.SMEM_LIMIT:
        U //= 2
    return 4 * (C + 2 * S * U) <= fe.SMEM_LIMIT


def _emit_shape_is_launchable(shape, S, B):
    """What csrc/fused_em.cu srhmm_emit_forward takes."""
    U, rec = shape["utts"], shape["rec_warps"]
    need = -(-U // (32 // S)) if S <= 32 else U * -(-S // 32)
    return (32 % U == 0 and S * U <= fe.MAX_STATES and rec == need and rec <= fe.EMIT_REC_WARPS
            and shape["em_warps"] >= 1 and shape["memory_warps"] >= 1
            and shape["smem_bytes"] <= fe.SMEM_LIMIT and shape["tile"] >= 1)


def test_no_emit_shape_taken_before_the_redesign_is_refused_now():
    """Over S = 1-256 states, P = 1, 2, 6 streams of M = 1-64 mixtures, D =
    1-64 diagonal and 1-16 full, B = 1, 37, 2048 on 132 SMs: wherever the
    cd9fbaf block fitted, the new one fits and launches; likewise at the
    largest constant blocks the old rule took, one float below its limit."""
    for full, dims in ((False, (1, 3, 9, 13, 39, 64)), (True, (1, 4, 9, 16))):
        for D in dims:
            for S in list(range(1, 34)) + [40, 63, 64, 65, 96, 128, 129, 200, 241, 256]:
                for P in (1, 2, 6):
                    for M in (1, 2, 3, 8, 16, 32, 64):
                        ds, ms = [D] * P, [M] * P
                        C = _consts_floats(S, ds, ms, full)
                        if not _emit_accepted_before_redesign(C, S):
                            continue
                        for B in (1, 37, 2048):
                            assert _emit_shape_is_launchable(fe.emit_block(S, B, C, ds, 132), S, B)
    for S in (1, 6, 8, 32, 33, 64, 200, 240):
        C = (fe.SMEM_LIMIT // 4 - 2 * S) // 4 * 4
        assert _emit_accepted_before_redesign(C, S)
        for ds in ([1], [64] * 6):
            for B in (1, 2048):
                shape = fe.emit_block(S, B, C, ds, 132)
                assert _emit_shape_is_launchable(shape, S, B) and shape["consts_global"]
