"""The fused emission / moment kernel module against the JAX package, on the
CPU.

pack_constants against srhmm_tpu's _pack_constants (rtol 1e-6); the twins
of emission_log_b (TPU kernel #21) and emission_stats (#22) against the
Pallas kernels in interpret mode on the same packed arrays: log b within
1e-5 per element, moments rtol 5e-4 (the bounds of
tests/test_pallas_kernels.py:33-39 and :215-217); log_state_emission_fused
against JAX's and against the plain log_state_emission; an all -inf log b
gives all-zero moments (mirrors :220-238); a zero-weight mixture; N off
every tile of the CUDA kernels (512 frames an emission tile, 128 down to 8
a moments tile), S = 64 and M = 16 included; the emission kernel's launch
shapes (emission_block) for every shape the 7ca66a2 kernel took, the
moments' (stats_block) for every shape the 6fe1112 kernel took; the
diagonal records filled in place (common.mixture_records) bitwise the
concatenated layout they replace.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srhmm_tpu.ops.pallas.emission_pallas as je
from srhmm_tpu_torch.ops.emission import log_state_emission
from srhmm_tpu_torch.ops.kernels import emission as ke
from srhmm_tpu_torch.ops.kernels.common import mixture_records
from torch_port_utils import both_models, rand_word


def _streams(S=4, M=3, D=5, seed=0, zero_weight=False):
    trans, streams = rand_word(seed, S, [(M, D)], "diag")
    if zero_weight:  # a mixture of weight 0 (bias log 1e-300)
        w = streams[0]["weights"]
        w[1, 0] = 0.0
        w[1] /= w[1].sum()
    jm, tm = both_models(trans, streams)
    return jm.astype(jnp.float32).streams[0], tm.astype(torch.float32).streams[0]


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(N, D, S, seed=1):
    rng = np.random.default_rng(seed)
    frames = (rng.normal(size=(N, D)) * 2.0).astype(np.float32)
    gamma = rng.uniform(0.0, 1.0, size=(N, S)).astype(np.float32)
    return frames, gamma


@pytest.mark.parametrize("zero_weight", [False, True])
def test_pack_constants_matches_jax(zero_weight):
    js, ts = _streams(zero_weight=zero_weight)
    for got, want in zip(ke.pack_constants(ts, torch.float32), je._pack_constants(js, jnp.float32)):
        assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("M,D,N,t_block", [(3, 5, 64, 16), (1, 3, 40, 8), (16, 13, 32, 32)])
def test_emission_log_b_matches_pallas(M, D, N, t_block):
    js, ts = _streams(S=4, M=M, D=D, seed=M)
    frames, _ = _inputs(N, D, 4)
    a, b = je._pack_constants(js, jnp.float32)
    want = np.asarray(je.emission_log_b_pallas(jnp.asarray(frames), a, b, t_block=t_block, interpret=True))
    got = ke.emission_log_b(_t(frames), _t(a), _t(b)).numpy()
    assert got.shape == (N, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_log_state_emission_fused_matches_jax_and_the_plain_emission():
    js, ts = _streams(S=8, M=3, D=9, seed=3, zero_weight=True)
    frames, _ = _inputs(37, 9, 8)  # N off every tile
    got = ke.log_state_emission_fused(_t(frames), ts).numpy()
    want = np.asarray(je.log_state_emission_fused(jnp.asarray(frames), js, t_block=1, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    plain = log_state_emission(_t(frames), (ts,)).numpy()
    np.testing.assert_allclose(got, plain, rtol=2e-5, atol=2e-5)


def test_log_state_emission_fused_is_diagonal_only():
    trans, streams = rand_word(0, 3, [(1, 3)], "full")
    _, tm = both_models(trans, streams)
    with pytest.raises(ValueError, match="diagonal"):
        ke.log_state_emission_fused(torch.zeros((4, 3)), tm.streams[0])


@pytest.mark.parametrize("M,D,N,t_block", [(3, 5, 64, 16), (2, 4, 48, 8), (16, 13, 32, 32)])
def test_emission_stats_matches_pallas(M, D, N, t_block):
    S = 4
    js, ts = _streams(S=S, M=M, D=D, seed=10 + M, zero_weight=True)
    frames, gamma = _inputs(N, D, S, seed=2)
    a, b = je._pack_constants(js, jnp.float32)
    log_b = ke.emission_log_b(_t(frames), _t(a), _t(b))
    log_b[3, 1] = -float("inf")  # a state of zero likelihood contributes nothing
    want = np.asarray(je.emission_stats_pallas(jnp.asarray(frames), jnp.asarray(gamma), jnp.asarray(log_b.numpy()),
                                               a, b, t_block=t_block, interpret=True))
    got = ke.emission_stats(_t(frames), _t(gamma), log_b, _t(a), _t(b)).numpy()
    assert got.shape == (S, M, 2 * D + 1)
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=1e-5 * np.abs(want).max())


def test_emission_stats_zero_likelihood_state():
    """Mirrors tests/test_pallas_kernels.py::test_emission_stats_kernel_zero_likelihood_state:
    log b = -inf everywhere gives all-zero moments, no NaN; N = 37 is off
    every tile."""
    js, ts = _streams(S=4, M=2, D=3, seed=3)
    frames, gamma = _inputs(37, 3, 4, seed=3)
    a, b = ke.pack_constants(ts, torch.float32)
    log_b = torch.full((37, 4), -float("inf"))
    out = ke.emission_stats(_t(frames), _t(gamma), log_b, a, b)
    assert (out == 0.0).all()
    # the JAX kernel on the same inputs (t_block 1 covers N = 37)
    want = je.emission_stats_pallas(jnp.asarray(frames), jnp.asarray(gamma), jnp.asarray(log_b.numpy()),
                                    *je._pack_constants(js, jnp.float32), t_block=1, interpret=True)
    assert np.all(np.asarray(want) == 0.0)


def test_cpu_tensors_run_the_twins():
    _, ts = _streams()
    frames, gamma = _inputs(16, 5, 4)
    a, b = ke.pack_constants(ts, torch.float32)
    before = ke.emission_log_b.launches, ke.emission_stats.launches
    lb = ke.emission_log_b(_t(frames), a, b)
    ke.emission_stats(_t(frames), _t(gamma), lb, a, b)
    assert (ke.emission_log_b.launches, ke.emission_stats.launches) == before
    with pytest.raises(ValueError, match="no implementation"):
        ke.emission_log_b(torch.empty((16, 5), device="meta"), a, b)


def test_emission_block_takes_every_shape_it_took_at_7ca66a2():
    """emission_block gives a launch shape within a block's shared memory to
    every (D, S, M) the 7ca66a2 kernel took (its S M records of 2 DMAX + 4
    floats in shared memory, D <= 64) and to more: fewer threads where the
    tiles do not fit, the records in device memory where they do not fit
    beside a tile, log b straight out where its tile does not fit; its bytes
    mirror csrc/emission_em.cu emit_floats."""
    for D in (1, 3, 9, 13, 16, 17, 39, 64):
        dmax = next(b for b in (4, 8, 12, 16, 32, 64) if b >= D)
        for S in (1, 8, 64, 200, 256, 1024):
            for M in (1, 3, 16, 64):
                sh = ke.emission_block(4133, D, S, M)
                assert sh["smem_bytes"] <= ke.SMEM_LIMIT
                tf = sh["threads"] * (2 if dmax <= 16 else 1)
                recs = 0 if sh["recs_global"] else S * M * (2 * dmax + 4)
                assert sh["smem_bytes"] == 4 * (recs + 2 * tf * D + (0 if sh["direct"] else tf * S))
                assert sh["tile_frames"] == tf and sh["tiles"] == -(-4133 // tf)
                # the records in shared memory wherever they fit beside 32 threads' tiles
                tf32 = 32 * (2 if dmax <= 16 else 1)
                fits32 = 4 * (S * M * (2 * dmax + 4) + tf32 * (2 * D + S)) <= ke.SMEM_LIMIT
                assert sh["recs_global"] != fits32 or sh["direct"]
    with pytest.raises(ValueError, match="exceeds"):
        ke.emission_block(10, 65, 8, 3)


@pytest.mark.parametrize("S,M,D,N,t_block", [(64, 16, 13, 133, 19), (11, 3, 39, 261, 29)])
def test_emission_stats_matches_pallas_at_the_new_kernels_edges(S, M, D, N, t_block):
    """The moments twin against the Pallas kernel (interpret mode) where the
    redesigned kernel splits the states into groups or reads its records
    from device memory (S = 64, M = 16), at D = 39, and with N off every
    tile of the CUDA kernel (133, 261 frames: no multiple of 8)."""
    js, ts = _streams(S=S, M=M, D=D, seed=20 + S, zero_weight=True)
    frames, gamma = _inputs(N, D, S, seed=4)
    a, b = je._pack_constants(js, jnp.float32)
    log_b = ke.emission_log_b(_t(frames), _t(a), _t(b))
    log_b[5, 3] = -float("inf")
    want = np.asarray(je.emission_stats_pallas(jnp.asarray(frames), jnp.asarray(gamma), jnp.asarray(log_b.numpy()),
                                               a, b, t_block=t_block, interpret=True))
    got = ke.emission_stats(_t(frames), _t(gamma), log_b, _t(a), _t(b)).numpy()
    assert got.shape == (S, M, 2 * D + 1)
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=1e-5 * np.abs(want).max())


def _stats_took_at_6fe1112(N, D, S, M):
    """The 6fe1112 moments wrapper's rule: N >= 1, D <= 64 (a compiled
    bound), and one state's block within shared memory: M records of 2 DMAX
    + 4 floats, M weight rows of 129, 128 frames of D | 1 floats and M (2D +
    1) accumulators."""
    if N < 1 or D > 64:
        return False
    dmax = next(b for b in (4, 8, 12, 16, 32, 64) if b >= D)
    return 4 * (M * (2 * dmax + 4) + M * 129 + 128 * (D | 1) + M * (2 * D + 1)) <= ke.SMEM_LIMIT


def test_stats_block_takes_every_shape_it_took_at_6fe1112():
    """stats_block gives a launch shape within a block's shared memory to
    every (N, D, S, M) the 6fe1112 moments kernel took, and its bytes mirror
    csrc/emission_em.cu stats_floats: all S states a block where they fit
    (the frames then read once), else groups of states with the records in
    device memory; the wrapper's checks pass on meta tensors there."""
    took = 0
    for D in (1, 3, 9, 13, 16, 17, 39, 64):
        dmax = next(b for b in (4, 8, 12, 16, 32, 64) if b >= D)
        for S in (1, 8, 64, 200, 2048):
            for M in (1, 3, 16, 64, 100, 127, 128, 200):
                for N in (1, 37, 4133, 1024000):
                    if not _stats_took_at_6fe1112(N, D, S, M):
                        continue
                    took += 1
                    sh = ke.stats_block(N, D, S, M)
                    TF, SG, rg = sh["tile_frames"], sh["states"], sh["recs_global"]
                    assert 1 <= SG <= S and sh["groups"] == -(-S // SG) and sh["tiles"] == -(-N // TF)
                    assert TF in ke.STATS_TILES and 256 % TF == 0
                    ks, rows = TF + 4, SG * M
                    want = 4 * ((0 if rg else rows * (2 * dmax + 4)) + 2 * TF * D + 4 * TF * SG + rows * ks + D * ks
                                + rows * (2 * D + 1))
                    assert sh["smem_bytes"] == want <= ke.SMEM_LIMIT
                    # one group wherever a block of 8-frame tiles holds all the states
                    if ke.stats_smem_bytes(dmax, D, S, M, 8, True) <= ke.SMEM_LIMIT:
                        assert SG == S
                    # the records in shared memory wherever they fit beside the largest tile
                    if ke.stats_smem_bytes(dmax, D, S, M, 128, False) <= ke.SMEM_LIMIT:
                        assert not rg and TF == 128
    assert took > 500
    # the wrapper's own checks on meta tensors at a shape 6fe1112 took
    N, D, S, M = 4133, 39, 64, 16
    meta = dict(device="meta", dtype=torch.float32)
    ln = ke._EmissionLaunch("emission_stats", torch.empty((N, D), **meta), torch.empty((M, 2 * D, S), **meta),
                            torch.empty((M, 1, S), **meta), extra=(torch.empty((N, S), **meta),) * 2)
    assert (ln.N, ln.D, ln.S, ln.M, ln.dmax) == (N, D, S, M, 64)
    assert ke.stats_block(N, D, S, M)["groups"] > 1
    with pytest.raises(ValueError, match="exceeds"):
        ke.stats_block(10, 65, 8, 3)


def _concatenated_diag_records(a, bias, logw, D, M, W, S, dmax):
    """The diagonal records as common.mixture_records concatenated them
    before its in-place fill: [mu k, -k/2] each padded to dmax, bias, log w
    (0 where None), 0, 0."""
    F = torch.nn.functional
    bias = bias.reshape(M, W, S).permute(1, 2, 0)[..., None]
    zeros = torch.zeros_like(bias)
    logw = zeros if logw is None else logw.reshape(M, W, S).permute(1, 2, 0)[..., None]
    lin = F.pad(a[..., :D].reshape(M, W, S, D).permute(1, 2, 0, 3), (0, dmax - D))
    quad = F.pad(a[..., D:].reshape(M, W, S, D).permute(1, 2, 0, 3), (0, dmax - D))
    return torch.cat([lin, quad, bias, logw, zeros, zeros], -1).reshape(W, -1)


@pytest.mark.parametrize("S,M,D,W,with_logw", [(8, 3, 9, 1, False), (3, 16, 64, 1, False), (5, 1, 1, 1, False),
                                               (64, 2, 13, 1, False), (4, 3, 9, 5, False), (6, 2, 17, 3, True),
                                               (8, 3, 9, 1, True)])
def test_diag_records_are_the_shared_record_layout(S, M, D, W, with_logw):
    """common.mixture_records' diagonal records, filled in place, equal the
    concatenated layout csrc/emission.cuh reads bit for bit: the emission
    wrappers' call ((M, 2D, S) constants, log w in the bias) and the
    vocabulary / E-step calls (W blocks, log w stored)."""
    _, ts = _streams(S=S, M=M, D=D, seed=S + M + D)
    a, b = ke.pack_constants(ts, torch.float32)
    dmax = next(v for v in (4, 8, 12, 16, 32, 64) if v >= D)
    if W == 1 and not with_logw:  # the emission wrappers' operands
        a3, bias, logw = a.permute(0, 2, 1), b.reshape(M, S, 1), None
    else:
        g = torch.Generator().manual_seed(W + D)
        a3 = torch.randn((M, W * S, 2 * D), generator=g)
        bias = torch.randn((M, W * S, 1), generator=g)
        logw = torch.randn((M, W * S, 1), generator=g) if with_logw else None
    want = _concatenated_diag_records(a3, bias, logw, D, M, W, S, dmax)
    got = mixture_records(a3, None, bias, logw, D, M, W, S, False, dmax)
    assert got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)
    if W == 1 and not with_logw:
        ln = ke._EmissionLaunch("emission_log_b", torch.zeros((4, D)), a, b)
        assert torch.equal(ln.recs, want.reshape(-1))
