"""The fused emission / moment kernel module against the JAX package, on the
CPU.

pack_constants against srhmm_tpu's _pack_constants (rtol 1e-6); the twins
of emission_log_b (TPU kernel #21) and emission_stats (#22) against the
Pallas kernels in interpret mode on the same packed arrays: log b within
1e-5 per element, moments rtol 5e-4 (the bounds of
tests/test_pallas_kernels.py:33-39 and :215-217); log_state_emission_fused
against JAX's and against the plain log_state_emission; an all -inf log b
gives all-zero moments (mirrors :220-238); a zero-weight mixture; N off
every tile of the CUDA kernels (128 frames a chunk, 2048 a block); the
emission kernel's launch shapes (emission_block) for every shape the
7ca66a2 kernel took.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srhmm_tpu.ops.pallas.emission_pallas as je
from srhmm_tpu_torch.ops.emission import log_state_emission
from srhmm_tpu_torch.ops.kernels import emission as ke
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
