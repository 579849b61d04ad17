"""bf16 moment statistics: srhmm_tpu_torch's e_step / em_step(bf16_stats=True)
against srhmm_tpu's, float32 models and features (CPU).

Both packages round the centred features and the occupancies to bf16 and
contract them with a float32 result about the stream's mean of means, so
port and JAX agree within the float32 tolerance of the port's EM mirror
tests (tests/test_torch_em_lane.py: statistics rtol 5e-4, atol 2e-4 of
their scale, log prob rtol 1e-5).  Against the port's own float32 path:
the bounds of tests/test_em_fast.py:289-360 (moments within 1e-3 of their
largest value, 2e-3 for full covariance; num_trans and log prob rtol 1e-6;
the updated weights and means rtol and atol 5e-3, finite log det).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srhmm_tpu.train.em as j_em
import srhmm_tpu_torch.train.em as t_em
from srhmm_tpu.io.dataset import pack_utterances as j_pack
from srhmm_tpu_torch.io.dataset import pack_utterances as t_pack
from torch_port_utils import both_models, rand_word, sample_utterance

CASES = [("diag", (2, 6), 1e-3), ("full", (2, 4), 2e-3)]


def _case(cov, mixes_dims, seed=3):
    trans, streams = rand_word(seed, 4, [mixes_dims], cov, scale=3.0)
    # means far from 0: the shifted origin is what keeps the bf16 rounding
    # relative to the centred magnitudes
    streams = [dict(s, means=s["means"] + 40.0) for s in streams]
    jm, tm = both_models(trans, streams, "w")
    rng = np.random.default_rng(seed + 400)
    utts = [sample_utterance(rng, trans, streams, 60 + 5 * i)[0] for i in range(12)]
    return (jm.astype(jnp.float32), tm.astype(torch.float32),
            j_pack(utts, pad_multiple=32, dtype=jnp.float32), t_pack(utts, pad_multiple=32, dtype=torch.float32))


def _close(got, want, rtol, atol_scale):
    want = np.asarray(want, np.float64)
    got = got.double().numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_scale * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("cov,mixes_dims,_", CASES)
def test_bf16_e_step_matches_jax(cov, mixes_dims, _):
    jm, tm, bj, bt = _case(cov, mixes_dims)
    ref = j_em.e_step(jm, bj, bf16_stats=True)
    got = t_em.e_step(tm, bt, bf16_stats=True)
    for name in ("num_trans", "den_trans", "den_mix"):
        _close(getattr(got, name), getattr(ref, name), 5e-4, 2e-4)
    np.testing.assert_allclose(float(got.log_prob), float(ref.log_prob), rtol=1e-5)
    assert float(got.num_valid) == float(ref.num_valid) == 12
    for name in ("w", "x", "xx"):
        _close(getattr(got.streams[0], name), getattr(ref.streams[0], name), 5e-4, 2e-4)


@pytest.mark.parametrize("cov,mixes_dims,moment_bound", CASES)
def test_bf16_stay_close_to_float32(cov, mixes_dims, moment_bound):
    _, tm, _, bt = _case(cov, mixes_dims)
    s32 = t_em.e_step(tm, bt)
    s16 = t_em.e_step(tm, bt, bf16_stats=True)
    for name in ("w", "x", "xx"):
        a = getattr(s32.streams[0], name).double().numpy()
        b = getattr(s16.streams[0], name).double().numpy()
        assert np.abs(a - b).max() / np.abs(a).max() < moment_bound, name
    assert not torch.equal(s16.streams[0].xx, s32.streams[0].xx)  # the bf16 path ran
    # the transition statistics and log prob never touch the contractions
    np.testing.assert_allclose(s16.num_trans.numpy(), s32.num_trans.numpy(), rtol=1e-6)
    np.testing.assert_allclose(float(s16.log_prob), float(s32.log_prob), rtol=1e-6)

    m32, lp32, _ = t_em.em_step(tm, bt)
    m16, lp16, _ = t_em.em_step(tm, bt, bf16_stats=True)
    np.testing.assert_allclose(float(lp16), float(lp32), rtol=1e-6)
    for name in ("weights", "means"):
        np.testing.assert_allclose(getattr(m16.streams[0], name).numpy(), getattr(m32.streams[0], name).numpy(),
                                   rtol=5e-3, atol=5e-3)
    assert torch.isfinite(m16.streams[0].log_det).all()
    # em_step(bf16_stats=True) is m_step over e_step(bf16_stats=True)
    want = t_em.m_step(tm, s16)
    for a, b in zip(m16.state_dict().values(), want.state_dict().values()):
        assert torch.equal(a, b)
