"""The two E-steps that reach TPU kernels #19-#22, against the JAX package,
on the CPU.

e_step_fused (emission and moments through ops/kernels/emission.py, their
twins here) against srhmm_tpu's e_step_fused(interpret=True) with the rtols
of tests/test_pallas_kernels.py::test_fused_e_step_matches_xla_e_step, and
against the port's plain e_step; its ValueError on full covariance and on
two streams.  e_step_lane_major: lattices="scan" in float64 against JAX's
(rtol 1e-9, tests/test_em_fast.py::test_lane_major_e_step_matches_vmapped)
and against the port's e_step; lattices="pallas" (the lattice kernels'
twins) in float32 against JAX's lattices="pallas" (2e-4,
tests/test_em_fast.py::test_lane_major_pallas_lattices_match).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srhmm_tpu.train.em as j_em
import srhmm_tpu_torch.train.em as t_em
from srhmm_tpu.io.dataset import pack_utterances as j_pack
from srhmm_tpu_torch.io.dataset import pack_utterances as t_pack
from torch_port_utils import both_models, rand_word

FIELDS = ("num_trans", "den_trans", "den_mix", "log_prob", "num_valid")


def _models(S, mixes_dims, cov="diag", seed=3, delta=1):
    return both_models(*rand_word(seed, S, mixes_dims, cov, delta))


def _batches(utts, pad_multiple, dtype_j, dtype_t, pad_batch_to=None):
    return (j_pack(utts, pad_multiple=pad_multiple, pad_batch_to=pad_batch_to, dtype=dtype_j),
            t_pack(utts, pad_multiple=pad_multiple, pad_batch_to=pad_batch_to, dtype=dtype_t))


def _stats(st):
    """[num_trans, den_trans, den_mix, log_prob, num_valid, then w, x, xx
    per stream] as float64 numpy."""
    out = [np.asarray(getattr(st, f), np.float64) for f in FIELDS]
    for s in st.streams:
        out += [np.asarray(s.w, np.float64), np.asarray(s.x, np.float64), np.asarray(s.xx, np.float64)]
    return out


def test_e_step_fused_matches_jax():
    """Mirrors tests/test_pallas_kernels.py::test_fused_e_step_matches_xla_e_step
    (S=5, M=3, D=4, B=6, T=40 padded to 8), at its rtols."""
    jm, tm = _models(5, [(3, 4)], seed=7)
    jm, tm = jm.astype(jnp.float32), tm.astype(torch.float32)
    rng = np.random.default_rng(7)
    utts = [rng.normal(size=(40 - 2 * (i % 3), 4)) for i in range(6)]
    jb, tb = _batches(utts, 8, jnp.float32, torch.float32)
    ref = j_em.e_step_fused(jm, jb, interpret=True)
    got = t_em.e_step_fused(tm, tb)
    for name in ("num_trans", "den_trans", "den_mix"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(float(got.log_prob), float(ref.log_prob), rtol=1e-5)
    assert float(got.num_valid) == float(ref.num_valid)
    for g, r in zip(got.streams, ref.streams):
        np.testing.assert_allclose(g.w.numpy(), np.asarray(r.w), rtol=5e-4, atol=1e-5)
        np.testing.assert_allclose(g.x.numpy(), np.asarray(r.x), rtol=5e-4, atol=2e-4)
        np.testing.assert_allclose(g.xx.numpy(), np.asarray(r.xx), rtol=5e-4, atol=2e-4)


def test_e_step_fused_matches_the_plain_e_step():
    """Padding, a zero-length row and a length-1 row: the fused E-step's
    statistics equal the port's plain e_step (float32, rtol 5e-4)."""
    _, tm = _models(4, [(2, 5)], seed=8, delta=2)
    tm = tm.astype(torch.float32)
    rng = np.random.default_rng(8)
    utts = [rng.normal(size=(n, 5)) for n in (23, 1, 30, 17)]
    tb = t_pack(utts, pad_multiple=8, pad_batch_to=5, dtype=torch.float32)
    for g, r in zip(_stats(t_em.e_step_fused(tm, tb)), _stats(t_em.e_step(tm, tb))):
        np.testing.assert_allclose(g, r, rtol=5e-4, atol=1e-5 * max(np.abs(r).max(), 1.0))


def test_e_step_fused_takes_one_diagonal_stream_only():
    rng = np.random.default_rng(0)
    tb = t_pack([rng.normal(size=(9, 3))], pad_multiple=1)
    _, full = _models(3, [(1, 3)], cov="full")
    _, two = _models(3, [(1, 3), (1, 3)])
    for model in (full, two):
        with pytest.raises(ValueError, match="single diagonal-covariance stream"):
            t_em.e_step_fused(model.astype(torch.float32), tb)


@pytest.mark.parametrize("mixes_dims", [[(2, 6)], [(2, 6), (1, 6)]])
def test_lane_major_scan_matches_jax_in_float64(mixes_dims):
    """Mirrors tests/test_em_fast.py::test_lane_major_e_step_matches_vmapped
    (rtol 1e-9), one and two streams (both read the batch's features)."""
    jm, tm = _models(5, mixes_dims, seed=3)
    rng = np.random.default_rng(11)
    utts = [rng.normal(size=(40 + 13 * i, 6)) for i in range(5)]
    jb, tb = _batches(utts, 32, jnp.float64, torch.float64, pad_batch_to=8)
    want = [np.asarray(x, np.float64) for x in jax.tree.leaves(j_em.e_step_lane_major(jm, jb))]
    got = t_em.e_step_lane_major(tm, tb)
    # JAX's leaves: num_trans, den_trans, den_mix, (w, x, xx) per stream, log_prob, num_valid
    order = [got.num_trans, got.den_trans, got.den_mix]
    for s in got.streams:
        order += [s.w, s.x, s.xx]
    order += [got.log_prob, got.num_valid]
    assert len(order) == len(want)
    for g, w in zip(order, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-9, atol=1e-9)
    for g, r in zip(_stats(got), _stats(t_em.e_step(tm, tb))):
        np.testing.assert_allclose(g, r, rtol=1e-9, atol=1e-9)


def test_lane_major_pallas_lattices_match_jax():
    """Mirrors tests/test_em_fast.py::test_lane_major_pallas_lattices_match
    (float32, 2e-4): the port's lattices="pallas" (the lattice kernels'
    twins) against JAX's (the Pallas kernels in interpret mode), and against
    the port's own scan lattices."""
    jm, tm = _models(5, [(2, 6)], seed=3)
    jm, tm = jm.astype(jnp.float32), tm.astype(torch.float32)
    rng = np.random.default_rng(17)
    utts = [rng.normal(size=(40 + 13 * i, 6)) for i in range(5)]
    jb, tb = _batches(utts, 32, jnp.float32, torch.float32, pad_batch_to=8)
    ref = j_em.e_step_lane_major(jm, jb, lattices="pallas")
    got = t_em.e_step_lane_major(tm, tb, lattices="pallas")
    scan = t_em.e_step_lane_major(tm, tb, lattices="scan")
    for g, r, s in zip(_stats(got), _stats(ref), _stats(scan)):
        np.testing.assert_allclose(g, r, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(g, s, rtol=2e-4, atol=2e-4)


def test_lane_major_pallas_uses_the_first_dividing_k_block(monkeypatch):
    from srhmm_tpu_torch.ops.kernels import lattice as kl

    seen = []
    for name in ("forward_lattice_blocked", "backward_lattice_blocked"):
        orig = getattr(kl, name)
        monkeypatch.setattr(kl, name, lambda *a, k_block, _o=orig: (seen.append(k_block), _o(*a, k_block=k_block))[1])
    _, tm = _models(3, [(1, 2)])
    rng = np.random.default_rng(0)
    for T, k in ((500, 4), (48, 16), (7, 1)):
        seen.clear()
        t_em.e_step_lane_major(tm.astype(torch.float32), t_pack([rng.normal(size=(T, 2))], pad_multiple=1),
                               lattices="pallas")
        assert seen == [k, k]
    with pytest.raises(ValueError, match="lattices"):
        t_em.e_step_lane_major(tm, t_pack([rng.normal(size=(4, 2))], pad_multiple=1, dtype=torch.float64),
                               lattices="xla")
