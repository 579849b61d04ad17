"""The lattice kernel module against the JAX package, on the CPU.

forward_lattice / backward_lattice and their blocked forms (TPU kernels
#17-#20) run their plain twins here; the same numpy inputs go through
srhmm_tpu's Pallas lattice kernels in interpret mode: per element
max |port - jax| / max(|jax|, 1) <= 1e-5 with equal masks of values above
NEG_INF/2, padded tails included (rows past a length repeat the last valid
row forward and hold the final-state initialization backward), log b with
-inf entries (clamped at -1e30 by both), lengths 0 and 1.  The twins also
hold the JAX scans (log_forward_full / log_backward_full, float64) to 1e-4,
as tests/test_pallas_kernels.py holds the Pallas kernels.  The CUDA kernel
is held against the twins on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srhmm_tpu.ops.pallas.lattice_pallas as jl
from srhmm_tpu.ops import log_backward_full as j_backward_full
from srhmm_tpu.ops import log_forward_full as j_forward_full
from srhmm_tpu_torch.ops.kernels import lattice as kl
from srhmm_tpu_torch.ops.kernels.common import NEG_INF
from torch_port_utils import assert_log_close, log_trans_np

def inputs(T=32, S=6, lens=(32, 21, 7, 2, 1, 0), seed=9, n_neg_inf=5):
    """(T, S, B) float32 log b with a few -inf entries, and int32 lengths."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    lb = rng.normal(size=(T, S, B)).astype(np.float32) * 2.0
    idx = rng.integers(0, [T, S, B], size=(n_neg_inf, 3))
    lb[idx[:, 0], idx[:, 1], idx[:, 2]] = -np.inf
    return lb, np.asarray(lens, np.int32)


def _jax(fn, lb, lt, lens, **kw):
    return np.asarray(fn(jnp.asarray(lb), jnp.asarray(lt), jnp.asarray(lens), interpret=True, **kw))


def _port(fn, lb, lt, lens, **kw):
    out = fn(torch.from_numpy(lb), torch.from_numpy(lt), torch.from_numpy(lens), **kw)
    assert out.dtype == torch.float32
    return out.numpy()


@pytest.mark.parametrize("kind", ["delta1", "delta2", "dense"])
def test_forward_lattice_matches_pallas(kind):
    lb, lens = inputs()
    lt = log_trans_np(lb.shape[1], kind)
    assert_log_close(_port(kl.forward_lattice, lb, lt, lens), _jax(jl.forward_lattice_pallas, lb, lt, lens))


@pytest.mark.parametrize("kind", ["delta1", "delta2", "dense"])
def test_backward_lattice_matches_pallas(kind):
    lb, lens = inputs(seed=10)
    lt = log_trans_np(lb.shape[1], kind, seed=1)
    assert_log_close(_port(kl.backward_lattice, lb, lt, lens), _jax(jl.backward_lattice_pallas, lb, lt, lens))


@pytest.mark.parametrize("k_block", [1, 4, 8])
def test_blocked_lattices_match_pallas(k_block):
    lb, lens = inputs(seed=11, lens=(32, 21, 8, 2, 0))
    lt = log_trans_np(lb.shape[1], "delta1", seed=2)
    fwd = _port(kl.forward_lattice_blocked, lb, lt, lens, k_block=k_block)
    bwd = _port(kl.backward_lattice_blocked, lb, lt, lens, k_block=k_block)
    assert_log_close(fwd, _jax(jl.forward_lattice_pallas_blocked, lb, lt, lens, k_block=k_block))
    assert_log_close(bwd, _jax(jl.backward_lattice_pallas_blocked, lb, lt, lens, k_block=k_block))
    # k_block is tiling: the blocked and unblocked functions are one function
    np.testing.assert_array_equal(fwd, _port(kl.forward_lattice, lb, lt, lens))
    np.testing.assert_array_equal(bwd, _port(kl.backward_lattice, lb, lt, lens))


def test_blocked_wrappers_keep_the_tiling_assertion():
    lb, lens = inputs(T=30)
    lt = log_trans_np(lb.shape[1], "delta1")
    for fn in (kl.forward_lattice_blocked, kl.backward_lattice_blocked):
        with pytest.raises(AssertionError):
            _port(fn, lb, lt, lens, k_block=8)


def test_padding_semantics():
    """Rows past a length repeat the last valid row (forward); rows at
    t >= length-1 hold the final-state initialization (backward); a
    zero-length row keeps frame 0."""
    lb, lens = inputs(seed=12)
    lt = log_trans_np(lb.shape[1], "delta1")
    la = _port(kl.forward_lattice, lb, lt, lens)
    lbw = _port(kl.backward_lattice, lb, lt, lens)
    S = lb.shape[1]
    init = np.where(np.arange(S) == S - 1, 0.0, NEG_INF).astype(np.float32)
    for b, n in enumerate(lens):
        last = max(int(n), 1) - 1
        assert (la[last:, :, b] == la[last, :, b]).all()
        assert (lbw[max(int(n) - 1, 0):, :, b] == init).all()


def test_twins_match_the_jax_scans():
    """The twins against srhmm_tpu's float64 log_forward_full /
    log_backward_full (the scans the Pallas kernels are tested against),
    rtol = atol = 1e-4 over the finite values, values below -1e28 where
    the scans give -inf."""
    lb, lens = inputs(seed=13, n_neg_inf=0, lens=(32, 20, 7, 2))
    lt = log_trans_np(lb.shape[1], "delta1", seed=4)
    la = _port(kl.forward_lattice, lb, lt, lens)
    lbw = _port(kl.backward_lattice, lb, lt, lens)
    for b, n in enumerate(lens):
        x = jnp.asarray(lb[:, :, b], jnp.float64)
        for got, ref in ((la[:, :, b], j_forward_full(x, jnp.asarray(lt, jnp.float64), int(n))),
                         (lbw[:, :, b], j_backward_full(x, jnp.asarray(lt, jnp.float64), int(n)))):
            ref = np.asarray(ref)
            fin = np.isfinite(ref)
            np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-4, atol=1e-4)
            assert (got[~fin] < -1e28).all()


def test_cpu_tensors_run_the_twins_and_other_devices_raise():
    lb, lens = inputs(T=16, lens=(16, 3))
    lt = log_trans_np(lb.shape[1], "delta1")
    fns = (kl.forward_lattice, kl.backward_lattice, kl.forward_lattice_blocked, kl.backward_lattice_blocked)
    before = [f.launches for f in fns]
    for f in fns:
        _port(f, lb, lt, lens)
    assert [f.launches for f in fns] == before
    meta = torch.empty(lb.shape, device="meta")
    for f in fns:
        with pytest.raises(ValueError, match="no implementation"):
            f(meta, torch.from_numpy(lt), torch.from_numpy(lens))
