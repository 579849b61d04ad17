"""The lattice kernel module against the JAX package, on the CPU.

forward_lattice / backward_lattice and their blocked forms (TPU kernels
#17-#20) run their plain twins here; the same numpy inputs go through
srhmm_tpu's Pallas lattice kernels in interpret mode: per element
max |port - jax| / max(|jax|, 1) <= 1e-5 with equal masks of values above
NEG_INF/2, padded tails included (rows past a length repeat the last valid
row forward and hold the final-state initialization backward), log b with
-inf entries (clamped at -1e30 by both), lengths 0 and 1.  The twins also
hold the JAX scans (log_forward_full / log_backward_full, float64) to 1e-4,
as tests/test_pallas_kernels.py holds the Pallas kernels; the forward and
backward twins also at S = 33 and 64, where the CUDA kernels hold two
states a lane.  The forward kernel's launch shape (forward_block) is held
to every shape the 6fe1112 kernel took, the backward's and the Viterbi's
(backward_block, viterbi_block) to every shape the bac667f kernels took.
The CUDA kernels are held against the twins on the card
(tests/test_torch_cuda.py, chip_smoke.py).
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


@pytest.mark.parametrize("S,kind", [(33, "dense"), (64, "delta2")])
def test_forward_lattice_matches_pallas_past_32_states(S, kind):
    """Past 32 states a lane of the CUDA forward kernel holds two states:
    the twin there against the Pallas kernel, T = 40 off the kernel's
    32-frame tiles."""
    lb, lens = inputs(T=40, S=S, lens=(40, 33, 9, 2, 1, 0), seed=14)
    lt = log_trans_np(S, kind, seed=6)
    assert_log_close(_port(kl.forward_lattice, lb, lt, lens), _jax(jl.forward_lattice_pallas, lb, lt, lens))


def test_forward_block_takes_every_shape_it_took_at_6fe1112():
    """The 6fe1112 forward kernel took every 1 <= S <= 64, T >= 1, B >= 1 in
    both layouts and with per-row transitions (a block of max(1, 128 // S)
    utterances, one thread a (state, utterance), within shared memory at
    every S).  forward_block gives each a launch shape the csrc/lattice.cu
    launcher takes: G = 32 // S utterances a warp (1 past 32 states, two
    states a lane), U = 4 G a block, NS >= S compiled slots, a tile whose
    shared memory (forward_floats) fits, the blocks covering B; the
    wrappers' checks pass on meta tensors.  Past 64 states the block-wide
    mode takes over (tests/test_torch_wide_lattice.py); past MAX_STATES
    the shape is refused."""
    for S in range(1, 65):
        for layout in ("tsb", "bts"):
            for per_row in (False, True):
                for B in (1, 37, 2048, 20480):
                    sh = kl.forward_block(S, B, layout, per_row)
                    R, G, U, TT = sh["states_per_lane"], sh["utts_per_warp"], sh["utts"], sh["tile"]
                    assert (R, G) == ((2, 1) if S > 32 else (1, 32 // S)) and U == 4 * G and G * S <= 32 * R
                    assert sh["slots"] >= S and sh["slots"] in (4, 8, 16, 32, 64) and sh["blocks"] * U >= B
                    assert TT in kl.FORWARD_TILES
                    tile = TT * S * U if layout == "tsb" else U * (-(-TT * S // 4) * 4 + 4)
                    want = 4 * (2 * tile + (2 * TT * S * U if layout == "tsb" else 0)
                                + ((U if per_row else 1) * S * S if S > 32 else 0))
                    assert sh["smem_bytes"] == want <= kl.SMEM_LIMIT
    meta = dict(device="meta", dtype=torch.float32)
    for S in (1, 33, 64):
        ln = kl.LatticeLaunch("log_forward_batch", torch.empty((37, 95, S), **meta), torch.empty((37, S, S), **meta),
                              torch.empty((37,), device="meta", dtype=torch.int32), "bts", per_row_ok=True)
        assert (ln.B, ln.T, ln.S, ln.per_row) == (37, 95, S, 1)
    with pytest.raises(ValueError, match="states"):
        kl.forward_block(kl.MAX_STATES + 1, 8, "tsb")


@pytest.mark.parametrize("S,kind", [(33, "dense"), (64, "delta2")])
def test_backward_lattice_matches_pallas_past_32_states(S, kind):
    """Past 32 states a lane of the CUDA backward kernel holds two states
    (the transitions transposed in shared memory): the twin there against
    the Pallas kernel, T = 40 off the kernel's 32-frame tiles."""
    lb, lens = inputs(T=40, S=S, lens=(40, 33, 9, 2, 1, 0), seed=15)
    lt = log_trans_np(S, kind, seed=7)
    assert_log_close(_port(kl.backward_lattice, lb, lt, lens), _jax(jl.backward_lattice_pallas, lb, lt, lens))


def _lane_shape_ok(sh, S, B):
    """The launch shape csrc/lattice.cu's launcher takes: G = 32 // S
    utterances a warp (1 past 32 states, two states a lane), U = 4 G a
    block, NS >= S compiled slots, a tile of FORWARD_TILES, the blocks
    covering B."""
    R, G, U = sh["states_per_lane"], sh["utts_per_warp"], sh["utts"]
    assert (R, G) == ((2, 1) if S > 32 else (1, 32 // S)) and U == 4 * G and G * S <= 32 * R
    assert sh["slots"] >= S and sh["slots"] in (4, 8, 16, 32, 64) and sh["blocks"] * U >= B
    assert sh["tile"] in kl.FORWARD_TILES


def test_backward_block_takes_every_shape_it_took_at_bac667f():
    """The bac667f backward kernel took every 1 <= S <= 64, T >= 1, B >= 1
    with shared (S, S) transitions (a block of max(1, 128 // S) utterances,
    one thread a (state, utterance)).  backward_block gives each a launch
    shape its launcher takes, with the forward lattice's lanes and shared
    memory (log b and the lattice in two (TT, S, U) slots each, the
    transitions past 32 states) within a block's limit; the wrapper's checks
    pass on meta tensors and refuse per-row transitions."""
    for S in range(1, 65):
        for B in (1, 37, 2048, 20480):
            sh = kl.backward_block(S, B)
            _lane_shape_ok(sh, S, B)
            U, TT = sh["utts"], sh["tile"]
            assert sh["smem_bytes"] == 4 * (4 * TT * S * U + (S * S if S > 32 else 0)) <= kl.SMEM_LIMIT
            fwd = kl.forward_block(S, B, "tsb")
            assert {k: sh[k] for k in ("states_per_lane", "utts_per_warp", "utts", "slots", "blocks")} == {
                k: fwd[k] for k in ("states_per_lane", "utts_per_warp", "utts", "slots", "blocks")}
    meta = dict(device="meta", dtype=torch.float32)
    lens = torch.empty((37,), device="meta", dtype=torch.int32)
    for S in (1, 33, 64):
        ln = kl.LatticeLaunch("backward_lattice", torch.empty((95, S, 37), **meta), torch.empty((S, S), **meta), lens,
                              "tsb")
        assert (ln.T, ln.S, ln.B, ln.per_row) == (95, S, 37, 0)
        with pytest.raises(ValueError, match="transitions"):
            kl.LatticeLaunch("backward_lattice", torch.empty((95, S, 37), **meta), torch.empty((37, S, S), **meta),
                             lens, "tsb")
    with pytest.raises(ValueError, match="states"):
        kl.backward_block(kl.MAX_STATES + 1, 8)


def test_viterbi_block_takes_every_shape_it_took_at_bac667f():
    """The bac667f Viterbi kernel took every 1 <= S <= 64, T >= 1, B >= 1
    on (B, T, S) log b.  viterbi_block gives each a launch shape its
    launcher takes: the forward's lanes, shared memory of log b and the
    backpointers in two slots each of U runs of TT S at a pitch rounded up
    to 4, + 4, the transitions past 32 states, within a block's limit; the
    wrapper's checks pass on meta tensors."""
    for S in range(1, 65):
        for B in (1, 37, 2048, 20480):
            sh = kl.viterbi_block(S, B)
            _lane_shape_ok(sh, S, B)
            U, TT = sh["utts"], sh["tile"]
            pitch = -(-TT * S // 4) * 4 + 4
            assert sh["smem_bytes"] == 4 * (4 * U * pitch + (S * S if S > 32 else 0)) <= kl.SMEM_LIMIT
    meta = dict(device="meta", dtype=torch.float32)
    for S in (1, 33, 64):
        ln = kl.LatticeLaunch("viterbi_batch", torch.empty((37, 95, S), **meta), torch.empty((S, S), **meta),
                              torch.empty((37,), device="meta", dtype=torch.int32), "bts")
        assert (ln.B, ln.T, ln.S, ln.per_row) == (37, 95, S, 0)
    with pytest.raises(ValueError, match="states"):
        kl.viterbi_block(kl.MAX_STATES + 1, 8)
