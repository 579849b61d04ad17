"""The lattice kernels past 64 states against the JAX package, on the CPU.

Past 64 states csrc/lattice.cu runs its group mode (a group of utterances a
cluster of blocks; the Viterbi its max-plus kind); the wrappers run their
plain twins here.
The same numpy inputs go through srhmm_tpu's Pallas kernels in interpret
mode at S = 65, 96 and 130 (banded, dense and spread: a state whose only
sources sit more than 100 nats below its row's maximum; rows of length 0
and 1, -inf entries of log b):
forward_lattice and its blocked form against forward_lattice_pallas(_blocked),
backward_lattice(_blocked) against backward_lattice_pallas(_blocked),
log_forward_batch (shared and per-row transitions) against
log_forward_batch_pallas, viterbi_batch against viterbi_batch_pallas:
per element max |port - jax| / max(|jax|, 1) <= 1e-5 with equal masks of
values above NEG_INF/2 (tests/test_pallas_kernels.py's float32 bound for
these kernels), backpointers and backtraces equal, a duplicated-state tie
going to the lowest source.  e_step_lane_major(lattices="pallas") at S = 96
against JAX's (rtol 2e-3, atol 2e-4 max, log prob rtol 1e-5: the fused
float32 statistics bound of tests/test_pallas_kernels.py).  The launch
shapes (group_block, and viterbi_block's max-plus rule) at every S of
torch_port_utils.WIDE_LATTICE_CASES and beyond, their shared memory
re-derived here from csrc/lattice.cu's group_layout, every key owned by
one block of its cluster; the wrappers' refusal past MAX_STATES on meta
tensors.  The Viterbi twin vectorized over the sources (the default)
bitwise its strict > loop, ties and states not yet reachable included.  The CUDA kernels are held against the twins on
the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srhmm_tpu.ops.pallas.forward_pallas as jf
import srhmm_tpu.ops.pallas.lattice_pallas as jl
import srhmm_tpu.train.em as j_em
import srhmm_tpu_torch.train.em as t_em
from srhmm_tpu.io.dataset import pack_utterances as j_pack
from srhmm_tpu_torch.io.dataset import pack_utterances as t_pack
from srhmm_tpu_torch.ops.kernels import forward as kf
from srhmm_tpu_torch.ops.kernels import lattice as kl
from torch_port_utils import (
    WIDE_LATTICE_CASES,
    assert_log_close,
    both_models,
    lattice_ranges,
    log_trans_np,
    rand_word,
    spread_log_b,
)

LENS = (40, 33, 9, 1, 0)
CASES = [(65, "delta1"), (96, "dense"), (130, "delta2"), (130, "dense"), (130, "spread")]


def _inputs(S, kind, T=40, seed=0):
    rng = np.random.default_rng(seed + S)
    lb = spread_log_b((rng.normal(size=(T, S, len(LENS))) * 2).astype(np.float32), kind, axis=1)
    idx = rng.integers(0, [T, S, len(LENS)], size=(5, 3))
    lb[idx[:, 0], idx[:, 1], idx[:, 2]] = -np.inf
    return lb, log_trans_np(S, kind, seed=S), np.asarray(LENS, np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _j(x):
    return jnp.asarray(x)


@pytest.mark.parametrize("S,kind", CASES)
def test_lattices_match_pallas_past_64_states(S, kind):
    lb, lt, lens = _inputs(S, kind)
    fwd = kl.forward_lattice(_t(lb), _t(lt), _t(lens)).numpy()
    bwd = kl.backward_lattice(_t(lb), _t(lt), _t(lens)).numpy()
    assert_log_close(fwd, np.asarray(jl.forward_lattice_pallas(_j(lb), _j(lt), _j(lens), interpret=True)))
    assert_log_close(bwd, np.asarray(jl.backward_lattice_pallas(_j(lb), _j(lt), _j(lens), interpret=True)))
    if kind == "delta1":  # the time-blocked forms, once
        assert_log_close(kl.forward_lattice_blocked(_t(lb), _t(lt), _t(lens), k_block=8).numpy(), np.asarray(
            jl.forward_lattice_pallas_blocked(_j(lb), _j(lt), _j(lens), k_block=8, interpret=True)))
        assert_log_close(kl.backward_lattice_blocked(_t(lb), _t(lt), _t(lens), k_block=8).numpy(), np.asarray(
            jl.backward_lattice_pallas_blocked(_j(lb), _j(lt), _j(lens), k_block=8, interpret=True)))


@pytest.mark.parametrize("S,kind", CASES)
def test_forward_batch_and_viterbi_match_pallas_past_64_states(S, kind):
    lb, lt, lens = _inputs(S, kind, seed=7)
    lb = np.ascontiguousarray(lb.transpose(2, 0, 1))  # (B, T, S)
    got = kf.log_forward_batch(_t(lb), _t(lt), _t(lens)).numpy()
    assert_log_close(got, np.asarray(jf.log_forward_batch_pallas(_j(lb), _j(lt), _j(lens), interpret=True)))
    rows = np.stack([log_trans_np(S, ("delta1", "dense")[b % 2], seed=b) for b in range(len(LENS))])
    got = kf.log_forward_batch(_t(lb), _t(rows), _t(lens)).numpy()
    assert_log_close(got, np.asarray(jf.log_forward_batch_pallas(_j(lb), _j(rows), _j(lens), interpret=True)))
    scores, bptr = kf.viterbi_batch(_t(lb), _t(lt), _t(lens))
    j_scores, j_bptr = jf.viterbi_batch_pallas(_j(lb), _j(lt), _j(lens), interpret=True)
    assert_log_close(scores.numpy(), np.asarray(j_scores))
    np.testing.assert_array_equal(bptr.numpy(), np.asarray(j_bptr))
    np.testing.assert_array_equal(kf.backtrace(bptr, _t(lens), S - 1).numpy(),
                                  np.asarray(jf.backtrace(j_bptr, _j(lens), S - 1)))


def test_viterbi_tie_goes_to_the_lowest_source_past_64_states():
    """States 40 and 41 duplicated (their transitions and log b): every
    candidate from them ties exactly, and the lower one wins, as in JAX."""
    S, T = 96, 30
    rng = np.random.default_rng(5)
    p = rng.uniform(0.1, 1.0, size=(S, S))
    p[41, :] = p[40, :]
    p[:, 41] = p[:, 40]
    lt = np.log(p / p.sum(-1, keepdims=True)).astype(np.float32)
    lb = (rng.normal(size=(3, T, S)) * 2).astype(np.float32)
    lb[..., 41] = lb[..., 40]
    lens = np.asarray([T, 17, 2], np.int32)
    _, bptr = kf.viterbi_batch(_t(lb), _t(lt), _t(lens))
    _, j_bptr = jf.viterbi_batch_pallas(_j(lb), _j(lt), _j(lens), interpret=True)
    np.testing.assert_array_equal(bptr.numpy(), np.asarray(j_bptr))
    assert (bptr.numpy()[:, 1:] == 40).any() and not (bptr.numpy()[0, 1:] == 41).any()


def test_lane_major_pallas_lattices_match_jax_past_64_states():
    """e_step_lane_major(lattices="pallas") on a 32-unit left-right chain of
    S = 96 states (the align_s96 shape, cut to 4 utterances) against JAX's,
    float32.  At 96 states either package's float32 statistics stray from
    float64 by up to 1.3e-3 of their scale (both alike), past
    tests/test_em_fast.py's 2e-4 for S = 5; the bound is the one
    tests/test_pallas_kernels.py holds fused float32 statistics to: rtol
    2e-3, atol 2e-4 max |jax|."""
    jm, tm = both_models(*rand_word(11, 96, [(1, 3)], "diag", 1))
    jm, tm = jm.astype(jnp.float32), tm.astype(torch.float32)
    rng = np.random.default_rng(12)
    utts = [rng.normal(size=(n, 3)) for n in (120, 97, 100, 131)]
    jb = j_pack(utts, pad_multiple=16, dtype=jnp.float32)
    tb = t_pack(utts, pad_multiple=16, dtype=torch.float32)
    ref = j_em.e_step_lane_major(jm, jb, lattices="pallas")
    got = t_em.e_step_lane_major(tm, tb, lattices="pallas")
    pairs = [(getattr(got, n).numpy(), np.asarray(getattr(ref, n))) for n in ("num_trans", "den_trans", "den_mix")]
    pairs += [(getattr(gs, n).numpy(), np.asarray(getattr(rs, n)))
              for gs, rs in zip(got.streams, ref.streams) for n in ("w", "x", "xx")]
    for a, b in pairs:
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4 * max(np.abs(b).max(), 1.0))
    np.testing.assert_allclose(float(got.log_prob), float(ref.log_prob), rtol=1e-5)
    assert float(got.num_valid) == float(ref.num_valid)


def _group_floats(S, G, C, NT, KS, SP, lt_cap):
    """csrc/lattice.cu group_layout and group_floats, written out again:
    keys ceil(S / C) rounded up to 4, two rows of G utterances at the
    larger of S rounded up to the tile's SP KS sources and S | 1, the ring
    of 8 frames of the owned pairs and their carries, 2 KS G Db partials,
    2 Db + 1 + G ints, the transitions."""
    r4 = lambda n: -(-n // 4) * 4  # noqa: E731
    Db = r4(-(-S // C))
    rp = max(-(-S // (SP * KS)) * SP * KS, S | 1)
    owned = -(-G * Db // NT) * NT
    return r4(2 * G * rp) + 9 * owned + 2 * KS * G * Db + r4(2 * Db + 1 + G) + lt_cap


WIDE_S = sorted({65, 66, 95, 96, 127, 128, 129, 130, 257, 511, 512, 513, 1024, 2048, 4095, 4096}
                | {c[0] for c in WIDE_LATTICE_CASES})


def test_wide_block_shapes_mirror_the_kernel():
    """Every S of 65-4096 at B = 1, 37 and 2048: the forward's, the
    backward's and the Viterbi's group shapes (G utterances, C blocks a
    cluster, NT threads: the register tiles' towards 512 and at most 640 in
    a cluster, the pairs over the fewest a thread within 1024 in one block;
    KS source shares of SP, lt_cap) with shared memory as csrc/lattice.cu
    computes it and within a block's limit, at least the streamed route's
    tiles of transitions, one utterance a group for per-row transitions;
    past MAX_STATES every rule refuses."""
    for S in WIDE_S:
        for B in (1, 37, 2048):
            shapes = [kl.forward_block(S, B, "tsb"), kl.forward_block(S, B, "bts"), kl.backward_block(S, B),
                      kl.forward_block(S, B, "bts", per_row=True), kl.viterbi_block(S, B)]
            assert shapes[0] == shapes[1] == shapes[2]
            for i, sh in enumerate(shapes):
                G, C, NT, KS, SP, cap = (sh[k] for k in ("utts", "cluster", "threads", "splits", "share", "lt_cap"))
                UT = 2 if G % 2 == 0 else 1
                units = (G // UT) * (sh["keys"] // 4)
                assert sh["mode"] == "group" and sh["utt_tile"] == UT and (G == 1 or i != 3)
                assert KS & (KS - 1) == 0 and NT % 32 == 0
                if C > 1:  # the register tiles aim at 512 threads, at most 640
                    assert NT == -(-units * KS // 32) * 32 <= 640 and (units * KS >= 512 or KS == 1)
                else:  # one block: the pairs over the fewest a thread within 1024 threads
                    owned = -(-G * sh["keys"] // 1024)
                    assert NT == -(-(-(-G * sh["keys"] // owned)) // 32) * 32 <= 1024
                    assert units * KS <= NT and (units * KS * 2 > NT or KS == 64)
                assert SP in ((32, 16, 8) if C > 1 else (8,)) and sh["tile_sources"] == SP * KS
                assert sh["owned"] == -(-G * sh["keys"] // NT) <= 16
                assert cap % 4 == 0 and cap >= 2 * SP * KS * sh["keys"]
                assert sh["smem_bytes"] == 4 * _group_floats(S, G, C, NT, KS, SP, cap) <= kl.SMEM_LIMIT
                assert sh["groups"] == -(-B // G) and sh["blocks"] == sh["groups"] * C
    for rule in (lambda S: kl.forward_block(S, 1, "tsb"), lambda S: kl.backward_block(S, 1),
                 lambda S: kl.viterbi_block(S, 1)):
        with pytest.raises(ValueError, match="4096"):
            rule(kl.MAX_STATES + 1)


@pytest.mark.parametrize("B", [1, 37, 64, 2048])
def test_viterbi_group_rule(B):
    """viterbi_block past 64 states, at every S of WIDE_LATTICE_CASES: the
    group mode's shape (its shared memory as csrc/lattice.cu's group_layout
    computes it, within SMEM_LIMIT) of the C whose frame, the longer of a
    block's G Db S max-plus steps at GROUP_MAXPLUS_PER_S (4 instructions a
    step at 128 lanes a clock, no exponentials) and the L2 reads of the
    groups at once, takes the least time over its waves, then the fewest
    groups; G fills GROUP_CLUSTERS_AT_ONCE (measured alike for the
    Viterbi's instances) in one wave.  A
    16-block cluster at S = 1024 for B = 64, one utterance a group at B =
    1."""
    for S in sorted({c[0] for c in WIDE_LATTICE_CASES}):
        sh = kl.viterbi_block(S, B)
        G, C, NT, KS, SP, cap = (sh[k] for k in ("utts", "cluster", "threads", "splits", "share", "lt_cap"))
        assert sh["mode"] == "group" and sh["smem_bytes"] == 4 * _group_floats(S, G, C, NT, KS, SP, cap)
        assert sh["smem_bytes"] <= kl.SMEM_LIMIT and cap >= 2 * SP * KS * sh["keys"]
        costs = {}
        for c in (1,) if S <= kl.SINGLE_BLOCK_STATES else kl.GROUP_CLUSTERS:
            at_once = min(kl.GROUP_CLUSTERS_AT_ONCE[c], 132 // c)
            g = max(1, -(-B // at_once))
            while g > 1 and kl.group_shape(S, g, c) is None:
                g -= 1
            alt = kl.group_shape(S, g, c)
            if alt is None:
                continue
            groups = -(-B // g)
            frame = max(g * alt["keys"] * S / (32 * 1.755e9), min(groups, at_once) * 4 * S * S / kl.GROUP_L2_BYTES_PER_S)
            costs[c] = (-(-groups // at_once) * frame, groups, g)
        assert costs[C] == min(costs.values()) and costs[C][2] == G, (S, B, costs, C)
        assert G == 1 or B > 1
    assert kl.viterbi_block(1024, 64)["cluster"] == 16 and kl.viterbi_block(1024, 1)["utts"] == 1
    assert kl.GROUP_MAXPLUS_PER_S == 128 / 4 * 1.755e9


@pytest.mark.parametrize("B", [1, 6, 37, 64, 2048])
def test_group_keys_are_owned_once_by_a_cluster(B):
    """Every S of 65-4096: C blocks a cluster, one of 1, 2, 4, 8 or 16 (16
    only past 8 with the non-portable attribute the launcher sets; one
    block up to SINGLE_BLOCK_STATES), each owning Db = ceil(S / C) rounded
    up to 4 keys [rank Db, rank Db + Db) clipped at S: every key owned by
    exactly one block, no block empty; G utterances a group fill the card
    in one wave of one block an SM (132 SMs, the clusters an H100 runs at
    once) where the rows fit, the last group ragged where G does not
    divide B."""
    for S in WIDE_S:
        sh = kl.group_block(S, B)
        G, C, Db = sh["utts"], sh["cluster"], sh["keys"]
        assert C in kl.GROUP_CLUSTERS and (C == 1 or S > kl.SINGLE_BLOCK_STATES)
        owner = np.full(S, -1)
        for rank in range(C):
            keys = np.arange(rank * Db, min(rank * Db + Db, S))
            assert keys.size > 0 and (owner[keys] == -1).all()
            owner[keys] = rank
        assert (owner >= 0).all()
        at_once = min(kl.GROUP_CLUSTERS_AT_ONCE[C], 132 // C)
        assert G <= max(1, -(-B // at_once))
        if sh["groups"] <= at_once:
            assert G == max(1, -(-B // at_once))
        members = [min(G, B - g * G) for g in range(sh["groups"])]
        assert sum(members) == B and min(members) >= 1


@pytest.mark.parametrize("i", range(len(WIDE_LATTICE_CASES)))
def test_wide_cases_reach_their_transition_placement(i):
    """Where each case of WIDE_LATTICE_CASES keeps its transitions: the
    group mode packs the ranges of a block's Db keys in shared memory where
    the widest range of the cluster times Db fits lt_cap, else streams
    tiles through L2 (S = 1024 and 4096 dense, the S = 1024 spread case's
    forward and Viterbi; the spread case's backward at S = 1024 packs: a
    source's destinations span at most half the states and the entry)."""
    S, kind, B, T = WIDE_LATTICE_CASES[i]
    lt = log_trans_np(S, kind, seed=S)
    W = int(lattice_ranges(lt, False).max())
    assert W == {"dense": S, "delta1": 2, "delta2": 3}.get(kind, W)
    for sh, rows in ((kl.forward_block(S, B, "tsb"), False), (kl.backward_block(S, B), True),
                     (kl.viterbi_block(S, B), False)):
        W = int(lattice_ranges(lt, rows).max())
        packed = W * sh["keys"] <= sh["lt_cap"]
        streamed = S >= 1024 and (kind == "dense" or kind == "spread" and not rows)
        assert packed != streamed, (S, kind, W, sh["lt_cap"])


def _viterbi_twin_inputs(case):
    """(B, T, S) log b, (S, S) log transitions and lengths of one
    test_viterbi_twin_vectorized_equals_the_loop case."""
    S, kind, T = {"band": (70, "delta1", 60), "ties": (96, "dense", 30), "spread": (130, "spread", 25),
                  "floor": (66, "delta2", 30)}[case]
    rng = np.random.default_rng(90 + S)
    lens = np.asarray([T, 17, 2, 1, 0, T - 3], np.int32)
    lb = spread_log_b((rng.normal(size=(len(lens), T, S)) * 2).astype(np.float32), kind, axis=2)
    lt = log_trans_np(S, kind, seed=S)
    if case == "ties":  # states 40, 41 and 77 duplicated, their candidates tie exactly, on top most frames
        for d in (41, 77):
            lt[d, :], lt[:, d], lb[..., d] = lt[40, :], lt[:, 40], lb[..., 40]
        lb[..., [40, 41, 77]] += 6.0
    if case == "floor":  # -inf log b and transitions, and log b on the -1e30 floor
        lb[rng.integers(0, len(lens), 20), rng.integers(0, T, 20), rng.integers(0, S, 20)] = -np.inf
        lb[:, 5:9, 10:30] = -1e30
        lt[3, 4] = -np.inf
    return lb, lt, lens


@pytest.mark.parametrize("case", ["band", "ties", "spread", "floor"])
def test_viterbi_twin_vectorized_equals_the_loop(case, monkeypatch):
    """viterbi_batch_plain vectorized over the sources (the max, then the
    lowest source equal to it; destinations in chunks) against its strict >
    loop, scores and backpointers bitwise: a banded chain whose states are
    not yet reachable in its first frames (every candidate on the floor,
    the lowest source wins), duplicated states whose candidates tie (the
    lower source wins), the spread case, -inf inputs and log b on the
    floor, rows of length 0, 1 and 2; at the default chunk and at chunks
    of 7 destinations."""
    lb, lt, lens = (_t(x) for x in _viterbi_twin_inputs(case))
    want = kf.viterbi_batch_plain(lb, lt, lens, loop=True)
    B, T, S = lb.shape
    for floats in (kf.VITERBI_PLAIN_FLOATS, 7 * B * S):
        monkeypatch.setattr(kf, "VITERBI_PLAIN_FLOATS", floats)
        got = kf.viterbi_batch_plain(lb, lt, lens)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    bp = want[1].numpy()
    live = np.arange(T)[None, :] < lens.numpy()[:, None]
    live[:, 0] = False
    if case == "ties":
        assert (bp[live] == 40).any() and not np.isin(bp[live], (41, 77)).any()
    if case == "band":  # states past 5 at frame 5: every candidate on the floor, source 0 wins
        assert (bp[0, 5, 6:] == 0).all() and (bp[0, 5, 1:6] >= np.arange(5)).all()


def test_spread_case_defeats_a_linear_domain_shortcut():
    """The spread case (torch_port_utils.spread_trans, S = 130): states of
    the second half past its entry have only sources of that half, and
    from the second frame on every such source of state 100 sits more than
    100 nats below the forward row's maximum (and the backward's inner
    terms the same way for its keys); a float32 sum taken in the linear
    domain against the row's maximum loses the state (-inf), where the
    log-domain twin keeps it finite."""
    lb, lt, lens = _inputs(130, "spread")
    alpha = kl.forward_lattice(_t(lb), _t(lt), _t(lens)).numpy().astype(np.float64)
    src = np.flatnonzero(lt[:, 100] > -1e30)
    assert src.min() >= 65
    gaps = [alpha[t - 1, :, 0].max() - (alpha[t - 1, src, 0] + lt[src, 100]).max() for t in range(2, 12)]
    assert min(gaps) > 100, gaps
    prev = alpha[10, :, 0].astype(np.float32)
    top = prev.max()
    with np.errstate(divide="ignore"):
        lin = np.log(np.exp(prev - top) @ np.exp(lt.astype(np.float32))) + top + lb[11, :, 0]
    assert np.isneginf(lin[100]) and np.isfinite(alpha[11, 100, 0])
    beta = kl.backward_lattice(_t(lb), _t(lt), _t(lens)).numpy().astype(np.float64)
    inner = np.maximum(lb[1:, :, 0], -1e30) + beta[1:, :, 0]  # frame t + 1's terms of row t
    dst = np.flatnonzero(lt[100] > -1e30)
    assert dst.min() >= 65 and min(inner[t].max() - (inner[t, dst] + lt[100, dst]).max() for t in range(0, 10)) > 100


def test_wrappers_take_past_64_states_and_refuse_past_the_bound():
    meta = dict(device="meta", dtype=torch.float32)
    lens = torch.empty((37,), device="meta", dtype=torch.int32)
    for S in (65, 4096):
        ln = kl.LatticeLaunch("log_forward_batch", torch.empty((37, 95, S), **meta),
                              torch.empty((37, S, S), **meta), lens, "bts", per_row_ok=True)
        assert (ln.B, ln.T, ln.S, ln.per_row) == (37, 95, S, 1)
    S = kl.MAX_STATES + 1
    for layout, shape in (("tsb", (95, S, 37)), ("bts", (37, 95, S))):
        with pytest.raises(ValueError, match="4096 states"):
            kl.LatticeLaunch("forward_lattice", torch.empty(shape, **meta), torch.empty((S, S), **meta), lens, layout)
