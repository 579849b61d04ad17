"""Helpers shared by the tests that hold srhmm_tpu_torch against srhmm_tpu.

Models are made once as numpy leaves from a seed and handed to both
packages, so both compute on the same numbers.  JAX is imported only by the
helpers that build JAX models, so the CUDA tests can use this module on a
machine without JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from srhmm_tpu_torch.models import gmm_hmm_from_numpy, init_left_right_trans


def rand_stream(rng, S, M, D, cov="diag", scale=2.0) -> dict:
    """Numpy leaves of one random GMM stream (positive-definite covariances)."""
    means = rng.normal(size=(S, M, D)) * scale
    w = rng.uniform(0.3, 0.7, size=(S, M))
    w /= w.sum(-1, keepdims=True)
    if cov == "full":
        a = rng.normal(size=(S, M, D, D)) * 0.3
        c = a @ np.swapaxes(a, -1, -2) + np.eye(D)
        inv_cov, det = np.linalg.inv(c), np.linalg.det(c)
    else:
        var = rng.uniform(0.5, 1.5, size=(S, M, D))
        inv_cov, det = 1.0 / var, np.prod(var, -1)
    return {"weights": w, "means": means, "inv_cov": inv_cov, "det": det,
            "log_det": None, "cov_type": cov}


def rand_word(seed, S, mixes_dims, cov="diag", delta=1, scale=2.0):
    """(trans, [stream dicts]) of one random left-right word model."""
    rng = np.random.default_rng(seed)
    trans = init_left_right_trans(S, delta).numpy()
    return trans, [rand_stream(rng, S, M, D, cov, scale) for M, D in mixes_dims]


def jax_model(trans, streams, word=""):
    import jax.numpy as jnp

    import srhmm_tpu.models as jm

    return jm.GmmHmm(
        trans=jnp.asarray(trans),
        streams=tuple(
            jm.GmmStream(
                weights=jnp.asarray(s["weights"]),
                means=jnp.asarray(s["means"]),
                inv_cov=jnp.asarray(s["inv_cov"]),
                det=jnp.asarray(s["det"]),
                cov_type=s["cov_type"],
                log_det=None if s.get("log_det") is None else jnp.asarray(s["log_det"]),
            )
            for s in streams
        ),
        word=word,
    )


def both_models(trans, streams, word=""):
    """The same word as a JAX GmmHmm and as a srhmm_tpu_torch GmmHmm."""
    return jax_model(trans, streams, word), gmm_hmm_from_numpy(trans, streams, word)


def leaves_jax(model) -> list[np.ndarray]:
    out = [np.asarray(model.trans)]
    for s in model.streams:
        out += [np.asarray(s.weights), np.asarray(s.means), np.asarray(s.inv_cov),
                np.asarray(s.det), np.asarray(s.log_abs_det())]
    return out


def leaves_torch(model) -> list[np.ndarray]:
    out = [model.trans.numpy()]
    for s in model.streams:
        out += [s.weights.numpy(), s.means.numpy(), s.inv_cov.numpy(),
                s.det.numpy(), s.log_abs_det().numpy()]
    return out


def assert_same_leaves(jax_model_, torch_model_, rtol=0.0):
    a, b = leaves_jax(jax_model_), leaves_torch(torch_model_)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype, (x.shape, y.shape, x.dtype, y.dtype)
        np.testing.assert_allclose(y, x, rtol=rtol, atol=0)


def sample_utterance(rng, trans, streams, T) -> list[np.ndarray]:
    """One utterance of T frames per stream, sampled from a left-right HMM
    (start in state 0) with the given numpy stream leaves."""
    S = trans.shape[0]
    states = [0]
    for _ in range(T - 1):
        states.append(int(rng.choice(S, p=trans[states[-1]])))
    out = []
    for s in streams:
        frames = []
        for st in states:
            m = int(rng.choice(s["weights"].shape[1], p=s["weights"][st]))
            mu, k = s["means"][st, m], s["inv_cov"][st, m]
            cov = np.linalg.inv(k) if s["cov_type"] == "full" else np.diag(1.0 / k)
            frames.append(rng.multivariate_normal(mu, cov))
        out.append(np.asarray(frames))
    return out


def entry_without_loop(trans) -> np.ndarray:
    """trans with state 0's self-loop removed (its row renormalized): the
    decode tests' words whose entry rows hold no within-word candidate
    while every exit token is NEG_INF."""
    t = np.array(trans, dtype=np.float64)
    t[0, 0] = 0.0
    t[0] /= t[0].sum()
    return t


def log_trans_np(S, kind, seed=0) -> np.ndarray:
    """(S, S) float32 log transitions: left-right of band 1 ("delta1") or 2
    ("delta2"), "dense", or "spread" (spread_trans); -inf off the band."""
    rng = np.random.default_rng(seed)
    if kind == "dense":
        t = rng.uniform(0.1, 1.0, size=(S, S))
    elif kind == "spread":
        t = spread_trans(rng, S)
    else:
        band = {"delta1": 1, "delta2": 2}[kind]
        t = np.zeros((S, S))
        for i in range(S):
            t[i, i : i + band + 1] = rng.uniform(0.2, 1.0, size=min(band + 1, S - i))
    t /= t.sum(-1, keepdims=True)
    with np.errstate(divide="ignore"):
        return np.log(t).astype(np.float32)


# the "spread" case's log b: every state SPREAD_BASE lower than the other
# cases' (its log-alpha falls steadily, as a real model's does, instead of
# walking about 0 through a dense 65-state half, where the float32 twin
# itself strays past 1e-5 of float64), the second half SPREAD_GAP lower still
SPREAD_BASE = 5.0
SPREAD_GAP = 120.0


def spread_trans(rng, S) -> np.ndarray:
    """(S, S) transition probabilities (rows not yet normalised) of two dense
    halves [0, S/2) and [S/2, S): the first half enters the second only
    through its first state S/2, the second never goes back.  With log b
    SPREAD_GAP lower on the second half (spread_log_b), a state of the
    second half past S/2 has only sources of that half, which sit more than
    100 nats below the row's maximum once it is two frames in: a sum taken
    in the linear domain against the row's maximum loses it in float32."""
    h = S // 2
    t = rng.uniform(0.1, 1.0, size=(S, S))
    t[:h, h + 1:] = 0.0
    t[h:, :h] = 0.0
    return t


def spread_log_b(lb: np.ndarray, kind: str, axis: int) -> np.ndarray:
    """lb SPREAD_BASE lower and its second half of states (along axis)
    SPREAD_GAP lower still where kind is "spread", else lb."""
    if kind == "spread":
        idx = [slice(None)] * lb.ndim
        idx[axis] = slice(lb.shape[axis] // 2, None)
        lb -= SPREAD_BASE
        lb[tuple(idx)] -= SPREAD_GAP
    return lb


def assert_log_close(got, want, bound=1e-5, neg_inf=-1e30):
    """Log-domain values: equal masks of values above neg_inf/2, and
    max |got - want| / max(|want|, 1) <= bound over them."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    mask = want > neg_inf / 2
    assert ((got > neg_inf / 2) == mask).all()
    rel = np.abs(got[mask] - want[mask]) / np.maximum(np.abs(want[mask]), 1.0)
    assert rel.max(initial=0.0) <= bound, rel.max()


def sparse_gammas(ids, lengths, T: int, seed: int) -> dict:
    """Hand-made gammas (T, LS, B) for the moments' zero-tile skipping.
    "edges": every (utterance, row) pair with frames keeps one non-zero
    frame, the first or the last of one 32-frame tile (or its last valid
    frame), so all-zero tiles sit next to tiles with one non-zero frame at
    an edge; frame `length` also carries a value (masked: t >= length).
    "single": one frame of one pair for each bank row, so each bank row's
    moments are one term (a posterior weight's rounding shows in full);
    "subnormal": "single" at 1e-40 scale (not zero: computed, not flushed).
    Shared by chip_smoke.py and tests/test_torch_cuda.py."""
    from srhmm_tpu_torch.ops.kernels.composed import TILE

    rng = np.random.default_rng(seed)
    B, LS = ids.shape
    lens = [int(n) for n in lengths.tolist()]
    ids_h = ids.cpu().numpy()
    edges = np.zeros((T, LS, B), np.float32)
    single = np.zeros((T, LS, B), np.float32)
    seen = set()
    for b in range(B):
        n = lens[b]
        for j in range(LS):
            if n < T:
                edges[n, j, b] = 0.5  # past the length: never counted
            if n < 1:
                continue
            u = int(rng.integers(0, -(-n // TILE)))
            t = min(u * TILE + (TILE - 1 if (b + j) % 2 else 0), n - 1)
            edges[t, j, b] = rng.uniform(0.05, 1.0)
            if int(ids_h[b, j]) not in seen:
                seen.add(int(ids_h[b, j]))
                single[t, j, b] = rng.uniform(0.05, 1.0)
    dev = ids.device
    return {"edges": torch.as_tensor(edges, device=dev), "single": torch.as_tensor(single, device=dev),
            "subnormal": torch.as_tensor(single * np.float32(1e-40), device=dev)}


# Bank-kernel shapes that reach the shallower buffer depths of
# csrc/composed.cu: (cov, ((M, D) per stream), the emission's ring depth
# (emission_ring), the moments' tiles a batch (moments_slots))
BANK_DEPTH_CASES = [
    ("diag", ((32, 64),) * 6, 2, 4),
    ("diag", ((64, 39),) * 6, 1, 4),
    ("full", ((82, 16),), 2, 2),
    ("diag", ((200, 39),), 2, 1),
]

# Diagonal bank shapes of hundreds of mixtures that reach the places of
# csrc/composed.cu's records and accumulators outside shared memory below
# full D = 16 (full covariance past it takes the z-GEMM blocks): (((M, D)
# per stream), the emission ring (emission_ring), the moments'
# (rec_global, acc_global) (moments_shape))
BANK_PLACE_CASES = [
    (((80, 64),) * 6, 0, (False, False)),
    (((240, 64),), 1, (False, True)),
    (((350, 33),), 1, (True, False)),
    (((400, 64),), 1, (True, True)),
]


NEG_INF = -1e30


# composed_forward and composed_backward_stats on their own (LS, nd, T, B):
# rows per lane 1, 2, 4, an utterance over 2 and 8 warps (LS 160, 1024),
# band 1 (nd 2) and up to 15 (nd 16), T one below, at and one above the
# backward's 16-frame tile and 95 (shorter than the forward's 32-frame tile
# and across it), B off the multiples of the block's utterances (2, 4, 8 on
# 132 SMs)
LATTICE_CASES = [
    (36, 3, 95, 37),
    (20, 3, 15, 517),
    (30, 3, 16, 1031),
    (12, 2, 17, 203),
    (48, 6, 40, 300),
    (90, 3, 95, 37),
    (160, 3, 100, 37),
    (1024, 16, 83, 5),
]


def lattice_case(device, seed, LS, nd, T, B):
    """(log_b (T, LS, B), diag_row, diag_col (nd, LS, B), lengths (B,)) from a
    seed: random log_b, per-utterance chains of nd diagonals in row and
    column form, lengths T, 0, 1, the backward's first tile's length and
    random ones."""
    from srhmm_tpu_torch.ops.kernels import composed as kc

    rng = np.random.default_rng(seed)
    TT = kc.BACKWARD_TILES[0]
    lens = ([T, 0, 1, min(TT, T)] + [int(n) for n in rng.integers(2, T + 1, size=B)])[:B]
    p = rng.uniform(0.05, 1.0, size=(LS, nd, B))
    i = np.arange(LS)[:, None]
    p[(i + np.arange(nd)[None, :]) >= LS] = 0.0
    p /= p.sum(1, keepdims=True)
    with np.errstate(divide="ignore"):
        row = np.maximum(np.log(p), NEG_INF).transpose(1, 0, 2)  # (nd, LS, B): a[i, i+d]
    col = np.full_like(row, NEG_INF)
    for d in range(nd):
        col[d, d:] = row[d, : LS - d]  # a[j-d, j]
    log_b = torch.as_tensor(rng.normal(size=(T, LS, B)) * 3 - 10, dtype=torch.float32, device=device)
    diag_row = torch.as_tensor(row, dtype=torch.float32, device=device)
    diag_col = torch.as_tensor(col, dtype=torch.float32, device=device)
    lengths = torch.as_tensor(lens, dtype=torch.int32, device=device)
    return log_b, diag_row, diag_col, lengths


def forward_lattice_case(device, seed, LS, nd, T, B):
    """composed_forward's inputs (log_b, diag_col, lengths) from lattice_case."""
    log_b, _, diag_col, lengths = lattice_case(device, seed, LS, nd, T, B)
    return log_b, diag_col, lengths


def backward_lattice_case(device, seed, LS, nd, T, B):
    """composed_backward_stats' inputs from lattice_case, log-alpha from the
    forward twin."""
    from srhmm_tpu_torch.ops.kernels import composed as kc

    log_b, diag_row, diag_col, lengths = lattice_case(device, seed, LS, nd, T, B)
    la = kc.composed_forward_plain(log_b, diag_col, lengths)
    log_z = la[-1, -1]
    valid = torch.isfinite(log_z) & (log_z > NEG_INF / 2) & (lengths > 0)
    return log_b, la, diag_row, lengths, torch.where(valid, log_z, 0.0), valid.to(torch.float32)


def em_tile_lengths(rng, T: int, TT: int) -> list[int]:
    """B=37 lengths up to T: random ones, T, 0, 1, and lengths whose last
    frame is the first frame of a backward-stats tile (the utterance's only
    non-zero gamma column there) or the last frame of one (tiles of TT
    frames counted down from T)."""
    edges = sorted({T - TT + 1, T - 2 * TT + 1, T - TT, T - 2 * TT, TT + 1, TT, TT - 1} & set(range(2, T)))
    lens = [int(n) for n in rng.integers(2, T, size=37 - 3 - len(edges))] + edges + [T, 0, 1]
    return lens


# emit_forward alone at launch shapes the kernel_em cases do not reach
# (chip_smoke.py's emit check and tests/test_torch_cuda.py): (cov, band,
# [(M, D) per stream], S, B, T), lengths from emit_check_lengths
EMIT_CHECK_CASES = [
    ("diag", 0, [(2, 9)], 5, 37, 95),  # band 0, S not dividing 32
    ("diag", 5, [(2, 9)], 12, 37, 95),  # 8 transition slots
    ("diag", 12, [(2, 5)], 24, 37, 95),  # a band past the compiled slot counts
    ("diag", 1, [(2, 9)], 40, 37, 95),  # an utterance across two warps
    ("full", None, [(1, 4)], 64, 37, 40),  # dense transitions across two warps
    ("diag", 2, [(1, 3)], 200, 9, 40),  # seven warps an utterance
    ("diag", 1, [(1, 3)], 240, 5, 20),  # constants past shared memory
    ("diag", 1, [(3, 9)], 8, 1001, 40),  # a ragged last block
    ("diag", 1, [(3, 9), (2, 3)], 8, 37, 7),  # T shorter than a tile
]


def emit_check_lengths(i: int, B: int, T: int) -> list[int]:
    """B lengths of EMIT_CHECK_CASES[i]: drawn in [2, T), then T, 0 and 1."""
    rng = np.random.default_rng(60 + i)
    return [int(n) for n in rng.integers(2, T, size=B - 3)] + [T, 0, 1]


# vocab_scores launch shapes, (cov, S, W, [(M, D) per stream], band, B, T):
# the unrolled slot counts 2 / 4 / 8 and the generic loop, several words a
# block and a ragged last word block, two and six streams, pairs across two
# and across eight warps (the most states), constants past shared memory,
# a ragged last utterance block, T shorter than a tile; every case has rows
# of length 0 and 1 and runs both semirings (full covariance past D = 16
# takes the emission pass: SCORE_FULL_WIDE_CASES covers it)
VOCAB_CHECK_CASES = [
    ("diag", 5, 6, [(2, 6)], 1, 37, 95),  # 2 slots, S not dividing 32, several words a block
    ("full", 6, 13, [(1, 9)], 1, 64, 95),  # full13's word shape: a ragged last word block
    ("full", 6, 5, [(3, 9), (2, 3)], 1, 37, 95),  # two streams
    ("diag", 5, 4, [(2, 9), (1, 3), (2, 5), (1, 7), (3, 4), (2, 6)], 1, 37, 95),  # six streams
    ("diag", 12, 3, [(2, 9)], 3, 37, 95),  # 4 slots
    ("diag", 12, 3, [(2, 9)], 5, 37, 95),  # 8 slots
    ("diag", 24, 3, [(2, 5)], 12, 37, 95),  # a band past the unrolled slots: the generic loop
    ("diag", 40, 3, [(2, 5)], 1, 37, 95),  # a pair across two warps
    ("diag", 256, 2, [(1, 3)], 2, 9, 30),  # the most states: a pair across eight warps
    ("full", 6, 3, [(4, 39)], 1, 37, 95),  # full past D = 16: the emission pass, then the recursion's wide instance
    ("diag", 8, 3, [(24, 64)], 1, 37, 95),  # constants past shared memory
    ("diag", 8, 13, [(3, 9)], 1, 1001, 40),  # a ragged last utterance block
    ("diag", 8, 5, [(3, 9), (2, 3)], 1, 37, 7),  # T shorter than a tile
]


def vocab_check_lengths(i: int, B: int, T: int) -> list[int]:
    """B lengths of VOCAB_CHECK_CASES[i]: drawn in [2, T), then T, 0 and 1."""
    rng = np.random.default_rng(80 + i)
    return [int(n) for n in rng.integers(2, T, size=B - 3)] + [T, 0, 1]


def vocab_check_case(i: int, device):
    """VOCAB_CHECK_CASES[i] as (float32 vocabulary on device, feature
    batch or per-stream tuple of batches): words from rand_word(100 i + w),
    features normal * 2 from a seed."""
    from srhmm_tpu_torch.io.dataset import pack_utterances
    from srhmm_tpu_torch.models import stack_models

    cov, S, W, mixes_dims, band, B, T = VOCAB_CHECK_CASES[i]
    words = [gmm_hmm_from_numpy(*rand_word(100 * i + w, S, mixes_dims, cov, band)) for w in range(W)]
    vocab = stack_models(words).astype(torch.float32).to(device)
    lens = vocab_check_lengths(i, B, T)
    rng = np.random.default_rng(90 + i)
    batch = tuple(pack_utterances([rng.normal(size=(n, D)) * 2 for n in lens], pad_multiple=1,
                                  dtype=torch.float32, device=device) for _, D in mixes_dims)
    return vocab, batch[0] if len(batch) == 1 else batch


# emission_log_b shapes beyond chip_smoke.py's D x M grid, (N, S, M, D):
# enough tiles that a block walks several, the records past shared memory,
# fewer threads a block (the records and tiles fill shared memory), a log b
# tile too wide for shared memory (stored straight out)
EMISSION_EXTRA_CASES = [
    (600001, 8, 3, 9),
    (4133, 64, 16, 64),
    (4133, 200, 1, 64),
    (4133, 2048, 1, 3),
]


# csrc/lattice.cu's kernels (forward, backward, Viterbi: one launch shape)
# at launch shapes the kernel_lattice grid (S = 3, 6, 8, 16, 64 at B = 37,
# T = 95) does not reach, (S, transitions, B, T): one state (32 utterances
# a warp), T shorter than a tile with a ragged last block and 4-byte
# copies, idle lanes (20 states a warp), two states a lane (S = 33, 40)
# walking ten tiles with 16-byte copies, em_diag's S = 8, 16 slots with a
# ragged last tile, one frame (T = 1: the backward's only row is its
# initialization); lengths from forward_check_lengths
FORWARD_CHECK_CASES = [
    (1, "dense", 37, 95),
    (5, "delta1", 1001, 7),
    (20, "delta2", 37, 95),
    (33, "dense", 37, 95),
    (40, "delta1", 64, 300),
    (8, "delta1", 2048, 64),
    (12, "delta2", 400, 130),
    (6, "delta2", 37, 1),
]


def forward_check_lengths(i: int, B: int, T: int) -> list[int]:
    """B lengths of FORWARD_CHECK_CASES[i]: drawn in [2, T), then T, 0 and
    1 (every row of length T where B < 4)."""
    rng = np.random.default_rng(120 + i)
    return [int(n) for n in rng.integers(2, max(T, 3), size=B - 3)] + [T, 0, 1]


# emission_stats shapes beyond chip_smoke.py's D x M grid (S = 8, N =
# 4133), (N, S, M, D): states split into groups with the records in device
# memory (S = 64, M = 16, D = 39; S = 300), 64-frame tiles (D = 64, M = 16),
# enough tiles that a block walks several, one tile of five frames
STATS_CHECK_CASES = [
    (4133, 64, 16, 39),
    (4133, 300, 1, 3),
    (4133, 8, 16, 64),
    (100003, 8, 3, 9),
    (5, 8, 3, 9),
]


# csrc/lattice.cu past 64 states (the forward and backward's group mode,
# the block-wide Viterbi), (S, transitions, B, T): every S of 65, 96, 127,
# 128, 130, 257, 1024 and 4096, banded, dense and spread, B of 1, 6, 8 and
# 37, T of 1 to 95; clusters of 1, 4, 8 and 16 blocks, groups of 1 to 6
# utterances (a ragged last group), the packed ranges (a band, a dense
# matrix whole or a slice) and the streamed tiles (S = 1024, 4096 dense) at
# register tiles of 1 and 2 utterances, a one-block group past 512 threads
# (S = 96, B = 800: 7 utterances, 672 pairs),
# the spread case packed (S = 130) and streamed (S = 1024); for the
# Viterbi idle threads, several states a thread, its ranges packed or read
# through L2; lengths from wide_lattice_lengths (rows of length 0 and 1
# where B >= 4)
WIDE_LATTICE_CASES = [
    (65, "delta1", 37, 95),
    (96, "delta2", 37, 95),
    (127, "dense", 37, 95),
    (128, "delta1", 1, 95),
    (257, "dense", 37, 95),
    (1024, "dense", 37, 95),
    (1024, "delta1", 1, 1),
    (4096, "delta1", 8, 95),
    (4096, "dense", 1, 1),
    (96, "dense", 37, 1),
    (130, "spread", 37, 95),
    (1024, "spread", 6, 40),
    (96, "delta2", 800, 20),
]


def wide_lattice_lengths(i: int, B: int, T: int) -> list[int]:
    """B lengths of WIDE_LATTICE_CASES[i]: drawn in [2, T), then T, 0 and 1
    (every row of length T where B < 4)."""
    if B < 4:
        return [T] * B
    rng = np.random.default_rng(160 + i)
    return [int(n) for n in rng.integers(2, max(T, 3), size=B - 3)] + [T, 0, 1]


def lattice_ranges(log_trans: np.ndarray, rows: bool) -> np.ndarray:
    """The block-wide kernels' ranges (csrc/lattice.cu lattice_block_kernel):
    per column (rows=False: a destination's sources) or row (a source's
    destinations) of float32 log transitions, the width from the first to
    the last entry above -1e30 (0 where none is)."""
    on = np.asarray(log_trans) > NEG_INF
    on = on if rows else on.T
    first = np.where(on.any(1), on.argmax(1), 0)
    last = np.where(on.any(1), on.shape[1] - 1 - on[:, ::-1].argmax(1), -1)
    return np.where(on.any(1), last - first + 1, 0)


# full covariance past D = 16 in the E-step kernels (csrc/fused_em.cu) and
# the composed bank kernels (csrc/composed.cu): [(M, D) per stream].  The
# E-step: D of 17, 20, 39 and 64 (bounds 32, 40, 64), one, two and six
# streams (of different D and M: one to four states a moments group, a
# state over two groups at M = 9 and 16, M odd); the bank
# kernels' z-GEMM blocks: every register bound 24, 32, 40, 48, 64 (D of 17,
# 20, 30, 39, 45, 64), two streams (of different M and mixture groups), one
# and several record slices, a partial last slice (M odd), one to three
# mixture groups of the moments, the n tile whole and padded (M = 9)
EM_FULL_WIDE_CASES = [
    [(2, 17)],
    [(3, 20), (2, 17)],
    [(4, 39)],
    [(16, 39)],
    [(4, 64)],
    [(2, 17), (1, 20), (3, 24), (9, 33), (4, 18), (2, 17)],
]
BANK_FULL_WIDE_CASES = [
    [(2, 17)],
    [(4, 20), (3, 20)],
    [(3, 30)],
    [(8, 39)],
    [(16, 39)],
    [(24, 39)],
    [(2, 45)],
    [(16, 64)],
    [(9, 39)],
    [(9, 17), (2, 17)],
    [(1, 45)],
]


def bank_wide_placements(md) -> set:
    """The launch shapes of the z-GEMM bank kernels (csrc/composed.cu,
    ops/kernels/composed.py) that one case of BANK_FULL_WIDE_CASES reaches:
    its register bound, two streams, one or several record slices of a
    stream and a partial last one, its moments' mixture groups, the n tile
    of a group whole or padded, streams of different group counts.  Shared
    by tests/test_torch_full_cov_wide.py and chip_smoke.py."""
    from srhmm_tpu_torch.ops.kernels import composed as kc

    mixes, D = [M for M, _ in md], md[0][1]
    groups = [-(-M // kc.WIDE_GROUP) for M in mixes]
    out = {f"rb_{kc.register_bound(D)}"} | {f"groups_{n}" for n in groups}
    out |= {"two_streams"} if len(md) == 2 else set()
    out |= {"one_slice" if M <= kc.WIDE_SLICE else "several_slices" for M in mixes}
    out |= {"partial_slice" for M in mixes if M % kc.WIDE_SLICE}
    out |= {"padded_n_tile" if M % kc.WIDE_GROUP else "whole_n_tile" for M in mixes}
    out |= {"streams_of_different_groups"} if len(set(groups)) > 1 else set()
    return out


BANK_WIDE_PLACEMENTS = {"rb_24", "rb_32", "rb_40", "rb_48", "rb_64", "two_streams", "one_slice", "several_slices",
                        "partial_slice", "groups_1", "groups_2", "groups_3", "padded_n_tile", "whole_n_tile",
                        "streams_of_different_groups"}


# vocab_scores at full covariance past D = 16 (csrc/wide_log_b.cu's emission
# pass, then the recursion's wide instances), (S, W, [(M, D) per stream], B,
# T, split): every register bound 24 / 32 / 40 / 48 / 64 (D = 17, 30, 39, 45,
# 64), two streams of different D, M odd (a partial last record slice), one
# mixture, columns off the 128-column tile, several row groups (full13_d39's
# words), rows of length 0 and 1 (every case), and a call split past the log
# b cap (wide_cap lowers common.WIDE_LOG_B_BYTES) over utterance blocks and
# over frames
SCORE_FULL_WIDE_CASES = [
    (5, 4, [(2, 17)], 37, 95, None),
    (6, 3, [(3, 30)], 37, 95, None),
    (6, 13, [(4, 39)], 37, 95, None),
    (4, 3, [(1, 45)], 37, 95, None),
    (4, 2, [(2, 64)], 9, 60, None),
    (6, 4, [(3, 20), (2, 17)], 37, 95, None),
    (6, 5, [(3, 39)], 37, 95, "utterances"),
    (6, 5, [(3, 39)], 37, 95, "frames"),
]
# the word-loop decoder there, (W, S, bigram, [(M, D) per stream], variant,
# Ks, split): the same register bounds, streams and splits; unigram and
# bigram (S = 6 padded to 8 states), K = 1 to 4, and ties through the
# duplicated word of kernel_decode's ("dup", a, c) variant (word c a copy of
# word a with the same arcs in and out)
DECODE_FULL_WIDE_CASES = [
    (5, 8, False, [(2, 17)], None, (1, 2, 3), None),
    (5, 8, True, [(3, 30)], None, (1, 2, 3), None),
    (5, 8, True, [(3, 39)], ("dup", 1, 3), (1, 2, 3, 4), None),
    (5, 8, False, [(3, 39)], ("dup", 1, 3), (1, 2, 3, 4), None),
    (4, 6, False, [(1, 45)], None, (1, 2), None),
    (3, 5, False, [(2, 64)], None, (1, 3), None),
    (4, 6, True, [(3, 20), (2, 17)], None, (1, 2, 3), None),
    (5, 8, True, [(3, 39)], None, (1, 2), "utterances"),
    (13, 8, False, [(3, 39)], None, (1, 3), "frames"),
]
WIDE_SHAPES = {"rb_24", "rb_32", "rb_40", "rb_48", "rb_64", "two_streams", "m_odd", "one_mixture",
               "ragged_columns", "row_groups", "length_0", "length_1", "split_utterances", "split_frames"}
DECODE_WIDE_SHAPES = WIDE_SHAPES | {"unigram", "bigram", "ties", "k_4"}


def wide_lengths(i: int, B: int, T: int) -> list[int]:
    """B lengths of case i of the wide sets: drawn in [2, T), then T, 0 and 1."""
    rng = np.random.default_rng(1200 + i)
    return [int(n) for n in rng.integers(2, T, size=B - 3)] + [T, 0, 1]


def wide_cap(split, T: int, N: int, unit: int):
    """The log b cap (bytes) that splits a call of T frames, N rows and
    utterance runs of `unit` (the scorer's U, the decoder's 1): two units a
    part ("utterances"), one unit's frames in chunks of 30 ("frames"), or
    None (the module's own cap, no split)."""
    if split == "utterances":
        return 4 * T * N * unit * 2
    if split == "frames":
        return 4 * N * unit * 30
    return None


def wide_placements(mixes_dims, lens, T: int, N: int, unit: int, cap=None) -> set:
    """The shapes of WIDE_SHAPES one call reaches: its register bound,
    streams, mixture counts, columns, row groups, rows of length 0 and 1,
    and its parts under the cap (wide_emission.plan_parts)."""
    from srhmm_tpu_torch.ops.kernels import common
    from srhmm_tpu_torch.ops.kernels import wide_emission as we
    from srhmm_tpu_torch.ops.kernels.composed import register_bound

    ms, ds = [M for M, _ in mixes_dims], [D for _, D in mixes_dims]
    n_cols = sum(min(max(n, 1), T) for n in lens)
    out = {f"rb_{register_bound(max(ds))}"}
    out |= {"two_streams"} if len(ms) == 2 else set()
    out |= {"m_odd" for M in ms if M % 2} | {"one_mixture" for M in ms if M == 1}
    out |= {"ragged_columns"} if n_cols % 128 else set()
    out |= {"row_groups"} if we.rows_per_group(N, ms) < N else set()
    out |= {f"length_{n}" for n in (0, 1) if n in lens}
    old = common.WIDE_LOG_B_BYTES
    common.WIDE_LOG_B_BYTES = old if cap is None else cap
    try:
        parts = we.plan_parts(len(lens), T, N, unit)
    finally:
        common.WIDE_LOG_B_BYTES = old
    out |= {"split_frames"} if any(t_lo > 0 for _, _, t_lo, _ in parts) else set()
    out |= {"split_utterances"} if len(parts) > 1 and all(t_lo == 0 and t_hi == T for _, _, t_lo, t_hi in parts) \
        else set()
    return out


def score_wide_case(i: int, device):
    """SCORE_FULL_WIDE_CASES[i] as (float32 vocabulary on device, feature
    batch or per-stream tuple, lengths): words from rand_word(1300 + 10 i
    + w), features normal * 2 from a seed."""
    from srhmm_tpu_torch.io.dataset import pack_utterances
    from srhmm_tpu_torch.models import stack_models

    S, W, mixes_dims, B, T, _ = SCORE_FULL_WIDE_CASES[i]
    words = [gmm_hmm_from_numpy(*rand_word(1300 + 10 * i + w, S, mixes_dims, "full")) for w in range(W)]
    lens = wide_lengths(i, B, T)
    rng = np.random.default_rng(1400 + i)
    batch = tuple(pack_utterances([rng.normal(size=(n, D)) * 2 for n in lens], pad_multiple=1,
                                  dtype=torch.float32, device=device) for _, D in mixes_dims)
    return stack_models(words).astype(torch.float32).to(device), batch[0] if len(batch) == 1 else batch, lens


def decode_wide_case(i: int, device):
    """DECODE_FULL_WIDE_CASES[i] as (float32 vocabulary on device, per-stream
    feature batches, decode_continuous_batch's graph keywords, lengths):
    words from rand_word(1500 + 10 i + w) (the copy of the "dup" variant
    with its arcs), a Dirichlet bigram for a bigram case."""
    from srhmm_tpu_torch.io.dataset import pack_utterances
    from srhmm_tpu_torch.models import stack_models

    W, S, bigram, mixes_dims, variant, _, _ = DECODE_FULL_WIDE_CASES[i]
    leaves = [rand_word(1500 + 10 * i + w, S, mixes_dims, "full") for w in range(W)]
    dup = variant[1:] if isinstance(variant, tuple) else None
    if dup:
        leaves[dup[1]] = leaves[dup[0]]
    words = [gmm_hmm_from_numpy(t, st, f"w{w}") for w, (t, st) in enumerate(leaves)]
    lens = wide_lengths(100 + i, 37, 95)
    rng = np.random.default_rng(1600 + i)
    batches = tuple(pack_utterances([rng.normal(size=(n, D)) * 2 for n in lens], pad_multiple=1,
                                    dtype=torch.float32, device=device) for _, D in mixes_dims)
    graph_kw = {}
    if bigram:
        lm = np.log(rng.dirichlet(np.ones(W), size=W))
        if dup:
            lm[:, dup[1]] = lm[:, dup[0]]
            lm[dup[1]] = lm[dup[0]]
        graph_kw["lm_logprobs"] = lm
    return stack_models(words).astype(torch.float32).to(device), batches, graph_kw, lens
