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
    ("delta2"), or "dense"; -inf off the band."""
    rng = np.random.default_rng(seed)
    if kind == "dense":
        t = rng.uniform(0.1, 1.0, size=(S, S))
    else:
        band = {"delta1": 1, "delta2": 2}[kind]
        t = np.zeros((S, S))
        for i in range(S):
            t[i, i : i + band + 1] = rng.uniform(0.2, 1.0, size=min(band + 1, S - i))
    t /= t.sum(-1, keepdims=True)
    with np.errstate(divide="ignore"):
        return np.log(t).astype(np.float32)


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
