"""The vocabulary scorer (#1) and the word-loop decoder (#6-#8) at full
covariance past D = 16, against the JAX package, on the CPU.

There csrc/wide_log_b.cu computes log b as z-GEMM blocks before the
recursions of csrc/vocab_scores.cu and csrc/word_loop_decode.cu read it; on
CPU tensors every wrapper runs its plain twin.  score_batch_fused (the
twin) against srhmm_tpu's score_batch_fused_lane (its Pallas kernel in
interpret mode) at full D = 17 and 39 and at two streams of D = 20 and 17,
total and final modes, sum and max semirings: rtol 1e-5, equal finite
masks, equal rankings.  decode_continuous_batch against srhmm_tpu's
(interpret mode) at full D = 39, K = 1 unigram and K = 2 bigram: identical
hypotheses, scores rtol 2e-5.  The launch rules on CPU and meta tensors:
the staged records (common.wide_records) at D = 17, 20, 30, 39, 45, 64
and their register bounds, read back as csrc/wide_gemm.cuh reads them;
the pass's plain twin through both recursions' buffer layouts against the
scorer's own per-frame emission; plan_parts' splits over utterances and
over frames; the columns a part steps; the shared-memory mirrors within a
block's budget; and the routing rules admitting what they admitted before
(D = 64 taken, D = 65 refused, up to six streams, S <= 256).  The CUDA
kernels are held against these twins on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srhmm_tpu.decode.continuous as jc
import srhmm_tpu.io.dataset as jds
import srhmm_tpu.models as jm
import srhmm_tpu_torch.decode.continuous as tc
import srhmm_tpu_torch.io.dataset as tds
import srhmm_tpu_torch.models as tm
from srhmm_tpu.ops.pallas.scoring_pallas import score_batch_fused_lane
from srhmm_tpu_torch.ops.kernels import common, scoring
from srhmm_tpu_torch.ops.kernels import decode as kd
from srhmm_tpu_torch.ops.kernels import wide_emission as we
from srhmm_tpu_torch.ops.kernels.composed import register_bound
from torch_port_utils import (
    DECODE_FULL_WIDE_CASES,
    DECODE_WIDE_SHAPES,
    SCORE_FULL_WIDE_CASES,
    WIDE_SHAPES,
    both_models,
    rand_word,
    wide_cap,
    wide_placements,
)


def _vocabs(W, S, mixes_dims, seed0):
    pairs = [both_models(*rand_word(seed0 + i, S, list(mixes_dims), "full"), f"w{i}") for i in range(W)]
    return (jm.stack_models([p[0] for p in pairs]).astype(jnp.float32),
            tm.stack_models([p[1] for p in pairs]).astype(torch.float32))


def _batches(per_stream):
    j = tuple(jds.pack_utterances(u, pad_multiple=8, dtype=jnp.float32) for u in per_stream)
    t = tuple(tds.pack_utterances(u, pad_multiple=8, dtype=torch.float32) for u in per_stream)
    return (j[0], t[0]) if len(j) == 1 else (j, t)


@pytest.mark.parametrize("mixes_dims,runs", [
    (((2, 17),), (("total", "sum"), ("final", "max"))),
    (((3, 39),), (("total", "max"), ("final", "sum"))),
    (((3, 20), (2, 17)), (("total", "sum"), ("final", "max"))),
], ids=["d17", "d39", "p2"])
def test_score_batch_full_wide_matches_jax(mixes_dims, runs):
    """Each case runs two (mode, semiring) pairs, so the set covers both
    modes and both semirings at every shape kind (the Pallas kernel in
    interpret mode takes ~10 s a call here)."""
    jv, tv = _vocabs(3, 4, mixes_dims, 40)
    rng = np.random.default_rng(4)
    lens = [13, 6, 1, 0, 16]
    jb, tb = _batches([[rng.normal(size=(n, D)) * 2 for n in lens] for _, D in mixes_dims])
    live = np.array(lens) > 0
    for mode, semiring in runs:
        want = np.asarray(score_batch_fused_lane(jv, jb, mode=mode, semiring=semiring, k_block=8, interpret=True))
        got = scoring.score_batch_fused(tv, tb, mode=mode, semiring=semiring).numpy()
        fin = np.isfinite(want)
        assert (np.isfinite(got) == fin).all()
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=0)
        assert (np.argsort(-got, axis=1, kind="stable")[live] == np.argsort(-want, axis=1, kind="stable")[live]).all()


def _utterances(rng, words, n):
    """Strings of 2-3 words sampled around the models' first means, plus
    rows of length 0 and 1."""
    utts = []
    for _ in range(n):
        parts = []
        for w in rng.integers(0, len(words), size=int(rng.integers(2, 4))):
            trans, streams = words[w]
            for s in range(trans.shape[0]):
                for _ in range(2 + int(rng.integers(0, 2))):
                    parts.append(streams[0]["means"][s, 0] + 0.3 * rng.normal(size=streams[0]["means"].shape[-1]))
        utts.append(np.asarray(parts))
    D = words[0][1][0]["means"].shape[-1]
    return utts + [np.zeros((0, D)), rng.normal(size=(1, D))]


@pytest.mark.parametrize("n_best,lm_kind", [(1, None), (2, "bigram")])
def test_decode_full_d39_matches_jax(n_best, lm_kind):
    rng = np.random.default_rng(60 + n_best)
    W, S = 5, 4
    words = [rand_word(700 + i, S, [(2, 39)], "full") for i in range(W)]
    pairs = [both_models(t, s, f"w{i}") for i, (t, s) in enumerate(words)]
    jv = jm.stack_models([p[0] for p in pairs]).astype(jnp.float32)
    tv = tm.stack_models([p[1] for p in pairs]).astype(torch.float32)
    jb, tb = _batches([_utterances(rng, words, 3)])
    lm = np.log(rng.dirichlet(np.ones(W), size=W)) if lm_kind == "bigram" else None
    want = jc.decode_continuous_batch(jv, jb, lm_logprobs=lm, n_best=n_best, interpret=True)
    got = tc.decode_continuous_batch(tv, tb, lm_logprobs=lm, n_best=n_best)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = ([g], [w]) if n_best == 1 else (g, w)
        assert [h[1:] for h in g] == [h[1:] for h in w]
        for hg, hw in zip(g, w):
            if np.isfinite(hw[0]):
                np.testing.assert_allclose(hg[0], hw[0], rtol=2e-5)
            else:
                assert hg[0] == hw[0]


@pytest.mark.parametrize("D,rb", [(17, 24), (20, 24), (30, 32), (39, 40), (45, 48), (64, 64)])
def test_wide_records_and_register_bound(D, rb):
    """The staged records at register bound rb: each an (rb + 1, rb + 4)
    matrix, rows d < D of L^T (zeros elsewhere), then c = -L^T mu, bias,
    log w, 0, 0 (csrc/wide_gemm.cuh wide_q's reads), row-major (row,
    mixture); a mixture's q from them equals the one from the packed
    constants."""
    assert register_bound(D) == rb and we.is_wide([D], True) and not we.is_wide([D], False)
    M, W, S = 3, 2, 3
    _, tv = _vocabs(W, S, ((M, D),), 80 + D)
    a, bias_g, bias, logw, _, _ = scoring.pack_vocab_constants(tv, torch.float32)
    N = W * S
    recs, offs, got_rb = we.pack_streams((a,), (bias_g,), (bias,), (logw,), (D,), (M,), N)
    assert got_rb == rb and offs == [0] and recs.numel() == N * M * (rb + 1) * (rb + 4)
    r = recs.reshape(N, M, rb + 1, rb + 4)
    lt = a.reshape(M, D, N, D).permute(2, 0, 1, 3)
    assert torch.equal(r[:, :, :D, :D], lt)
    assert not r[:, :, :D, D:].any() and not r[:, :, D:rb].any()
    assert torch.equal(r[:, :, rb, :D], bias_g.reshape(M, D, N).permute(2, 0, 1))
    assert not r[:, :, rb, D:rb].any() and not r[:, :, rb, rb + 2:].any()
    assert torch.equal(r[:, :, rb, rb], bias.reshape(M, N).T)
    assert torch.equal(r[:, :, rb, rb + 1], logw.reshape(M, N).T)
    assert (torch.triu(torch.ones(D, D)) >= (lt[0, 0] != 0).float()).all()  # L^T upper triangular


def _pass_vs_frame_emission(mixes_dims, lens, T, uo, t_major, b_lo=0, t_lo=0):
    """The pass's twin (wide_log_b on CPU tensors) into a buffer of a
    recursion's layout, read back at its columns, against
    scoring._plain_stream_log_b summed over the streams (the twins'
    per-frame emission): the values agree, and elements off the columns
    stay untouched."""
    _, tv = _vocabs(3, 4, mixes_dims, 90)
    rng = np.random.default_rng(9)
    feats = tuple(torch.as_tensor(rng.normal(size=(T, D, len(lens))) * 2, dtype=torch.float32)
                  for _, D in mixes_dims)
    packs = [scoring.pack_vocab_constants(tv, torch.float32, stream=p) for p in range(len(mixes_dims))]
    ds, ms = [D for _, D in mixes_dims], [M for M, _ in mixes_dims]
    N = 12
    recs, offs, rb = we.pack_streams(*(tuple(pk[i] for pk in packs) for i in (0, 1, 2, 3)), ds, ms, N)
    lengths = torch.as_tensor(lens, dtype=torch.int32)
    t_hi, b_hi = T, len(lens)
    cols = we.columns(lengths, b_lo, b_hi, t_lo, t_hi, T, t_major)
    frames = t_hi - t_lo
    nb = -(-(b_hi - b_lo) // uo)
    layout = (b_lo, t_lo, uo, frames * N * uo, N * uo, uo)
    buf = torch.full((nb, frames, N, uo), 7.0)
    we.wide_log_b(feats, recs, offs, ds, ms, rb, N, cols, buf, *layout)
    got = we.gather_columns(buf, cols, N, *layout)
    want = torch.stack([
        sum(scoring._plain_stream_log_b(f[t][:, b:b + 1], pk[0], pk[1], pk[2], pk[3], D, True)[:, 0]
            for f, pk, D in zip(feats, packs, ds))
        for t, b in cols.tolist()])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert int((buf == 7.0).sum()) == buf.numel() - cols.shape[0] * N
    return cols


def test_pass_twin_through_the_scorer_and_decoder_layouts():
    lens = [5, 0, 1, 9, 3]
    T = 9
    cols = _pass_vs_frame_emission([(2, 17)], lens, T, uo=2, t_major=True)
    assert cols.shape[0] == sum(min(max(n, 1), T) for n in lens)
    assert cols[:, 0].tolist() == sorted(cols[:, 0].tolist())  # frame-major: the scorer's order
    cols = _pass_vs_frame_emission([(3, 20), (2, 17)], lens, T, uo=1, t_major=False)
    assert cols[:, 1].tolist() == sorted(cols[:, 1].tolist())  # utterance-major: the decoder's order
    cols = _pass_vs_frame_emission([(1, 39)], lens, T, uo=4, t_major=True, b_lo=1, t_lo=2)
    assert cols[:, 0].min() >= 2 and cols[:, 1].min() >= 1


def test_plan_parts_covers_every_utterance_and_frame_once(monkeypatch):
    """plan_parts: one part below the cap; runs of whole units past it, each
    part's buffer within the cap; one unit's frames in chunks, in time order,
    where a unit alone passes it."""
    B, T, N = 37, 95, 30
    assert we.plan_parts(B, T, N, 8) == [(0, B, 0, T)]
    for unit, cap in ((8, 4 * T * N * 8 * 2), (1, 4 * T * N * 5), (8, 4 * N * 8 * 30), (1, 4 * N * 7),
                      (3, 4 * N * 3 * 95 + 1)):
        monkeypatch.setattr(common, "WIDE_LOG_B_BYTES", cap)
        parts = we.plan_parts(B, T, N, unit)
        seen = np.zeros((B, T), int)
        for b_lo, b_hi, t_lo, t_hi in parts:
            assert b_lo % unit == 0 and (b_hi == B or (b_hi - b_lo) % unit == 0)
            assert 4 * -(-(b_hi - b_lo) // unit) * unit * (t_hi - t_lo) * N <= cap
            seen[b_lo:b_hi, t_lo:t_hi] += 1
        assert (seen == 1).all() and len(parts) > 1
        if 4 * N * unit * T > cap:  # frames split: a unit's chunks follow each other in time
            for (b0, _, t0, t1), (b1, _, t2, _) in zip(parts, parts[1:]):
                assert (b1 == b0 and t2 == t1) or (b1 > b0 and t2 == 0)


def test_the_wide_sets_reach_every_shape():
    """SCORE_FULL_WIDE_CASES and DECODE_FULL_WIDE_CASES reach every shape of
    their sets (the scorer's unit its launch shape's U, the decoder's 1)."""
    from torch_port_utils import wide_lengths

    seen = set()
    for i, (S, W, md, B, T, split) in enumerate(SCORE_FULL_WIDE_CASES):
        lens = wide_lengths(i, B, T)
        N = W * S
        U = scoring.vocab_block(S, W, B, 4, 0)["utts"]
        got = wide_placements(md, lens, T, N, U, wide_cap(split, T, N, U))
        assert (split is None) or f"split_{split}" in got
        seen |= got
    assert seen == WIDE_SHAPES
    seen = set()
    for i, (W, S, bigram, md, variant, Ks, split) in enumerate(DECODE_FULL_WIDE_CASES):
        lens = wide_lengths(100 + i, 37, 95)
        N = W * (8 if bigram and S % 8 else S)
        seen |= wide_placements(md, lens, 95, N, 1, wide_cap(split, 95, N, 1))
        seen |= {"bigram" if bigram else "unigram"} | ({"ties"} if variant else set())
        seen |= {"k_4"} if 4 in Ks else set()
    assert seen == DECODE_WIDE_SHAPES


def test_shared_memory_mirrors_stay_within_a_block():
    """The pass's block (common.wide_emission_bytes at every register bound,
    two blocks an SM), the scorer's wide launch shape (no features, the
    diagonals alone) and the decoder's wide chunk (no features) fit a
    block's shared memory, and the wide decoder's chunk is never shorter
    than the lane rule's."""
    for rb in (24, 32, 40, 48, 64):
        assert 2 * (common.wide_emission_bytes(rb) + 4 * 2 * common.WIDE_FRAMES) <= 2 * common.SMEM_LIMIT
        assert common.wide_emission_bytes(rb) + 1024 <= common.SMEM_LIMIT
    for S in (1, 3, 6, 8, 40, 256):
        for W in (1, 13, 200, 5000):
            C = -(-2 * S // 4) * 4
            sh = scoring.vocab_block(S, W, 2048, C, 0)
            assert not sh["consts_global"]
            assert sh["smem_bytes"] == scoring.vocab_smem_bytes(C, S, 0, sh["utts"], sh["words"], sh["tile"])
            assert sh["smem_bytes"] <= common.SMEM_LIMIT
    for N, W, K, P, bigram in ((1600, 200, 1, 1, False), (1600, 200, 3, 1, True), (3200, 400, 4, 2, True),
                               (40, 5, 4, 6, True)):
        for dmax in (32, 64):
            lane = kd.frames_per_chunk(N, W, K, P, dmax, bigram)
            wide = kd.frames_per_chunk(N, W, K, P, dmax, bigram, wide=True)
            assert wide >= lane and 1 <= wide <= 16
            assert kd.smem_bytes(N, W, K, P, dmax, bigram, wide, wide=True) <= common.SMEM_LIMIT
            assert kd.smem_bytes(N, W, K, P, dmax, bigram, wide, wide=True) + 4 * wide * P * dmax \
                == kd.smem_bytes(N, W, K, P, dmax, bigram, wide)


def test_routing_rules_admit_what_they_admitted():
    """scoring.fits / refusal and decode.fits at full covariance past D = 16
    take what they took before the emission pass: D = 64 taken, D = 65
    refused, up to six streams, at most 256 states (the scorer); the
    decoder's rule still counts the features a lane chunk stages."""
    assert scoring.fits(1, [64], 6) and not scoring.fits(1, [65], 6)
    assert scoring.fits(6, [39] * 6, 256) and not scoring.fits(7, [39] * 7, 6) and not scoring.fits(1, [39], 257)
    assert kd.fits(1600, 200, 3, [39], True) and kd.fits(40, 5, 4, [64] * 6, True)
    assert not kd.fits(40, 5, 1, [65], False) and not kd.fits(40, 5, 1, [39] * 7, False)

    def old_rule(N, W, K, dims, bigram):  # decode.fits before the emission pass, written out
        dmax = next(b for b in (4, 8, 12, 16, 32, 64) if b >= max(dims))
        f = lambda F: 4 * (-(-2 * K * N // 4) * 4 + -(-F * N // 4) * 4 + F * len(dims) * dmax + 128  # noqa: E731
                          + (3 * K * W if bigram else 0))
        return 1 <= K <= 4 and len(dims) <= 6 and f(1) <= common.SMEM_LIMIT

    for S in (3, 8):
        for W in (1, 5, 200, 1000, 3000, 5000, 6000):
            for K in (1, 4):
                for dims in ([17], [39], [64], [20, 17], [64] * 6):
                    for bigram in (False, True):
                        assert kd.fits(W * S, W, K, dims, bigram) == old_rule(W * S, W, K, dims, bigram)


def test_wrappers_take_d64_and_refuse_d65_on_meta_tensors():
    """The scorer's launch checks on meta tensors: full D = 64 takes the
    wide launch (the diagonals alone in its constant blocks, the records at
    register bound 64), D = 65 is refused with the reason fits gives."""
    for D, ok in ((64, True), (65, False)):
        M, N, S = 2, 6, 3
        feats = (torch.empty((10, D, 4), device="meta"),)
        a_s = (torch.empty((M * D, N, D), device="meta"),)
        bg = (torch.empty((M * D, N, 1), device="meta"),)
        b = (torch.empty((M, N, 1), device="meta"),)
        lw = (torch.empty((M, N, 1), device="meta"),)
        diag = torch.empty((2, N, 1), device="meta")
        lengths = torch.empty((4,), dtype=torch.int32, device="meta")
        if not ok:
            with pytest.raises(ValueError, match="exceeds 64"):
                scoring._VocabLaunch(feats, a_s, bg, b, lw, diag, lengths, S, 1)
            continue
        ln = scoring._VocabLaunch(feats, a_s, bg, b, lw, diag, lengths, S, 1)
        assert ln.wide and ln.rb == 64 and ln.consts.shape == (2, 8)
        assert ln.recs.numel() == N * M * 65 * 68 and not ln.shape["consts_global"]
