"""Continuous decoding, part 2: the batched path.  The port's
decode_continuous_batch (the word-loop twin on CPU tensors, the batched
backtrace, the host dedupe) against srhmm_tpu's (the Pallas kernels in
interpret mode) on the same numpy inputs: hypotheses equal, scores within
2e-5 relative (float32 kernels); and the static eligibility rule that
replaces the JAX package's ``except ValueError`` routes.
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
from srhmm_tpu_torch.ops.kernels import decode as kd
from srhmm_tpu_torch.ops.kernels.common import dmax_for
from torch_port_utils import both_models, rand_word


def _words(W, S, mixes_dims, cov, seed):
    return [rand_word(seed * 100 + i, S, mixes_dims, cov, delta=1 + i % 2) for i in range(W)]


def _vocabs(words, hetero=False):
    pairs = [both_models(t, s, f"w{i}") for i, (t, s) in enumerate(words)]
    if hetero:
        (jv, jfs), (tv, tfs) = jm.pad_stack_models([p[0] for p in pairs]), \
            tm.pad_stack_models([p[1] for p in pairs])
        np.testing.assert_array_equal(tfs.numpy(), np.asarray(jfs))
        return jv.astype(jnp.float32), tv.astype(torch.float32), np.asarray(jfs)
    return (jm.stack_models([p[0] for p in pairs]).astype(jnp.float32),
            tm.stack_models([p[1] for p in pairs]).astype(torch.float32), None)


def _utterances(rng, words, n, lens_extra=(0, 1, 3)):
    """Word strings sampled around the models' means (per stream), plus
    utterances of lengths 0, 1 and 3 (too short to reach an exit: their
    K-best hypotheses come from NEG_INF-level tokens)."""
    P = len(words[0][1])
    utts = []
    for _ in range(n):
        per = [[] for _ in range(P)]
        for w in rng.integers(0, len(words), size=3):
            trans, streams = words[w]
            S = trans.shape[0]
            for s in range(S):
                for _ in range(2 + int(rng.integers(0, 2))):
                    for p, st in enumerate(streams):
                        per[p].append(st["means"][s, 0] + 0.5 * rng.normal(size=st["means"].shape[-1]))
        utts.append([np.asarray(x) for x in per])
    for L in lens_extra:
        utts.append([rng.normal(size=(L, st["means"].shape[-1])) for st in words[0][1]])
    return utts


def _batches(utts, P):
    j = tuple(jds.pack_utterances([u[p] for u in utts], pad_multiple=8, dtype=jnp.float32) for p in range(P))
    t = tuple(tds.pack_utterances([u[p] for u in utts], pad_multiple=8, dtype=torch.float32) for p in range(P))
    return (j[0], t[0]) if P == 1 else (j, t)


def _same_hyps(got, want, n_best):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if n_best == 1:
            g, w = [g], [w]
        assert [h[1:] for h in g] == [h[1:] for h in w]
        for hg, hw in zip(g, w):
            if np.isfinite(hw[0]):
                np.testing.assert_allclose(hg[0], hw[0], rtol=2e-5)
            else:
                assert hg[0] == hw[0]


@pytest.mark.parametrize("n_best,lm_kind,S", [
    (1, None, 4), (1, "bigram", 6), (2, "unigram", 4), (2, "bigram", 8), (3, "bigram", 6), (3, None, 4),
])
def test_batch_decode_matches_jax(n_best, lm_kind, S):
    rng = np.random.default_rng(10 + n_best)
    W = 4
    words = _words(W, S, [(2, 4)], "diag", seed=n_best)
    jv, tv, _ = _vocabs(words)
    lm = {"unigram": np.log(rng.dirichlet(np.ones(W))),
          "bigram": np.log(rng.dirichlet(np.ones(W), size=W)), None: None}[lm_kind]
    bj, bt = _batches(_utterances(rng, words, 3), 1)
    kw = dict(lm_logprobs=lm, n_best=n_best, word_insertion_penalty=-0.5)
    want = jc.decode_continuous_batch(jv, bj, interpret=True, **kw)
    got = tc.decode_continuous_batch(tv, bt, **kw)
    _same_hyps(got, want, n_best)


@pytest.mark.parametrize("n_best", [1, 2])
def test_batch_decode_full_cov_heterogeneous_matches_jax(n_best):
    rng = np.random.default_rng(20 + n_best)
    words = [rand_word(300 + i, S, [(2, 3)], "full") for i, S in enumerate((4, 6, 5))]
    jv, tv, fs = _vocabs(words, hetero=True)
    bj, bt = _batches(_utterances(rng, words, 3), 1)
    want = jc.decode_continuous_batch(jv, bj, n_best=n_best, final_states=fs, interpret=True)
    got = tc.decode_continuous_batch(tv, bt, n_best=n_best, final_states=fs)
    _same_hyps(got, want, n_best)


@pytest.mark.parametrize("n_best", [1, 3])
def test_batch_decode_multistream_matches_jax(n_best):
    rng = np.random.default_rng(30 + n_best)
    words = _words(3, 4, [(2, 4), (1, 2)], "diag", seed=5)
    jv, tv, _ = _vocabs(words)
    bj, bt = _batches(_utterances(rng, words, 3), 2)
    want = jc.decode_continuous_batch(jv, bj, n_best=n_best, interpret=True)
    got = tc.decode_continuous_batch(tv, bt, n_best=n_best)
    _same_hyps(got, want, n_best)


def test_fused_outputs_match_jax():
    """token_passing_fused / _k2 / _kn: the padded state space, final
    scores and pointers of the JAX wrappers (B trimmed, T as given)."""
    rng = np.random.default_rng(40)
    W = 3
    words = _words(W, 6, [(2, 4)], "diag", seed=7)
    jv, tv, _ = _vocabs(words)
    bj, bt = _batches(_utterances(rng, words, 2), 1)
    lm = np.log(rng.dirichlet(np.ones(W), size=W))
    gj, gt = jc.compose_word_loop_blocks(jv, lm_logprobs=lm), tc.compose_word_loop_blocks(tv, lm_logprobs=lm)
    T = bt.features.shape[1]
    for name, kw in (("token_passing_fused", {}), ("token_passing_fused_k2", {}),
                     ("token_passing_fused_kn", {"n_best": 3})):
        fj, pj, sj = getattr(jc, name)(jv, gj, bj, interpret=True, **kw)
        ft, pt, st = getattr(tc, name)(tv, gt, bt, **kw)
        assert st == sj == 8
        fj, pj = np.asarray(fj), np.asarray(pj)[:T]
        live = fj > -5e29
        assert ((ft.numpy() > -5e29) == live).all()
        np.testing.assert_allclose(ft.numpy()[live], fj[live], rtol=2e-5)
        np.testing.assert_array_equal(pt.numpy(), pj)


def test_backtrace_batch_device_matches_jax():
    rng = np.random.default_rng(41)
    T, N, B = 9, 12, 5
    bps = rng.integers(0, N, size=(T, N, B)).astype(np.int32)
    states = rng.integers(0, N, size=B).astype(np.int32)
    want = np.asarray(jc.backtrace_batch_device(jnp.asarray(bps), jnp.asarray(states)))
    got = tc.backtrace_batch_device(torch.as_tensor(bps), torch.as_tensor(states))
    np.testing.assert_array_equal(got.numpy(), want)
    # a strided (B, T, N) lattice viewed as (T, N, B), as the kernel returns it
    view = torch.as_tensor(np.ascontiguousarray(bps.transpose(2, 0, 1))).permute(1, 2, 0)
    np.testing.assert_array_equal(tc.backtrace_batch_device(view, torch.as_tensor(states)).numpy(), want)


def test_eligibility_is_static(monkeypatch):
    """Ineligible batches take the per-utterance engine because the static
    rule says so; an eligible batch reaches the kernel wrapper or raises."""
    rng = np.random.default_rng(42)
    words = _words(3, 4, [(2, 4)], "diag", seed=9)
    _, tv, _ = _vocabs(words)
    _, bt = _batches(_utterances(rng, words, 2), 1)
    graph = tc.compose_word_loop_blocks(tv)
    assert tc._fused_decode_eligible(tv, bt, graph, 1)
    assert tc._fused_decode_eligible(tv, bt, graph, kd.K_MAX)
    assert not tc._fused_decode_eligible(tv, bt, graph, kd.K_MAX + 1)
    with pytest.raises(ValueError, match="feature batches"):
        tc._fused_decode_eligible(tv, (bt, bt), graph, 1)
    # K beyond the compiled maximum: the per-utterance engine, equal to it
    K = kd.K_MAX + 1
    want = [tc.decode_continuous(tv, bt.features[b, :L], n_best=K) if L > 0 else []
            for b, L in enumerate(bt.lengths.tolist())]
    assert tc.decode_continuous_batch(tv, bt, n_best=K) == want

    def boom(*a, **k):
        raise RuntimeError("kernel failed")

    # an eligible batch whose kernel raises is not retried elsewhere
    monkeypatch.setattr(kd, "word_loop_decode", boom)
    with pytest.raises(RuntimeError, match="kernel failed"):
        tc.decode_continuous_batch(tv, bt)


def _fits_at_03f5319(N, W, K, dims, bigram):
    """The word-loop kernel's acceptance rule at 03f5319, written out: K in
    [1, 4], at most 6 streams, feature dims within the compiled bound of
    64, and one frame's working set in a block's shared memory (232,448
    bytes): the double-buffered (K, N) carry, one frame of log b, x and x^2
    per stream padded to the bound, 128 reduction words and, for a bigram,
    3 K W words of exit tokens and cross-word candidates."""
    if not 1 <= K <= 4 or len(dims) > 6 or max(dims) > 64:
        return False
    dmax = next(b for b in (4, 8, 12, 16, 32, 64) if b >= max(dims))
    r4 = lambda x: -(-x // 4) * 4
    words = r4(2 * K * N) + r4(N) + len(dims) * 2 * dmax + 128 + (3 * K * W if bigram else 0)
    return 4 * words <= 232448


_FITS_DIMS = [(9,), (13,), (39,), (64,), (65,), (9, 3), (13,) * 6, (9,) * 7]


def _widest_at_03f5319(S, K, dims, bigram):
    lo, hi = 0, 1
    while _fits_at_03f5319(hi * S, hi, K, dims, bigram):
        lo, hi = hi, 2 * hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if _fits_at_03f5319(mid * S, mid, K, dims, bigram) else (lo, mid)
    return lo


@pytest.mark.parametrize("bigram", [False, True])
def test_fits_accepts_every_shape_it_accepted_at_03f5319(bigram):
    """kd.fits (and so _fused_decode_eligible) takes every (N, W, K, dims)
    the 03f5319 rule took, up to and past its widest vocabulary, and the
    kernel's shared memory at the chosen chunk stays within a block's."""
    for S in (1, 3, 6, 8, 16):
        for K in (1, 2, 3, 4, 5):
            for dims in _FITS_DIMS:
                widest = _widest_at_03f5319(S, K, dims, bigram)
                for W in sorted({1, 2, 5, 13, 45, 200, 400, 1000, widest // 2, widest, widest + 1} - {0}):
                    N = W * S
                    old = _fits_at_03f5319(N, W, K, dims, bigram)
                    assert not old or kd.fits(N, W, K, dims, bigram), (N, W, K, dims, bigram)
                    if kd.fits(N, W, K, dims, bigram):
                        dmax = dmax_for(dims, "test")
                        F = kd.frames_per_chunk(N, W, K, len(dims), dmax, bigram)
                        assert 1 <= F <= 16
                        assert kd.smem_bytes(N, W, K, len(dims), dmax, bigram, F) <= kd.SMEM_LIMIT


def test_smem_bytes_mirrors_the_kernel():
    """decode.smem_bytes = csrc/word_loop_decode.cu smem_floats * 4: the
    (2, K, N) carry and F frames of log b (each rounded up to 4 floats), x of
    every stream for F frames, 128 reduction words, 3 K W words for a
    bigram; frames_per_chunk takes the most frames (up to 16) that fit."""
    r4 = lambda x: -(-x // 4) * 4
    for N, W, K, P, dmax, bigram, F in ((1600, 200, 1, 1, 16, False, 16), (1600, 200, 3, 1, 16, True, 16),
                                        (3200, 400, 4, 2, 12, True, 5), (39, 13, 2, 6, 64, True, 3)):
        want = 4 * (r4(2 * K * N) + r4(F * N) + F * P * dmax + 128 + (3 * K * W if bigram else 0))
        assert kd.smem_bytes(N, W, K, P, dmax, bigram, F) == want
    assert kd.frames_per_chunk(1600, 200, 1, 1, 16, False) == 16
    assert kd.frames_per_chunk(3200, 400, 4, 1, 12, True) == 8
    assert kd.smem_bytes(3200, 400, 4, 1, 12, True, 8) <= kd.SMEM_LIMIT < kd.smem_bytes(3200, 400, 4, 1, 12, True, 9)


def test_merge_groups_split_every_destination_over_the_block():
    """merge_groups: the largest power of two up to 32 whose product with W
    fits the block's threads (1 when W alone does not)."""
    assert [kd.merge_groups(W, t) for W, t in ((200, 512), (5, 64), (45, 384), (400, 512), (600, 512), (1, 32))] \
        == [2, 8, 8, 1, 1, 32]
    for W in range(1, 700):
        for t in (32, 64, 384, 512):
            g = kd.merge_groups(W, t)
            assert g & (g - 1) == 0 and 1 <= g <= 32 and (g == 1 or g * W <= t) and (g == 32 or 2 * g * W > t)


def test_fused_eligible_takes_a_bigram_whose_arcs_exceed_shared_memory():
    """W=400 words of 8 states under a bigram: the (W, W) float32 arcs (640
    KB) do not fit a block's shared memory, and the batch still rides the
    kernel at every K (as at 03f5319)."""
    rng = np.random.default_rng(3)
    W = 400
    words = [tm.gmm_hmm_from_numpy(*rand_word(i, 8, [(2, 9)], "diag"), f"w{i}") for i in range(W)]
    tv = tm.stack_models(words).astype(torch.float32)
    lm = np.log(rng.dirichlet(np.ones(W), size=W))
    graph = tc.compose_word_loop_blocks(tv, lm_logprobs=lm)
    bt = tds.pack_utterances([rng.normal(size=(n, 9)) for n in (12, 0, 1)], pad_multiple=1, dtype=torch.float32)
    assert 4 * W * W > kd.SMEM_LIMIT
    for K in (1, 2, 3, 4):
        assert tc._fused_decode_eligible(tv, bt, graph, K) == _fits_at_03f5319(W * 8, W, K, [9], True) is True


def test_decode_records_lay_the_diagonal_records_out_row_minor():
    """decode_records: full covariance records as they are; diagonal ones as
    float4 groups (M, dmax / 4, 2, N, 4) of the x and x^2 halves, then bias
    and log w (M, 2, N), padded to a multiple of 4 floats (the order
    csrc/word_loop_decode.cu reads)."""
    for N, M, dmax in ((5, 3, 8), (40, 1, 4), (3, 2, 16)):
        stride = 2 * dmax + 4
        rec = torch.arange(N * M * stride, dtype=torch.float32).reshape(1, -1)
        out = kd.decode_records(rec, N, M, dmax, False)
        r = rec.reshape(N, M, stride)
        assert out.numel() % 4 == 0 and out.numel() >= N * M * (2 * dmax + 2)
        vec = out[: M * dmax * 2 * N].reshape(M, dmax // 4, 2, N, 4)
        for h in range(2):
            np.testing.assert_array_equal(vec[:, :, h].permute(2, 0, 1, 3).reshape(N, M, dmax).numpy(),
                                          r[..., h * dmax:(h + 1) * dmax].numpy())
        sc = out[M * dmax * 2 * N: M * dmax * 2 * N + 2 * M * N].reshape(M, 2, N)
        np.testing.assert_array_equal(sc.permute(2, 0, 1).numpy(), r[..., 2 * dmax:2 * dmax + 2].numpy())
    full = torch.arange(60, dtype=torch.float32).reshape(1, -1)
    assert torch.equal(kd.decode_records(full, 2, 1, 4, True), full.reshape(-1))
