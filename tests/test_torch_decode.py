"""Continuous decoding, part 1: the port's graph builders, emissions,
per-utterance engines and the word-loop kernel's plain twin, held against
srhmm_tpu on the same numpy inputs.

Bounds: graphs exactly equal; emissions and engine scores rtol 1e-10 in
float64; pointers and hypotheses exactly equal; the twin's final scores
within 2e-5 relative of the Pallas kernels run in interpret mode (the
bound of tests/test_continuous.py's kernel-vs-engine checks, float32) and
every pointer equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srhmm_tpu.decode.continuous as jc
import srhmm_tpu.models as jm
import srhmm_tpu_torch.decode.continuous as tc
import srhmm_tpu_torch.models as tm
from srhmm_tpu.ops.pallas import decode_pallas as jdp
from srhmm_tpu.ops.pallas.scoring_pallas import pack_vocab_constants as j_pack
from srhmm_tpu_torch.ops.kernels import decode as kd
from srhmm_tpu_torch.ops.kernels.scoring import pack_vocab_constants as t_pack
from torch_port_utils import both_models, rand_word

NEG = -1e30


def _vocab(W, S, mixes_dims, cov="diag", seed=0, dtype=np.float64, dup=False):
    """The same stacked vocabulary in both packages (alternating band 1 and
    2 words), cast to dtype; dup: word 3 is a copy of word 1."""
    pairs = [both_models(*rand_word(seed * 100 + (1 if dup and i == 3 else i), S, mixes_dims, cov,
                                    delta=1 + i % 2), f"w{i}")
             for i in range(W)]
    jv = jm.stack_models([p[0] for p in pairs])
    tv = tm.stack_models([p[1] for p in pairs])
    if dtype == np.float32:
        jv, tv = jv.astype(jnp.float32), tv.astype(torch.float32)
    return jv, tv


def _lm(rng, W, kind):
    if kind == "unigram":
        return np.log(rng.dirichlet(np.ones(W)))
    if kind == "bigram":
        return np.log(rng.dirichlet(np.ones(W), size=W))
    return None


def _graph_leaves(g):
    names = ("log_trans", "state_to_word", "entry_states", "exit_states", "log_entry")
    return [np.asarray(getattr(g, n)) if not isinstance(getattr(g, n), torch.Tensor)
            else getattr(g, n).numpy() for n in names]


@pytest.mark.parametrize("lm_kind", [None, "unigram", "bigram"])
def test_graph_builders_equal(lm_kind):
    rng = np.random.default_rng(1)
    jv, tv = _vocab(4, 5, [(2, 3)])
    lm = _lm(rng, 4, lm_kind)
    kw = dict(lm_logprobs=lm, exit_logprob=-1.7, lm_scale=0.8, word_insertion_penalty=-0.5)
    for extra in ({}, {"lm_initial": np.log(rng.dirichlet(np.ones(4)))}):
        gj, gt = jc.compose_word_loop(jv, **kw, **extra), tc.compose_word_loop(tv, **kw, **extra)
        for a, b in zip(_graph_leaves(gj), _graph_leaves(gt)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)
        assert gt.words == gj.words == ("w0", "w1", "w2", "w3")
        fs = np.array([4, 2, 3, 4])
        bj = jc.compose_word_loop_blocks(jv, final_states=fs, **kw, **extra)
        bt = tc.compose_word_loop_blocks(tv, final_states=fs, **kw, **extra)
        for n in ("log_trans", "arc", "log_entry", "exit_states"):
            np.testing.assert_array_equal(getattr(bt, n).numpy(), np.asarray(getattr(bj, n)))
    sj, st = jc.compose_sequence(jv, [2, 0, 2, 1]), tc.compose_sequence(tv, [2, 0, 2, 1])
    for a, b in zip(_graph_leaves(sj), _graph_leaves(st)):
        np.testing.assert_array_equal(b, a)
    assert tc.compose_word_loop_blocks(tv).exit_states is None
    with pytest.raises(ValueError, match="lm_logprobs"):
        tc.compose_word_loop(tv, lm_logprobs=np.zeros((3, 3)))


@pytest.mark.parametrize("cov,mixes_dims", [("diag", [(2, 3)]), ("full", [(2, 3)]),
                                            ("diag", [(2, 3), (1, 2)])])
def test_emissions_equal(cov, mixes_dims):
    rng = np.random.default_rng(2)
    jv, tv = _vocab(3, 4, mixes_dims, cov)
    frames = [rng.normal(size=(11, D)) for _, D in mixes_dims]
    fj = tuple(jnp.asarray(f) for f in frames)
    ft = tuple(torch.as_tensor(f) for f in frames)
    if len(frames) == 1:
        fj, ft = fj[0], ft[0]
    np.testing.assert_allclose(tc.composed_emissions(tv, ft).numpy(),
                               np.asarray(jc.composed_emissions(jv, fj)), rtol=1e-10)
    gj, gt = jc.compose_sequence(jv, [1, 0, 1]), tc.compose_sequence(tv, [1, 0, 1])
    np.testing.assert_allclose(tc.emissions_for_graph(tv, gt, ft).numpy(),
                               np.asarray(jc.emissions_for_graph(jv, gj, fj)), rtol=1e-10)


def _assert_tokens(got, want):
    """(scores, pointers) of two token-passing runs: equal -inf masks,
    scores rtol 1e-10, pointers equal wherever the token is finite."""
    (fg, bg), (fw, bw) = got, want
    fg, bg, fw, bw = fg.numpy(), bg.numpy(), np.asarray(fw), np.asarray(bw)
    fin = np.isfinite(fw)
    assert (np.isfinite(fg) == fin).all()
    np.testing.assert_allclose(fg[fin], fw[fin], rtol=1e-10)
    assert bg.shape == bw.shape and bg.dtype == bw.dtype
    np.testing.assert_array_equal(bg[:, fin], bw[:, fin])


@pytest.mark.parametrize("n_best", [1, 2, 3])
def test_token_passing_engines_equal(n_best):
    rng = np.random.default_rng(3)
    jv, tv = _vocab(4, 4, [(2, 3)])
    lm = _lm(rng, 4, "bigram")
    frames = rng.normal(size=(14, 3)) * 2
    lbj = jc.composed_emissions(jv, jnp.asarray(frames))
    lbt = tc.composed_emissions(tv, torch.as_tensor(frames))
    gj, gt = jc.compose_word_loop(jv, lm_logprobs=lm), tc.compose_word_loop(tv, lm_logprobs=lm)
    _assert_tokens(tc.token_passing(gt, lbt, n_best=n_best), jc.token_passing(gj, lbj, n_best=n_best))
    _assert_tokens(tc.token_passing(gt, lbt, length=9, n_best=n_best, beam=30.0),
                   jc.token_passing(gj, lbj, length=jnp.asarray(9), n_best=n_best, beam=30.0))
    fs = np.array([3, 2, 3, 1])
    bj = jc.compose_word_loop_blocks(jv, lm_logprobs=lm, final_states=fs)
    bt = tc.compose_word_loop_blocks(tv, lm_logprobs=lm, final_states=fs)
    _assert_tokens(tc.token_passing_blocks(bt, lbt, n_best=n_best),
                   jc.token_passing_blocks(bj, lbj, n_best=n_best))
    _assert_tokens(tc.token_passing_blocks(bt, lbt, length=torch.tensor(10), n_best=n_best, beam=25.0),
                   jc.token_passing_blocks(bj, lbj, length=jnp.asarray(10), n_best=n_best, beam=25.0))


def test_stable_top_k_breaks_ties_like_lax():
    x = np.array([[-np.inf, 3.0, -np.inf, 3.0, 1.0, -np.inf, 3.0],
                  [-np.inf] * 7,
                  [2.0, -np.inf, 2.0, -np.inf, 2.0, 2.0, -np.inf]])
    for k in (1, 2, 3, 5, 7):
        vj, ij = jax.lax.top_k(jnp.asarray(x), k)
        vt, it = tc._top_k(torch.as_tensor(x), k)
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    # torch.topk alone is not stable on these rows
    assert any(
        not np.array_equal(torch.topk(torch.as_tensor(x), k).indices.numpy(),
                           np.asarray(jax.lax.top_k(jnp.asarray(x), k)[1]))
        for k in (2, 3, 5)
    )


@pytest.mark.parametrize("engine,n_best,lm_kind,hetero", [
    ("blocks", 1, None, False), ("blocks", 3, "bigram", False), ("blocks", 2, "unigram", True),
    ("dense", 1, "unigram", False), ("dense", 3, "bigram", False),
])
def test_decode_continuous_equal(engine, n_best, lm_kind, hetero):
    rng = np.random.default_rng(4)
    jv, tv = _vocab(4, 4, [(2, 3)], dtype=np.float32)
    lm = _lm(rng, 4, lm_kind)
    means = np.asarray(jv.streams[0].means)
    frames = np.concatenate([means[w, s, 0] + 0.3 * rng.normal(size=(3, 3))
                             for w in (2, 0, 3) for s in range(4)]).astype(np.float32)
    fs = np.array([3, 2, 3, 1]) if hetero else None
    kw = dict(lm_logprobs=lm, n_best=n_best, engine=engine, final_states=fs, word_insertion_penalty=-1.0)
    hj = jc.decode_continuous(jv, jnp.asarray(frames), **kw)
    ht = tc.decode_continuous(tv, torch.as_tensor(frames), **kw)
    assert [h[1:] for h in ht] == [h[1:] for h in hj]
    np.testing.assert_allclose([h[0] for h in ht], [h[0] for h in hj], rtol=1e-5)
    assert len(ht) == n_best


def test_decode_continuous_float64_and_multistream():
    rng = np.random.default_rng(5)
    jv, tv = _vocab(3, 4, [(2, 3), (1, 2)])
    frames = [rng.normal(size=(16, 3)) * 2, rng.normal(size=(16, 2))]
    hj = jc.decode_continuous(jv, tuple(jnp.asarray(f) for f in frames), n_best=3)
    ht = tc.decode_continuous(tv, tuple(torch.as_tensor(f) for f in frames), n_best=3)
    assert [h[1:] for h in ht] == [h[1:] for h in hj]
    np.testing.assert_allclose([h[0] for h in ht], [h[0] for h in hj], rtol=1e-10)


# ---------------------------------------------------------------------------
# the word-loop kernel's plain twin against the Pallas kernels (interpret)
# ---------------------------------------------------------------------------


def _twin_case(cov, W, S, mixes_dims, bigram, hetero, seed, T=16, B=5, dup=False):
    """Packed operands of one decode, as (jax kwargs, torch kwargs); dup:
    word 3 a copy of word 1 with the same arcs in and out, so their tokens
    tie exactly."""
    rng = np.random.default_rng(seed)
    jv, tv = _vocab(W, S, mixes_dims, cov, seed=seed, dtype=np.float32, dup=dup)
    N, P = W * S, len(mixes_dims)
    lens = np.array([T, 0, 1] + list(rng.integers(2, T, size=B - 3)), np.int32)
    feats = [(rng.normal(size=(T, D, B)) * 2).astype(np.float32) for _, D in mixes_dims]
    if bigram:
        arc = np.maximum(np.log(rng.dirichlet(np.ones(W), size=W)) + np.log(0.1), NEG)
        if dup:
            arc[:, 3] = arc[:, 1]
            arc[3] = arc[1]
    else:
        arc = np.full((N, 1), NEG)
        arc[np.arange(W) * S, 0] = np.log(rng.dirichlet(np.ones(W))) + np.log(0.1)
        if dup:
            arc[3 * S, 0] = arc[S, 0]
    entry = np.full((N, 1), NEG)
    entry[np.arange(W) * S, 0] = -np.log(W)
    exit_col = None
    if hetero:
        exit_col = np.full((N, 1), NEG)
        exit_col[np.arange(W) * S + rng.integers(S // 2, S, size=W), 0] = 0.0
    full = cov == "full"
    packs = ([j_pack(jv, jnp.float32, stream=p) for p in range(P)],
             [t_pack(tv, torch.float32, stream=p) for p in range(P)])
    out = []
    for lib, pk, conv in ((jnp, packs[0], lambda x: jnp.asarray(x, jnp.float32)),
                          (torch, packs[1], lambda x: torch.as_tensor(x, dtype=torch.float32))):
        def sel(i):
            xs = tuple(x[i] for x in pk)
            return xs[0] if P == 1 else xs
        f = tuple(conv(x) for x in feats)
        out.append(dict(
            feats_tdb=f[0] if P == 1 else f, a=sel(0), bias=sel(2), diag=pk[0][4],
            arc_col=conv(arc), entry_col=conv(entry),
            lengths=jnp.asarray(lens) if lib is jnp else torch.as_tensor(lens),
            s_word=S, band=pk[0][5], exit_col=None if exit_col is None else conv(exit_col),
            bias_g=sel(1) if full else None, logw=sel(3) if full else None,
        ))
    return out


# every (covariance, arc) pair at K = 1, 2, 3; two streams with
# heterogeneous exits once per pair, at one K each
_TWIN_CASES = [
    (cov, W, S, md, bigram, hetero, K)
    for cov in ("diag", "full")
    for (W, S, md, bigram, hetero, Ks) in (
        (4, 5, [(2, 5)], False, False, (1, 2, 3)),
        (3, 8, [(2, 5)], True, False, (1, 2, 3)),
        (3, 6, [(3, 4), (1, 3)], False, True, (2,) if cov == "diag" else (1,)),
        (3, 8, [(2, 4), (2, 3)], True, True, (3,) if cov == "diag" else (2,)),
    )
    for K in Ks
]


@pytest.mark.parametrize("cov,W,S,mixes_dims,bigram,hetero,n_best", _TWIN_CASES)
def test_twin_matches_pallas_kernels(cov, W, S, mixes_dims, bigram, hetero, n_best):
    jk, tk = _twin_case(cov, W, S, mixes_dims, bigram, hetero, seed=len(mixes_dims) + 7 * bigram)
    if n_best == 1:
        fj, bj = jdp.word_loop_decode_pallas(**jk, k_block=1, interpret=True)
    elif n_best == 2:
        fj, bj = jdp.word_loop_decode_k2_pallas(**jk, k_block=1, interpret=True)
    else:
        fj, bj = jdp.word_loop_decode_kn_pallas(**jk, n_best=n_best, k_block=1, interpret=True)
    ft, bt = kd.word_loop_decode_plain(**tk, n_best=n_best)
    # on CPU tensors the wrappers run the twin
    wrapper = {1: kd.word_loop_decode, 2: kd.word_loop_decode_k2}.get(n_best)
    again = wrapper(**tk) if wrapper else kd.word_loop_decode_kn(**tk, n_best=n_best)
    assert torch.equal(again[0], ft) and torch.equal(again[1], bt)
    fj, bj, ft, bt = np.asarray(fj), np.asarray(bj), ft.numpy(), bt.numpy()
    assert ft.shape == fj.shape and bt.shape == bj.shape and bt.dtype == bj.dtype
    live = fj > NEG / 2
    assert ((ft > NEG / 2) == live).all()
    rel = np.abs(ft[live] - fj[live]) / np.maximum(np.abs(fj[live]), 1.0)
    assert rel.max() <= 2e-5
    np.testing.assert_array_equal(bt, bj)


@pytest.mark.parametrize("n_best", [1, 2, 3])
@pytest.mark.parametrize("bigram", [False, True])
def test_twin_breaks_exact_ties_like_pallas(bigram, n_best):
    """A duplicated word makes exit tokens tie exactly: the lowest row (then
    the lowest plane) must win, as in the Pallas kernels."""
    jk, tk = _twin_case("diag", 4, 8, [(2, 5)], bigram, False, seed=11, dup=True)
    if n_best == 1:
        fj, bj = jdp.word_loop_decode_pallas(**jk, k_block=1, interpret=True)
    elif n_best == 2:
        fj, bj = jdp.word_loop_decode_k2_pallas(**jk, k_block=1, interpret=True)
    else:
        fj, bj = jdp.word_loop_decode_kn_pallas(**jk, n_best=n_best, k_block=1, interpret=True)
    ft, bt = kd.word_loop_decode_plain(**tk, n_best=n_best)
    fj = np.asarray(fj)
    live = fj > NEG / 2
    np.testing.assert_allclose(ft.numpy()[live], fj[live], rtol=2e-5)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    # the two copies' exit rows hold equal live tokens
    fin = ft.numpy().reshape(n_best, 4, 8, -1)
    assert ((fin[:, 1] == fin[:, 3]) & (fin[:, 1] > NEG / 2)).any()


def test_twin_k2_and_kn_agree_on_the_top_two():
    """At K = 2 the K-slot kernel (#8) and the 2-best kernel (#7) keep the
    same tokens; the twin follows #7."""
    jk, tk = _twin_case("diag", 3, 8, [(2, 5)], True, False, seed=3)
    fj, bj = jdp.word_loop_decode_kn_pallas(**jk, n_best=2, k_block=1, interpret=True)
    ft, bt = kd.word_loop_decode_plain(**tk, n_best=2)
    live = np.asarray(fj) > NEG / 2
    np.testing.assert_allclose(ft.numpy()[live], np.asarray(fj)[live], rtol=2e-5)
    np.testing.assert_array_equal(bt.numpy()[:, live], np.asarray(bj)[:, live])


def test_kernel_fits_and_refuses():
    # the main shape fits; a very wide K-best vocabulary does not
    assert kd.fits(200 * 8, 200, 3, [13], bigram=True)
    assert kd.frames_per_chunk(200 * 8, 200, 3, 1, 16, True) == 16  # the emission chunk: up to 16 frames
    assert not kd.fits(8000 * 8, 8000, 1, [13], bigram=False)
    assert not kd.fits(16, 2, kd.K_MAX + 1, [13], bigram=False)
    assert not kd.fits(16, 2, 1, [80], bigram=False)
    with pytest.raises(ValueError, match="n_best >= 2"):
        kd.word_loop_decode_kn(None, None, None, None, None, None, None, 8, 1, n_best=1)
