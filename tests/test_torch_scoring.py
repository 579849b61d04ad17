"""The scoring kernel module against the JAX package.

On the CPU: pack_vocab_constants against JAX's packer; vocab_scores_plain
against JAX's Pallas kernel run in interpret mode on the same packed
arrays; score_batch_fused against JAX's score_batch_log (diag rtol 1e-5,
full and multi-stream rtol 1e-4, atol 1e-5 * max|ref|, equal finite masks,
the tolerances tests/test_pallas_kernels.py holds the Pallas kernel to);
the max semiring against Viterbi; the kernel's per-word constant layout,
read back the way csrc/vocab_scores.cu reads it; the build's missing-nvcc
error.  The CUDA kernel is held against the plain version on the card by
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srhmm_tpu.models as jm
import srhmm_tpu_torch.models as tm
from srhmm_tpu.decode.scorer import score_batch_log as j_score_batch_log
from srhmm_tpu.io.dataset import pack_utterances as j_pack
from srhmm_tpu.ops import log_state_emission as j_log_state_emission
from srhmm_tpu.ops import viterbi as j_viterbi
from srhmm_tpu.ops.pallas.scoring_pallas import pack_vocab_constants as j_pack_constants
from srhmm_tpu.ops.pallas.scoring_pallas import vocab_scores_pallas
from srhmm_tpu_torch.decode.scorer import score_batch, score_batch_log
from srhmm_tpu_torch.io.dataset import pack_utterances
from srhmm_tpu_torch.ops.kernels import build, scoring
from srhmm_tpu_torch.ops.kernels.common import _TINY, LOG_GAUS_CLAMP, NEG_INF
from torch_port_utils import both_models, rand_word


def _vocabs(cov, W=5, S=5, mixes_dims=((2, 6),), scale=3.0, seed0=0):
    pairs = [
        both_models(*rand_word(seed0 + i, S, list(mixes_dims), cov, scale=scale), f"w{i}")
        for i in range(W)
    ]
    jv = jm.stack_models([p[0] for p in pairs]).astype(jnp.float32)
    tv = tm.stack_models([p[1] for p in pairs]).astype(torch.float32)
    return jv, tv


def _batches(utts):
    return (
        j_pack(utts, pad_multiple=8, dtype=jnp.float32),
        pack_utterances(utts, pad_multiple=8, dtype=torch.float32),
    )


def _close(got, ref, rtol):
    finite = np.isfinite(ref)
    assert (np.isfinite(got) == finite).all()
    np.testing.assert_allclose(
        got[finite], ref[finite], rtol=rtol, atol=1e-5 * np.abs(ref[finite]).max()
    )


@pytest.mark.parametrize("cov", ["diag", "full"])
def test_pack_vocab_constants_matches_jax(cov):
    jv, tv = _vocabs(cov, W=3, S=4)
    if cov == "full":  # a degenerate and a non-PD mixture take the bias rules
        streams = rand_word(7, 4, [(2, 6)], cov)[1]
        streams[0]["det"][1, 0] = 0.0
        streams[0]["inv_cov"][2, 1] = -np.eye(6)
        pj, pt = both_models(np.asarray(jm.init_left_right_trans(4)), streams, "x")
        jv = jm.stack_models([pj, pj]).astype(jnp.float32)
        tv = tm.stack_models([pt, pt]).astype(torch.float32)
    want = j_pack_constants(jv, jnp.float32)
    got = scoring.pack_vocab_constants(tv, torch.float32)
    assert got[5] == want[5] == 1
    for g, w in zip(got[:5], want[:5]):
        assert g.dtype == torch.float32 and tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)


@pytest.mark.parametrize("semiring", ["sum", "max"])
@pytest.mark.parametrize("cov", ["diag", "full"])
def test_vocab_scores_plain_matches_pallas_interpret(cov, semiring):
    jv, tv = _vocabs(cov, W=4, S=5, mixes_dims=((2, 4),))
    rng = np.random.default_rng(2)
    T, B = 16, 6
    feats = (rng.normal(size=(T, 4, B)) * 2).astype(np.float32)
    lengths = np.array([16, 9, 1, 0, 12, 16], np.int32)
    pj = j_pack_constants(jv, jnp.float32)
    want = np.asarray(vocab_scores_pallas(
        jnp.asarray(feats), *pj[:4], pj[4], jnp.asarray(lengths), s_word=5, band=pj[5],
        k_block=8, semiring=semiring, interpret=True,
    ))
    pt = scoring.pack_vocab_constants(tv, torch.float32)
    got = scoring.vocab_scores_plain(
        torch.from_numpy(feats), *pt[:4], pt[4], torch.from_numpy(lengths), s_word=5,
        band=pt[5], semiring=semiring,
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    launches = scoring.vocab_scores.launches
    via = scoring.vocab_scores(
        torch.from_numpy(feats), *pt[:4], pt[4], torch.from_numpy(lengths), s_word=5,
        band=pt[5], semiring=semiring,
    ).numpy()
    np.testing.assert_array_equal(via, got)  # CPU tensors: the plain version
    assert scoring.vocab_scores.launches == launches


@pytest.mark.parametrize("mode", ["total", "final"])
@pytest.mark.parametrize("cov,rtol", [("diag", 1e-5), ("full", 1e-4)])
def test_score_batch_fused_matches_jax(cov, rtol, mode):
    jv, tv = _vocabs(cov, W=6, S=5)
    rng = np.random.default_rng(0)
    utts = [rng.normal(size=(20 + 3 * i, 6)) for i in range(7)] + [np.zeros((0, 6))]
    jb, tb = _batches(utts)
    ref = np.asarray(j_score_batch_log(jv, jb, mode=mode))
    _close(scoring.score_batch_fused(tv, tb, mode=mode).numpy(), ref, rtol)
    _close(score_batch(tv, tb, mode=mode, impl="fused").numpy(), ref, rtol)
    _close(score_batch_log(tv, tb, mode=mode).numpy(), ref, rtol)


@pytest.mark.parametrize("cov", ["diag", "full"])
def test_score_batch_fused_multi_stream_matches_jax(cov):
    jv, tv = _vocabs(cov, W=5, S=6, mixes_dims=((3, 9), (2, 3)), scale=2.0, seed0=100)
    rng = np.random.default_rng(3)
    lens = [50 + 7 * i for i in range(4)]
    jb1, tb1 = _batches([rng.normal(size=(n, 9)) for n in lens])
    jb2, tb2 = _batches([rng.normal(size=(n, 3)) for n in lens])
    for mode in ("total", "final"):
        ref = np.asarray(j_score_batch_log(jv, (jb1, jb2), mode=mode))
        _close(scoring.score_batch_fused(tv, (tb1, tb2), mode=mode).numpy(), ref, 1e-4)
        _close(score_batch_log(tv, (tb1, tb2), mode=mode).numpy(), ref, 1e-4)


@pytest.mark.parametrize("mode", ["total", "final"])
def test_score_batch_fused_heterogeneous_matches_jax(mode):
    shapes = [(4, 2), (6, 1), (3, 3), (5, 2)]
    pairs = [both_models(*rand_word(i, S, [(M, 6)], "diag"), f"w{i}") for i, (S, M) in enumerate(shapes)]
    sj, fj = jm.pad_stack_models([p[0] for p in pairs])
    st, ft = tm.pad_stack_models([p[1] for p in pairs])
    sj, st = sj.astype(jnp.float32), st.astype(torch.float32)
    rng = np.random.default_rng(0)
    jb, tb = _batches([rng.normal(size=(40 + 7 * i, 6)) for i in range(5)])
    ref = np.asarray(j_score_batch_log(sj, jb, mode=mode, final_states=fj))
    got = scoring.score_batch_fused(st, tb, mode=mode, final_states=ft).numpy()
    _close(got, ref, 1e-5)
    _close(score_batch_log(st, tb, mode=mode, final_states=ft).numpy(), ref, 1e-5)


def test_max_semiring_equals_viterbi():
    jv, tv = _vocabs("diag", W=6, S=5)
    rng = np.random.default_rng(0)
    utts = [rng.normal(size=(20 + 3 * i, 6)) for i in range(5)]
    _, tb = _batches(utts)
    got = scoring.score_batch_fused(tv, tb, mode="final", semiring="max").numpy()
    for b in (0, 3):
        frames = jnp.asarray(utts[b], jnp.float32)
        for wi in (0, 4):
            one = jax.tree.map(lambda x: x[wi], jv)
            score, _ = j_viterbi(j_log_state_emission(frames, one.streams), one.log_trans())
            np.testing.assert_allclose(got[b, wi], float(score), rtol=1e-5)


def _emulate_kernel(consts, offs, diag_off, ds, ms, feats, lengths, S, band, full, dmax, viterbi):
    """csrc/vocab_scores.cu's arithmetic in numpy, reading the (W, C)
    constant blocks at the offsets and strides the kernel uses."""
    c = consts.numpy().astype(np.float64)
    W = c.shape[0]
    T, _, B = feats[0].shape
    alpha = np.full((W, S, B), NEG_INF)
    for t in range(T):
        lb = np.zeros((W, S, B))
        for q, (D, M) in enumerate(zip(ds, ms)):
            x = np.zeros((dmax, B))
            x[:D] = feats[q][t]
            stride = D * dmax + dmax + 4 if full else 2 * dmax + 4
            for s in range(S):
                qs = []
                for m in range(M):
                    r = c[:, offs[q] + (s * M + m) * stride:][:, :stride]
                    if full:
                        z = r[:, : D * dmax].reshape(W, D, dmax) @ x + r[:, D * dmax : D * dmax + D, None]
                        bias, logw = r[:, D * dmax + dmax, None], r[:, D * dmax + dmax + 1, None]
                        qs.append(np.minimum(-0.5 * (z * z).sum(1) + bias, LOG_GAUS_CLAMP) + logw)
                    else:
                        qs.append(r[:, :dmax] @ x + r[:, dmax : 2 * dmax] @ (x * x) + r[:, 2 * dmax, None])
                qs = np.stack(qs)
                mx = np.maximum(qs.max(0), NEG_INF)
                lb[:, s] += np.log(np.maximum(np.exp(qs - mx).sum(0), _TINY)) + mx
        if t == 0:
            start = np.where(np.arange(S) == 0, 0.0, NEG_INF)[None, :, None]
            alpha = np.maximum(start + lb, NEG_INF)
            continue
        new = np.empty_like(alpha)
        for j in range(S):
            terms = np.stack([alpha[:, j - d] + c[:, diag_off + d * S + j, None] for d in range(min(band, j) + 1)])
            m = np.maximum(terms.max(0), NEG_INF)
            upd = m if viterbi else np.maximum(np.log(np.maximum(np.exp(terms - m).sum(0), _TINY)) + m, NEG_INF)
            new[:, j] = np.maximum(upd + lb[:, j], NEG_INF)
        alpha = np.where(lengths[None, None, :] > t, new, alpha)
    return alpha.reshape(W * S, B)


@pytest.mark.parametrize(
    "cov,mixes_dims,semiring,delta",
    [("diag", ((2, 6),), "sum", 1), ("full", ((2, 3),), "max", 2), ("diag", ((3, 5), (2, 3)), "sum", 2)],
)
def test_kernel_constant_layout_reproduces_plain(cov, mixes_dims, semiring, delta):
    W, S = 3, 5
    models = [tm.gmm_hmm_from_numpy(*rand_word(i, S, list(mixes_dims), cov, delta)) for i in range(W)]
    vocab = tm.stack_models(models).astype(torch.float32)
    packs = [scoring.pack_vocab_constants(vocab, stream=p) for p in range(len(mixes_dims))]
    rng = np.random.default_rng(5)
    T, B = 9, 4
    feats = tuple(torch.from_numpy((rng.normal(size=(T, D, B)) * 2).astype(np.float32)) for _, D in mixes_dims)
    lengths = torch.tensor([9, 4, 1, 0], dtype=torch.int32)
    a_s, bg_s, bi_s, lw_s = (tuple(pk[i] for pk in packs) for i in range(4))
    band = packs[0][5]
    ds, ms, full = scoring._stream_shapes(feats, a_s)
    dmax = scoring.dmax_for(ds, "vocab_scores")
    consts, offs, diag_off = scoring._kernel_constants(
        a_s, bg_s, bi_s, lw_s, packs[0][4], ds, ms, W, S, band, full, dmax
    )
    assert consts.shape[1] % 4 == 0 and all(o % 4 == 0 for o in offs)
    emulated = _emulate_kernel(
        consts, offs, diag_off, ds, ms, [f.numpy() for f in feats], lengths.numpy(), S, band,
        full, dmax, semiring == "max",
    )
    plain = scoring.vocab_scores_plain(
        feats, a_s, bg_s, bi_s, lw_s, packs[0][4], lengths, s_word=S, band=band, semiring=semiring
    ).numpy()
    np.testing.assert_allclose(emulated, plain, rtol=1e-5, atol=1e-3)


def test_build_names_missing_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "CUDA_ROOT", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.find_nvcc()
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_library()


def test_score_batch_dispatch_on_cpu():
    jv, tv = _vocabs("diag", W=4, S=4, mixes_dims=((2, 5),))
    rng = np.random.default_rng(1)
    _, tb = _batches([rng.normal(size=(18 + i, 5)) for i in range(5)])
    np.testing.assert_array_equal(score_batch(tv, tb).numpy(), score_batch_log(tv, tb).numpy())
    np.testing.assert_array_equal(
        score_batch(tv, tb, impl="plain").numpy(), score_batch_log(tv, tb).numpy()
    )
    with pytest.raises(ValueError, match="impl"):
        score_batch(tv, tb, impl="xla")
