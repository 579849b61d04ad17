"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports no JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Bounds: scores, log_b and log-alpha max |kernel - plain| / max(|plain|, 1)
<= 1e-5 over finite values (above NEG_INF/2 for the lattices), equal masks
(the bound of the JAX package's compiled-vs-interpret gate); summed E-step
statistics max |kernel - plain| <= 1e-4 max |plain| (fp32 sums taken in
another order).  Both run fp32.
"""

import numpy as np
import pytest
import torch

import srhmm_tpu_torch.models as tm
from srhmm_tpu_torch.io.dataset import UtteranceBatch, pack_utterances
from srhmm_tpu_torch.ops.kernels import fused_em as fe
from srhmm_tpu_torch.ops.kernels import scoring
from srhmm_tpu_torch.ops.kernels.common import NEG_INF
from srhmm_tpu_torch.train import em
from torch_port_utils import (
    BANK_DEPTH_CASES,
    BANK_PLACE_CASES,
    EMIT_CHECK_CASES,
    LATTICE_CASES,
    backward_lattice_case,
    em_tile_lengths,
    emit_check_lengths,
    entry_without_loop,
    forward_lattice_case,
    rand_word,
    sparse_gammas,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _vocab(cov, W, S, mixes_dims, delta=1):
    words = [tm.gmm_hmm_from_numpy(*rand_word(i, S, list(mixes_dims), cov, delta)) for i in range(W)]
    return tm.stack_models(words).astype(torch.float32)


def _batch(device, dims, lens, seed=8):
    rng = np.random.default_rng(seed)
    out = tuple(
        pack_utterances([rng.normal(size=(n, D)) * 2 for n in lens], pad_multiple=1,
                        dtype=torch.float32, device=device)
        for D in dims
    )
    return out[0] if len(out) == 1 else out


def _kernel_and_plain(vocab, batch, device, mode, semiring, final_states=None):
    cpu = tuple(b.to("cpu") for b in batch) if isinstance(batch, tuple) else batch.to("cpu")
    launches = scoring.vocab_scores.launches
    got = scoring.score_batch_fused(vocab.to(device), batch, mode, semiring, final_states)
    torch.cuda.synchronize()
    assert scoring.vocab_scores.launches == launches + 1
    want = scoring.score_batch_fused(vocab.to("cpu"), cpu, mode, semiring, final_states)
    return got.cpu().numpy(), want.numpy()


def _assert_close(got, want):
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all()
    rel = np.max(np.abs(got[fin] - want[fin]) / np.maximum(np.abs(want[fin]), 1.0))
    assert rel <= 1e-5, rel
    assert (got.argmax(1) == want.argmax(1)).all()


@pytest.mark.parametrize("semiring", ["sum", "max"])
@pytest.mark.parametrize("cov,mixes_dims,delta", [
    ("diag", ((3, 9), (2, 3)), 1),
    ("full", ((3, 9), (2, 3)), 1),
    ("diag", ((4, 13),), 2),
    ("full", ((1, 9),), 1),
    ("diag", ((2, 40),), 1),
])
def test_kernel_matches_plain(cuda_device, cov, mixes_dims, delta, semiring):
    vocab = _vocab(cov, 7, 6, mixes_dims, delta)
    lens = [0, 1, 33, 130, 129, 77, 5, 300]
    batch = _batch(cuda_device, [D for _, D in mixes_dims], lens)
    for mode in ("total", "final"):
        _assert_close(*_kernel_and_plain(vocab, batch, cuda_device, mode, semiring))


def test_kernel_heterogeneous_final_states(cuda_device):
    words = [tm.gmm_hmm_from_numpy(*rand_word(i, S, [(M, 6)], "diag"))
             for i, (S, M) in enumerate([(4, 2), (6, 1), (6, 3), (4, 2)])]
    vocab, fs = tm.pad_stack_models(words)
    vocab = vocab.astype(torch.float32)
    batch = _batch(cuda_device, [6], [40, 0, 17, 129, 3])
    for mode in ("total", "final"):
        _assert_close(*_kernel_and_plain(vocab, batch, cuda_device, mode, "sum", fs))


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    vocab = _vocab("diag", 2, 4, ((2, 5),)).to(cuda_device)
    b64 = _batch(cuda_device, [5], [10, 12])
    args, kw = scoring.pack_batch(vocab, b64)
    with pytest.raises(ValueError, match="float32"):
        scoring.vocab_scores(args[0].double(), *args[1:], **kw)
    wide = _vocab("diag", 2, 4, ((1, 65),)).to(cuda_device)
    with pytest.raises(ValueError, match="exceeds"):
        scoring.score_batch_fused(wide, _batch(cuda_device, [65], [10]))


def _em_inputs(device, cov, band, mixes_dims, lens, S=6, seed=3, shared_gaussians=False):
    """(feats, packed, origins, trans, lengths) of one E-step on `device`;
    band=None gives a dense random transition matrix; shared_gaussians gives
    every mixture of a state mixture 0's Gaussian (posteriors = weights)."""
    rng = np.random.default_rng(seed)
    if band is None:
        trans = rng.uniform(0.1, 1.0, size=(S, S))
    else:
        trans = np.zeros((S, S))
        for i in range(S):
            trans[i, i : i + band + 1] = rng.uniform(0.2, 1.0, size=min(band + 1, S - i))
    trans /= trans.sum(-1, keepdims=True)
    _, streams = rand_word(seed, S, list(mixes_dims), cov, scale=3.0)
    if shared_gaussians:
        for st in streams:
            for key in ("means", "inv_cov", "det"):
                st[key] = np.repeat(st[key][:, :1], st[key].shape[1], axis=1)
    model = tm.gmm_hmm_from_numpy(trans, streams).astype(torch.float32).to(device)
    T, B = max(lens), len(lens)
    feats = tuple(
        torch.as_tensor(rng.normal(size=(T, D, B)) * 3, dtype=torch.float32, device=device)
        for _, D in mixes_dims
    )
    origins = tuple(s.means.mean(dim=(0, 1)) for s in model.streams)
    packed = tuple(fe.pack_lane_constants(s, origin=o) for s, o in zip(model.streams, origins))
    return feats, packed, origins, model.trans, torch.as_tensor(lens, dtype=torch.int32, device=device)


def _lattice_close(got, want):
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    mask = want > NEG_INF / 2
    assert ((got > NEG_INF / 2) == mask).all()
    rel = np.max(np.abs(got[mask] - want[mask]) / np.maximum(np.abs(want[mask]), 1.0))
    assert rel <= 1e-5, rel


def _stat_close(got, want):
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


_LENS = [int(n) for n in np.random.default_rng(5).integers(2, 95, size=34)] + [95, 0, 1]


@pytest.mark.parametrize("mixes_dims", [((3, 9),), ((3, 9), (2, 3))])
@pytest.mark.parametrize("band", [1, 2, None])
@pytest.mark.parametrize("cov", ["diag", "full"])
def test_em_kernels_match_plain(cuda_device, cov, band, mixes_dims):
    feats, packed, origins, trans, lengths = _em_inputs(cuda_device, cov, band, mixes_dims, _LENS)
    args = (feats, packed, origins, trans, lengths, band)
    counts = fe.emit_forward.launches, fe.backward_stats.launches
    lb_k, la_k = fe.emit_forward(*args)
    lb_p, la_p = fe.emit_forward_plain(*args)
    _lattice_close(lb_k, lb_p)
    _lattice_close(la_k, la_p)
    log_z = la_p[-1, -1]
    valid = torch.isfinite(log_z) & (log_z > NEG_INF / 2) & (lengths > 0)
    rest = (feats, lb_p, la_p, packed, origins, trans, lengths, torch.where(valid, log_z, 0.0),
            valid.float(), band)
    got, want = fe.backward_stats(*rest), fe.backward_stats_plain(*rest)
    torch.cuda.synchronize()
    assert (fe.emit_forward.launches, fe.backward_stats.launches) == (counts[0] + 1, counts[1] + 1)
    for a, b in zip(_stat_parts(got, mixes_dims), _stat_parts(want, mixes_dims)):
        assert a.shape == b.shape
        _stat_close(a, b)


def test_em_kernels_take_non_contiguous_inputs(cuda_device):
    """Strided views give the same lattices and statistics as contiguous
    copies: each wrapper holds its contiguous copies until the launch."""
    feats, packed, origins, trans, lengths = _em_inputs(cuda_device, "diag", 1, ((3, 9),), _LENS)

    def strided(x):  # same values, every other element of a doubled buffer
        return torch.stack([x, torch.zeros_like(x)], dim=-1)[..., 0]

    lb, la = fe.emit_forward(feats, packed, origins, trans, lengths, 1)
    lb_s, la_s = fe.emit_forward(tuple(map(strided, feats)), packed, origins, trans, lengths, 1)
    log_z = la[-1, -1]
    valid = torch.isfinite(log_z) & (log_z > NEG_INF / 2) & (lengths > 0)
    safe_z, vmask = torch.where(valid, log_z, 0.0), valid.float()
    want = fe.backward_stats(feats, lb, la, packed, origins, trans, lengths, safe_z, vmask, 1)
    got = fe.backward_stats(tuple(map(strided, feats)), strided(lb), strided(la), packed, origins,
                            trans, lengths, strided(safe_z), strided(vmask), 1)
    torch.cuda.synchronize()
    assert not strided(lb).is_contiguous()
    assert torch.equal(lb, lb_s) and torch.equal(la, la_s)
    for a, b in zip(_stat_parts(got, ((3, 9),)), _stat_parts(want, ((3, 9),))):
        assert torch.equal(a, b)


def _stat_parts(stats, mixes_dims):
    """xi, den_trans, den_mix, then per stream its first moments, second
    moments and occupancies apart (each has its own scale)."""
    out = list(stats[:3])
    for mom, (_, D) in zip(stats[3], mixes_dims):
        out += [mom[:, :D], mom[:, D:-1], mom[:, -1]]
    return out


def _train_batch(device, S=5, D=4, B=33, seed=7, cov="diag"):
    rng = np.random.default_rng(seed)
    utts = [rng.normal(size=(int(rng.integers(20, 60)), D)) + np.arange(D) for _ in range(B)]
    batch = pack_utterances(utts, pad_multiple=1, dtype=torch.float32, device=device)
    trans, streams = rand_word(seed, S, [(2, D)], cov)
    return tm.gmm_hmm_from_numpy(trans, streams).astype(torch.float32).to(device), batch


def test_em_step_launches_the_kernels_and_repeats_bitwise(cuda_device):
    model, batch = _train_batch(cuda_device)
    assert em._fused_lane_eligible(model, batch)
    counts = fe.emit_forward.launches, fe.backward_stats.launches
    m1, lp1, nv1 = em.em_step(model, batch)
    m2, lp2, nv2 = em.em_step(model, batch)
    torch.cuda.synchronize()
    assert (fe.emit_forward.launches, fe.backward_stats.launches) == (counts[0] + 2, counts[1] + 2)
    assert torch.equal(lp1, lp2) and torch.equal(nv1, nv2)
    for a, b in zip(m1.buffers(), m2.buffers()):
        assert torch.equal(a, b)
    # the kernels' step agrees with the plain path on the card
    m_p, lp_p, _ = em.em_step(model, batch, fused=False)
    np.testing.assert_allclose(float(lp1), float(lp_p), rtol=1e-5)
    np.testing.assert_allclose(m1.streams[0].means.cpu().numpy(), m_p.streams[0].means.cpu().numpy(),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("cov", ["diag", "full"])
def test_em_iterations_never_sync_the_host(cuda_device, cov):
    """em_train_scan keeps its log probs on the device: no operation of an
    iteration (packing, kernels, reductions, m_step) waits for the card."""
    model, batch = _train_batch(cuda_device, seed=9, cov=cov)
    use_fused, feats_tdb, band = em._fused_setup(model, batch)
    assert use_fused
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, lps, nvs = em.em_train_scan(model, batch, 3, feats_tdb, fused=True, band=band)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert lps.shape == (3,) and bool(torch.isfinite(lps).all())


def test_cuda_batch_never_reaches_a_twin(cuda_device, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA batch reached a plain twin")

    monkeypatch.setattr(fe, "emit_forward_plain", refuse)
    monkeypatch.setattr(fe, "backward_stats_plain", refuse)
    model, batch = _train_batch(cuda_device, seed=8)
    counts = fe.emit_forward.launches, fe.backward_stats.launches
    res = em.train_fast(model, batch, max_iterations=4, chunk=2)
    torch.cuda.synchronize()
    assert fe.emit_forward.launches - counts[0] >= res.iterations
    assert fe.backward_stats.launches - counts[1] >= res.iterations
    # a float64 CUDA batch is not eligible and a forced launch refuses it
    b64 = UtteranceBatch(batch.features.double(), batch.lengths)
    assert not em._fused_lane_eligible(model, b64)
    packed = (fe.pack_lane_constants(model.streams[0]),)
    origins = (model.streams[0].means.mean(dim=(0, 1)),)
    with pytest.raises(ValueError, match="float32"):
        fe.emit_forward((b64.features.permute(1, 2, 0).contiguous(),), packed, origins,
                        model.trans, batch.lengths, 1)


# ---------------------------------------------------------------------------
# the word-loop decode kernel (csrc/word_loop_decode.cu)
# ---------------------------------------------------------------------------

from srhmm_tpu_torch.decode import continuous as dc  # noqa: E402
from srhmm_tpu_torch.ops.kernels import decode as kd  # noqa: E402

_DECODE_LENS = [int(n) for n in np.random.default_rng(6).integers(2, 95, size=34)] + [95, 0, 1]
_WRAPPERS = {1: "word_loop_decode", 2: "word_loop_decode_k2", 3: "word_loop_decode_kn", 4: "word_loop_decode_kn"}


def _decode_case(device, cov, S, bigram, mixes_dims, variant=None, W=5, lens=_DECODE_LENS, seed=4, dup=(1, 3)):
    """(vocab, batch, graph kwargs) of one decode on `device`.  variant
    "hetero": word lengths S and S-2, padded (pad_stack_models) with their
    final states; "dup": word dup[1] a copy of word dup[0] with the same
    arcs (the bigram's row and column; the unigram is uniform), so tokens
    tie bitwise; "noloop": no self-loop at the words' first states and
    words 0-19 unreachable by a bigram."""
    rng = np.random.default_rng(seed)
    a, c = dup
    sizes = [S - 2 * (i % 2) if variant == "hetero" else S for i in range(W)]
    leaves = [rand_word(seed * 50 + (a if variant == "dup" and i == c else i), s, list(mixes_dims), cov,
                        1 + (a if variant == "dup" and i == c else i) % 2) for i, s in enumerate(sizes)]
    if variant == "noloop":  # no self-loop at the entry states
        leaves = [(entry_without_loop(t), st) for t, st in leaves]
    words = [tm.gmm_hmm_from_numpy(t, st) for t, st in leaves]
    vocab, fs = tm.pad_stack_models(words) if variant == "hetero" else (tm.stack_models(words), None)
    kw = {"final_states": fs}
    if bigram:
        lm = np.log(rng.dirichlet(np.ones(W), size=W))
        if variant == "dup":  # arcs in and out too: the two words are interchangeable
            lm[:, c] = lm[:, a]
            lm[c] = lm[a]
        if variant == "noloop":  # words 0-19 unreachable by the bigram
            lm[:, :20] = -np.inf
        kw["lm_logprobs"] = lm
    batch = _batch(device, [D for _, D in mixes_dims], lens, seed=seed)
    return vocab.astype(torch.float32).to(device), batch, kw


def _twins(monkeypatch):
    monkeypatch.setattr(kd, "word_loop_decode", lambda *a, **k: kd.word_loop_decode_plain(*a, n_best=1, **k))
    monkeypatch.setattr(kd, "word_loop_decode_k2", lambda *a, **k: kd.word_loop_decode_plain(*a, n_best=2, **k))
    monkeypatch.setattr(kd, "word_loop_decode_kn", lambda *a, **k: kd.word_loop_decode_plain(*a, **k))


def _decode_operands(vocab, batch, kw):
    batches = batch if isinstance(batch, tuple) else (batch,)
    graph = dc.compose_word_loop_blocks(vocab, **kw)
    (feats, a, bias, bias_g, logw, diag, band, arc_col, entry_col, exit_col, lengths,
     s_eff) = dc._fused_operands(vocab, graph, batches)
    return (feats, a, bias, diag, arc_col, entry_col, lengths, s_eff, band), dict(
        exit_col=exit_col, bias_g=bias_g, logw=logw)


@pytest.mark.parametrize("n_best", [1, 2, 3, 4])
@pytest.mark.parametrize("cov,S,bigram,mixes_dims,variant", [
    ("diag", 8, False, ((3, 9),), None),
    ("diag", 6, True, ((3, 9), (2, 3)), None),
    ("full", 8, True, ((3, 9),), None),
    ("full", 6, False, ((3, 9), (2, 3)), "hetero"),
    ("diag", 8, True, ((3, 9),), "hetero"),
    ("diag", 8, False, ((3, 9),), "dup"),
    ("diag", 8, True, ((3, 9),), "dup"),
])
def test_decode_kernel_matches_plain(cuda_device, monkeypatch, cov, S, bigram, mixes_dims, variant, n_best):
    vocab, batch, kw = _decode_case(cuda_device, cov, S, bigram, mixes_dims, variant)
    args, opt = _decode_operands(vocab, batch, kw)
    wrapper = getattr(kd, _WRAPPERS[n_best])
    extra = {"n_best": n_best} if n_best > 2 else {}
    before = wrapper.launches
    fk, bk = wrapper(*args, **opt, **extra)
    fk2, bk2 = wrapper(*args, **opt, **extra)
    fp, bpp = kd.word_loop_decode_plain(*args, n_best=n_best, **opt)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert torch.equal(fk, fk2) and torch.equal(bk, bk2)  # two runs bitwise equal
    _lattice_close(fk, fp)
    assert bk.shape == bpp.shape and bk.dtype == bpp.dtype
    assert int((bk != bpp).sum()) <= 1e-4 * bk.numel()
    # hypotheses through the same backtrace: kernel pointers vs twin pointers
    got = dc.decode_continuous_batch(vocab, batch, n_best=n_best, **kw)
    _twins(monkeypatch)
    want = dc.decode_continuous_batch(vocab, batch, n_best=n_best, **kw)
    for g, w in zip(got, want):
        g, w = ([g], [w]) if n_best == 1 else (g, w)
        assert [h[1:] for h in g] == [h[1:] for h in w]
        for hg, hw in zip(g, w):
            assert hg[0] == hw[0] or abs(hg[0] - hw[0]) <= 1e-5 * max(abs(hw[0]), 1.0)


def test_decode_batch_launches_the_kernel_and_never_the_twin(cuda_device, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA batch reached the plain twin")

    monkeypatch.setattr(kd, "word_loop_decode_plain", refuse)
    vocab, batch, kw = _decode_case(cuda_device, "diag", 6, True, ((3, 9),))
    for n_best, name in _WRAPPERS.items():
        before = getattr(kd, name).launches
        out = dc.decode_continuous_batch(vocab, batch, n_best=n_best, **kw)
        torch.cuda.synchronize()
        assert getattr(kd, name).launches == before + 1
        assert len(out) == len(_DECODE_LENS)
    # float64 features are cast to float32 for the kernel; a float64 operand is refused
    args, opt = _decode_operands(vocab, batch, kw)
    with pytest.raises(ValueError, match="float32"):
        kd.word_loop_decode(args[0].double(), *args[1:], **opt)


@pytest.mark.parametrize("n_best", [1, 2, 3, 4])
@pytest.mark.parametrize("W,bigram,variant", [(45, False, "dup"), (45, True, "dup"), (45, True, "noloop"),
                                               (400, True, None)])
def test_decode_kernel_matches_plain_at_wide_vocabularies(cuda_device, W, bigram, variant, n_best):
    """W off the multiples of 32 with word 33 a copy of word 2 (their ties
    settled across two lanes of one destination's merge group, or across
    two warps of the unigram argmax); entry states without a self-loop and
    unreachable words (NEG_INF-level cross candidates reach the pointers);
    a bigram whose (W, W) arcs exceed a block's shared memory: kernel vs
    twin, two runs bitwise equal."""
    vocab, batch, kw = _decode_case(cuda_device, "diag", 8, bigram, ((2, 9),), variant, W=W,
                                    lens=[40, 0, 1, 33, 17, 2, 39], dup=(2, 33))
    args, opt = _decode_operands(vocab, batch, kw)
    wrapper = getattr(kd, _WRAPPERS[n_best])
    extra = {"n_best": n_best} if n_best > 2 else {}
    fk, bk = wrapper(*args, **opt, **extra)
    fk2, bk2 = wrapper(*args, **opt, **extra)
    fp, bpp = kd.word_loop_decode_plain(*args, n_best=n_best, **opt)
    torch.cuda.synchronize()
    assert torch.equal(fk, fk2) and torch.equal(bk, bk2)
    _lattice_close(fk, fp)
    assert int((bk != bpp).sum()) <= 1e-4 * bk.numel()


def test_decode_kernel_takes_the_main_width(cuda_device):
    """W=200, S=8, M=4, D=13 bigram at K=3 (the JAX package's config-3
    vocabulary), a short T: kernel vs twin."""
    vocab, batch, kw = _decode_case(cuda_device, "diag", 8, True, ((4, 13),), W=200,
                                    lens=[40, 0, 1, 33, 17])
    args, opt = _decode_operands(vocab, batch, kw)
    fk, bk = kd.word_loop_decode_kn(*args, n_best=3, **opt)
    fp, bpp = kd.word_loop_decode_plain(*args, n_best=3, **opt)
    torch.cuda.synchronize()
    _lattice_close(fk, fp)
    assert int((bk != bpp).sum()) <= 1e-4 * bk.numel()


# ---------------------------------------------------------------------------
# the composed-lattice kernels of embedded / tied training (csrc/composed.cu)
# ---------------------------------------------------------------------------

from srhmm_tpu_torch.ops.kernels import composed as kc  # noqa: E402
from srhmm_tpu_torch.train import embedded as emb  # noqa: E402
from srhmm_tpu_torch.train import tied as tied_mod  # noqa: E402

_COMPOSED_LENS = [int(n) for n in np.random.default_rng(7).integers(2, 95, size=34)] + [95, 0, 1]


def _composed_units(cov, S, mixes_dims, P=5, seed=11):
    words = [tm.gmm_hmm_from_numpy(*rand_word(seed + i, S, list(mixes_dims), cov, max(S - 1, 1), scale=3.0))
             for i in range(P)]
    return tm.stack_models(words).astype(torch.float32)


def _composed_case(device, cov, S, L, mixes_dims, lens=_COMPOSED_LENS, seed=12):
    """The four kernels' inputs for a batch of transcripts of L units
    (utterance 0 repeats one unit), on `device`."""
    rng = np.random.default_rng(seed)
    models = _composed_units(cov, S, mixes_dims).to(device)
    P, B, T, D = models.trans.shape[0], len(lens), max(lens), mixes_dims[0][1]
    trs = rng.integers(0, P, size=(B, L))
    trs[0] = 2
    transcripts = torch.as_tensor(trs, device=device)
    feats = torch.as_tensor(rng.normal(size=(B, T, D)) * 3, dtype=torch.float32, device=device)
    lengths = torch.as_tensor(lens, dtype=torch.int32, device=device)
    full = cov == "full"
    banks = tuple(emb._pack_bank(st, D, full) for st in models.streams)
    ids = emb._positions(transcripts, S)
    pos_logt = models.log_trans()[transcripts.long()]
    diag_row, diag_col = emb._composed_diagonals(pos_logt, max(S - 1, 1))
    return models, transcripts, ids, banks, feats, lengths, diag_row, diag_col, full


_COMPOSED_CASES = [
    ("diag", 2, 1, ((3, 9),)),
    ("diag", 3, 3, ((3, 9), (2, 9))),
    ("full", 3, 5, ((2, 6),)),
    ("diag", 4, 5, ((4, 13),)),
    ("full", 2, 3, ((3, 4), (2, 4))),
]


@pytest.mark.parametrize("cov,S,L,mixes_dims", _COMPOSED_CASES)
def test_composed_kernels_match_plain(cuda_device, cov, S, L, mixes_dims):
    _, _, ids, banks, feats, lengths, diag_row, diag_col, full = _composed_case(
        cuda_device, cov, S, L, mixes_dims)
    counts = kc.launch_counts()
    lb_k = kc.bank_emission(ids, banks, feats, full)
    lb_p = kc.bank_emission_plain(ids, banks, feats, full)
    _lattice_close(lb_k, lb_p)
    la_k = kc.composed_forward(lb_p, diag_col, lengths)
    la_p = kc.composed_forward_plain(lb_p, diag_col, lengths)
    _lattice_close(la_k, la_p)
    log_z = la_p[-1, -1]
    valid = torch.isfinite(log_z) & (log_z > NEG_INF / 2) & (lengths > 0)
    rest = (lb_p, la_p, diag_row, lengths, torch.where(valid, log_z, 0.0), valid.float())
    st_k, st_k2 = kc.composed_backward_stats(*rest), kc.composed_backward_stats(*rest)
    st_p = kc.composed_backward_stats_plain(*rest)
    for a, b, c in zip(st_k, st_p, st_k2):
        _stat_close(a, b)
        assert torch.equal(a, c)
    gamma = st_p[0]
    m_lat = kc.bank_moments_lattice(ids, banks, feats, gamma, lengths, full)
    m_lat2 = kc.bank_moments_lattice(ids, banks, feats, gamma, lengths, full)
    m_bst = kc.bank_moments(ids, banks, feats, gamma.permute(2, 1, 0).contiguous(), lengths, full)
    m_p = kc.bank_moments_lattice_plain(ids, banks, feats, gamma, lengths, full)
    torch.cuda.synchronize()
    D = feats.shape[-1]
    for a, b, a2, c in zip(m_lat, m_p, m_lat2, m_bst):
        assert torch.equal(a, a2) and torch.equal(a, c)  # bitwise: repeat and both gamma layouts
        for part in (slice(0, D), slice(D, -1), slice(-1, None)):
            _stat_close(a[..., part], b[..., part])
    after = kc.launch_counts()
    assert after == {"bank_emission": counts["bank_emission"] + 1,
                     "composed_forward": counts["composed_forward"] + 1,
                     "composed_backward_stats": counts["composed_backward_stats"] + 2,
                     "bank_moments_lattice": counts["bank_moments_lattice"] + 2,
                     "bank_moments": counts["bank_moments"] + 1}


def test_fused_embedded_e_step_repeats_bitwise_and_matches_plain(cuda_device):
    models, transcripts, _, _, feats, lengths, *_ = _composed_case(cuda_device, "diag", 3, 4, ((3, 9),))
    assert emb._embedded_fused_eligible(models, transcripts, feats)
    a = emb.batch_stats_fused(models, transcripts, feats, lengths)
    b = emb.batch_stats_fused(models, transcripts, feats, lengths)
    p = emb.batch_stats(models, transcripts, feats, lengths)
    torch.cuda.synchronize()
    for x, y, z in ((a.num_trans, b.num_trans, p.num_trans), (a.den_mix, b.den_mix, p.den_mix),
                    (a.streams[0].x, b.streams[0].x, p.streams[0].x),
                    (a.streams[0].xx, b.streams[0].xx, p.streams[0].xx)):
        assert torch.equal(x, y)
        np.testing.assert_allclose(x.cpu().numpy(), z.cpu().numpy(), rtol=5e-4,
                                   atol=5e-4 * float(z.abs().max()))
    assert torch.equal(a.log_prob, b.log_prob)


def test_tied_em_step_takes_the_kernels(cuda_device, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA batch reached a plain twin")

    models, transcripts, _, _, feats, lengths, *_ = _composed_case(cuda_device, "diag", 3, 3, ((2, 9),))
    sm = (np.arange(5 * 3).reshape(5, 3) % 8).astype(np.int32)
    tied = tm.tie_from_models(models, sm).astype(torch.float32)
    for name in ("bank_emission_plain", "composed_forward_plain", "composed_backward_stats_plain",
                 "bank_moments_plain", "bank_moments_lattice_plain"):
        monkeypatch.setattr(kc, name, refuse)
    counts = kc.launch_counts()
    t1, lp1, nv1 = tied_mod.tied_em_step(tied, transcripts, feats, lengths)
    t2, lp2, nv2 = tied_mod.tied_em_step(tied, transcripts, feats, lengths, gamma_lattice=False)
    torch.cuda.synchronize()
    after = kc.launch_counts()
    assert all(after[k] > counts[k] for k in counts)
    assert torch.equal(lp1, lp2) and torch.equal(t1.senones.means, t2.senones.means)
    tp, lpp, _ = tied_mod.tied_em_step(tied, transcripts, feats, lengths, fused=False)
    np.testing.assert_allclose(float(lp1), float(lpp), rtol=1e-5)
    np.testing.assert_allclose(t1.trans.cpu().numpy(), tp.trans.cpu().numpy(), rtol=1e-3, atol=1e-5)
    # a float64 CUDA batch is not eligible; a forced launch refuses it
    assert not tied_mod._tied_fused_eligible(tied, transcripts, feats.double())
    with pytest.raises(ValueError, match="float32"):
        kc.bank_emission(emb._positions(transcripts, 3), emb._pack_bank(tied.senones, 9, False),
                         feats.double())


# the redesigned bank kernels: every register bound, M off the mma tiles,
# six streams of different M, lengths off the 32-frame tile, sparse gammas
# (torch_port_utils.sparse_gammas: zero tiles beside single-frame edge tiles, one
# term a bank row, subnormal values)
_BANK_LENS = [0, 1, 31, 32, 33, 64, 95] + [int(n) for n in np.random.default_rng(9).integers(2, 95, size=12)]
_BANK_CASES = [
    ("diag", ((1, 13),)),
    ("diag", ((3, 13),)),
    ("diag", ((16, 13),)),
    ("diag", ((17, 13),)),
    ("diag", ((32, 13),)),
    ("diag", ((3, 9),)),
    ("diag", ((4, 39),)),
    ("diag", ((2, 64),)),
    ("full", ((3, 4),)),
    ("full", ((2, 16),)),
    ("diag", ((1, 13), (3, 13), (16, 13), (17, 13), (32, 13), (2, 13))),
]


def _moments_all(ids, banks, feats, gamma, lengths, full):
    """Kernel twice and in the (B, LS, T) layout, and the twin, as tuples."""
    as_t = lambda m: m if isinstance(m, tuple) else (m,)
    k = as_t(kc.bank_moments_lattice(ids, banks, feats, gamma, lengths, full))
    k2 = as_t(kc.bank_moments_lattice(ids, banks, feats, gamma, lengths, full))
    kb = as_t(kc.bank_moments(ids, banks, feats, gamma.permute(2, 1, 0).contiguous(), lengths, full))
    p = as_t(kc.bank_moments_lattice_plain(ids, banks, feats, gamma, lengths, full))
    torch.cuda.synchronize()
    return k, k2, kb, p


def _check_bank_kernels(device, cov, mixes_dims):
    """bank_emission and the moments vs their twins: log_b within 1e-5,
    moments within 1e-4 of scale per part, on the lattice's own gamma and
    on sparse / subnormal ones; two runs and the two layouts bitwise equal."""
    _, _, ids, banks, feats, lengths, diag_row, diag_col, full = _composed_case(
        device, cov, 3, 4, mixes_dims, lens=_BANK_LENS)
    banks = banks if len(banks) > 1 else banks[0]
    lb_k = kc.bank_emission(ids, banks, feats, full)
    lb_p = kc.bank_emission_plain(ids, banks, feats, full)
    _lattice_close(lb_k, lb_p)
    assert torch.equal(lb_k, kc.bank_emission(ids, banks, feats, full))
    la = kc.composed_forward_plain(lb_p, diag_col, lengths)
    log_z = la[-1, -1]
    valid = torch.isfinite(log_z) & (log_z > NEG_INF / 2) & (lengths > 0)
    gamma = kc.composed_backward_stats_plain(lb_p, la, diag_row, lengths, torch.where(valid, log_z, 0.0),
                                             valid.float())[0]
    D = feats.shape[-1]
    gammas = {"lattice": gamma, **sparse_gammas(ids, lengths, feats.shape[1], seed=3)}
    for tag, g in gammas.items():
        k, k2, kb, p = _moments_all(ids, banks, feats, g, lengths, full)
        for a, a2, b, want in zip(k, k2, kb, p):
            assert torch.equal(a, a2) and torch.equal(a, b), tag
            for part in (slice(0, D), slice(D, -1), slice(-1, None)):
                _stat_close(a[..., part], want[..., part])
        if tag == "subnormal":  # not flushed: as the twin's, to 1e-4 of their scale
            assert all(float(a[..., -1].abs().max()) > 0 for a in k)


@pytest.mark.parametrize("cov,mixes_dims", _BANK_CASES)
def test_bank_kernels_match_plain_at_every_bound(cuda_device, cov, mixes_dims):
    _check_bank_kernels(cuda_device, cov, mixes_dims)


@pytest.mark.parametrize("cov,mixes_dims,nbuf,slots", BANK_DEPTH_CASES)
def test_bank_kernels_match_plain_at_every_buffer_depth(cuda_device, cov, mixes_dims, nbuf, slots):
    """_check_bank_kernels where the emission's ring holds nbuf < 3 rows'
    records and a moments batch takes slots < 4 tiles (their own copy,
    wait and barrier branches)."""
    mixes, D = [m for m, _ in mixes_dims], mixes_dims[0][1]
    assert kc.emission_ring(mixes, [kc.record_stride(D, cov == "full")] * len(mixes)) == nbuf
    assert kc.moments_slots(mixes, D, cov == "full") == slots
    _check_bank_kernels(cuda_device, cov, mixes_dims)


@pytest.mark.parametrize("mixes_dims,nbuf,place", BANK_PLACE_CASES)
def test_bank_kernels_match_plain_with_records_or_accumulators_off_chip(cuda_device, mixes_dims, nbuf, place):
    """_check_bank_kernels at the diagonal shapes whose emission reads the
    records from device memory (ring 0) or a one-row ring, and whose
    moments keep the records, the accumulators or both outside shared
    memory."""
    mixes, D = [m for m, _ in mixes_dims], mixes_dims[0][1]
    assert kc.emission_ring(mixes, [kc.record_stride(D, False)] * len(mixes)) == nbuf
    assert kc.moments_shape(mixes, D, False)[1:] == place
    _check_bank_kernels(cuda_device, "diag", mixes_dims)


def test_bank_kernels_poison_out_of_range_ids(cuda_device):
    """An id outside [0, NB) gives NaN log_b rows and a NaN moment row (the
    first or last bank row, where the stable sort puts it); every other
    bank row stays finite and equal to the twin's."""
    _, _, ids, banks, feats, lengths, diag_row, diag_col, full = _composed_case(
        cuda_device, "diag", 3, 4, ((3, 9),), lens=_BANK_LENS)
    bank = banks[0]
    NB = bank.shape[0]
    bad = ids.clone()
    bad[3, 5] = NB
    bad[4, 0] = -1
    lb = kc.bank_emission(bad, bank, feats, full)
    torch.cuda.synchronize()
    assert torch.isnan(lb[:, 5, 3]).all() and torch.isnan(lb[:, 0, 4]).all()
    assert int(torch.isnan(lb).sum()) == 2 * lb.shape[0]
    g = sparse_gammas(ids, lengths, feats.shape[1], seed=3)["edges"]
    mom = kc.bank_moments_lattice(bad, bank, feats, g, lengths, full)
    torch.cuda.synchronize()
    rows_nan = torch.isnan(mom).flatten(1).any(1).cpu().numpy()
    assert rows_nan[0] and rows_nan[NB - 1] and not rows_nan[1:NB - 1].any()
    want = kc.bank_moments_lattice_plain(bad.clamp(0, NB - 1), bank, feats, g, lengths, full)
    ok = torch.as_tensor(~rows_nan, device=mom.device)
    _stat_close(mom[ok], want[ok])


# the redesigned lattice kernels: composed_forward and
# composed_backward_stats at every launch shape (rows per lane 1 / 2 / 4, an
# utterance over 2 and 8 warps, band 1 to 15, T around and below the tiles,
# B off the block's utterances) and backward_stats at lengths on its tile
# edges


@pytest.mark.parametrize("LS,nd,T,B", LATTICE_CASES)
def test_composed_forward_matches_plain_at_every_launch_shape(cuda_device, LS, nd, T, B):
    args = forward_lattice_case(cuda_device, 900 + LS, LS, nd, T, B)
    counts = kc.launch_counts()["composed_forward"]
    got, again = kc.composed_forward(*args), kc.composed_forward(*args)
    want = kc.composed_forward_plain(*args)
    torch.cuda.synchronize()
    assert kc.launch_counts()["composed_forward"] == counts + 2
    _lattice_close(got, want)
    assert torch.equal(got, again)  # bitwise repeat


@pytest.mark.parametrize("LS,nd,T,B", LATTICE_CASES)
def test_composed_backward_stats_matches_plain_at_every_launch_shape(cuda_device, LS, nd, T, B):
    args = backward_lattice_case(cuda_device, 700 + LS, LS, nd, T, B)
    counts = kc.launch_counts()["composed_backward_stats"]
    got, again = kc.composed_backward_stats(*args), kc.composed_backward_stats(*args)
    want = kc.composed_backward_stats_plain(*args)
    torch.cuda.synchronize()
    assert kc.launch_counts()["composed_backward_stats"] == counts + 2
    for a, b, c in zip(got, want, again):
        assert a.shape == b.shape
        _stat_close(a, b)
        assert torch.equal(a, c)  # bitwise repeat


_EM_TILE_CASES = [
    ("diag", 1, ((3, 9),), 6),
    ("diag", 2, ((3, 9),), 6),
    ("diag", None, ((3, 9),), 6),
    ("diag", 1, ((3, 39),), 6),
    ("full", 1, ((2, 16),), 6),
    ("diag", 2, ((3, 9), (2, 3)), 6),
    ("diag", 2, ((3, 9), (2, 3), (2, 5), (1, 7), (3, 4), (2, 6)), 6),
    ("full", 1, ((16, 16),), 6),  # accumulators in the partials (acc_global)
    ("diag", None, ((3, 9),), 10),  # transition slots past the registers
]


@pytest.mark.parametrize("cov,band,mixes_dims,S", _EM_TILE_CASES)
def test_backward_stats_matches_plain_on_tile_edges(cuda_device, cov, band, mixes_dims, S):
    """Lengths whose last frame opens or closes a tile (a tile whose only
    non-zero gamma column is its first frame), 0 and 1, T = 95 off the
    16-frame tile; the E-step statistics within 1e-4 of scale, two runs
    bitwise equal."""
    lens = em_tile_lengths(np.random.default_rng(31), 95, fe.BACKWARD_TILES[0])
    feats, packed, origins, trans, lengths = _em_inputs(cuda_device, cov, band, mixes_dims, lens, S=S)
    lb, la = fe.emit_forward_plain(feats, packed, origins, trans, lengths, band)
    log_z = la[-1, -1]
    valid = torch.isfinite(log_z) & (log_z > NEG_INF / 2) & (lengths > 0)
    rest = (feats, lb, la, packed, origins, trans, lengths, torch.where(valid, log_z, 0.0), valid.float(), band)
    got, again = fe.backward_stats(*rest), fe.backward_stats(*rest)
    want = fe.backward_stats_plain(*rest)
    torch.cuda.synchronize()
    for a, b, c in zip(_stat_parts(got, mixes_dims), _stat_parts(want, mixes_dims), _stat_parts(again, mixes_dims)):
        assert a.shape == b.shape
        _stat_close(a, b)
        assert torch.equal(a, c)
    acc_global = fe.occupancy(1, feats, packed, origins, trans, lengths, band)["acc_in_shared_memory"] is False
    assert acc_global == (mixes_dims == ((16, 16),))


@pytest.mark.parametrize("i", range(len(EMIT_CHECK_CASES)))
def test_emit_forward_matches_plain_at_every_launch_shape(cuda_device, i):
    """emit_forward alone at the launch shapes of EMIT_CHECK_CASES (band 0,
    8 slots, a band past the unrolled slots, dense and banded utterances
    across warps, the constants in device memory, a ragged last block, T
    shorter than a tile): log_b and log-alpha within 1e-5, one launch, two
    launches bitwise equal."""
    cov, band, mixes_dims, S, B, T = EMIT_CHECK_CASES[i]
    lens = emit_check_lengths(i, B, T)
    args = _em_inputs(cuda_device, cov, band, mixes_dims, lens, S=S)
    before = fe.emit_forward.launches
    lb_k, la_k = fe.emit_forward(*args, band)
    lb_k2, la_k2 = fe.emit_forward(*args, band)
    lb_p, la_p = fe.emit_forward_plain(*args, band)
    torch.cuda.synchronize()
    assert fe.emit_forward.launches == before + 2
    _lattice_close(lb_k, lb_p)
    _lattice_close(la_k, la_p)
    assert torch.equal(lb_k, lb_k2) and torch.equal(la_k, la_k2)


def test_backward_stats_matches_plain_on_few_frames(cuda_device):
    """Two utterances of 2 and 3 frames through S=2 states of M=2 mixtures
    sharing one Gaussian: each moment holds one or two terms with the
    mixture weights as posteriors, so the contraction's 3xTF32 rounding is
    not averaged away (dropping a term of the split shows here)."""
    feats, packed, origins, trans, lengths = _em_inputs(cuda_device, "diag", 1, ((2, 9),), [2, 3], S=2,
                                                        shared_gaussians=True)
    lb, la = fe.emit_forward_plain(feats, packed, origins, trans, lengths, 1)
    log_z = la[-1, -1]
    valid = torch.isfinite(log_z) & (log_z > NEG_INF / 2) & (lengths > 0)
    assert bool(valid.all())
    rest = (feats, lb, la, packed, origins, trans, lengths, torch.where(valid, log_z, 0.0), valid.float(), 1)
    got, want = fe.backward_stats(*rest), fe.backward_stats_plain(*rest)
    torch.cuda.synchronize()
    for a, b in zip(_stat_parts(got, ((2, 9),)), _stat_parts(want, ((2, 9),))):
        _stat_close(a, b)


# ---------------------------------------------------------------------------
# the MFCC frontend (csrc/mfcc.cu) and the pipeline's clustering statistics
# ---------------------------------------------------------------------------

import dataclasses  # noqa: E402

from srhmm_tpu_torch.features.frontend import FrontendConfig  # noqa: E402
from srhmm_tpu_torch.ops.kernels import mfcc as km  # noqa: E402

_MFCC_CONFIGS = {
    "default": FrontendConfig(),
    "mels40": FrontendConfig(n_mels=40, n_mfcc=20),
    "hann": FrontendConfig(window="hann"),
    "w512_s128": FrontendConfig(frame_length=512, frame_shift=128),
    "energy": FrontendConfig(include_energy=True),
    "w1024_mels128": FrontendConfig(frame_length=1024, frame_shift=256, n_mels=128, n_mfcc=40),
    # W = 19 x 29: two generic odd-prime FFT stages; another sample rate
    "w551_22k": FrontendConfig(sample_rate=22_050, frame_length=551, frame_shift=220),
    "w397_prime": FrontendConfig(frame_length=397),  # one generic stage
    "w480_radix3": FrontendConfig(frame_length=480),  # 240 = 8 x 2 x 5 x 3
    "w405_energy": FrontendConfig(frame_length=405, include_energy=True),  # odd: no split step
}


def _mfcc_waves(seed=3):
    """Waveforms of different lengths: 29 frames (no tile multiple), one
    clamped 300-sample frame, a silent one, 2 s of speech-band noise."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=5000), rng.normal(size=300), np.zeros(4000), rng.normal(size=32000) * 0.1]


@pytest.mark.parametrize("name", sorted(_MFCC_CONFIGS))
def test_mfcc_kernel_matches_plain(cuda_device, name):
    """max |kernel - twin| <= 1e-3 on the MFCC (the JAX package's
    compiled-vs-interpret gate for this kernel, bench.py:547-549); two
    launches bitwise equal; one launch for the whole batch."""
    cfg = _MFCC_CONFIGS[name]
    samples, offsets = km.pack_waves(_mfcc_waves(), cuda_device)
    before = km.mfcc_fused.launches
    got = km.mfcc_fused(samples, offsets, cfg)
    again = km.mfcc_fused(samples, offsets, cfg)
    want = km.mfcc_plain(samples, offsets, cfg)
    torch.cuda.synchronize()
    assert km.mfcc_fused.launches == before + 2
    assert got.shape == want.shape == (int(km.frame_offsets(offsets, cfg)[-1]), cfg.n_mfcc)
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert float((got - want).abs().max()) <= 1e-3


def test_mfcc_kernel_refuses_what_it_does_not_take(cuda_device):
    samples, offsets = km.pack_waves(_mfcc_waves(), cuda_device)
    with pytest.raises(ValueError, match="float32"):
        km.mfcc_fused(samples.double(), offsets, FrontendConfig())
    with pytest.raises(ValueError):
        km.mfcc_fused(samples, offsets, dataclasses.replace(FrontendConfig(), frame_length=2048))


def test_pipeline_mfcc_features_take_the_kernel(cuda_device, monkeypatch):
    from srhmm_tpu_torch.pipeline import mfcc_features

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA batch reached the plain twin")

    waves = [w.astype(np.float32) for w in _mfcc_waves()]
    want = mfcc_features(waves, FrontendConfig(), device="cpu")
    monkeypatch.setattr(km, "mfcc_plain", refuse)
    before = km.mfcc_fused.launches
    got = mfcc_features(waves, FrontendConfig(), device=cuda_device)
    assert km.mfcc_fused.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-3


def test_bucketed_stats_take_the_composed_kernels(cuda_device):
    """_bucketed_embedded_stats runs batch_stats_fused on eligible CUDA
    buckets; it agrees with the plain batch_stats within 5e-4 of each
    statistic's scale."""
    from srhmm_tpu_torch.pipeline import _bucketed_embedded_stats

    models = _composed_units("diag", 3, ((2, 9),)).to(cuda_device)
    rng = np.random.default_rng(4)
    utts = [rng.normal(size=(int(n), 9)) * 3 for n in rng.integers(20, 90, size=12)]
    trs = [rng.integers(0, 5, size=int(L)).tolist() for L in rng.integers(1, 4, size=12)]
    counts = kc.launch_counts()
    got = _bucketed_embedded_stats(models, utts, trs)
    after = kc.launch_counts()
    assert all(after[k] > counts[k] for k in ("bank_emission", "composed_forward", "composed_backward_stats"))
    want = _bucketed_embedded_stats(models, utts, trs, fused=False)
    torch.cuda.synchronize()
    for a, b in ((got.num_trans, want.num_trans), (got.den_trans, want.den_trans),
                 (got.den_mix, want.den_mix), (got.streams[0].w, want.streams[0].w),
                 (got.streams[0].x, want.streams[0].x), (got.streams[0].xx, want.streams[0].xx)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=5e-4,
                                   atol=5e-4 * float(b.abs().max()))
    np.testing.assert_allclose(float(got.log_prob), float(want.log_prob), rtol=1e-5)


# ---------------------------------------------------------------------------
# csrc/lattice.cu (TPU kernels #15-#20) and csrc/emission_em.cu (#21, #22)
# ---------------------------------------------------------------------------


def _lattice_inputs(device, S, kind, lens=_LENS, seed=12):
    """(T, S, B) log b with a few -inf entries (the spread case's second
    half of states lower), (S, S) log transitions, int32 lengths, on
    `device`."""
    from torch_port_utils import log_trans_np, spread_log_b

    rng = np.random.default_rng(seed)
    T, B = max(lens), len(lens)
    lb = spread_log_b((rng.normal(size=(T, S, B)) * 2).astype(np.float32), kind, axis=1)
    lb[rng.integers(0, T, 7), rng.integers(0, S, 7), rng.integers(0, B, 7)] = -np.inf
    lb[5:, 0, lens.index(T)] = -np.inf  # a state impossible from frame 5: carries on the floor
    lt = log_trans_np(S, kind, seed)
    as_t = lambda x: torch.as_tensor(x, device=device)
    return as_t(lb), as_t(lt), torch.as_tensor(lens, dtype=torch.int32, device=device)


@pytest.mark.parametrize("kind", ["delta1", "delta2", "dense"])
@pytest.mark.parametrize("S", [3, 6, 8, 16, 64])
def test_lattice_kernels_match_plain(cuda_device, S, kind):
    """forward / backward lattices (and their blocked wrappers, k_block 5
    and 19 of T = 95) against the twins: 1e-5 with equal masks, the entries
    on the -1e30 floor bitwise equal; the blocked wrappers bitwise equal to the unblocked;
    each wrapper counts its own launches."""
    from srhmm_tpu_torch.ops.kernels import lattice as kl

    lb, lt, lens = _lattice_inputs(cuda_device, S, kind)
    fns = (kl.forward_lattice, kl.backward_lattice, kl.forward_lattice_blocked, kl.backward_lattice_blocked)
    before = [f.launches for f in fns]
    fwd, bwd = kl.forward_lattice(lb, lt, lens), kl.backward_lattice(lb, lt, lens)
    fwd_b = kl.forward_lattice_blocked(lb, lt, lens, k_block=5)
    bwd_b = kl.backward_lattice_blocked(lb, lt, lens, k_block=19)
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [n + 1 for n in before]
    for got, want in ((fwd, kl.forward_lattice_plain(lb, lt, lens)), (bwd, kl.backward_lattice_plain(lb, lt, lens))):
        _lattice_close(got, want)
        # the -1e30 floor, outside the mask above: equal bit for bit
        below = want <= NEG_INF / 2
        assert torch.equal(got[below], want[below])
    assert torch.equal(fwd, fwd_b) and torch.equal(bwd, bwd_b)


@pytest.mark.parametrize("S", [3, 8, 64])
def test_forward_batch_and_viterbi_match_plain(cuda_device, S):
    """log_forward_batch (shared and per-row transitions) and viterbi_batch
    on (B, T, S) log b against the twins: scores 1e-5 with equal masks,
    backpointers equal."""
    from srhmm_tpu_torch.ops.kernels import forward as kf
    from torch_port_utils import log_trans_np

    lb_tsb, lt, lens = _lattice_inputs(cuda_device, S, "delta1", seed=13)
    lb = lb_tsb.permute(2, 0, 1).contiguous()
    B = lb.shape[0]
    per_row = torch.as_tensor(
        np.stack([log_trans_np(S, ("delta1", "delta2", "dense")[b % 3], b) for b in range(B)]), device=cuda_device)
    counts = kf.log_forward_batch.launches, kf.viterbi_batch.launches
    for trans in (lt, per_row):
        _lattice_close(kf.log_forward_batch(lb, trans, lens), kf.log_forward_batch_plain(lb, trans, lens))
    scores, bptr = kf.viterbi_batch(lb, lt, lens)
    scores_p, bptr_p = kf.viterbi_batch_plain(lb, lt, lens)
    torch.cuda.synchronize()
    assert (kf.log_forward_batch.launches, kf.viterbi_batch.launches) == (counts[0] + 2, counts[1] + 1)
    _lattice_close(scores, scores_p)
    assert torch.equal(bptr, bptr_p)
    assert torch.equal(kf.backtrace(bptr, lens, S - 1), kf.backtrace(bptr_p, lens, S - 1))


def test_viterbi_kernel_ties_go_to_the_lowest_source(cuda_device):
    from srhmm_tpu_torch.ops.kernels import forward as kf

    S = 6
    rng = np.random.default_rng(14)
    p = rng.uniform(0.1, 1.0, size=(S, S))
    p[3, :] = p[2, :]
    p[:, 3] = p[:, 2]
    lt = torch.as_tensor(np.log(p / p.sum(-1, keepdims=True)), dtype=torch.float32, device=cuda_device)
    lb = torch.as_tensor(rng.normal(size=(len(_LENS), 95, S)), dtype=torch.float32, device=cuda_device)
    lb[..., 3] = lb[..., 2]
    lens = torch.as_tensor(_LENS, dtype=torch.int32, device=cuda_device)
    _, bptr = kf.viterbi_batch(lb, lt, lens)
    _, bptr_p = kf.viterbi_batch_plain(lb, lt, lens)
    assert torch.equal(bptr, bptr_p)
    live = torch.arange(95, device=cuda_device)[None, :] < lens[:, None].long()
    live[:, 0] = False  # row 0 and rows past a length are the identity
    assert not bool((bptr[live] == 3).any())


@pytest.mark.parametrize("D,M", [(3, 1), (9, 3), (13, 16), (39, 1), (39, 3)])
def test_emission_kernels_match_plain(cuda_device, D, M):
    """emission_log_b (1e-5 relative) and emission_stats (1e-4 of each
    moment block's scale; two launches bitwise equal) against the twins on
    N off every tile, a zero-weight mixture and -inf log b rows.  Each
    moments call reads the log b of its own emission: exp(min(q - log b,
    0)) cancels two values of size |q|, so another summation order's log b
    biases the posteriors by ulps of |q| (~1.6e-4 of the scale at D=39,
    M=1)."""
    from srhmm_tpu_torch.ops.kernels import emission as ke

    S, N = 8, 4133
    trans, streams = rand_word(15, S, [(M, D)], "diag", scale=3.0)
    streams[0]["weights"][2, 0] = 0.0
    stream = tm.gmm_hmm_from_numpy(trans, streams).astype(torch.float32).to(cuda_device).streams[0]
    rng = np.random.default_rng(16)
    frames = torch.as_tensor(rng.normal(size=(N, D)) * 3, dtype=torch.float32, device=cuda_device)
    gamma = torch.as_tensor(rng.uniform(size=(N, S)), dtype=torch.float32, device=cuda_device)
    a, b = ke.pack_constants(stream, torch.float32)
    counts = ke.emission_log_b.launches, ke.emission_stats.launches
    lb, lb_p = ke.emission_log_b(frames, a, b), ke.emission_log_b_plain(frames, a, b)
    _lattice_close(lb, lb_p)
    lb, lb_p = lb.clone(), lb_p.clone()
    lb[100:140] = lb_p[100:140] = -torch.inf
    got, again = ke.emission_stats(frames, gamma, lb, a, b), ke.emission_stats(frames, gamma, lb, a, b)
    want = ke.emission_stats_plain(frames, gamma, lb_p, a, b)
    torch.cuda.synchronize()
    assert (ke.emission_log_b.launches, ke.emission_stats.launches) == (counts[0] + 1, counts[1] + 2)
    assert torch.equal(got, again)
    for part in (slice(0, D), slice(D, 2 * D), slice(2 * D, 2 * D + 1)):
        _stat_close(got[..., part], want[..., part])


def test_new_kernels_refuse_what_they_do_not_take(cuda_device):
    from srhmm_tpu_torch.ops.kernels import emission as ke
    from srhmm_tpu_torch.ops.kernels import forward as kf
    from srhmm_tpu_torch.ops.kernels import lattice as kl

    lb, lt, lens = _lattice_inputs(cuda_device, 4, "delta1")
    with pytest.raises(ValueError, match="float32"):
        kl.forward_lattice(lb.double(), lt, lens)
    # past the block-wide mode's bound (64 states before it)
    wide, wide_t, _ = _lattice_inputs(cuda_device, kl.MAX_STATES + 1, "delta1")
    with pytest.raises(ValueError, match="4096 states"):
        kl.backward_lattice(wide, wide_t, lens)
    with pytest.raises(ValueError, match="float32"):
        kf.viterbi_batch(lb.permute(2, 0, 1).double(), lt, lens)
    frames = torch.zeros((10, 70), device=cuda_device)
    with pytest.raises(ValueError, match="exceeds"):
        ke.emission_log_b(frames, torch.zeros((1, 140, 2), device=cuda_device), torch.zeros((1, 1, 2), device=cuda_device))


def test_lane_e_steps_take_the_kernels(cuda_device, monkeypatch):
    """e_step_fused (#21, #22) and e_step_lane_major(lattices="pallas")
    (#20, #19) launch their kernels on a CUDA batch, never a twin, and agree
    with the plain e_step within 1e-4 of each statistic's scale."""
    from srhmm_tpu_torch.ops.kernels import emission as ke
    from srhmm_tpu_torch.ops.kernels import lattice as kl

    model, batch = _train_batch(cuda_device, seed=17)
    want = em.e_step(model, batch)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA batch reached a plain twin")

    for mod, name in ((ke, "emission_log_b_plain"), (ke, "emission_stats_plain"),
                      (kl, "forward_lattice_plain"), (kl, "backward_lattice_plain")):
        monkeypatch.setattr(mod, name, refuse)
    counts = [f.launches for f in (ke.emission_log_b, ke.emission_stats, kl.forward_lattice_blocked,
                                   kl.backward_lattice_blocked)]
    for got in (em.e_step_fused(model, batch), em.e_step_lane_major(model, batch, lattices="pallas")):
        for a, b in ((got.num_trans, want.num_trans), (got.den_trans, want.den_trans), (got.den_mix, want.den_mix),
                     (got.streams[0].w, want.streams[0].w), (got.streams[0].x, want.streams[0].x),
                     (got.streams[0].xx, want.streams[0].xx)):
            _stat_close(a, b)
        np.testing.assert_allclose(float(got.log_prob), float(want.log_prob), rtol=1e-5)
    assert [f.launches for f in (ke.emission_log_b, ke.emission_stats, kl.forward_lattice_blocked,
                                 kl.backward_lattice_blocked)] == [n + 1 for n in counts]


# ---------------------------------------------------------------------------
# the vocabulary-scoring kernel's launch shapes and routing
# (csrc/vocab_scores.cu), the emission log-b kernel (csrc/emission_em.cu)
# and the isolated-word EM routing
# ---------------------------------------------------------------------------

from torch_port_utils import EMISSION_EXTRA_CASES, VOCAB_CHECK_CASES, vocab_check_case  # noqa: E402


@pytest.mark.parametrize("i", range(len(VOCAB_CHECK_CASES)))
def test_vocab_scores_matches_plain_at_every_launch_shape(cuda_device, i):
    """vocab_scores' final log-alpha at each of VOCAB_CHECK_CASES (2 / 4 / 8
    slots and the generic loop, two and six streams, pairs across two and
    eight warps, constants in device memory, ragged word and utterance
    blocks, T below a tile; rows of length 0 and 1) against the twin, both
    semirings; two launches bitwise equal."""
    args, kw = scoring.pack_batch(*vocab_check_case(i, cuda_device))
    for semiring in ("sum", "max"):
        launches = scoring.vocab_scores.launches
        got = scoring.vocab_scores(*args, **kw, semiring=semiring)
        again = scoring.vocab_scores(*args, **kw, semiring=semiring)
        want = scoring.vocab_scores_plain(*args, **kw, semiring=semiring)
        torch.cuda.synchronize()
        assert scoring.vocab_scores.launches == launches + 2
        _lattice_close(got, want)
        assert torch.equal(got, again)


def test_score_batch_scores_full_d39_through_the_kernel(cuda_device):
    """A full-covariance D=39, S=6, M=4 vocabulary: its constants (246 KB a
    word) exceed a block's shared memory, which the scoring kernel before
    its redesign refused inside score_batch; the emission pass
    (csrc/wide_log_b.cu) and the recursion's wide instance take it, and
    score_batch (auto) matches score_batch_log."""
    from srhmm_tpu_torch.decode.scorer import score_batch, score_batch_log

    vocab = _vocab("full", 3, 6, ((4, 39),)).to(cuda_device)
    batch = _batch(cuda_device, [39], [0, 1, 40, 77, 120, 3, 95])
    for mode in ("total", "final"):
        launches = scoring.vocab_scores.launches
        got = score_batch(vocab, batch, mode=mode).cpu().numpy()
        assert scoring.vocab_scores.launches == launches + 1
        want = score_batch_log(vocab, batch, mode=mode).cpu().numpy()
        fin = np.isfinite(want)
        assert (np.isfinite(got) == fin).all()
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4, atol=1e-5 * np.abs(want[fin]).max())
        assert (got.argmax(1) == want.argmax(1)).all()


def test_score_batch_routes_refused_shapes_to_the_plain_path(cuda_device):
    """Vocabularies the kernel refuses (feature dims past 64, more than 256
    states) go to score_batch_log on the card without a launch."""
    from srhmm_tpu_torch.decode.scorer import score_batch, score_batch_log

    for vocab, dims in ((_vocab("diag", 2, 4, ((1, 65),)), [65]), (_vocab("diag", 1, 257, ((1, 3),)), [3])):
        vocab = vocab.to(cuda_device)
        batch = _batch(cuda_device, dims, [0, 1, 30])
        launches = scoring.vocab_scores.launches
        got = score_batch(vocab, batch)
        assert scoring.vocab_scores.launches == launches
        assert torch.equal(got, score_batch_log(vocab, batch))


_EMISSION_LOG_B_CASES = [(4133, 8, M, D) for D in (1, 9, 39, 64) for M in (1, 3, 16)] + EMISSION_EXTRA_CASES


@pytest.mark.parametrize("N,S,M,D", _EMISSION_LOG_B_CASES)
def test_emission_log_b_matches_plain(cuda_device, N, S, M, D):
    """emission_log_b against its twin at a ragged N (off every tile), D = 1
    / 9 / 39 / 64 x M = 1 / 3 / 16, and at EMISSION_EXTRA_CASES (blocks
    walking several tiles, records past shared memory, fewer threads a
    block): within 1e-5 relative, equal masks, two launches bitwise equal,
    and a frame view off 16-byte alignment taken too."""
    from srhmm_tpu_torch.ops.kernels import emission as ke

    trans, streams = rand_word(100 * D + M + S, S, [(M, D)], "diag", scale=3.0)
    stream = tm.gmm_hmm_from_numpy(trans, streams).astype(torch.float32).to(cuda_device).streams[0]
    rng = np.random.default_rng(17)
    frames = torch.as_tensor(rng.normal(size=(N + 1, D)) * 3, dtype=torch.float32, device=cuda_device)
    a, b = ke.pack_constants(stream, torch.float32)
    launches = ke.emission_log_b.launches
    got, again = ke.emission_log_b(frames[:N], a, b), ke.emission_log_b(frames[:N], a, b)
    _lattice_close(got, ke.emission_log_b_plain(frames[:N], a, b))
    assert torch.equal(got, again)
    shifted = frames.reshape(-1)[1 : 1 + N * D].reshape(N, D)  # a view 4 bytes off
    _lattice_close(ke.emission_log_b(shifted, a, b), ke.emission_log_b_plain(shifted, a, b))
    torch.cuda.synchronize()
    assert ke.emission_log_b.launches == launches + 3


def test_train_fast_full_d39_takes_the_plain_route(cuda_device):
    """A model past the fused E-step kernels' bound takes the plain route:
    full covariance at D = 65 (the bound was 16 when this test held D = 39,
    which the kernels now take: test_train_fast_full_d39_takes_the_kernels).
    em_step (auto), train_fast and em_train_scan take the plain e_step on
    the card instead of raising, and train_fast equals the chunked driver
    over em_train_scan(fused=False)."""
    from srhmm_tpu_torch.train.driver import chunked_convergence_train

    rng = np.random.default_rng(21)
    utts = [rng.normal(size=(int(rng.integers(80, 120)), 65)) + np.arange(65) * 0.1 for _ in range(64)]
    batch = pack_utterances(utts, pad_multiple=1, dtype=torch.float32, device=cuda_device)
    trans, streams = rand_word(21, 3, [(1, 65)], "full")
    model = tm.gmm_hmm_from_numpy(trans, streams).astype(torch.float32).to(cuda_device)
    assert not em._fused_lane_eligible(model, batch)
    counts = fe.emit_forward.launches, fe.backward_stats.launches
    m_auto, lp_auto, _ = em.em_step(model, batch)
    m_plain, lp_plain, _ = em.em_step(model, batch, fused=False)
    assert torch.equal(lp_auto, lp_plain)
    res = em.train_fast(model, batch, max_iterations=3, chunk=2)
    want = chunked_convergence_train(
        model, lambda m, k: em.em_train_scan(m, batch, k, fused=False), threshold=1.0e-3, max_iterations=3, chunk=2)
    torch.cuda.synchronize()
    assert (fe.emit_forward.launches, fe.backward_stats.launches) == counts
    assert np.isfinite(res.log_prob_history).all()
    assert res.iterations == want[1] and res.log_prob_history == want[2]
    for x, y in zip(res.model.buffers(), want[0].buffers()):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the redesigned lattice kernels (csrc/lattice.cu: forward, backward,
# Viterbi) and moments kernel (csrc/emission_em.cu) at their launch shapes
# ---------------------------------------------------------------------------

from torch_port_utils import FORWARD_CHECK_CASES, STATS_CHECK_CASES, forward_check_lengths, log_trans_np  # noqa: E402


@pytest.mark.parametrize("i", range(len(FORWARD_CHECK_CASES)))
def test_forward_kernel_matches_plain_at_every_launch_shape(cuda_device, i):
    """The forward kernel at FORWARD_CHECK_CASES (one state, T below a tile
    with a ragged last block and 4-byte copies, idle lanes, two states a
    lane, ten tiles, 16 slots): the (T, S, B) lattice and the (B, T, S) last
    row with shared and per-row transitions against the twins, the -1e30
    floor bitwise; two launches bitwise equal; the blocked wrapper bitwise
    the unblocked."""
    from srhmm_tpu_torch.ops.kernels import forward as kf
    from srhmm_tpu_torch.ops.kernels import lattice as kl

    S, kind, B, T = FORWARD_CHECK_CASES[i]
    rng = np.random.default_rng(300 + i)
    lb = torch.as_tensor((rng.normal(size=(T, S, B)) * 2).astype(np.float32), device=cuda_device)
    lt = torch.as_tensor(log_trans_np(S, kind, i), device=cuda_device)
    rows = torch.as_tensor(np.stack([log_trans_np(S, ("delta1", "delta2", "dense")[b % 3], b) for b in range(B)]),
                           device=cuda_device)
    lens = torch.as_tensor(forward_check_lengths(i, B, T), dtype=torch.int32, device=cuda_device)
    la, again = kl.forward_lattice(lb, lt, lens), kl.forward_lattice(lb, lt, lens)
    want = kl.forward_lattice_plain(lb, lt, lens)
    _lattice_close(la, want)
    below = want <= NEG_INF / 2
    assert torch.equal(la[below], want[below]) and torch.equal(la, again)
    assert torch.equal(kl.forward_lattice_blocked(lb, lt, lens, k_block=1), la)
    lb_bts = lb.permute(2, 0, 1).contiguous()
    for trans in (lt, rows):
        got, again = kf.log_forward_batch(lb_bts, trans, lens), kf.log_forward_batch(lb_bts, trans, lens)
        _lattice_close(got, kf.log_forward_batch_plain(lb_bts, trans, lens))
        assert torch.equal(got, again)
    # the last row is the lattice's last row where the transitions are shared
    assert torch.equal(kf.log_forward_batch(lb_bts, lt, lens), la[-1].T)


@pytest.mark.parametrize("i", range(len(FORWARD_CHECK_CASES)))
def test_backward_and_viterbi_kernels_match_plain_at_every_launch_shape(cuda_device, i):
    """The backward and Viterbi kernels at FORWARD_CHECK_CASES (one state,
    T below a tile with a ragged last block and 4-byte copies, idle lanes,
    two states a lane walking ten tiles, 16 slots, one frame): the (T, S, B)
    log-beta lattice and the Viterbi scores against the twins, the -1e30
    floor bitwise; the backpointers equal to the twin's; two launches
    bitwise equal; the blocked wrapper bitwise the unblocked."""
    from srhmm_tpu_torch.ops.kernels import forward as kf
    from srhmm_tpu_torch.ops.kernels import lattice as kl

    S, kind, B, T = FORWARD_CHECK_CASES[i]
    rng = np.random.default_rng(500 + i)
    lb_np = (rng.normal(size=(T, S, B)) * 2).astype(np.float32)
    lb_np[rng.integers(0, T, 7), rng.integers(0, S, 7), rng.integers(0, B, 7)] = -np.inf
    lb = torch.as_tensor(lb_np, device=cuda_device)
    lt = torch.as_tensor(log_trans_np(S, kind, i), device=cuda_device)
    lens = torch.as_tensor(forward_check_lengths(i, B, T), dtype=torch.int32, device=cuda_device)
    counts = kl.backward_lattice.launches, kf.viterbi_batch.launches
    bwd, again = kl.backward_lattice(lb, lt, lens), kl.backward_lattice(lb, lt, lens)
    want = kl.backward_lattice_plain(lb, lt, lens)
    _lattice_close(bwd, want)
    below = want <= NEG_INF / 2
    assert torch.equal(bwd[below], want[below]) and torch.equal(bwd, again)
    assert torch.equal(kl.backward_lattice_blocked(lb, lt, lens, k_block=1), bwd)
    lb_bts = lb.permute(2, 0, 1).contiguous()
    (scores, bptr), (scores2, bptr2) = kf.viterbi_batch(lb_bts, lt, lens), kf.viterbi_batch(lb_bts, lt, lens)
    scores_p, bptr_p = kf.viterbi_batch_plain(lb_bts, lt, lens)
    torch.cuda.synchronize()
    assert (kl.backward_lattice.launches, kf.viterbi_batch.launches) == (counts[0] + 2, counts[1] + 2)
    _lattice_close(scores, scores_p)
    below = scores_p <= NEG_INF / 2
    assert torch.equal(scores[below], scores_p[below])
    assert torch.equal(bptr, bptr_p) and torch.equal(scores, scores2) and torch.equal(bptr, bptr2)


@pytest.mark.parametrize("N,S,M,D", STATS_CHECK_CASES)
def test_emission_stats_matches_plain_at_every_launch_shape(cuda_device, N, S, M, D):
    """emission_stats at STATS_CHECK_CASES (states split into groups with
    the records in device memory, 64-frame tiles, blocks walking several
    tiles, one tile of five frames) against the twin, each side reading the
    log b of its own emission, within 1e-4 of each moment block's scale;
    two launches bitwise equal."""
    from srhmm_tpu_torch.ops.kernels import emission as ke

    trans, streams = rand_word(40 + S, S, [(M, D)], "diag", scale=3.0)
    stream = tm.gmm_hmm_from_numpy(trans, streams).astype(torch.float32).to(cuda_device).streams[0]
    rng = np.random.default_rng(41)
    frames = torch.as_tensor(rng.normal(size=(N, D)) * 3, dtype=torch.float32, device=cuda_device)
    gamma = torch.as_tensor(rng.uniform(size=(N, S)), dtype=torch.float32, device=cuda_device)
    a, b = ke.pack_constants(stream, torch.float32)
    lb, lb_p = ke.emission_log_b(frames, a, b), ke.emission_log_b_plain(frames, a, b)
    lb[:3], lb_p[:3] = -torch.inf, -torch.inf
    got, again = ke.emission_stats(frames, gamma, lb, a, b), ke.emission_stats(frames, gamma, lb, a, b)
    want = ke.emission_stats_plain(frames, gamma, lb_p, a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    for part in (slice(0, D), slice(D, 2 * D), slice(2 * D, 2 * D + 1)):
        _stat_close(got[..., part], want[..., part])


def test_emission_stats_single_frame_posteriors(cuda_device):
    """emission_stats where each state's posterior sits on one frame (S =
    64, M = 1, so each weight is the posterior, and 1 <= |x| <= 2): every
    moment is one product, which a single TF32 pass would round by up to
    2^-11 of it; the kernel stays within 1e-4 of each moment block's
    scale."""
    from srhmm_tpu_torch.ops.kernels import emission as ke

    N, S, D = 4133, 64, 9
    trans, streams = rand_word(77, S, [(1, D)], "diag", scale=3.0)
    stream = tm.gmm_hmm_from_numpy(trans, streams).astype(torch.float32).to(cuda_device).streams[0]
    rng = np.random.default_rng(43)
    x = rng.uniform(1.0, 2.0, size=(N, D)) * rng.choice([-1.0, 1.0], size=(N, D))
    g = np.zeros((N, S))
    g[7 + 61 * np.arange(S), np.arange(S)] = rng.uniform(0.75, 1.0, size=S)
    frames = torch.as_tensor(x, dtype=torch.float32, device=cuda_device)
    gamma = torch.as_tensor(g, dtype=torch.float32, device=cuda_device)
    a, b = ke.pack_constants(stream, torch.float32)
    got = ke.emission_stats(frames, gamma, ke.emission_log_b(frames, a, b), a, b)
    want = ke.emission_stats_plain(frames, gamma, ke.emission_log_b_plain(frames, a, b), a, b)
    for part in (slice(0, D), slice(D, 2 * D), slice(2 * D, 2 * D + 1)):
        _stat_close(got[..., part], want[..., part])


# ---------------------------------------------------------------------------
# the production surface on the card: the prefetch loader's copies, resumed
# training, the profiling timer
# ---------------------------------------------------------------------------


def _em_diag_like(device, B, T, seed=31):
    rng = np.random.default_rng(seed)
    trans, streams = rand_word(seed, 8, [(3, 9)], "diag", scale=3.0)
    model = tm.gmm_hmm_from_numpy(trans, streams).astype(torch.float32).to(device)
    host = pack_utterances([rng.normal(size=(int(rng.integers(T // 2, T + 1)), 9)) * 3.0 for _ in range(B)],
                           pad_multiple=1, dtype=torch.float32)
    return model, host


def test_streamed_shards_are_waited_on(cuda_device):
    """device_put_loader copies each shard from pinned memory on its own
    stream while the E-step of the previous shard runs: every shard's fused
    E-step statistics equal, bitwise, those of the same shard copied
    synchronously (a consumer that did not wait for a copy would read a
    shard still in flight)."""
    from srhmm_tpu_torch.io.pipeline import device_put_loader
    from srhmm_tpu_torch.ops.kernels.common import trans_band
    from srhmm_tpu_torch.train.streaming import shard_batch

    model, host = _em_diag_like(cuda_device, B=2048, T=400)
    band = trans_band(model.trans.cpu().numpy())
    shards = shard_batch(host, 4)
    launches = fe.emit_forward.launches
    streamed = [em._e_step_any(model, b, True, None, band) for b in device_put_loader(shards, device=cuda_device)]
    torch.cuda.synchronize()
    assert fe.emit_forward.launches == launches + len(shards)
    for shard, got in zip(shards, streamed):
        want = em._e_step_any(model, shard.to(cuda_device), True, None, band)
        for name in ("num_trans", "den_trans", "den_mix", "log_prob", "num_valid"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        for name in ("w", "x", "xx"):
            assert torch.equal(getattr(got.streams[0], name), getattr(want.streams[0], name)), name


def test_resumed_training_is_bitwise_the_uninterrupted_run(cuda_device, tmp_path):
    from srhmm_tpu_torch.train.checkpoint import train_fast_resumable

    model, host = _em_diag_like(cuda_device, B=256, T=200)
    batch = host.to(cuda_device)
    launches = fe.emit_forward.launches, fe.backward_stats.launches
    whole = train_fast_resumable(model, batch, tmp_path / "a", max_iterations=6)
    train_fast_resumable(model, batch, tmp_path / "b", max_iterations=2)
    resumed = train_fast_resumable(model, batch, tmp_path / "b", max_iterations=6)
    assert fe.emit_forward.launches > launches[0] and fe.backward_stats.launches > launches[1]
    assert resumed.iterations == whole.iterations and resumed.log_prob_history == whole.log_prob_history
    for x, y in zip(resumed.model.buffers(), whole.model.buffers()):
        assert x.device.type == "cuda" and torch.equal(x, y)


def test_timed_waits_for_the_card(cuda_device):
    from srhmm_tpu_torch.utils import timed

    a = torch.randn(4096, 4096, device=cuda_device)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    out = {}
    with timed(out, sync=a):
        start.record()
        for _ in range(8):
            a = a @ a / 64.0
        end.record()
    assert end.query()  # the timer synchronized before it stopped the clock
    assert out["seconds"] * 1e3 >= 0.9 * start.elapsed_time(end)


# ---------------------------------------------------------------------------
# the shapes past the lane path: the lattice kernels past 64 states (the
# group mode of csrc/lattice.cu, the Viterbi its max-plus kind), full covariance past D = 16
# (csrc/fused_em.cu, csrc/composed.cu), and the shapes before them bitwise
# the parent's (tests/torch_lane_digests.py)
# ---------------------------------------------------------------------------

from torch_port_utils import (  # noqa: E402
    BANK_FULL_WIDE_CASES,
    EM_FULL_WIDE_CASES,
    WIDE_LATTICE_CASES,
    wide_lattice_lengths,
)


@pytest.mark.parametrize("i", range(len(WIDE_LATTICE_CASES)))
def test_wide_lattice_kernels_match_plain(cuda_device, i):
    """#15-#20 at every case of WIDE_LATTICE_CASES against their twins:
    lattices and scores within 1e-5 (equal masks), backpointers equal over
    the whole T, two launches bitwise equal, the blocked wrappers bitwise
    the unblocked."""
    from srhmm_tpu_torch.ops.kernels import forward as kf
    from srhmm_tpu_torch.ops.kernels import lattice as kl

    S, kind, B, T = WIDE_LATTICE_CASES[i]
    lens = wide_lattice_lengths(i, B, T)
    lb, lt, lengths = _lattice_inputs(cuda_device, S, kind, lens=lens, seed=40 + i)
    for fn, plain in ((kl.forward_lattice, kl.forward_lattice_plain), (kl.backward_lattice, kl.backward_lattice_plain)):
        got = fn(lb, lt, lengths)
        assert torch.equal(got, fn(lb, lt, lengths))
        _lattice_close(got, plain(lb, lt, lengths))
    assert torch.equal(kl.forward_lattice_blocked(lb, lt, lengths, k_block=1), kl.forward_lattice(lb, lt, lengths))
    assert torch.equal(kl.backward_lattice_blocked(lb, lt, lengths, k_block=1), kl.backward_lattice(lb, lt, lengths))
    lb_bts = lb.permute(2, 0, 1).contiguous()
    rows = lt.expand(B, S, S).contiguous()
    for trans in (lt, rows):
        got = kf.log_forward_batch(lb_bts, trans, lengths)
        assert torch.equal(got, kf.log_forward_batch(lb_bts, trans, lengths))
        _lattice_close(got, kf.log_forward_batch_plain(lb_bts, trans, lengths))
    sc, bp = kf.viterbi_batch(lb_bts, lt, lengths)
    sc_p, bp_p = kf.viterbi_batch_plain(lb_bts, lt, lengths)
    assert torch.equal(bp, bp_p) and torch.equal(bp, kf.viterbi_batch(lb_bts, lt, lengths)[1])
    _lattice_close(sc, sc_p)


def test_block_viterbi_ties_go_to_the_lowest_source(cuda_device):
    """S = 96 with states 40 and 41 duplicated: the candidates from them tie
    exactly, and the group mode's Viterbi (the packed route) keeps the
    lower, as the twin."""
    from srhmm_tpu_torch.ops.kernels import forward as kf

    S, T = 96, 60
    rng = np.random.default_rng(13)
    p = rng.uniform(0.1, 1.0, size=(S, S))
    p[41, :] = p[40, :]
    p[:, 41] = p[:, 40]
    lt = torch.as_tensor(np.log(p / p.sum(-1, keepdims=True)).astype(np.float32), device=cuda_device)
    lb = rng.normal(size=(len(_LENS), T, S)).astype(np.float32) * 2
    lb[..., 41] = lb[..., 40]
    lb = torch.as_tensor(lb, device=cuda_device)
    lengths = torch.as_tensor(np.minimum(_LENS, T), dtype=torch.int32, device=cuda_device)
    _, bp = kf.viterbi_batch(lb, lt, lengths)
    _, bp_p = kf.viterbi_batch_plain(lb, lt, lengths)
    assert torch.equal(bp, bp_p)
    live = torch.arange(T, device=cuda_device)[None, :] < lengths[:, None].long()
    live[:, 0] = False  # row 0 and rows past a length are the identity
    assert bool((bp[live] == 40).any()) and not bool((bp[live] == 41).any())


def test_group_viterbi_ties_across_shares_go_to_the_lowest_source(cuda_device):
    """S = 1024 dense (the streamed route, chip_smoke.TIE_STREAMED: 16-block
    clusters of 10 utterances, a ragged last group) with state 40
    duplicated in its chunk, its share, the next share and in lower shares
    of later tiles (chip_smoke.tie_duplicates), 6 higher in log b: every
    candidate from them ties exactly, and the kernel keeps state 40 as the
    twin does, the scores equal."""
    import chip_smoke as cs
    from srhmm_tpu_torch.ops.kernels import forward as kf

    lb, lt, _, lengths, _ = cs.wide_lattice_inputs(torch)["tie_streamed"]
    sc, bp = kf.viterbi_batch(lb, lt, lengths)
    sc_p, bp_p = kf.viterbi_batch_plain(lb, lt, lengths)
    assert torch.equal(bp, bp_p) and torch.equal(sc, sc_p)
    live = torch.arange(lb.shape[1], device=cuda_device)[None, :] < lengths[:, None].long()
    live[:, 0] = False
    dups = torch.as_tensor(cs.tie_duplicates(*cs.TIE_STREAMED[:2]), dtype=bp.dtype, device=cuda_device)
    assert bool((bp[live] == cs.TIE_BASE).any()) and not bool(torch.isin(bp[live], dups).any())


@pytest.mark.parametrize("band", [1, None])
@pytest.mark.parametrize("mixes_dims", EM_FULL_WIDE_CASES)
def test_em_kernels_match_plain_past_full_d16(cuda_device, band, mixes_dims):
    """emit_forward and backward_stats at full covariance past D = 16 (the
    z-GEMM emission and moments: the bounds 32, 40 and 64, two and six
    streams, banded and dense, M past one n tile, B = 37 off the blocks'
    utterances and T = 95 off the tiles, rows of length 0 and 1, columns of
    all-zero gamma) against their twins, two launches bitwise equal; the
    stored per-mixture q against the twin's, and the statistics from it
    bitwise those the moments recompute."""
    args = (*_em_inputs(cuda_device, "full", band, mixes_dims, _LENS), band)
    lb_k, la_k = fe.emit_forward(*args)
    lb_p, la_p = fe.emit_forward_plain(*args)
    _lattice_close(lb_k, lb_p)
    _lattice_close(la_k, la_p)
    assert all(torch.equal(a, b) for a, b in zip((lb_k, la_k), fe.emit_forward(*args)))
    feats, packed, origins, trans, lengths, _ = args
    # the stored per-mixture q: the lattices unchanged, q against the twin's
    T, S, B = lb_k.shape
    q, q_p = ([torch.empty((T, M * S, B), device=cuda_device) for M, _ in mixes_dims] for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip((lb_k, la_k), fe.emit_forward(*args, q_out=q)))
    fe.emit_forward_plain(*args, q_out=q_p)
    for a, b in zip(q, q_p):
        _lattice_close(a, b)
    log_z = la_p[-1, -1]
    valid = torch.isfinite(log_z) & (log_z > NEG_INF / 2) & (lengths > 0)
    rest = (feats, lb_p, la_p, packed, origins, trans, lengths, torch.where(valid, log_z, 0.0), valid.float(), band)
    got, again, want = fe.backward_stats(*rest), fe.backward_stats(*rest), fe.backward_stats_plain(*rest)
    stored = fe.backward_stats(*rest, q=q)
    torch.cuda.synchronize()
    for a, b, c, d in zip(_stat_parts(got, mixes_dims), _stat_parts(again, mixes_dims), _stat_parts(want, mixes_dims),
                          _stat_parts(stored, mixes_dims)):
        assert torch.equal(a, b) and torch.equal(a, d)
        _stat_close(a, c)


@pytest.mark.parametrize("mixes_dims", [((4, 39),), ((9, 20), (1, 17))])
def test_em_wide_kernels_at_many_columns_and_zero_gamma(cuda_device, mixes_dims):
    """The z-GEMM E-step past full D = 16 at B = 300 (three emission column
    blocks, the last ragged; several utterances a moments range), T = 40
    off the recursions' tiles, shared Gaussians (every posterior a weight,
    no mixture's q far below the others): log b, log-alpha and the
    statistics against the twins, two runs bitwise equal; then every
    utterance invalid (vmask 0: every gamma 0.0f, so the moments' scan
    keeps no column): the statistics exactly the twins' zeros."""
    rng = np.random.default_rng(29)
    lens = [int(n) for n in rng.integers(2, 40, size=297)] + [40, 0, 1]
    args = (*_em_inputs(cuda_device, "full", 1, mixes_dims, lens, shared_gaussians=True), 1)
    lb_k, la_k = fe.emit_forward(*args)
    lb_p, la_p = fe.emit_forward_plain(*args)
    _lattice_close(lb_k, lb_p)
    _lattice_close(la_k, la_p)
    feats, packed, origins, trans, lengths, _ = args
    log_z = la_p[-1, -1]
    valid = torch.isfinite(log_z) & (log_z > NEG_INF / 2) & (lengths > 0)
    for vmask in (valid.float(), torch.zeros_like(valid, dtype=torch.float32)):
        rest = (feats, lb_p, la_p, packed, origins, trans, lengths, torch.where(valid, log_z, 0.0), vmask, 1)
        got, again, want = fe.backward_stats(*rest), fe.backward_stats(*rest), fe.backward_stats_plain(*rest)
        torch.cuda.synchronize()
        for a, b, c in zip(_stat_parts(got, mixes_dims), _stat_parts(again, mixes_dims),
                           _stat_parts(want, mixes_dims)):
            assert torch.equal(a, b)
            if float(vmask.sum()) == 0.0:
                assert torch.equal(a, c) and not bool(c.any())
            else:
                _stat_close(a, c)


@pytest.mark.parametrize("mixes_dims", [tuple(md) for md in BANK_FULL_WIDE_CASES])
def test_bank_kernels_match_plain_past_full_d16(cuda_device, mixes_dims):
    """The bank kernels' z-GEMM blocks at full covariance past D = 16
    (every register bound 24-64, D = 17, 39, 64, T = 95 off the 128-frame
    tile, two streams of different M, a partial slice, one to three
    mixture groups, a padded n tile at M = 9): _check_bank_kernels (two
    runs and the two gamma layouts bitwise equal)."""
    _check_bank_kernels(cuda_device, "full", mixes_dims)


def test_wide_bank_kernels_poison_out_of_range_ids(cuda_device):
    """The z-GEMM blocks at full D = 39, M = 9, with utterances of up to
    300 frames (three frame tiles, the last partial): an id outside [0, NB)
    gives NaN log_b rows and a NaN moment row (the first or last bank row,
    where the stable sort puts it); every other row equals the twin's."""
    lens = [300, 0, 1, 129, 128, 257] + [int(n) for n in np.random.default_rng(17).integers(2, 300, size=7)]
    _, _, ids, banks, feats, lengths, *_, full = _composed_case(cuda_device, "full", 3, 4, ((9, 39),), lens=lens)
    bank = banks[0]
    NB = bank.shape[0]
    bad = ids.clone()
    bad[3, 5] = NB
    bad[4, 0] = -1
    lb = kc.bank_emission(bad, bank, feats, full)
    lb_p = kc.bank_emission_plain(bad.clamp(0, NB - 1), bank, feats, full)
    torch.cuda.synchronize()
    assert torch.isnan(lb[:, 5, 3]).all() and torch.isnan(lb[:, 0, 4]).all()
    assert int(torch.isnan(lb).sum()) == 2 * lb.shape[0]
    ok = ~torch.isnan(lb)
    _lattice_close(torch.where(ok, lb, 0.0), torch.where(ok, lb_p, 0.0))
    for g in sparse_gammas(ids, lengths, feats.shape[1], seed=5).values():
        mom = kc.bank_moments_lattice(bad, bank, feats, g, lengths, full)
        again = kc.bank_moments(bad, bank, feats, g.permute(2, 1, 0).contiguous(), lengths, full)
        torch.cuda.synchronize()
        rows_nan = torch.isnan(mom).flatten(1).any(1).cpu().numpy()
        assert rows_nan[0] and rows_nan[NB - 1] and not rows_nan[1:NB - 1].any()
        assert torch.equal(torch.isnan(mom), torch.isnan(again))
        want = kc.bank_moments_lattice_plain(bad.clamp(0, NB - 1), bank, feats, g, lengths, full)
        keep = torch.as_tensor(~rows_nan, device=mom.device)
        assert torch.equal(mom[keep], again[keep])
        _stat_close(mom[keep], want[keep])


def test_train_fast_full_d39_takes_the_kernels(cuda_device):
    """Full covariance at D = 39 (S=3, M=2): em_step (auto) launches the
    E-step kernels, and its log prob equals the plain e_step's within 1e-5."""
    rng = np.random.default_rng(21)
    utts = [rng.normal(size=(int(rng.integers(80, 120)), 39)) + np.arange(39) * 0.1 for _ in range(64)]
    batch = pack_utterances(utts, pad_multiple=1, dtype=torch.float32, device=cuda_device)
    trans, streams = rand_word(21, 3, [(2, 39)], "full")
    model = tm.gmm_hmm_from_numpy(trans, streams).astype(torch.float32).to(cuda_device)
    assert em._fused_lane_eligible(model, batch)
    counts = fe.emit_forward.launches, fe.backward_stats.launches
    _, lp_auto, _ = em.em_step(model, batch)
    _, lp_plain, _ = em.em_step(model, batch, fused=False)
    torch.cuda.synchronize()
    assert (fe.emit_forward.launches, fe.backward_stats.launches) == (counts[0] + 1, counts[1] + 1)
    np.testing.assert_allclose(float(lp_auto), float(lp_plain), rtol=1e-5)


def test_lane_and_narrow_full_launches_are_the_parents(cuda_device):
    """The lattice lane path (S <= 64), the E-step kernels and the composed
    kernels up to full D = 16 give bitwise the outputs of commit 76f6f1a's
    kernels, the composed kernels at diagonal D = 39 those of commit
    b91d8b8's, at full D = 39 (the z-GEMM bank kernels) those of commit
    51f7e05's, the block-wide Viterbi past 64 states those of commit
    d778d84's, and the scorer and the word-loop decoder at diagonal and
    full covariance up to D = 16 those of commit 2b6efac's:
    tests/torch_lane_digests.py's digests equal the ones saved in
    tests/lane_digests.json from those commits' kernels on an H100."""
    import json
    from pathlib import Path

    import torch_lane_digests

    want = json.loads((Path(__file__).parent / "lane_digests.json").read_text())
    got = torch_lane_digests.digests()
    assert sorted(got) == sorted(want)
    assert [k for k in want if got[k] != want[k]] == []


# ---------------------------------------------------------------------------
# #1 and #6-#8 at full covariance past D = 16: csrc/wide_log_b.cu's emission
# pass, then the recursions' wide instances
# ---------------------------------------------------------------------------

from srhmm_tpu_torch.ops.kernels import common as kcommon  # noqa: E402
from srhmm_tpu_torch.ops.kernels import wide_emission as we  # noqa: E402
from torch_port_utils import (  # noqa: E402
    DECODE_FULL_WIDE_CASES,
    SCORE_FULL_WIDE_CASES,
    decode_wide_case,
    score_wide_case,
    wide_cap,
)


def _vocab_launch(args, kw):
    return scoring._VocabLaunch(*(a if isinstance(a, tuple) else (a,) for a in args[:5]), *args[5:], **kw)


@pytest.mark.parametrize("i", range(len(SCORE_FULL_WIDE_CASES)))
def test_vocab_scores_matches_plain_past_full_d16(cuda_device, monkeypatch, i):
    """vocab_scores at each case of SCORE_FULL_WIDE_CASES: the emission
    pass's log b within 1e-5 of its twin's (wide_log_b_plain) at every
    stepped column, the final log-alpha within 1e-5 of vocab_scores_plain
    with equal masks, both semirings, two launches bitwise equal; a call
    split past a lowered log b cap launches once a part and is bitwise the
    unsplit call."""
    S, W, md, B, T, split = SCORE_FULL_WIDE_CASES[i]
    vocab, batch, _ = score_wide_case(i, cuda_device)
    args, kw = scoring.pack_batch(vocab, batch)
    ln = _vocab_launch(args, kw)
    U, N = ln.shape["utts"], ln.N
    assert ln.wide
    cols = we.columns(ln.lengths, 0, B, 0, T, T, t_major=True)
    layout = (0, 0, U, T * N * U, N * U, U)
    buf = torch.empty((-(-B // U), T, N, U), device=cuda_device)
    twin = torch.empty_like(buf)
    passes = we.wide_log_b.launches
    we.wide_log_b(ln.feats, ln.recs, ln.rec_offs, ln.ds, ln.ms, ln.rb, N, cols, buf, *layout)
    assert we.wide_log_b.launches == passes + 1
    we.wide_log_b_plain(ln.feats, ln.recs, ln.rec_offs, ln.ds, ln.ms, ln.rb, N, cols, twin, *layout)
    _lattice_close(we.gather_columns(buf, cols, N, *layout), we.gather_columns(twin, cols, N, *layout))
    for semiring in ("sum", "max"):
        before = scoring.vocab_scores.launches
        got = scoring.vocab_scores(*args, **kw, semiring=semiring)
        again = scoring.vocab_scores(*args, **kw, semiring=semiring)
        want = scoring.vocab_scores_plain(*args, **kw, semiring=semiring)
        torch.cuda.synchronize()
        assert scoring.vocab_scores.launches == before + 2
        _lattice_close(got, want)
        assert torch.equal(got, again)
        cap = wide_cap(split, T, N, U)
        if cap is not None:
            monkeypatch.setattr(kcommon, "WIDE_LOG_B_BYTES", cap)
            parts = we.plan_parts(B, T, N, U)
            before = scoring.vocab_scores.launches
            split_la = scoring.vocab_scores(*args, **kw, semiring=semiring)
            torch.cuda.synchronize()
            assert len(parts) > 1 and scoring.vocab_scores.launches == before + len(parts)
            assert torch.equal(split_la, got)
            monkeypatch.undo()


@pytest.mark.parametrize("i", range(len(DECODE_FULL_WIDE_CASES)))
def test_decode_kernel_matches_plain_past_full_d16(cuda_device, monkeypatch, i):
    """The word-loop decoder at each case of DECODE_FULL_WIDE_CASES and each
    of its K: final tokens within 1e-5 of the twin's with equal masks,
    pointer mismatches <= 1e-4, two runs bitwise equal, a call split past a
    lowered log b cap bitwise the unsplit one (a launch a part), and
    identical hypotheses through decode_continuous_batch."""
    W, S, bigram, md, variant, Ks, split = DECODE_FULL_WIDE_CASES[i]
    vocab, batches, graph_kw, lens = decode_wide_case(i, cuda_device)
    batch = batches if len(batches) > 1 else batches[0]
    args, opt = _decode_operands(vocab, batch, graph_kw)
    B, T, N = len(lens), max(lens), W * args[7]
    got_hyps = {}
    for K in Ks:
        wrapper = getattr(kd, _WRAPPERS[K])
        extra = {"n_best": K} if K > 2 else {}
        before = wrapper.launches
        fk, bk = wrapper(*args, **opt, **extra)
        fk2, bk2 = wrapper(*args, **opt, **extra)
        fp, bpp = kd.word_loop_decode_plain(*args, n_best=K, **opt)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 2
        assert torch.equal(fk, fk2) and torch.equal(bk, bk2)
        _lattice_close(fk, fp)
        assert int((bk != bpp).sum()) <= 1e-4 * bk.numel()
        cap = wide_cap(split, T, N, 1)
        if cap is not None:
            monkeypatch.setattr(kcommon, "WIDE_LOG_B_BYTES", cap)
            parts = we.plan_parts(B, T, N, 1)
            before = wrapper.launches
            fs, bs = wrapper(*args, **opt, **extra)
            torch.cuda.synchronize()
            assert len(parts) > 1 and wrapper.launches == before + len(parts)
            assert torch.equal(fs, fk) and torch.equal(bs, bk)
            monkeypatch.undo()
        got_hyps[K] = dc.decode_continuous_batch(vocab, batch, n_best=K, **graph_kw)
    _twins(monkeypatch)
    for K in Ks:
        want = dc.decode_continuous_batch(vocab, batch, n_best=K, **graph_kw)
        for g, w in zip(got_hyps[K], want):
            g, w = ([g], [w]) if K == 1 else (g, w)
            assert [h[1:] for h in g] == [h[1:] for h in w]
            for hg, hw in zip(g, w):
                assert hg[0] == hw[0] or abs(hg[0] - hw[0]) <= 1e-5 * max(abs(hw[0]), 1.0)
