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
from torch_port_utils import rand_word

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


def _em_inputs(device, cov, band, mixes_dims, lens, S=6, seed=3):
    """(feats, packed, origins, trans, lengths) of one E-step on `device`;
    band=None gives a dense random transition matrix."""
    rng = np.random.default_rng(seed)
    if band is None:
        trans = rng.uniform(0.1, 1.0, size=(S, S))
    else:
        trans = np.zeros((S, S))
        for i in range(S):
            trans[i, i : i + band + 1] = rng.uniform(0.2, 1.0, size=min(band + 1, S - i))
    trans /= trans.sum(-1, keepdims=True)
    _, streams = rand_word(seed, S, list(mixes_dims), cov, scale=3.0)
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
_WRAPPERS = {1: "word_loop_decode", 2: "word_loop_decode_k2", 3: "word_loop_decode_kn"}


def _decode_case(device, cov, S, bigram, mixes_dims, variant=None, W=5, lens=_DECODE_LENS, seed=4):
    """(vocab, batch, graph kwargs) of one decode on `device`.  variant
    "hetero": word lengths S and S-2, padded (pad_stack_models) with their
    final states; "dup": word 3 a copy of word 1 with the same arcs (the
    bigram's row and column; the unigram is uniform), so tokens tie
    bitwise."""
    rng = np.random.default_rng(seed)
    sizes = [S - 2 * (i % 2) if variant == "hetero" else S for i in range(W)]
    words = [tm.gmm_hmm_from_numpy(*rand_word(seed * 50 + (1 if variant == "dup" and i == 3 else i), s,
                                              list(mixes_dims), cov, 1 + i % 2))
             for i, s in enumerate(sizes)]
    vocab, fs = tm.pad_stack_models(words) if variant == "hetero" else (tm.stack_models(words), None)
    kw = {"final_states": fs}
    if bigram:
        lm = np.log(rng.dirichlet(np.ones(W), size=W))
        if variant == "dup":  # arcs in and out too: the two words are interchangeable
            lm[:, 3] = lm[:, 1]
            lm[3] = lm[1]
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


@pytest.mark.parametrize("n_best", [1, 2, 3])
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
