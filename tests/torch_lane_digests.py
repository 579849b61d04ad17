"""SHA-256 digests of the lattice, E-step and composed kernels' outputs on
the shapes they took before the block-wide lattice mode and full
covariance past D = 16 (needs a CUDA card; not a tier-1 test):

    python tests/torch_lane_digests.py dump OUT.json       # this tree's kernels
    PYTHONPATH=OTHER python tests/torch_lane_digests.py dump OUT.json   # another tree's
    python tests/torch_lane_digests.py compare A.json B.json

Every input is made on the CPU from a seed (the constants and banks packed
there in float64, then cast), then moved to the card, so two trees (or two
runs) that launch the same kernels give the same digests.  The cases:
csrc/lattice.cu's lane path (forward lattice and last row, shared and
per-row transitions, backward, Viterbi scores and backpointers) at S = 3,
8, 33, 64, banded and dense; csrc/fused_em.cu's emit_forward and
backward_stats at diagonal and full covariance up to D = 16 (one and two
streams, dense transitions, the accumulators in the partials);
csrc/composed.cu's four kernels at diagonal and full covariance up to
D = 16 (two streams, the emission ring and moments batch at two), at
diagonal D = 39, the frontend's width, and at full D = 39, M = 9 (the
z-GEMM bank kernels); csrc/lattice.cu's Viterbi past 64 states (scores
and backpointers; the group mode's max-plus kind, exact, so bitwise the
block-wide kernel it replaced) at three cases of
torch_port_utils.WIDE_LATTICE_CASES, S = 96 banded, 257 and 1024 dense;
csrc/vocab_scores.cu's final log-alpha (both semirings) and
csrc/word_loop_decode.cu's final tokens and pointers (K = 1 unigram, K = 2
and 3 bigram) at their lane shapes: diagonal and full covariance up to
D = 16 (the recognizer's full13 and diag10 vocabularies, two streams, the
decoder's dec_w200 vocabulary and full13 with a bigram).
tests/lane_digests.json holds the digests of commit 76f6f1a's kernels (the
diagonal D = 39 case's of commit b91d8b8's, the full D = 39 case's of
commit 51f7e05's, the Viterbi past 64 states' of commit d778d84's
block-wide kernel, the scorer's and decoder's of commit 2b6efac's);
tests/test_torch_cuda.py holds these kernels to them.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_port_utils import WIDE_LATTICE_CASES, log_trans_np, rand_word, wide_lattice_lengths  # noqa: E402

LATTICE = [(S, kind) for S in (3, 8, 33, 64) for kind in ("delta1", "dense")]
EM = [("diag", 1, [(3, 9)]), ("full", 1, [(3, 9)]), ("full", None, [(16, 16)]), ("diag", 2, [(3, 9), (2, 3)]),
      ("full", 2, [(2, 12), (1, 4)])]
VITERBI_WIDE = [1, 4, 5]  # WIDE_LATTICE_CASES: S = 96 delta2, 257 dense, 1024 dense
# (cov, W, S, [(M, D) per stream]) of the scorer and the decoder
VOCAB = [("full", 13, 6, [(1, 9)]), ("diag", 10, 8, [(4, 13)]), ("full", 5, 6, [(3, 9), (2, 3)]),
         ("full", 4, 5, [(2, 16)])]
DECODE = [("diag", 200, 8, [(4, 13)]), ("full", 13, 6, [(1, 9)]), ("full", 5, 8, [(2, 16)])]
BANK = [("full", [(2, 6)]), ("full", [(3, 16)]), ("diag", [(4, 13)]), ("full", [(3, 4), (2, 4)]),
        ("full", [(82, 16)]), ("diag", [(3, 39)]), ("full", [(9, 39)])]


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _lengths(rng, B=37, T=95):
    return [int(n) for n in rng.integers(2, T, size=B - 3)] + [T, 0, 1]


def lattice_digests(dev) -> dict:
    from srhmm_tpu_torch.ops.kernels import forward as kf
    from srhmm_tpu_torch.ops.kernels import lattice as kl

    out = {}
    for i, (S, kind) in enumerate(LATTICE):
        rng = np.random.default_rng(500 + i)
        lens = _lengths(rng)
        T, B = max(lens), len(lens)
        lb = (rng.normal(size=(T, S, B)) * 2).astype(np.float32)
        lb[rng.integers(0, T, 7), rng.integers(0, S, 7), rng.integers(0, B, 7)] = -np.inf
        rows = np.stack([log_trans_np(S, ("delta1", "dense")[b % 2], seed=b) for b in range(B)])
        lb_t, lt = torch.as_tensor(lb, device=dev), torch.as_tensor(log_trans_np(S, kind, seed=S), device=dev)
        lengths = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        lb_bts = lb_t.permute(2, 0, 1).contiguous()
        tag = f"lattice_S{S}_{kind}"
        out[f"{tag}_forward"] = _digest(kl.forward_lattice(lb_t, lt, lengths))
        out[f"{tag}_backward"] = _digest(kl.backward_lattice(lb_t, lt, lengths))
        out[f"{tag}_last_row"] = _digest(kf.log_forward_batch(lb_bts, lt, lengths))
        out[f"{tag}_last_row_per_row"] = _digest(kf.log_forward_batch(lb_bts, torch.as_tensor(rows, device=dev),
                                                                      lengths))
        out[f"{tag}_viterbi"] = _digest(*kf.viterbi_batch(lb_bts, lt, lengths))
    return out


def viterbi_wide_digests(dev) -> dict:
    """The Viterbi's scores and backpointers past 64 states at VITERBI_WIDE's
    cases of WIDE_LATTICE_CASES (their lengths, seeded (B, T, S) log b)."""
    from srhmm_tpu_torch.ops.kernels import forward as kf

    out = {}
    for i in VITERBI_WIDE:
        S, kind, B, T = WIDE_LATTICE_CASES[i]
        rng = np.random.default_rng(800 + i)
        lb = (rng.normal(size=(B, T, S)) * 2).astype(np.float32)
        lt = torch.as_tensor(log_trans_np(S, kind, seed=S), device=dev)
        lengths = torch.as_tensor(wide_lattice_lengths(i, B, T), dtype=torch.int32, device=dev)
        out[f"viterbi_wide_S{S}_{kind}"] = _digest(*kf.viterbi_batch(torch.as_tensor(lb, device=dev), lt, lengths))
    return out


def em_digests(dev) -> dict:
    from srhmm_tpu_torch.models import gmm_hmm_from_numpy
    from srhmm_tpu_torch.ops.kernels import fused_em as fe
    from srhmm_tpu_torch.ops.kernels.common import NEG_INF

    out = {}
    for i, (cov, band, md) in enumerate(EM):
        rng = np.random.default_rng(600 + i)
        S = 6
        if band is None:
            trans = rng.uniform(0.1, 1.0, size=(S, S))
            trans /= trans.sum(-1, keepdims=True)
        else:
            trans = rand_word(600 + i, S, md, cov, band)[0]
        _, streams = rand_word(610 + i, S, md, cov, 1)
        model = gmm_hmm_from_numpy(trans, streams)  # float64 on the CPU
        lens = _lengths(rng)
        T, B = max(lens), len(lens)
        feats = tuple(torch.as_tensor(rng.normal(size=(T, D, B)) * 3, dtype=torch.float32, device=dev)
                      for _, D in md)
        origins = tuple(s.means.mean(dim=(0, 1)).float() for s in model.streams)
        packed = tuple(tuple(x.to(dev) for x in fe.pack_lane_constants(s, torch.float32, origin=o))
                       for s, o in zip(model.streams, origins))
        origins = tuple(o.to(dev) for o in origins)
        tr = model.trans.float().to(dev)
        lengths = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        lb, la = fe.emit_forward(feats, packed, origins, tr, lengths, band)
        log_z = la[-1, -1]
        valid = torch.isfinite(log_z) & (log_z > NEG_INF / 2) & (lengths > 0)
        st = fe.backward_stats(feats, lb, la, packed, origins, tr, lengths, torch.where(valid, log_z, 0.0),
                               valid.to(torch.float32), band)
        tag = f"em_{cov}_band{band}_" + "_".join(f"M{M}D{D}" for M, D in md)
        out[f"{tag}_emit_forward"] = _digest(lb, la)
        out[f"{tag}_backward_stats"] = _digest(st[0], st[1], st[2], *st[3])
    return out


def bank_digests(dev) -> dict:
    from srhmm_tpu_torch.models import gmm_hmm_from_numpy, stack_models
    from srhmm_tpu_torch.ops.kernels import composed as kc
    from srhmm_tpu_torch.ops.kernels.common import NEG_INF
    from srhmm_tpu_torch.train import embedded as emb

    out = {}
    for i, (cov, md) in enumerate(BANK):
        rng = np.random.default_rng(700 + i)
        S, L, P = 3, 4, 6
        units = [rand_word(710 + 10 * i + u, S, md, cov, 1 + u % 2) for u in range(P)]
        models = stack_models([gmm_hmm_from_numpy(t, st, f"u{u}") for u, (t, st) in enumerate(units)])
        lens = _lengths(rng)
        T, B, D = max(lens), len(lens), md[0][1]
        trs = torch.as_tensor(rng.integers(0, P, size=(B, L)))
        full = cov == "full"
        banks = tuple(emb._pack_bank(st, D, full).to(dev) for st in models.streams)
        banks = banks if len(banks) > 1 else banks[0]
        diag_row, diag_col = (d.to(dev) for d in emb._composed_diagonals(
            models.log_trans().to(torch.float32)[trs.long()], max(S - 1, 1)))
        ids = emb._positions(trs, S).to(dev)
        feats = torch.as_tensor(rng.normal(size=(B, T, D)) * 3, dtype=torch.float32, device=dev)
        lengths = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        lb = kc.bank_emission(ids, banks, feats, full)
        la = kc.composed_forward(lb, diag_col, lengths)
        log_z = la[-1, -1]
        valid = torch.isfinite(log_z) & (log_z > NEG_INF / 2) & (lengths > 0)
        st = kc.composed_backward_stats(lb, la, diag_row, lengths, torch.where(valid, log_z, 0.0),
                                        valid.to(torch.float32))
        as_t = lambda m: m if isinstance(m, tuple) else (m,)  # noqa: E731
        tag = f"bank_{cov}_" + "_".join(f"M{M}D{D}" for M, D in md)
        out[f"{tag}_bank_emission"] = _digest(lb)
        out[f"{tag}_composed_forward"] = _digest(la)
        out[f"{tag}_composed_backward_stats"] = _digest(*st)
        out[f"{tag}_bank_moments_lattice"] = _digest(*as_t(kc.bank_moments_lattice(ids, banks, feats, st[0], lengths,
                                                                                    full)))
        out[f"{tag}_bank_moments"] = _digest(*as_t(kc.bank_moments(ids, banks, feats,
                                                                    st[0].permute(2, 1, 0).contiguous(), lengths,
                                                                    full)))
    return out


def _vocab_case(seed, cov, W, S, md, lens):
    """A float32 vocabulary (on the CPU) of W words from rand_word(seed + w)
    and per-stream CPU feature batches of the lengths (normal * 2)."""
    from srhmm_tpu_torch.io.dataset import pack_utterances
    from srhmm_tpu_torch.models import gmm_hmm_from_numpy, stack_models

    words = [gmm_hmm_from_numpy(*rand_word(seed + w, S, md, cov, 1), f"w{w}") for w in range(W)]
    rng = np.random.default_rng(seed)
    batches = tuple(pack_utterances([rng.normal(size=(n, D)) * 2 for n in lens], pad_multiple=1,
                                    dtype=torch.float32) for _, D in md)
    return stack_models(words).astype(torch.float32), batches


def _to(x, dev):
    if isinstance(x, tuple):
        return tuple(_to(v, dev) for v in x)
    return x.to(dev) if isinstance(x, torch.Tensor) else x


def vocab_digests(dev) -> dict:
    """vocab_scores' final log-alpha at VOCAB's lane shapes, both
    semirings (the constants packed on the CPU, then moved)."""
    from srhmm_tpu_torch.ops.kernels import scoring

    out = {}
    for i, (cov, W, S, md) in enumerate(VOCAB):
        lens = _lengths(np.random.default_rng(900 + i), B=67, T=120)
        vocab, batches = _vocab_case(910 + 20 * i, cov, W, S, md, lens)
        args, kw = scoring.pack_batch(vocab, batches if len(batches) > 1 else batches[0])
        args = _to(args, dev)
        tag = f"vocab_{cov}_W{W}_S{S}_" + "_".join(f"M{M}D{D}" for M, D in md)
        for semiring in ("sum", "max"):
            out[f"{tag}_{semiring}"] = _digest(scoring.vocab_scores(*args, **kw, semiring=semiring))
    return out


def decode_digests(dev) -> dict:
    """The word-loop decoder's final tokens and pointers at DECODE's lane
    shapes: K = 1 unigram, K = 2 and 3 bigram (operands as
    decode_continuous_batch builds them, on the CPU, then moved)."""
    from srhmm_tpu_torch.decode import continuous as dc
    from srhmm_tpu_torch.ops.kernels import decode as kd

    out = {}
    for i, (cov, W, S, md) in enumerate(DECODE):
        rng = np.random.default_rng(950 + i)
        lens = _lengths(rng, B=19, T=80)
        vocab, batches = _vocab_case(960 + 300 * i, cov, W, S, md, lens)
        uni, bi = np.log(rng.dirichlet(np.ones(W))), np.log(rng.dirichlet(np.ones(W), size=W))
        tag = f"decode_{cov}_W{W}_S{S}_" + "_".join(f"M{M}D{D}" for M, D in md)
        for K, lm in ((1, uni), (2, bi), (3, bi)):
            graph = dc.compose_word_loop_blocks(vocab, lm_logprobs=lm)
            ops = dc._fused_operands(vocab, graph, batches)
            (feats, a, bias, bias_g, logw, diag, band, arc_col, entry_col, exit_col, lengths, s_eff) = _to(ops, dev)
            args = (feats, a, bias, diag, arc_col, entry_col, lengths, s_eff, band)
            kw = {"exit_col": exit_col, "bias_g": bias_g, "logw": logw}
            if K == 1:
                res = kd.word_loop_decode(*args, **kw)
            elif K == 2:
                res = kd.word_loop_decode_k2(*args, **kw)
            else:
                res = kd.word_loop_decode_kn(*args, n_best=K, **kw)
            out[f"{tag}_K{K}"] = _digest(*res)
    return out


def digests(dev="cuda") -> dict:
    dev = torch.device(dev)
    out = {**lattice_digests(dev), **viterbi_wide_digests(dev), **em_digests(dev), **bank_digests(dev),
           **vocab_digests(dev), **decode_digests(dev)}
    torch.cuda.synchronize()
    return out


def main(argv) -> int:
    if argv[:1] == ["dump"]:
        Path(argv[1]).write_text(json.dumps(digests(), indent=1, sort_keys=True) + "\n")
        return 0
    if argv[:1] == ["compare"]:
        a, b = (json.loads(Path(p).read_text()) for p in argv[1:3])
        differ = sorted(k for k in a if a[k] != b.get(k))
        print(json.dumps({"cases": len(a), "equal": len(a) - len(differ), "differ": differ,
                          "missing": sorted(set(a) ^ set(b))}))
        return 1 if differ or set(a) != set(b) else 0
    raise SystemExit(__doc__)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
