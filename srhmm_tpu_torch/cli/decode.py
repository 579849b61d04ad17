"""Continuous recognition CLI: word-loop token-passing decode with N-best
(counterpart of ``srhmm_tpu/cli/decode.py``; same arguments, same output).

Usage:
    python -m srhmm_tpu_torch.cli.decode model_list input_list output_file
        [--n-best K] [--exit-logprob X] [--ref ref_file]
        [--lm lm_file] [--lm-scale S] [--word-penalty P] [--batch]
        [--device cuda|cpu]

model_list: list file of .hmm paths (the vocabulary); input_list: list file
of .perfil paths (one utterance each), or for a multi-stream vocabulary a
comma-separated list of per-stream list files.  output_file receives one
line per utterance, ``<perfil>  <score>  <word sequence>``, plus the other
hypotheses when --n-best > 1; --ref (one transcript line per utterance)
adds a WER summary.

--lm: a text file of W lines ("word logprob", unigram) or W*W lines ("prev
next logprob", bigram), or a .npy array of shape (W,) / (W, W).
--lm-scale and --word-penalty are the acoustic/LM balance knobs.  --batch
decodes every utterance in one padded batch through the word-loop kernel
(decode_continuous_batch, n_best <= 2); the default is the per-utterance
engine, which takes any n_best.  --device (default cuda) says where it
runs; without a CUDA device, cuda exits non-zero instead of falling back.
"""

from __future__ import annotations

import argparse
import sys

from .device import add_device_argument, resolve_device


def _read_lm(path: str, words: list[str]):
    """(W,) unigram or (W, W) bigram log-probs from .npy or text."""
    import numpy as np

    if path.endswith(".npy"):
        lm = np.load(path)
        if lm.shape not in ((len(words),), (len(words), len(words))):
            raise SystemExit(f"--lm: shape {lm.shape} does not match vocabulary W={len(words)}")
        return lm
    idx = {w: i for i, w in enumerate(words)}
    rows = [l.split() for l in open(path).read().splitlines() if l.strip()]
    if all(len(r) == 2 for r in rows):
        lm = np.full(len(words), -np.inf)
        for w, lp in rows:
            lm[idx[w]] = float(lp)
        return lm
    if all(len(r) == 3 for r in rows):
        lm = np.full((len(words), len(words)), -np.inf)
        for u, v, lp in rows:
            lm[idx[u], idx[v]] = float(lp)
        return lm
    raise SystemExit("--lm: lines must be 'word logprob' or 'prev next logprob'")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("model_list")
    ap.add_argument("input_list")
    ap.add_argument("output_file")
    ap.add_argument("--n-best", type=int, default=1)
    ap.add_argument("--exit-logprob", type=float, default=None)
    ap.add_argument("--ref", default=None)
    ap.add_argument("--lm", default=None, help="unigram/bigram log-prob file")
    ap.add_argument("--lm-scale", type=float, default=None)
    ap.add_argument("--word-penalty", type=float, default=None)
    ap.add_argument(
        "--batch", action="store_true",
        help="decode all utterances in one batch through the word-loop kernel (n_best <= 2)",
    )
    add_device_argument(ap)
    ns = ap.parse_args(argv)
    device = resolve_device(ns.device, "decode")
    if device is None:
        return 2

    import numpy as np
    import torch

    from ..decode.continuous import decode_continuous, decode_continuous_batch
    from ..eval.metrics import WerCounts, edit_alignment
    from ..io import read_list, read_perfil, read_vocabulary
    from ..io.dataset import pack_utterances
    from ..models import stack_models

    vocab = stack_models(read_vocabulary(ns.model_list)).astype(torch.float32).to(device)
    words = list(vocab.word)
    kwargs = {}
    if ns.exit_logprob is not None:
        kwargs["exit_logprob"] = ns.exit_logprob
    if ns.lm is not None:
        kwargs["lm_logprobs"] = _read_lm(ns.lm, words)
    if ns.lm_scale is not None:
        kwargs["lm_scale"] = ns.lm_scale
    if ns.word_penalty is not None:
        kwargs["word_insertion_penalty"] = ns.word_penalty

    refs = None
    if ns.ref:
        refs = [l.split() for l in open(ns.ref).read().splitlines() if l.strip()]

    stream_lists = ns.input_list.split(",")
    n_streams = len(vocab.streams)
    if len(stream_lists) != n_streams:
        raise SystemExit(
            f"vocabulary has {n_streams} stream(s); pass {n_streams} "
            f"comma-separated input list(s), got {len(stream_lists)}"
        )
    per_stream_paths = [list(read_list(sl)) for sl in stream_lists]
    paths = per_stream_paths[0]
    if any(len(pp) != len(paths) for pp in per_stream_paths):
        raise SystemExit("per-stream input lists must have equal lengths")
    multi = n_streams > 1
    all_hyps = None
    if ns.batch:
        if ns.n_best > 2:
            raise SystemExit("--batch supports n_best <= 2 (fused kernels)")
        batches = tuple(
            pack_utterances([np.asarray(read_perfil(p), np.float32) for p in pp],
                            pad_multiple=128, dtype=torch.float32, device=device)
            for pp in per_stream_paths
        )
        results = decode_continuous_batch(vocab, batches if multi else batches[0],
                                          n_best=ns.n_best, **kwargs)
        all_hyps = [r if isinstance(r, list) else [r] for r in results]

    total = WerCounts()
    with open(ns.output_file, "w") as out:
        for i, path in enumerate(paths):
            if all_hyps is not None:
                hyps = all_hyps[i]
            else:
                frames = tuple(
                    torch.as_tensor(np.asarray(read_perfil(pp[i])), dtype=torch.float32, device=device)
                    for pp in per_stream_paths
                )
                hyps = decode_continuous(vocab, frames if multi else frames[0], n_best=ns.n_best,
                                         **kwargs)
            best_score, best_words, _ = hyps[0]
            hyp_words = [words[w] for w in best_words]
            out.write(f"{path}\t{best_score:.4f}\t{' '.join(hyp_words)}\n")
            for rank_i, (sc, ws, _) in enumerate(hyps[1:], start=2):
                out.write(f"#  {rank_i}-best\t{sc:.4f}\t{' '.join(words[w] for w in ws)}\n")
            if refs is not None and i < len(refs):
                total = total + edit_alignment(refs[i], hyp_words)
        if refs is not None:
            out.write(
                f"\nWER: {total.wer * 100.0:.2f}%  "
                f"(S={total.substitutions} I={total.insertions} "
                f"D={total.deletions} N={total.num_ref_words})\n"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
