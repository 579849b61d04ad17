"""One-command end-to-end pipeline: audio -> ... -> WER (counterpart of
``srhmm_tpu/cli/pipeline.py``; same flags, same one-line JSON summary).

A single invocation synthesizes a continuous-speech corpus, extracts
MFCCs, flat-starts monophones with LBG, trains monophone embedded EM,
clusters states into senones with the phonetic decision tree, trains the
tied system, materializes the lexicon into decode word models, runs the
bigram n-best decoder on held-out audio, and reports WER with per-stage
wall times (srhmm_tpu_torch/pipeline.py).

Usage:
    python -m srhmm_tpu_torch.cli.pipeline [--n-train N] [--n-test N] [--snr DB]
        [--words W] [--phones-per-word K] [--states S] [--mix M]
        [--mono-iters N] [--tied-iters N] [--n-best K] [--lm-scale X]
        [--max-senones N] [--seed N] [--json FILE] [--device cuda|cpu]

--device (default cuda) says where the whole chain runs; without a CUDA
device, cuda exits 2 instead of falling back.  --data-parallel N is not
ported yet: the CLI exits 2.  Exit code 0 on success; the one-line JSON
summary goes to stdout (and --json FILE if given).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .device import add_device_argument, resolve_device


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-train", type=int, default=48)
    ap.add_argument("--n-test", type=int, default=16)
    ap.add_argument("--snr", type=float, default=None, help="SNR dB; default clean")
    ap.add_argument("--words", type=int, default=10)
    ap.add_argument("--phones-per-word", type=int, default=3)
    ap.add_argument("--states", type=int, default=3, help="states per phone")
    ap.add_argument("--mix", type=int, default=2, help="mixtures per senone")
    ap.add_argument("--mono-iters", type=int, default=8)
    ap.add_argument("--tied-iters", type=int, default=8)
    ap.add_argument("--n-best", type=int, default=2)
    ap.add_argument("--lm-scale", type=float, default=1.0)
    ap.add_argument("--max-senones", type=int, default=None)
    ap.add_argument("--min-gain", type=float, default=200.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-parallel", type=int, default=None, metavar="N",
                    help="data-parallel EM over N devices (not ported yet: exits 2)")
    ap.add_argument("--json", default=None, help="also write the summary here")
    ap.add_argument("--quiet", action="store_true")
    add_device_argument(ap)
    ns = ap.parse_args(argv)
    if ns.data_parallel is not None:
        print("pipeline: --data-parallel is not ported to srhmm_tpu_torch yet", file=sys.stderr)
        return 2
    device = resolve_device(ns.device, "pipeline")
    if device is None:
        return 2

    from ..pipeline import PipelineConfig, run_pipeline

    cfg = PipelineConfig(
        n_words=ns.words,
        phones_per_word=ns.phones_per_word,
        states_per_phone=ns.states,
        n_mix=ns.mix,
        snr_db=ns.snr,
        seed=ns.seed,
    )
    t0 = time.time()
    res = run_pipeline(
        cfg,
        n_train=ns.n_train,
        n_test=ns.n_test,
        max_iterations=ns.mono_iters,
        tied_iterations=ns.tied_iters,
        n_best=ns.n_best,
        lm_scale=ns.lm_scale,
        max_senones=ns.max_senones,
        min_gain=ns.min_gain,
        verbose=not ns.quiet,
        device=device,
    )
    wall = time.time() - t0

    summary = {
        "wer": round(res.wer.wer, 4),
        "substitutions": res.wer.substitutions,
        "insertions": res.wer.insertions,
        "deletions": res.wer.deletions,
        "num_ref_words": res.wer.num_ref_words,
        "n_senones": res.n_senones,
        "n_units": res.n_units,
        "mono_iterations": res.mono_iterations,
        "tied_iterations": res.tied_iterations,
        "mono_log_prob": round(res.mono_log_prob, 3),
        "tied_log_prob": round(res.tied_log_prob, 3),
        "snr_db": ns.snr,
        "wall_seconds": round(wall, 2),
        "stage_seconds": res.stage_seconds,
    }
    line = json.dumps(summary)
    print(line)
    if ns.json:
        with open(ns.json, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
