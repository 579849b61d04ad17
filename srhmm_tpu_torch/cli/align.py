"""Forced-alignment CLI: Viterbi-align transcripts to feature files
(counterpart of ``srhmm_tpu/cli/align.py``; same arguments, same output,
same exit code).

Usage:
    python -m srhmm_tpu_torch.cli.align MODEL_LIST TRANSCRIPTS OUTPUT
        [--frame-shift MS] [--device cuda|cpu]

MODEL_LIST: list file of .hmm paths (the unit inventory, stacked in order);
TRANSCRIPTS: one utterance per line, ``path/to/features.perfil unit_a
unit_b ...``.  OUTPUT receives, per utterance, one line per transcript
unit:

    <perfil>  <unit>  <start_frame>  <end_frame>  [<start_s> <end_s>]

with times when --frame-shift (milliseconds) is given, or
``<perfil>  ALIGNMENT-FAILED`` when the best path through the
concatenated unit models (compose_sequence), forced to end in the last
unit's exit state, does not traverse every unit; any failure makes the
exit code 2.  --device (default cuda) says where it runs; without a CUDA
device, cuda exits non-zero instead of falling back.
"""

from __future__ import annotations

import argparse
import sys

from .device import add_device_argument, resolve_device


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("model_list")
    ap.add_argument("transcripts")
    ap.add_argument("output_file")
    ap.add_argument(
        "--frame-shift", type=float, default=None, metavar="MS",
        help="frame shift in milliseconds; adds start/end seconds columns",
    )
    add_device_argument(ap)
    ns = ap.parse_args(argv)
    device = resolve_device(ns.device, "align")
    if device is None:
        return 2

    import numpy as np
    import torch

    from ..decode.continuous import (
        backtrace_words,
        compose_sequence,
        emissions_for_graph,
        token_passing,
    )
    from ..io import read_perfil, read_vocabulary
    from ..models import stack_models
    from .train_embedded import read_transcripts

    models = read_vocabulary(ns.model_list)
    uidx = {m.word: i for i, m in enumerate(models)}
    vocab = stack_models(models).astype(torch.float32).to(device)

    items = read_transcripts(ns.transcripts)
    shift_s = ns.frame_shift / 1000.0 if ns.frame_shift else None
    n_fail = 0
    with open(ns.output_file, "w") as out:
        for path, seq in items:
            missing = [u for u in seq if u not in uidx]
            if missing:
                raise SystemExit(f"{path}: unknown units {missing}")
            ids = [uidx[u] for u in seq]
            frames = torch.as_tensor(np.asarray(read_perfil(path), np.float32), device=device)
            graph = compose_sequence(vocab, ids)
            log_b = emissions_for_graph(vocab, graph, frames)
            final, bps = token_passing(graph, log_b, n_best=1)
            # the forced-alignment contract: end at the last unit's exit state
            fin = final.cpu().numpy()
            exit_last = int(graph.exit_states[-1])
            masked = np.full_like(fin, -np.inf)
            masked[exit_last] = fin[exit_last]
            score, units, spans = backtrace_words(graph, masked, bps.cpu().numpy(), log_b.shape[0])
            if not np.isfinite(score) or units != ids:
                out.write(f"{path}\tALIGNMENT-FAILED\n")
                n_fail += 1
                continue
            for u, (a, b) in zip(seq, spans):
                line = f"{path}\t{u}\t{a}\t{b}"
                if shift_s is not None:
                    line += f"\t{a * shift_s:.3f}\t{b * shift_s:.3f}"
                out.write(line + "\n")
    if n_fail:
        print(f"{n_fail}/{len(items)} utterances failed to align", file=sys.stderr)
    return 0 if n_fail == 0 else 2


if __name__ == "__main__":
    sys.exit(main())
