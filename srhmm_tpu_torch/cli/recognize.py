"""Recognition CLI mirroring the reference argv contract (counterpart of
``srhmm_tpu/cli/recognize.py``; same arguments, same report).

Usage (recognition-full-fs/recognition_continuous_full_fs.c:183-193):

    python -m srhmm_tpu_torch.cli.recognize models_number model1 ... modelN
        coef_model1 ... coef_modelN input_file1 ... input_fileM
        word_file output_file

where modelK is a list file of .hmm paths (one vocabulary), coef_modelK the
weighting coefficient for that model set, input_fileK..M one parameter-list
file per model set per stream, word_file the spoken-word transcript, and
output_file the report.  Paths inside list files resolve against the CWD.

Optional leading flags (before the positionals):
    --mode total|final      scoring mode; default: total for full covariance
                            (the R1 recognizer), final for diagonal (R2)
    --numerics parity|fast  parity = float64 probability-domain semantics on
                            the CPU with the reference's NaN-freezing
                            bubble-sort ranking (reproduces the golden
                            report); fast = float64 log-space path on
                            --device with the sane NaN-last ranking
    --device cuda|cpu       where --numerics fast runs (default cuda); without
                            a CUDA device, cuda exits non-zero instead of
                            falling back to the CPU
"""

from __future__ import annotations

import argparse
import sys
import time

from .device import add_device_argument, resolve_device


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(add_help=True)
    ap.add_argument("--mode", choices=["total", "final"], default=None)
    ap.add_argument("--numerics", choices=["parity", "fast"], default="parity")
    add_device_argument(ap)
    ap.add_argument("rest", nargs=argparse.REMAINDER)
    ns = ap.parse_args(argv)
    rest = ns.rest

    if len(rest) < 5:
        print(
            "Usage: recognize models_number model1 ... modelN coef_model1 ... "
            "coef_modelN input_file1 ... input_fileM word_file output_file",
            file=sys.stderr,
        )
        return 1

    import numpy as np
    import torch

    from ..decode.scorer import rank, rank_c_parity, score_vocab_log, score_vocab_parity
    from ..eval.report import RecognitionReport
    from ..io import read_list, read_perfil, read_vocabulary
    from ..models import pad_stack_models, stack_models

    # parity is the reference-exact mode: IEEE float64 on the CPU
    if ns.numerics == "parity":
        device = torch.device("cpu")
    else:
        device = resolve_device(ns.device, "recognize")
        if device is None:
            return 2

    models_number = int(rest[0])
    model_lists = rest[1 : 1 + models_number]
    coef_model = [float(x) for x in rest[1 + models_number : 1 + 2 * models_number]]
    output_file = rest[-1]
    word_file = rest[-2]
    input_files = rest[1 + 2 * models_number : -2]

    # load model sets; mixed-shape vocabularies are stacked padded with
    # per-word final-state indices
    vocabs = []
    final_states_per_set = []
    for ml in model_lists:
        models = read_vocabulary(ml)
        print("\nLoading Models")
        for m in models:
            print(f"Model: {m.word}")
        try:
            stacked, fs = stack_models(models), None
        except ValueError:
            stacked, fs = pad_stack_models(models)
        vocabs.append(stacked.to(device))
        final_states_per_set.append(fs)
    words = list(vocabs[0].word)
    cov_type = vocabs[0].streams[0].cov_type

    mode = ns.mode or ("total" if cov_type == "full" else "final")

    # one parameter list per model set per stream (R1:253-262)
    param_lists = []
    k = 0
    for j in range(models_number):
        per_stream = []
        for _ in range(vocabs[j].num_streams):
            per_stream.append(iter(read_list(input_files[k])))
            k += 1
        param_lists.append(per_stream)

    report = RecognitionReport(
        vocab_words=words,
        models_number=models_number,
        model_list_names=model_lists,
        coef_model=coef_model,
        cov_type=cov_type,
    )

    score = score_vocab_parity if ns.numerics == "parity" else score_vocab_log
    print("\nStarting Tests")
    for spoken_word in read_list(word_file):
        t0 = time.process_time()
        probab = np.zeros(len(words))
        obs_time = 0
        for j in range(models_number):
            frames_per_stream = tuple(
                torch.as_tensor(read_perfil(next(it)), dtype=torch.float64, device=device)
                for it in param_lists[j]
            )
            obs_time = frames_per_stream[-1].shape[0]
            s = score(
                vocabs[j], frames_per_stream, mode=mode, final_states=final_states_per_set[j]
            )
            probab += coef_model[j] * s.cpu().numpy()
        ranking = (rank_c_parity if ns.numerics == "parity" else rank)(probab)
        cpu = time.process_time() - t0
        report.add_utterance(spoken_word, ranking, obs_time, cpu)
        for i in ranking:
            print(f"{words[i]} :  {probab[i]:f} ")
        print()
    print("\nEnding Tests")

    with open(output_file, "w") as f:
        f.write(report.finalize())
    return 0


if __name__ == "__main__":
    sys.exit(main())
