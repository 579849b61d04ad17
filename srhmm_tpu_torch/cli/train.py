"""Training CLI mirroring the reference argv contract (counterpart of
``srhmm_tpu/cli/train.py``; same arguments, same files).

Usage (hmm-full-fs/hmm_continuous_full_fs.c:166-176):

    python -m srhmm_tpu_torch.cli.train word states_number param_number
        mix_number1 ... mix_numberN input_file1 ... input_fileN
        output_file [initial_model]

input_fileK is a list file naming one .perfil per training exemplar for
stream K.  Writes the binary model to output_file and the text summary to
the reference's derived name (first-dot truncation + ".txt").

Optional leading flags:
    --cov full|diag   covariance type (full = hmm_continuous_full_fs,
                      diag = hmm_continuous_fs); default full
    --threshold X     convergence threshold (default 1e-3, T1:36)
    --size-t-width N  .hmm size_t width (default 4, matching the fixtures)
    --numerics parity|fast
                      parity = float64 reference-exact EM on the CPU
                      (default); fast = log-space batched float32 EM on
                      --device, through the fused E-step kernels on a card
    --device cuda|cpu (fast) where EM runs (default cuda); without a CUDA
                      device, cuda exits non-zero instead of falling back
    --scan-iters N    (fast) run exactly N EM iterations (em_train_scan, no
                      host sync inside), skipping the convergence rule
    --cmvn global     (fast) train in globally mean/variance-normalized
                      feature space and de-normalize the exported model; EM
                      is equivariant under the affine map, so the exported
                      model and the reported mean probability (Jacobian-
                      corrected) are unchanged up to float rounding
    --checkpoint-dir D
                      (fast) checkpoint every EM iteration into D
                      (train/checkpoint.py train_fast_resumable); a rerun
                      with the same D resumes from its newest complete
                      checkpoint with the identical trajectory
    --stream-shards N (fast) split the batch into N host shards and stream
                      them through the device every iteration
                      (train/streaming.py train_streaming; the copy of
                      shard k+1 overlaps the E-step of shard k)

--scan-iters, --checkpoint-dir and --stream-shards are tried in that order;
the first one given picks the trainer.

With --numerics fast the CLI writes the JAX CLI's two JSONL events to
stderr (utils/logging.py EventLog): {"event": "train_fast", "seconds",
"word"} around the EM run and {"event": "converged", "iterations",
"mean_log_prob"} after it.

The reference's warm-start bug (argv[argc] off-by-one, T1:204, which made the
documented initial_model argument unusable) is fixed, not replicated.
"""

from __future__ import annotations

import argparse
import sys
import time

from .device import add_device_argument, resolve_device

USAGE = (
    "Usage: train word states_number param_number mix_number1 ... "
    "mix_numberN input_file1 ... input_fileN output_file [initial_model]"
)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(add_help=True)
    ap.add_argument("--cov", choices=["full", "diag"], default="full")
    ap.add_argument("--threshold", type=float, default=1.0e-3)
    ap.add_argument("--size-t-width", type=int, default=4)
    ap.add_argument("--numerics", choices=["parity", "fast"], default="parity")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--scan-iters", type=int, default=None)
    ap.add_argument("--cmvn", choices=["off", "global"], default="off")
    ap.add_argument("--stream-shards", type=int, default=None)
    add_device_argument(ap)
    ap.add_argument("rest", nargs=argparse.REMAINDER)
    ns = ap.parse_args(argv)
    rest = ns.rest
    if len(rest) < 5:
        print(USAGE, file=sys.stderr)
        return 1

    import numpy as np
    import torch

    from ..eval.report import (
        c_strftime_cpu,
        c_strftime_datetime,
        c_text_file_name,
        trainer_text_summary,
    )
    from ..init.lbg import create_initial_model
    from ..io import read_hmm, read_list, read_perfil, write_hmm
    from ..models.gmm_hmm import FINITE_PROBAB, GmmHmm, GmmStream, denormalize_model
    from ..train.em_parity import train_word_parity

    start_wall = time.time()
    starting_time = c_strftime_datetime(start_wall)

    word = rest[0]
    states_number = int(rest[1])
    param_number = int(rest[2])
    mixture_numbers = [int(x) for x in rest[3 : 3 + param_number]]
    data_files = rest[3 + param_number : 3 + 2 * param_number]
    output_file = rest[3 + 2 * param_number]
    initial_model = (
        rest[3 + 2 * param_number + 1] if len(rest) > 3 + 2 * param_number + 1 else None
    )

    if ns.numerics == "fast":
        from ..io.dataset import UtteranceBatch, load_batch

        device = resolve_device(ns.device, "train")
        if device is None:
            return 2
        # one pass over the files into padded float64 batches; the LBG init
        # takes per-utterance views of the same arrays
        batches_f64 = tuple(load_batch(df, dtype=torch.float64) for df in data_files)
        utterances_per_stream = [
            [b.features[i, : int(b.lengths[i])].numpy() for i in range(b.batch_size)]
            for b in batches_f64
        ]
        cmvn_stats = None
        cmvn_offset = 0.0
        cmvn_abs_floors = None
        cmvn_zd = None
        if ns.cmvn == "global":
            from ..features.frontend import global_cmvn_stats

            cmvn_stats = [global_cmvn_stats(b.features, b.lengths) for b in batches_f64]
            # the LBG init still runs on RAW utterances (its Euclidean metric
            # is not affine-equivariant); the raw-space initial model is
            # mapped into normalized space below.  Constant Jacobian
            # correction: log p_raw = log p_norm - frames * sum(log std) per
            # stream, applied inside the convergence rule and to every
            # reported probability
            cmvn_offset = -sum(
                int(b.lengths.sum()) * float(np.log(s).sum())
                for b, (_, s) in zip(batches_f64, cmvn_stats)
            )
            batches_f64 = tuple(
                UtteranceBatch((b.features - torch.as_tensor(m)) / torch.as_tensor(s), b.lengths)
                for b, (m, s) in zip(batches_f64, cmvn_stats)
            )
            # the reference's absolute 1e-5 variance floor and the
            # treat_zero_det trigger (log 1e-20) are raw-space quantities:
            # scale them with the transform
            cmvn_abs_floors = tuple(
                torch.as_tensor(FINITE_PROBAB / (s * s), dtype=torch.float32, device=device)
                for (_, s) in cmvn_stats
            )
            cmvn_zd = tuple(float(np.log(1e-20) - 2.0 * np.log(s).sum()) for (_, s) in cmvn_stats)
        # --stream-shards keeps the batch on the host: its shards go to the
        # device every iteration (the branches below take the first flag given)
        streaming = bool(ns.stream_shards) and not (ns.scan_iters or ns.checkpoint_dir)
        batches = tuple(
            UtteranceBatch(b.features.to(torch.float32), b.lengths) if streaming
            else UtteranceBatch(b.features.to(device=device, dtype=torch.float32), b.lengths.to(device))
            for b in batches_f64
        )
    else:
        utterances_per_stream = [[read_perfil(p) for p in read_list(df)] for df in data_files]

    if initial_model:
        model = read_hmm(initial_model)
        model = GmmHmm(trans=model.trans, streams=list(model.streams), word=word)
    else:
        model = create_initial_model(
            utterances_per_stream, states_number, mixture_numbers, word=word, cov_type=ns.cov,
        )

    print("\nCreating HMM using Forward-Backward algorithm (Baum-Welch)")
    if ns.numerics == "fast":
        from ..train.em import _fused_setup, em_train_scan, train_fast
        from ..train.em_parity import TrainResult
        from ..utils import EventLog

        log = EventLog()
        batch = batches[0] if len(batches) == 1 else batches
        if cmvn_stats is not None:
            # the initial model is in raw feature space; map it into the
            # normalized space of the batch (the inverse affine)
            model = denormalize_model(model, [(-m / s, 1.0 / s) for (m, s) in cmvn_stats])
        fast_model = model.astype(torch.float32).to(device)
        with log.span("train_fast", word=word):
            if ns.scan_iters:
                use_fused, feats_tdb, band = _fused_setup(fast_model, batch)
                final, lps, nvs = em_train_scan(
                    fast_model, batch, ns.scan_iters, feats_tdb, fused=use_fused, band=band,
                    abs_floors=cmvn_abs_floors, zero_det_thresholds=cmvn_zd,
                )
                lps_h = lps.cpu().numpy().astype(np.float64) + cmvn_offset
                nv = int(nvs.cpu().numpy()[-1])
                res = TrainResult(
                    model=final,
                    iterations=ns.scan_iters,
                    mean_log_prob=float(lps_h[-1]) / max(nv, 1),
                    exemplar_count=nv,
                    log_prob_history=[float(x) for x in lps_h],
                )
            elif ns.checkpoint_dir:
                from ..train.checkpoint import train_fast_resumable

                res = train_fast_resumable(
                    fast_model, batch, ns.checkpoint_dir, threshold=ns.threshold, log_prob_offset=cmvn_offset,
                )
            elif ns.stream_shards:
                from ..train.streaming import shard_batch, train_streaming

                res = train_streaming(
                    fast_model, shard_batch(batch, ns.stream_shards), threshold=ns.threshold,
                    log_prob_offset=cmvn_offset, abs_floors=cmvn_abs_floors, zero_det_thresholds=cmvn_zd,
                )
            else:
                res = train_fast(
                    fast_model, batch, threshold=ns.threshold, log_prob_offset=cmvn_offset,
                    abs_floors=cmvn_abs_floors, zero_det_thresholds=cmvn_zd,
                )
        log.emit("converged", iterations=res.iterations, mean_log_prob=res.mean_log_prob)
        if cmvn_stats is not None:
            # back to raw feature space (exact inverse affine); reported
            # probabilities already carry the Jacobian offset
            res.model = denormalize_model(res.model, cmvn_stats)

        # export in float64 (the file contract): the linear det recomputed
        # from log_det on the host
        def to_f64(s):
            def host(t):
                return t.detach().cpu().numpy().astype(np.float64)

            return GmmStream(
                weights=host(s.weights),
                means=host(s.means),
                inv_cov=host(s.inv_cov),
                det=np.exp(host(s.log_abs_det())),
                cov_type=s.cov_type,
            )

        res.model = GmmHmm(
            trans=res.model.trans.detach().cpu().numpy().astype(np.float64),
            streams=[to_f64(s) for s in res.model.streams],
            word=res.model.word,
        )
    else:
        res = train_word_parity(utterances_per_stream, model, threshold=ns.threshold)
    print(f"\nFinal model after {res.iterations} iterations, mean probability {res.mean_log_prob:f}")

    write_hmm(output_file, res.model, size_t_width=ns.size_t_width)

    text_file = c_text_file_name(output_file)
    cpu_seconds = time.process_time()
    with open(text_file, "w") as f:
        f.write(
            trainer_text_summary(
                model_file=output_file,
                word=word,
                states_number=states_number,
                param_number=param_number,
                mixture_numbers=mixture_numbers,
                data_files=data_files,
                threshold=ns.threshold,
                exemplar_number=res.exemplar_count,
                mean_probability=res.mean_log_prob,
                iterations=res.iterations,
                starting_time=starting_time,
                ending_time=c_strftime_datetime(),
                cpu_time=c_strftime_cpu(cpu_seconds),
                cov_type=ns.cov,
            )
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
