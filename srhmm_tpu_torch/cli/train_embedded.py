"""Production CLI of the embedded and tied-state trainers (counterpart of
``srhmm_tpu/cli/train_embedded.py``; the same flags and the same files):

    python -m srhmm_tpu_torch.cli.train_embedded TRANSCRIPTS OUTPUT_DIR
        [--states S] [--mix M] [--cov diag|full]
        [--tied] [--max-senones N] [--min-gain X] [--min-occ X]
        [--init DIR] [--threshold X] [--max-iters N] [--chunk K]
        [--pad-multiple N] [--var-floor X] [--size-t-width N]
        [--scan-iters N] [--cmvn off|global] [--checkpoint-dir D]
        [--device cuda|cpu]

TRANSCRIPTS: text file, one training utterance per line:

    path/to/features.perfil unit_a unit_b unit_c ...

Unit names of the form `left-center+right` are parsed as triphones (the
HTK-style convention), which enables `--tied` decision-tree clustering
across contexts; any other name is its own context-free unit.

Without --tied: embedded EM over the unit inventory (train/embedded.py,
the composed kernels of csrc/composed.cu on a card); OUTPUT_DIR gets one
reference-compatible `<unit>.hmm` per unit plus `summary.json`.

With --tied: the units ARE the inventory (monophone-cloned triphone
seeding is the caller's); per-(unit, state) statistics from one embedded
E-step feed the phonetic decision tree (models/decision_tree.py), the tied
system trains with train/tied.train_tied, and OUTPUT_DIR gets the
materialized per-unit `.hmm` files plus `senone_map.json` (unit -> senone
ids) and `summary.json`.

--checkpoint-dir enables chunk-granular checkpoint / resume through the
chunked convergence driver for both trainers: a killed run re-invoked with
the same command line resumes from the newest complete checkpoint with the
identical trajectory.
--init DIR warm-starts each unit from DIR/<unit>.hmm instead of the LBG
flat start.  --device (default cuda) says where EM runs; without a CUDA
device, cuda exits 2 instead of falling back to the CPU.

--data-parallel N trains data-parallel over N ranks, one process each,
started by a launcher (parallel/distributed.py):

    torchrun --standalone --nproc-per-node N \
        -m srhmm_tpu_torch.cli.train_embedded TRANSCRIPTS OUTPUT_DIR --data-parallel N

Each rank reads the whole input and trains on its rows of every bucket on
its own device (cuda:LOCAL_RANK, or the CPU with --device cpu; nccl when
every rank has a card, gloo otherwise); only the coordinator writes
OUTPUT_DIR and checkpoints.  Without a launcher of N ranks the CLI exits 2.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from .device import add_device_argument, data_parallel_mesh, resolve_device


def read_transcripts(path: str):
    """[(perfil_path, [unit names...])] from a transcript file: one
    utterance per line, ``path/to/features.perfil unit_a unit_b ...``;
    blank lines and lines starting with # are skipped."""
    items = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) < 2:
            raise ValueError(f"transcript line needs a path and units: {line!r}")
        items.append((parts[0], parts[1:]))
    return items


def parse_triphone(name: str):
    """`l-c+r` -> (l, c, r); bare names -> ('', name, '')."""
    if "-" in name and "+" in name and name.index("-") < name.index("+"):
        left, rest = name.split("-", 1)
        center, right = rest.split("+", 1)
        return (left, center, right)
    return ("", name, "")


def flat_start_units(unit_names, feats, transcripts, states: int, mix: int, cov: str):
    """LBG flat start for an arbitrary unit inventory: uniform segmentation
    of each utterance over its transcript positions, then per-unit LBG init
    (init/lbg.py create_initial_model).  A CPU float64 stacked GmmHmm."""
    import numpy as np

    from ..init.lbg import create_initial_model
    from ..models import stack_models

    segments = {u: [] for u in unit_names}
    for f, seq in zip(feats, transcripts):
        bounds = np.linspace(0, len(f), len(seq) + 1).astype(int)
        for k, u in enumerate(seq):
            seg = f[bounds[k] : bounds[k + 1]]
            if len(seg) >= states:
                segments[u].append(np.asarray(seg, np.float64))
    models = []
    for u in unit_names:
        if not segments[u]:
            raise SystemExit(f"unit {u!r} has no usable training segments")
        models.append(create_initial_model([segments[u]], states, [mix], word=u, cov_type=cov))
    return stack_models(models)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("transcripts")
    ap.add_argument("output_dir")
    ap.add_argument("--states", type=int, default=3)
    ap.add_argument("--mix", type=int, default=2)
    ap.add_argument("--cov", choices=["diag", "full"], default="diag")
    ap.add_argument("--tied", action="store_true")
    ap.add_argument("--max-senones", type=int, default=None)
    ap.add_argument("--min-gain", type=float, default=200.0)
    ap.add_argument("--min-occ", type=float, default=40.0)
    ap.add_argument("--init", default=None, metavar="DIR")
    ap.add_argument("--threshold", type=float, default=1.0e-3)
    ap.add_argument("--max-iters", type=int, default=50)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="checkpoint every EM chunk into this directory and resume from it")
    ap.add_argument("--data-parallel", type=int, default=None, metavar="N",
                    help="data-parallel EM over N ranks of a launcher (torchrun --nproc-per-node N)")
    ap.add_argument("--pad-multiple", type=int, default=32)
    ap.add_argument(
        "--var-floor", type=float, default=0.0,
        help="relative variance floor on top of the reference's absolute 1e-5",
    )
    ap.add_argument("--size-t-width", type=int, default=4)
    ap.add_argument(
        "--scan-iters", type=int, default=None, metavar="N",
        help="fixed-budget mode: run exactly N EM iterations, skipping the reference "
        "convergence rule",
    )
    ap.add_argument(
        "--cmvn", choices=["off", "global"], default="off",
        help="train in globally mean/variance-normalized feature space and de-normalize "
        "the exported models (EM is affine-equivariant)",
    )
    add_device_argument(ap)
    ns = ap.parse_args(argv)
    device = resolve_device(ns.device, "train_embedded")
    if device is None:
        return 2
    if ns.data_parallel is None:
        return _run(ns, device, None)
    mesh = data_parallel_mesh(ns.data_parallel, ns.device, "train_embedded")
    if mesh is None:
        return 2
    from ..parallel import distributed

    try:
        return _run(ns, mesh.device, mesh)
    finally:
        distributed.destroy()


def _run(ns, device, mesh) -> int:
    import numpy as np
    import torch

    from ..io import read_hmm, read_perfil, write_hmm
    from ..models import GmmHmm, GmmStream, stack_models

    t0 = time.time()
    items = read_transcripts(ns.transcripts)
    unit_names = sorted({u for _, seq in items for u in seq})
    uidx = {u: i for i, u in enumerate(unit_names)}
    feats = [np.asarray(read_perfil(p), np.float32) for p, _ in items]
    transcripts_named = [seq for _, seq in items]
    transcripts = [[uidx[u] for u in seq] for seq in transcripts_named]

    cmvn_stats = None
    lp_offset = 0.0
    if ns.cmvn == "global":
        allf = np.concatenate([np.asarray(f, np.float64) for f in feats], 0)
        g_mean = allf.mean(0)
        g_std = np.maximum(allf.std(0), 1e-8)
        # constant Jacobian correction applied INSIDE the convergence rule
        # (the reference's relative-change test is not shift-invariant)
        lp_offset = -float(sum(len(f) for f in feats) * np.log(g_std).sum())
        feats = [((f - g_mean) / g_std).astype(np.float32) for f in feats]
        cmvn_stats = (g_mean, g_std)

    if ns.init:
        warm = [read_hmm(str(Path(ns.init) / f"{u}.hmm")) for u in unit_names]
        models = stack_models([GmmHmm(trans=m.trans, streams=list(m.streams), word=u)
                               for u, m in zip(unit_names, warm)])
    else:
        models = flat_start_units(unit_names, feats, transcripts_named, ns.states, ns.mix, ns.cov)
    models = models.astype(torch.float32).to(device)

    from ..parallel.distributed import is_coordinator

    write = is_coordinator()  # one writer under a launcher of several ranks
    out_dir = Path(ns.output_dir)
    summary = {
        "units": unit_names,
        "n_utterances": len(items),
        "states": ns.states,
        "mix": ns.mix,
        "cov": ns.cov,
    }
    threshold, max_iters, chunk = (
        (-1.0, ns.scan_iters, ns.scan_iters) if ns.scan_iters else (ns.threshold, ns.max_iters, ns.chunk)
    )
    if ns.tied:
        from ..models.tying import tie_from_models
        from ..pipeline import tree_cluster
        from ..train.tied import train_tied

        tris = [parse_triphone(u) for u in unit_names]
        cluster = tree_cluster(
            models, feats, transcripts, tris, pad_multiple=ns.pad_multiple, mesh=mesh,
            min_occ=ns.min_occ, min_gain=ns.min_gain, max_senones=ns.max_senones,
        )
        tied0 = tie_from_models(models, cluster.state_map).astype(torch.float32)
        res = train_tied(
            tied0, feats, transcripts, threshold=threshold, max_iterations=max_iters,
            var_floor=ns.var_floor, log_prob_offset=lp_offset, pad_multiple=ns.pad_multiple,
            chunk=chunk, checkpoint_dir=ns.checkpoint_dir, mesh=mesh,
        )
        trained = res.model
        unit_models = trained.materialize()
        state_map = trained.state_map.cpu().numpy()
        summary.update(n_senones=int(trained.num_senones), senone_map_file="senone_map.json")
        senone_map = json.dumps({u: state_map[i].tolist() for i, u in enumerate(unit_names)})
    else:
        from ..train.embedded import train_embedded

        res = train_embedded(
            models, feats, transcripts, threshold=threshold, max_iterations=max_iters,
            var_floor=ns.var_floor, log_prob_offset=lp_offset, pad_multiple=ns.pad_multiple,
            chunk=chunk, checkpoint_dir=ns.checkpoint_dir, mesh=mesh,
        )
        unit_models = res.model
        senone_map = None

    if cmvn_stats is not None:
        # back to raw feature space (exact inverse affine; the reported
        # probabilities already carry the Jacobian offset)
        from ..models.gmm_hmm import denormalize_model

        unit_models = denormalize_model(unit_models, [cmvn_stats])

    summary.update(
        iterations=res.iterations,
        mean_log_prob=float(res.mean_log_prob),
        wall_seconds=round(time.time() - t0, 2),
        tied=bool(ns.tied),
    )
    if mesh is not None:
        summary.update(data_parallel=mesh.size("data"))
    if not write:
        return 0
    out_dir.mkdir(parents=True, exist_ok=True)
    if senone_map is not None:
        (out_dir / "senone_map.json").write_text(senone_map)

    # export: one reference-compatible .hmm per unit in float64 (the file
    # contract), the linear det recomputed from log|det| on the host
    def host(t):
        return t.detach().cpu().numpy().astype(np.float64)

    trans = host(unit_models.trans)
    leaves = [(host(s.weights), host(s.means), host(s.inv_cov), np.exp(host(s.log_abs_det())), s.cov_type)
              for s in unit_models.streams]
    for i, u in enumerate(unit_names):
        streams = [GmmStream(weights=w[i], means=mu[i], inv_cov=ic[i], det=det[i], cov_type=cov)
                   for w, mu, ic, det, cov in leaves]
        write_hmm(str(out_dir / f"{u}.hmm"), GmmHmm(trans=trans[i], streams=streams, word=u),
                  size_t_width=ns.size_t_width)
    (out_dir / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
