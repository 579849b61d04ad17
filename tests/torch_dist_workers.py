"""Rank code of the multi-rank CPU tests of srhmm_tpu_torch/parallel
(tests/test_torch_parallel_mesh.py, test_torch_sequence_parallel.py,
test_torch_distributed.py, test_torch_pipeline.py).  JAX-free: ``spawn``
re-imports the module that defines a rank's function, and the launcher runs
this file as a script:

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        tests/torch_dist_workers.py distributed OUT.pt

The inputs are numpy leaves from seeds, made by the functions below on the
ranks and again in the test process for the JAX side.  Each case returns
numpy arrays; the tests compare them with JAX in the parent process.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))  # torch_port_utils, under a launcher too

from torch_port_utils import rand_word, sample_utterance  # noqa: E402

from srhmm_tpu_torch.io.dataset import UtteranceBatch, pack_utterances  # noqa: E402
from srhmm_tpu_torch.models import gmm_hmm_from_numpy, init_left_right_trans, stack_models  # noqa: E402

TIMEOUT_S = 180.0  # a group of test ranks is killed after this long
REPO = Path(__file__).resolve().parent.parent


def launch(args, cwd, nproc: int = 2, timeout: float = TIMEOUT_S):
    """(exit code, stdout, stderr) of `args` run under the torch launcher
    (``python -m torch.distributed.run --standalone``, which picks its own
    free port) with nproc ranks; the whole process group is killed, and
    TimeoutError raised, when it outlives `timeout`."""
    import os
    import signal
    import subprocess

    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc-per-node={nproc}", *args]
    p = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise TimeoutError(f"{args} under the launcher outlived {timeout} s") from None
    return p.returncode, out, err

# ---------------------------------------------------------------------------
# inputs (numpy, from seeds)
# ---------------------------------------------------------------------------


def diag_stream(rng, S, M, D, mean_scale=2.0, uniform_weights=False) -> dict:
    """A diagonal stream drawn as tests/test_sharding.py draws its toy's."""
    means = rng.normal(size=(S, M, D)) * mean_scale
    var = rng.uniform(0.5, 1.5, size=(S, M, D))
    if uniform_weights:
        w = np.ones((S, M)) / M
    else:
        w = rng.uniform(0.3, 0.7, size=(S, M))
        w /= w.sum(-1, keepdims=True)
    return {"weights": w, "means": means, "inv_cov": 1.0 / var, "det": np.prod(var, -1), "log_det": None,
            "cov_type": "diag"}


def toy(seed=0, S=4, M=4, D=8, B=16):
    """tests/test_sharding.py's toy: (trans, [stream], utterances of 50 +
    3 i frames)."""
    rng = np.random.default_rng(seed)
    stream = diag_stream(rng, S, M, D)
    return init_left_right_trans(S).numpy(), [stream], [rng.normal(size=(50 + 3 * i, D)) for i in range(B)]


def composed_inputs():
    """tests/test_sharding.py test_fused_composed_sharded_matches_single_device:
    (unit words, transcripts, feats float32, lengths, state map of 6 senones)."""
    P, S, M, D, B, T, L = 4, 3, 2, 5, 8, 24, 3
    units = [(init_left_right_trans(S).numpy(), [diag_stream(np.random.default_rng(i), S, M, D, 3.0)])
             for i in range(P)]
    rng = np.random.default_rng(0)
    trs = rng.integers(0, P, size=(B, L)).astype(np.int32)
    feats = (rng.normal(size=(B, T, D)) * 2.0).astype(np.float32)
    lengths = np.asarray([T, T - 3, T, 9, T, T - 1, T, T - 5], np.int32)
    sm = rng.integers(0, 6, size=(P, S)).astype(np.int32)
    sm[0] = [0, 1, 2]
    return units, trs, feats, lengths, sm


def scan_inputs():
    """tests/test_sharding.py test_composed_sharded_scan_trajectory_matches_single_device."""
    P, S, M, D, B, T, L = 3, 3, 2, 5, 8, 32, 2
    units = [(init_left_right_trans(S).numpy(), [diag_stream(np.random.default_rng(i), S, M, D, 3.0, True)])
             for i in range(P)]
    rng = np.random.default_rng(5)
    trs = rng.integers(0, P, size=(B, L)).astype(np.int32)
    feats = rng.normal(size=(B, T, D)).astype(np.float32)
    lens = rng.integers(T // 2, T + 1, size=(B,)).astype(np.int32)
    sm = rng.integers(0, 5, size=(P, S)).astype(np.int32)
    sm[0] = [0, 1, 2]
    return units, trs, feats, lens, sm


TRAIN_P, TRAIN_S = 4, 3
TRAIN_TRANSCRIPTS = [[0, 1, 2], [2, 3, 0], [1, 0, 3], [3, 2, 1], [0, 3, 1], [2, 1]]
TIE_MAP = (np.arange(TRAIN_P * TRAIN_S) // 2).reshape(TRAIN_P, TRAIN_S).astype(np.int32)  # 2 states a senone


def train_inputs():
    """(unit words, start-mean noise, utterances, transcripts) of the
    composed trainers' tests: buckets of 5 and 1 utterances (3 and 2
    units), neither a multiple of 2 or 4 ranks."""
    words = [rand_word(20 + i, TRAIN_S, [(2, 5)], "diag", 1, scale=3.0) for i in range(TRAIN_P)]
    rng = np.random.default_rng(5)
    noise = rng.normal(size=(TRAIN_P, TRAIN_S, 2, 5)) * 0.5
    utts = [np.concatenate([sample_utterance(rng, *words[u], 3 * TRAIN_S)[0] for u in tr])
            for tr in TRAIN_TRANSCRIPTS]
    return words, noise, utts, TRAIN_TRANSCRIPTS


def sequence_problem(seed, T, S, B=None):
    """(log_b (T, S) or (B, T, S), log_trans (S, S)) float64 from a seed."""
    rng = np.random.default_rng(seed)
    log_b = rng.normal(size=(T, S) if B is None else (B, T, S)) * 3.0
    trans = init_left_right_trans(S).numpy()
    with np.errstate(divide="ignore"):
        return log_b, np.log(np.where(trans > 0, trans, 0.0))


SEQ_LENGTHS = (96, 61, 24, 10)  # over 4 x 24-frame blocks: an edge, inside blocks 2 and 0


def sequence_toy(seed=0, S=4, M=2, D=6, lengths=SEQ_LENGTHS):
    """tests/test_sequence_parallel.py's _toy_batch with one more utterance
    that ends inside the first block."""
    rng = np.random.default_rng(seed)
    stream = diag_stream(rng, S, M, D, 4.0)
    return init_left_right_trans(S).numpy(), [stream], [rng.normal(size=(T, D)) * 2.0 for T in lengths]


def sequence_scan_toy():
    """tests/test_sequence_parallel.py test_time_sharded_scan_matches_per_iteration_loop."""
    rng = np.random.default_rng(23)
    S, M, D, B, T = 5, 2, 6, 4, 64
    means = rng.normal(size=(S, M, D)) * 3.0
    var = rng.uniform(0.5, 1.5, size=(S, M, D))
    stream = {"weights": np.ones((S, M)) / M, "means": means, "inv_cov": 1.0 / var, "det": np.prod(var, -1),
              "log_det": None, "cov_type": "diag"}
    utts = [rng.normal(size=(T - 8 * (i % 2), D)) + means[np.minimum(np.arange(T - 8 * (i % 2)) * S // T, S - 1), 0]
            for i in range(B)]
    return init_left_right_trans(S).numpy(), [stream], utts


# ---------------------------------------------------------------------------
# port-side helpers
# ---------------------------------------------------------------------------


def model_leaves(model) -> list[np.ndarray]:
    out = [model.trans.detach().cpu().numpy()]
    for s in model.streams:
        out += [t.detach().cpu().numpy() for t in (s.weights, s.means, s.inv_cov, s.det, s.log_abs_det())]
    return out


STAT_NAMES = ("num_trans", "den_trans", "den_mix", "log_prob", "num_valid")
TIED_STAT_NAMES = ("w", "x", "xx", "den_mix", "num_trans", "den_trans", "log_prob", "num_valid")


def stats_dict(st) -> dict:
    """{name: numpy} of a SuffStats (stream fields as w0, x0, xx0, ...) or of
    the tied trainer's (StreamStats, den_mix, num_trans, den_trans,
    log_prob, num_valid) tuple (JAX's structures alike)."""
    if isinstance(st, tuple):
        vals = (st[0].w, st[0].x, st[0].xx) + tuple(st[1:])
        out = dict(zip(TIED_STAT_NAMES, vals))
    else:
        out = {k: getattr(st, k) for k in STAT_NAMES}
        for i, s in enumerate(st.streams):
            out.update({f"w{i}": s.w, f"x{i}": s.x, f"xx{i}": s.xx})
    return {k: np.asarray(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v) for k, v in out.items()}


def units_model(units, dtype=torch.float32):
    return stack_models([gmm_hmm_from_numpy(t, s, f"u{i}") for i, (t, s) in enumerate(units)]).astype(dtype)


def start_models(words, noise):
    """The composed trainers' start: the unit words with noisy means."""
    models = []
    for i, (trans, streams) in enumerate(words):
        st = dict(streams[0], means=streams[0]["means"] + noise[i])
        models.append(gmm_hmm_from_numpy(trans, [st], f"u{i}"))
    return stack_models(models).astype(torch.float32)


def _history(res) -> dict:
    return {"iterations": res.iterations, "history": np.asarray(res.log_prob_history),
            "num_valid": res.exemplar_count}


# ---------------------------------------------------------------------------
# test_torch_parallel_mesh.py: one group of 4 ranks
# ---------------------------------------------------------------------------

MESH_SHAPES = ((4, 1), (2, 2), (1, 4))


def mesh_cases(rank: int) -> dict:
    from srhmm_tpu_torch.decode.scorer import score_batch_sharded
    from srhmm_tpu_torch.models.tying import tie_from_models
    from srhmm_tpu_torch.parallel.mesh import em_step_sharded, gather_model, make_mesh, shard_batch, shard_model
    from srhmm_tpu_torch.train import embedded as emb
    from srhmm_tpu_torch.train import tied as td
    from srhmm_tpu_torch.train.em import (
        e_step_fused_lane_sharded,
        em_train_scan_sharded,
        m_step,
        train_fast,
    )

    out = {}
    trans, streams, utts = toy()
    model = gmm_hmm_from_numpy(trans, streams)
    batch = pack_utterances(utts, pad_multiple=16, dtype=torch.float64)
    for shape in MESH_SHAPES:
        mesh = make_mesh(*shape, device="cpu")
        new, lp, nv = em_step_sharded(shard_model(model, mesh), shard_batch(batch, mesh), mesh)
        out[f"em_{shape}"] = (model_leaves(gather_model(new, mesh)), float(lp), float(nv))

    dmesh = make_mesh(4, 1, device="cpu")
    try:
        shard_batch(UtteranceBatch(batch.features[:6], batch.lengths[:6]), dmesh)
        out["indivisible_raises"] = False
    except ValueError:
        out["indivisible_raises"] = True

    vocab = stack_models([gmm_hmm_from_numpy(trans, streams, f"w{i}") for i in range(8)])
    out["scores"] = score_batch_sharded(vocab, batch, dmesh).numpy()

    m32 = model.astype(torch.float32)
    b32 = UtteranceBatch(batch.features.float(), batch.lengths)
    out["fused_lane"] = stats_dict(e_step_fused_lane_sharded(m32, b32, dmesh))
    n_iters = 4
    final, lps, nvs = em_train_scan_sharded(m32, b32, n_iters, dmesh)
    cur, ref_lps = m32, []
    for _ in range(n_iters):
        st = e_step_fused_lane_sharded(cur, b32, dmesh)
        ref_lps.append(float(st.log_prob))
        cur = m_step(cur, st)
    out["scan"] = (lps.numpy(), nvs.numpy(), model_leaves(final), np.asarray(ref_lps), model_leaves(cur))
    res_dp = train_fast(m32, b32, max_iterations=6, data_mesh=dmesh)
    res_one = train_fast(m32, b32, max_iterations=6)
    out["train_fast"] = (_history(res_dp), model_leaves(res_dp.model), _history(res_one), model_leaves(res_one.model))

    units, trs, feats, lengths, sm = composed_inputs()
    um = units_model(units)
    trs_t, feats_t, len_t = torch.as_tensor(trs), torch.as_tensor(feats), torch.as_tensor(lengths)
    out["composed"] = stats_dict(emb.batch_stats_fused_sharded(um, trs_t, feats_t, len_t, dmesh))
    tied = tie_from_models(um, sm).astype(torch.float32)
    out["tied_composed"] = stats_dict(td.tied_batch_stats_fused_sharded(tied, trs_t, feats_t, len_t, dmesh))

    units, trs, feats, lens, sm = scan_inputs()
    um = units_model(units)
    packed = ((torch.as_tensor(trs), torch.as_tensor(feats), torch.as_tensor(lens)),)
    f_ref, l_ref, _ = emb._embedded_chunk(um, packed, 3, 0.0, True)
    f_got, l_got, _ = emb.embedded_train_scan_sharded(um, packed, 3, dmesh)
    out["embedded_scan"] = (l_got.numpy(), model_leaves(f_got), l_ref.numpy(), model_leaves(f_ref))
    tied = tie_from_models(um, sm).astype(torch.float32)
    t_ref, tl_ref, _ = td._tied_chunk(tied, packed, 3, 0.0, True)
    t_got, tl_got, _ = td.tied_train_scan_sharded(tied, packed, 3, dmesh)
    tied_leaves = lambda t: [x.detach().numpy() for x in (t.trans, t.senones.weights, t.senones.means,
                                                          t.senones.inv_cov)]
    out["tied_scan"] = (tl_got.numpy(), tied_leaves(t_got), tl_ref.numpy(), tied_leaves(t_ref))

    words, noise, utts, transcripts = train_inputs()
    start = start_models(words, noise)
    res = emb.train_embedded(start, utts, transcripts, threshold=-1.0, max_iterations=3, mesh=dmesh)
    out["train_embedded"] = (_history(res), model_leaves(res.model))
    tied0 = tie_from_models(start, TIE_MAP).astype(torch.float32)
    res = td.train_tied(tied0, utts, transcripts, threshold=-1.0, max_iterations=3, mesh=dmesh)
    out["train_tied"] = (_history(res), tied_leaves(res.model))
    return out


# ---------------------------------------------------------------------------
# test_torch_sequence_parallel.py: one group of 4 ranks
# ---------------------------------------------------------------------------


def sequence_cases(rank: int) -> dict:
    from srhmm_tpu_torch.parallel.sequence import (
        e_step_time_sharded,
        log_backward_time_sharded,
        log_forward_time_sharded,
        make_time_mesh,
        pad_time,
    )
    from srhmm_tpu_torch.train.em import em_step_time_sharded, em_train_scan_time_sharded, train_fast

    mesh = make_time_mesh(device="cpu")
    t = torch.as_tensor
    out = {}
    lb, lt = sequence_problem(0, 160, 6)
    out["forward"] = log_forward_time_sharded(t(lb), t(lt), mesh).numpy()
    lb, lt = sequence_problem(1, 160, 6)
    out["backward"] = log_backward_time_sharded(t(lb), t(lt), mesh).numpy()
    lb, lt = sequence_problem(2, 131, 5)
    lb_pad = pad_time(t(lb), 4 * 8)  # T = 160, 40 frames a rank
    out["padded"] = (log_forward_time_sharded(lb_pad, t(lt), mesh, length=131).numpy(),
                     log_backward_time_sharded(lb_pad, t(lt), mesh, length=131).numpy())
    lb, lt = sequence_problem(6, 160, 6, B=4)
    lens = t([160, 131, 17, 1])
    out["batched"] = (log_forward_time_sharded(t(lb), t(lt), mesh, length=lens).numpy(),
                      log_backward_time_sharded(t(lb), t(lt), mesh, length=lens).numpy())
    lb, lt = sequence_problem(4, 30, 4)
    try:
        log_forward_time_sharded(t(lb), t(lt), mesh)
        out["indivisible_raises"] = False
    except ValueError:
        out["indivisible_raises"] = True

    trans, streams, utts = sequence_toy()
    model = gmm_hmm_from_numpy(trans, streams)
    batch = pack_utterances(utts, pad_multiple=96, dtype=torch.float64)
    out["e_step"] = stats_dict(e_step_time_sharded(model, batch, mesh))

    trans, streams, utts = sequence_toy(seed=5, lengths=SEQ_LENGTHS[:3])
    model = gmm_hmm_from_numpy(trans, streams)
    batch = pack_utterances(utts, pad_multiple=96, dtype=torch.float64)
    res = train_fast(model, batch, max_iterations=4, time_mesh=mesh)
    out["train_fast"] = (_history(res), model_leaves(res.model))

    trans, streams, utts = sequence_scan_toy()
    model = gmm_hmm_from_numpy(trans, streams).astype(torch.float32)
    batch = pack_utterances(utts, pad_multiple=8, dtype=torch.float32)
    m1, lps_loop = model, []
    for _ in range(4):
        m1, lp, _ = em_step_time_sharded(m1, batch, mesh)
        lps_loop.append(float(lp))
    final, lps, _ = em_train_scan_time_sharded(model, batch, 4, mesh)
    res_sp = train_fast(model, batch, max_iterations=6, time_mesh=mesh)
    res_sd = train_fast(model, batch, max_iterations=6)
    out["scan"] = (lps.numpy(), np.asarray(lps_loop), model_leaves(final), model_leaves(m1),
                   _history(res_sp), float(res_sp.mean_log_prob), _history(res_sd), float(res_sd.mean_log_prob))
    return out


def failing_case(rank: int) -> None:
    """Rank 1 fails before the collective that rank 0 then waits in."""
    from srhmm_tpu_torch.parallel import distributed

    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    distributed.all_reduce(torch.ones(1), torch.distributed.group.WORLD)


# ---------------------------------------------------------------------------
# test_torch_pipeline.py: run_pipeline on a mesh of 2 ranks
# ---------------------------------------------------------------------------


def pipeline_case(rank: int, cfg, kwargs) -> dict:
    from srhmm_tpu_torch.parallel.mesh import make_mesh
    from srhmm_tpu_torch.pipeline import run_pipeline

    res = run_pipeline(cfg, mesh=make_mesh(device="cpu"), device="cpu", **kwargs)
    return {"hyps": res.hyps, "refs": res.refs, "wer": res.wer.wer, "n_senones": res.n_senones,
            "mono_log_prob": res.mono_log_prob, "tied_log_prob": res.tied_log_prob}


def tree_case(rank: int, models, utts, transcripts, units, cluster_kw) -> dict:
    """The tied-state tree on a mesh of 2 ranks, rank 1's copy of every
    frame one float32 ulp up: the all-reduced clustering statistics, the
    state map built from them, and this rank's own whole-batch statistics
    (no mesh) for contrast."""
    from srhmm_tpu_torch.models.decision_tree import state_stats_from_suffstats
    from srhmm_tpu_torch.parallel.mesh import make_mesh
    from srhmm_tpu_torch.pipeline import _bucketed_embedded_stats, tree_cluster

    if rank == 1:
        utts = [np.nextafter(np.asarray(u, np.float32), np.float32(np.inf)) for u in utts]
    mesh = make_mesh(device="cpu")
    shared = state_stats_from_suffstats(_bucketed_embedded_stats(models, utts, transcripts, mesh=mesh))
    own = state_stats_from_suffstats(_bucketed_embedded_stats(models, utts, transcripts))
    cluster = tree_cluster(models, utts, transcripts, units, mesh=mesh, **cluster_kw)
    return {"shared": [np.asarray(a) for a in shared], "own": [np.asarray(a) for a in own],
            "state_map": np.asarray(cluster.state_map)}


# ---------------------------------------------------------------------------
# test_torch_distributed.py: 2 ranks under torch.distributed.run
# ---------------------------------------------------------------------------

DIST_SHAPE = (4, 2, 6, 16)  # S, M, D, B of tests/test_distributed.py
FLOOR_ITERS = 4  # train_fast iterations of the floor cases


def floor_inputs(mesh_kind: str):
    """The float64 problem, padding and floors of a floor case: toy() on
    the data mesh, sequence_toy's three-utterance problem on the time mesh;
    an absolute variance floor of 0.05 a dim (above ~10 % of the unfloored
    variances) and a zero-det threshold of -12 (above the smallest log
    dets), both binding."""
    trans, streams, utts = toy() if mesh_kind == "data" else sequence_toy(seed=5, lengths=SEQ_LENGTHS[:3])
    D = streams[0]["means"].shape[-1]
    return trans, streams, utts, 16 if mesh_kind == "data" else 96, [np.full(D, 0.05)], [-12.0]


def floor_cases() -> dict:
    """train_fast(data_mesh=) and train_fast(time_mesh=) on the launcher's
    ranks with binding floors, float64 (the plain E-step on the CPU)."""
    from srhmm_tpu_torch.parallel.mesh import make_mesh
    from srhmm_tpu_torch.parallel.sequence import make_time_mesh
    from srhmm_tpu_torch.train.em import train_fast

    out = {}
    for kind, mesh_kw in (("data", {"data_mesh": make_mesh(device="cpu")}),
                          ("time", {"time_mesh": make_time_mesh(device="cpu")})):
        trans, streams, utts, pad, floors, zd = floor_inputs(kind)
        model = gmm_hmm_from_numpy(trans, streams)
        batch = pack_utterances(utts, pad_multiple=pad, dtype=torch.float64)
        res = train_fast(model, batch, max_iterations=FLOOR_ITERS, abs_floors=floors, zero_det_thresholds=zd,
                         **mesh_kw)
        out[kind] = (_history(res), model_leaves(res.model))
    return out


def dist_inputs():
    """tests/test_distributed.py's model (float32 there) and utterances."""
    S, M, D, B = DIST_SHAPE
    rng = np.random.default_rng(0)
    var = rng.uniform(0.5, 1.5, size=(S, M, D))
    w = rng.uniform(0.3, 0.7, size=(S, M))
    w /= w.sum(-1, keepdims=True)
    stream = {"weights": w, "means": rng.normal(size=(S, M, D)) * 2.0, "inv_cov": 1.0 / var,
              "det": np.prod(var, -1), "log_det": None, "cov_type": "diag"}
    utts = [rng.normal(size=(30 + i, D)) for i in range(B)]
    return init_left_right_trans(S).numpy(), [stream], utts


def distributed_main(out: str) -> None:
    """Under a launcher of 2 ranks: initialize from its environment, an
    e_step on each rank's half of the utterances all-reduced, and
    train_embedded on a 2-rank mesh with checkpoints: a run stopped after
    two iterations, then resumed to four, against an uninterrupted run of
    four.  The coordinator saves the results to `out`."""
    import os

    import torch.distributed as dist

    from srhmm_tpu_torch.parallel import distributed
    from srhmm_tpu_torch.parallel.mesh import all_reduce_stats, make_mesh, shard_batch
    from srhmm_tpu_torch.train.checkpoint import CheckpointManager
    from srhmm_tpu_torch.train.em import e_step
    from srhmm_tpu_torch.train.embedded import train_embedded

    distributed.initialize(device="cpu", timeout_s=TIMEOUT_S)
    try:
        res = {"world": distributed.world_size(), "initialized": dist.is_initialized(),
               "backend": dist.get_backend(), "rank": distributed.rank()}
        mesh = make_mesh(device="cpu")
        trans, streams, utts = dist_inputs()
        model = gmm_hmm_from_numpy(trans, streams).astype(torch.float32)
        half = len(utts) // 2
        mine = utts[distributed.rank() * half : (distributed.rank() + 1) * half]
        local = shard_batch(pack_utterances(mine, pad_multiple=8), mesh, local=True)
        st = all_reduce_stats(e_step(model, local), mesh.group("data"))
        res["e_step"] = {"log_prob": float(st.log_prob), "num_valid": float(st.num_valid),
                         "den_mix": st.den_mix.numpy()}

        ck = Path(out).parent / "ck"
        words, noise, utts, transcripts = train_inputs()
        start = start_models(words, noise)
        kw = dict(threshold=-1.0, chunk=2, mesh=mesh)
        whole = train_embedded(start, utts, transcripts, max_iterations=4, **kw)
        first = train_embedded(start, utts, transcripts, max_iterations=2, checkpoint_dir=ck, **kw)
        files_first = sorted(p.name for p in ck.iterdir())
        dist.barrier()
        again = train_embedded(start, utts, transcripts, max_iterations=4, checkpoint_dir=ck, **kw)
        res["checkpoint"] = {
            "whole": (_history(whole), model_leaves(whole.model)),
            "first": _history(first),
            "again": (_history(again), model_leaves(again.model)),
            "files_first": files_first,
            "files_again": sorted(p.name for p in ck.iterdir()),
            "writers": [bool(x) for x in distributed.all_gather(
                torch.tensor(CheckpointManager.should_write()), mesh.group("data"))],
        }
        res["floors"] = floor_cases()
        if distributed.is_coordinator():
            torch.save(res, out)
        else:
            assert os.environ["LOCAL_RANK"] == str(distributed.rank())
    finally:
        distributed.destroy()


if __name__ == "__main__":
    if sys.argv[1] == "distributed":
        distributed_main(sys.argv[2])
    else:
        raise SystemExit(f"unknown case {sys.argv[1]!r}")
