"""The training slice as a whole: the port's train CLI against the JAX one
on the same generated .perfil files.

--numerics parity: byte-identical .hmm files and .txt summaries identical
apart from the time lines.  --numerics fast --scan-iters 4 on the CPU, with
and without --cmvn global: the models agree at rtol 1e-4 (a fixed iteration
budget keeps a threshold flip out of the comparison).  Usage errors exit
non-zero; --checkpoint-dir and --stream-shards train as the JAX CLI does;
no srhmm_tpu_torch module of the slice imports jax.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import srhmm_tpu.cli.train as j_cli
import srhmm_tpu.io as jio
import srhmm_tpu_torch.cli.train as t_cli
import srhmm_tpu_torch.io as tio
from torch_port_utils import rand_word, sample_utterance

REPO = Path(__file__).resolve().parent.parent


def _fixture(tmp_path, cov, mixes_dims, n=6, scale=2.0, offset=40.0):
    """.perfil files sampled from a random word, one list file per stream;
    returns the list file names."""
    trans, streams = rand_word(70, 4, mixes_dims, cov, scale=scale)
    rng = np.random.default_rng(71)
    lists = []
    for p, st in enumerate(streams):
        st["means"] = st["means"] + offset * (p + 1)  # .perfil-like offsets
    utts = [sample_utterance(rng, trans, streams, 18 + 3 * i) for i in range(n)]
    for p in range(len(streams)):
        names = []
        for i, u in enumerate(utts):
            tio.write_perfil(tmp_path / f"s{p}_{i}.perfil", u[p])
            names.append(f"s{p}_{i}.perfil")
        (tmp_path / f"list{p}.txt").write_text("\n".join(names) + "\n")
        lists.append(f"list{p}.txt")
    return lists


def _args(mixes_dims, lists, out):
    return ["w", "4", str(len(lists)), *(str(m) for m, _ in mixes_dims), *lists, out]


def _summary(path):
    return [l for l in Path(path).read_text().splitlines() if "time:" not in l]


@pytest.mark.parametrize("cov,mixes_dims", [("full", [(1, 3)]), ("diag", [(2, 3), (1, 2)])])
def test_parity_cli_writes_the_jax_files(tmp_path, monkeypatch, capsys, cov, mixes_dims):
    lists = _fixture(tmp_path, cov, mixes_dims)
    monkeypatch.chdir(tmp_path)
    flags = ["--cov", cov, "--numerics", "parity"]
    assert j_cli.main(flags + _args(mixes_dims, lists, "jax.hmm")) == 0
    out_j = capsys.readouterr().out
    assert t_cli.main(flags + _args(mixes_dims, lists, "torch.hmm")) == 0
    out_t = capsys.readouterr().out
    assert (tmp_path / "torch.hmm").read_bytes() == (tmp_path / "jax.hmm").read_bytes()
    assert _summary("torch.txt") == [l.replace("jax.hmm", "torch.hmm") for l in _summary("jax.txt")]
    final = [l for l in out_j.splitlines() if l.startswith("Final model")]
    assert final and final == [l for l in out_t.splitlines() if l.startswith("Final model")]


@pytest.mark.parametrize("cmvn,offset", [("off", 0.0), ("global", 40.0)])
def test_fast_cli_matches_jax(tmp_path, monkeypatch, cmvn, offset):
    # float32 statistics at raw feature offsets are what --cmvn global is for
    mixes_dims = [(2, 3)]
    lists = _fixture(tmp_path, "diag", mixes_dims, n=8, offset=offset)
    monkeypatch.chdir(tmp_path)
    flags = ["--cov", "diag", "--numerics", "fast", "--scan-iters", "4", "--cmvn", cmvn]
    assert j_cli.main(flags + _args(mixes_dims, lists, "jax.hmm")) == 0
    assert t_cli.main(flags + ["--device", "cpu"] + _args(mixes_dims, lists, "torch.hmm")) == 0
    mj, mt = jio.read_hmm("jax.hmm"), tio.read_hmm("torch.hmm")
    np.testing.assert_allclose(mt.trans.numpy(), np.asarray(mj.trans), rtol=1e-4, atol=1e-6)
    for sj, st in zip(mj.streams, mt.streams):
        for name in ("weights", "means", "inv_cov", "det"):
            np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(sj, name)), rtol=1e-4)
    want = {l.split(":")[0]: l for l in _summary("jax.txt")}
    got = {l.split(":")[0]: l for l in _summary("torch.txt")}
    assert want.keys() == got.keys()
    key = next(k for k in want if "mean probability" in k)
    lp_j, lp_t = (float(d[key].split(":")[1]) for d in (want, got))
    np.testing.assert_allclose(lp_t, lp_j, rtol=1e-4)


def _events(err):
    """{event name: its keys but the time} of the JSONL lines on stderr."""
    import json

    out = {}
    for line in err.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            out[rec["event"]] = sorted(k for k in rec if k != "t")
    return out


@pytest.mark.parametrize("scan_iters", [None, "3"])
def test_fast_cli_writes_the_jax_events(tmp_path, monkeypatch, capsys, scan_iters):
    """--numerics fast: the port writes the JAX CLI's JSONL events to stderr,
    a train_fast span (seconds, word) and converged (iterations,
    mean_log_prob), with the same keys."""
    lists = _fixture(tmp_path, "diag", [(1, 3)], n=4)
    monkeypatch.chdir(tmp_path)
    flags = ["--cov", "diag", "--numerics", "fast"] + (["--scan-iters", scan_iters] if scan_iters else [])
    assert j_cli.main(flags + _args([(1, 3)], lists, "jax.hmm")) == 0
    j_events = _events(capsys.readouterr().err)
    assert t_cli.main(flags + ["--device", "cpu"] + _args([(1, 3)], lists, "torch.hmm")) == 0
    t_events = _events(capsys.readouterr().err)
    assert j_events == {"train_fast": ["event", "seconds", "word"],
                        "converged": ["event", "iterations", "mean_log_prob"]}
    assert t_events == j_events


def _iterations(summary):
    return next(l for l in _summary(summary) if "iterations" in l.lower())


def test_cli_usage_errors_and_flags_not_ported(tmp_path, monkeypatch, capsys):
    """Usage errors exit 1; --checkpoint-dir and --stream-shards, once
    refused, now train as the JAX CLI does (its models within the fast
    CLI's rtol 1e-4, and atol 1e-4 of each leaf's scale for the means near
    0 after seven iterations; the same iterations), and a second --checkpoint-dir
    run resumes from the converged checkpoint to the same .hmm bytes."""
    assert t_cli.main([]) == 1
    assert "Usage: train" in capsys.readouterr().err
    mixes_dims = [(2, 3)]
    lists = _fixture(tmp_path, "diag", mixes_dims, n=8, offset=0.0)
    monkeypatch.chdir(tmp_path)
    fast = ["--cov", "diag", "--numerics", "fast"]
    for name, flag in (("ck", ["--checkpoint-dir"]), ("st", ["--stream-shards", "3"])):
        jflag = flag + ([f"{name}_jax"] if name == "ck" else [])
        tflag = flag + ([f"{name}_torch"] if name == "ck" else [])
        assert j_cli.main(fast + jflag + _args(mixes_dims, lists, f"{name}_jax.hmm")) == 0
        assert t_cli.main(fast + tflag + ["--device", "cpu"] + _args(mixes_dims, lists, f"{name}_torch.hmm")) == 0
        mj, mt = jio.read_hmm(f"{name}_jax.hmm"), tio.read_hmm(f"{name}_torch.hmm")
        np.testing.assert_allclose(mt.trans.numpy(), np.asarray(mj.trans), rtol=1e-4, atol=1e-6)
        for leaf in ("weights", "means", "inv_cov", "det"):
            want = np.asarray(getattr(mj.streams[0], leaf))
            np.testing.assert_allclose(getattr(mt.streams[0], leaf).numpy(), want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max())
        assert _iterations(f"{name}_torch.txt") == _iterations(f"{name}_jax.txt")
    assert sorted(p.name for p in (tmp_path / "ck_torch").glob("*.json"))
    first = (tmp_path / "ck_torch.hmm").read_bytes()
    assert t_cli.main(fast + ["--checkpoint-dir", "ck_torch", "--device", "cpu"]
                      + _args(mixes_dims, lists, "ck_torch.hmm")) == 0
    assert (tmp_path / "ck_torch.hmm").read_bytes() == first
    capsys.readouterr()


def test_train_slice_imports_no_jax():
    code = (
        "import sys\n"
        "import srhmm_tpu_torch.cli.train, srhmm_tpu_torch.train.em, srhmm_tpu_torch.train.driver\n"
        "import srhmm_tpu_torch.ops.kernels.fused_em, srhmm_tpu_torch.init, srhmm_tpu_torch.features\n"
        "import srhmm_tpu_torch.ops.linalg_parity, srhmm_tpu_torch.train.em_parity\n"
        "import srhmm_tpu_torch.train.checkpoint, srhmm_tpu_torch.train.streaming, srhmm_tpu_torch.io.pipeline\n"
        "import srhmm_tpu_torch.io.native_loader, srhmm_tpu_torch.utils.profiling\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'srhmm_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
