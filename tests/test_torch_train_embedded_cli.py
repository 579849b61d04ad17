"""Embedded / tied training, part 4: the port's train_embedded CLI (with
--device cpu) against the JAX CLI on the same transcript and .perfil files,
without and with --tied.

Both CLIs run the same flat start (the LBG init is a port of the JAX one)
and the plain EM path in float32; the exported .hmm files agree within
trans atol 1e-5 and means rtol 2e-3 (the trajectory bounds of
tests/test_embedded.py:251-258), senone_map.json is identical, and
summary.json has the same keys and iteration count.  --data-parallel 2
under torch.distributed.run writes the one-process CLI's models to the same
bounds.
"""

import json
from pathlib import Path

import numpy as np
import pytest

import srhmm_tpu.cli.train_embedded as j_cli
import srhmm_tpu_torch.cli.train_embedded as t_cli
import srhmm_tpu_torch.io as tio
from torch_port_utils import rand_word, sample_utterance

S = 3
UNITS = ["a", "b", "c", "d"]
TRIPHONES = ["sil-a+b", "a-b+c", "b-c+sil", "sil-b+a", "b-a+d", "a-d+sil"]


def _fixture(root: Path, names, seqs, seed=0):
    """One .perfil per transcript (units sampled from random word models
    keyed by center phone) and the transcript file."""
    rng = np.random.default_rng(seed)
    models = {u: rand_word(70 + i, S, [(2, 3)], "diag", scale=3.0) for i, u in enumerate(UNITS)}
    lines = []
    for i, seq in enumerate(seqs):
        frames = np.concatenate([sample_utterance(rng, *models[t_cli.parse_triphone(names[k])[1]], 3 * S)[0]
                                 for k in seq])
        tio.write_perfil(root / f"u{i:02d}.perfil", frames)
        lines.append(f"u{i:02d}.perfil " + " ".join(names[k] for k in seq))
    (root / "trans.txt").write_text("# path units\n" + "\n".join(lines) + "\n")


def _check_same_models(root: Path, names, tied: bool):
    sj = json.loads((root / "jax" / "summary.json").read_text())
    st = json.loads((root / "torch" / "summary.json").read_text())
    assert sorted(sj) == sorted(st)
    assert st["iterations"] == sj["iterations"] and st["units"] == sj["units"] == sorted(names)
    np.testing.assert_allclose(st["mean_log_prob"], sj["mean_log_prob"], rtol=2e-4)
    for u in names:
        hj, ht = tio.read_hmm(root / "jax" / f"{u}.hmm"), tio.read_hmm(root / "torch" / f"{u}.hmm")
        assert ht.word == hj.word == u
        np.testing.assert_allclose(ht.trans.numpy(), hj.trans.numpy(), atol=1e-5)
        np.testing.assert_allclose(ht.streams[0].means.numpy(), hj.streams[0].means.numpy(), rtol=2e-3,
                                   atol=2e-3)
    if tied:
        assert (root / "torch" / "senone_map.json").read_text() == (root / "jax" / "senone_map.json").read_text()
        assert st["n_senones"] == sj["n_senones"]


@pytest.mark.parametrize("tied,extra", [(False, []), (True, []), (False, ["--cmvn", "global"])])
def test_train_embedded_cli_matches_jax(tmp_path, monkeypatch, capsys, tied, extra):
    if tied:
        names = TRIPHONES
        seqs = [[0, 1, 2], [3, 4, 5], [0, 1, 2], [3, 4, 5], [1, 2], [4, 5], [0, 1], [3, 4],
                [0, 1, 2], [3, 4, 5], [1, 2], [4, 5]]
        flags = ["--tied", "--min-occ", "10", "--min-gain", "30", "--max-iters", "4"]
    else:
        names = UNITS
        seqs = [[0, 1, 2], [2, 3, 0], [1, 0, 3], [3, 2, 1], [0, 2], [1, 3], [2, 0, 1], [3, 1, 0],
                [0, 3], [2, 1], [1, 2, 3], [0, 1, 2, 3]]
        flags = ["--max-iters", "6", "--pad-multiple", "16"] + extra
    _fixture(tmp_path, names, seqs)
    monkeypatch.chdir(tmp_path)
    assert j_cli.main(["trans.txt", "jax"] + flags) == 0
    assert t_cli.main(["trans.txt", "torch", "--device", "cpu"] + flags) == 0
    _check_same_models(tmp_path, names, tied)
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(printed)["tied"] is tied


def test_train_embedded_cli_refuses_what_is_not_ported(tmp_path, monkeypatch, capsys):
    """--data-parallel N without a launcher of N ranks is refused (exit 2,
    the launcher named); --checkpoint-dir trains, and a second run with the
    same directory resumes to the same .hmm files."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    (tmp_path / "one.txt").write_text("u.perfil a\n")
    assert t_cli.main([str(tmp_path / "one.txt"), str(tmp_path / "out"), "--device", "cpu",
                       "--data-parallel", "2"]) == 2
    err = capsys.readouterr().err
    assert "--data-parallel 2 needs a launcher of 2 ranks" in err and "torchrun" in err
    assert not (tmp_path / "out").exists()
    _fixture(tmp_path, UNITS, [[0, 1, 2], [2, 3, 0], [1, 0, 3], [3, 2, 1], [0, 2], [1, 3]])
    monkeypatch.chdir(tmp_path)
    flags = ["--device", "cpu", "--max-iters", "4", "--chunk", "2", "--checkpoint-dir", "ck"]
    assert t_cli.main(["trans.txt", "first"] + flags) == 0
    assert sorted(p.name for p in (tmp_path / "ck").glob("*.json"))
    assert t_cli.main(["trans.txt", "again"] + flags) == 0
    for u in UNITS:
        assert (tmp_path / "again" / f"{u}.hmm").read_bytes() == (tmp_path / "first" / f"{u}.hmm").read_bytes()
    runs = [json.loads((tmp_path / d / "summary.json").read_text()) for d in ("first", "again")]
    assert runs[0]["iterations"] == runs[1]["iterations"]
    capsys.readouterr()
    assert t_cli.parse_triphone("l-c+r") == ("l", "c", "r") and t_cli.parse_triphone("ab") == ("", "ab", "")


@pytest.mark.parametrize("tied", [False, True])
def test_train_embedded_cli_data_parallel_matches_one_process(tmp_path, monkeypatch, tied):
    """--data-parallel 2 under torch.distributed.run (2 CPU ranks, gloo):
    the coordinator alone writes OUTPUT_DIR, whose models agree with the
    one-process CLI's within rtol 2e-3 (the file's trajectory bound; the
    float32 statistics summed in another order), the zeros of the
    transitions kept (atol 1e-5)."""
    import torch_dist_workers as w

    if tied:
        names = TRIPHONES
        seqs = [[0, 1, 2], [3, 4, 5], [0, 1, 2], [3, 4, 5], [1, 2], [4, 5], [0, 1], [3, 4], [0, 1, 2]]
        flags = ["--tied", "--min-occ", "10", "--min-gain", "30", "--max-iters", "4"]
    else:
        names = UNITS
        seqs = [[0, 1, 2], [2, 3, 0], [1, 0, 3], [3, 2, 1], [0, 2], [1, 3], [2, 0, 1]]
        flags = ["--max-iters", "5", "--pad-multiple", "16"]
    _fixture(tmp_path, names, seqs)
    monkeypatch.chdir(tmp_path)
    assert t_cli.main(["trans.txt", "one", "--device", "cpu"] + flags) == 0
    rc, out, err = w.launch(["-m", "srhmm_tpu_torch.cli.train_embedded", "trans.txt", "dp", "--device", "cpu",
                             "--data-parallel", "2"] + flags, tmp_path)
    assert rc == 0, err[-4000:]
    assert len([line for line in out.splitlines() if line.startswith("{")]) == 1  # the coordinator's
    s1 = json.loads((tmp_path / "one" / "summary.json").read_text())
    s2 = json.loads((tmp_path / "dp" / "summary.json").read_text())
    assert s2.pop("data_parallel") == 2 and sorted(s1) == sorted(s2)
    assert s2["iterations"] == s1["iterations"] and s2["tied"] is tied
    np.testing.assert_allclose(s2["mean_log_prob"], s1["mean_log_prob"], rtol=2e-4)
    for u in names:
        h1, h2 = tio.read_hmm(tmp_path / "one" / f"{u}.hmm"), tio.read_hmm(tmp_path / "dp" / f"{u}.hmm")
        np.testing.assert_allclose(h2.trans.numpy(), h1.trans.numpy(), rtol=2e-3, atol=1e-5)
        np.testing.assert_allclose(h2.streams[0].means.numpy(), h1.streams[0].means.numpy(), rtol=2e-3, atol=2e-3)
    if tied:
        assert (tmp_path / "dp" / "senone_map.json").read_text() == (tmp_path / "one" / "senone_map.json").read_text()
