"""Embedded / tied training, part 4: the port's train_embedded CLI (with
--device cpu) against the JAX CLI on the same transcript and .perfil files,
without and with --tied.

Both CLIs run the same flat start (the LBG init is a port of the JAX one)
and the plain EM path in float32; the exported .hmm files agree within
trans atol 1e-5 and means rtol 2e-3 (the trajectory bounds of
tests/test_embedded.py:251-258), senone_map.json is identical, and
summary.json has the same keys and iteration count.
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


def test_train_embedded_cli_refuses_what_is_not_ported(tmp_path, capsys):
    (tmp_path / "trans.txt").write_text("u.perfil a\n")
    for flag in (["--checkpoint-dir", "ck"], ["--data-parallel", "2"]):
        assert t_cli.main([str(tmp_path / "trans.txt"), str(tmp_path / "out"), "--device", "cpu"] + flag) == 2
        assert "not ported" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()
    assert t_cli.parse_triphone("l-c+r") == ("l", "c", "r") and t_cli.parse_triphone("ab") == ("", "ab", "")
