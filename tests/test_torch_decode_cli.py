"""Continuous decoding, part 3: the port's decode and align CLIs against
the JAX CLIs on the same .hmm / .perfil / LM / transcript files (the port
with --device cpu), and the --device cuda refusal of every port CLI on a
host without a CUDA device.

Both CLIs write identical files (decode: paths, scores, word sequences,
N-best ranks and the WER line; align: the unit spans) and return the same
exit codes.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import srhmm_tpu.cli.align as j_align
import srhmm_tpu.cli.decode as j_decode
import srhmm_tpu_torch.cli.align as t_align
import srhmm_tpu_torch.cli.decode as t_decode
import srhmm_tpu_torch.cli.recognize as t_recognize
import srhmm_tpu_torch.cli.train as t_train
import srhmm_tpu_torch.cli.train_embedded as t_train_embedded
import srhmm_tpu_torch.io as tio
from srhmm_tpu_torch.cli.train_embedded import read_transcripts
from srhmm_tpu_torch.models import gmm_hmm_from_numpy
from torch_port_utils import rand_word, sample_utterance


def _fixture(root: Path, W=4, S=4, n=6, seed=0):
    """W word models, n utterances of 2-3 words each, the list files, a
    reference file, unigram and bigram LM files, and transcripts."""
    rng = np.random.default_rng(seed)
    words = [rand_word(60 + i, S, [(2, 3)], "diag", scale=3.0) for i in range(W)]
    names = [f"word{i}" for i in range(W)]
    for (trans, streams), name in zip(words, names):
        tio.write_hmm(root / f"{name}.hmm", gmm_hmm_from_numpy(trans, streams, name))
    (root / "models.txt").write_text("".join(f"{n}.hmm\n" for n in names))
    refs = []
    for i in range(n):
        seq = [int(w) for w in rng.integers(0, W, size=2 + i % 2)]
        frames = np.concatenate([sample_utterance(rng, *words[w], 3 * S)[0] for w in seq])
        tio.write_perfil(root / f"u{i}.perfil", frames)
        refs.append([names[w] for w in seq])
    tio.write_perfil(root / "short.perfil", rng.normal(size=(2, 3)))
    (root / "inputs.txt").write_text("".join(f"u{i}.perfil\n" for i in range(n)))
    (root / "ref.txt").write_text("".join(" ".join(r) + "\n" for r in refs))
    uni = np.log(rng.dirichlet(np.ones(W)))
    (root / "uni.txt").write_text("".join(f"{names[v]} {uni[v]}\n" for v in range(W)))
    bi = np.log(rng.dirichlet(np.ones(W), size=W))
    (root / "bi.txt").write_text(
        "".join(f"{names[u]} {names[v]} {bi[u, v]}\n" for u in range(W) for v in range(W)))
    (root / "trans.txt").write_text(
        "# path units\n" + "".join(f"u{i}.perfil {' '.join(r)}\n" for i, r in enumerate(refs)))
    return refs


@pytest.mark.parametrize("flags", [
    [],
    ["--n-best", "3", "--lm", "uni.txt", "--ref", "ref.txt", "--word-penalty", "-2"],
    ["--batch"],
    ["--batch", "--lm", "bi.txt", "--n-best", "2", "--ref", "ref.txt"],
    ["--batch", "--lm", "uni.txt", "--lm-scale", "2", "--exit-logprob", "-1"],
])
def test_decode_cli_matches_jax(tmp_path, monkeypatch, flags):
    _fixture(tmp_path)
    monkeypatch.chdir(tmp_path)
    args = ["models.txt", "inputs.txt"]
    assert j_decode.main(args + ["jax.txt"] + flags) == 0
    assert t_decode.main(args + ["torch.txt"] + flags + ["--device", "cpu"]) == 0
    assert Path("torch.txt").read_text() == Path("jax.txt").read_text()
    if "--ref" in flags:
        assert "WER: 0.00%" in Path("torch.txt").read_text()


def test_align_cli_matches_jax(tmp_path, monkeypatch, capsys):
    refs = _fixture(tmp_path)
    monkeypatch.chdir(tmp_path)
    for extra in ([], ["--frame-shift", "10"]):
        assert j_align.main(["models.txt", "trans.txt", "jax.txt"] + extra) == 0
        assert t_align.main(["models.txt", "trans.txt", "torch.txt", "--device", "cpu"] + extra) == 0
        text = Path("torch.txt").read_text()
        assert text == Path("jax.txt").read_text()
        units = [l.split("\t")[1] for l in text.splitlines()]
        assert units == [u for r in refs for u in r]
    # an utterance too short for its transcript fails in both: exit code 2
    with open("trans.txt", "a") as f:
        f.write("short.perfil word0 word1 word2\n")
    assert j_align.main(["models.txt", "trans.txt", "jax.txt"]) == 2
    assert t_align.main(["models.txt", "trans.txt", "torch.txt", "--device", "cpu"]) == 2
    assert Path("torch.txt").read_text() == Path("jax.txt").read_text()
    assert "short.perfil\tALIGNMENT-FAILED" in Path("torch.txt").read_text()
    assert "1/7 utterances failed to align" in capsys.readouterr().err
    assert read_transcripts("trans.txt")[-1] == ("short.perfil", ["word0", "word1", "word2"])


_REFUSALS = {
    "decode": (t_decode.main, ["models.txt", "inputs.txt", "out.txt", "--batch", "--device", "cuda"]),
    "align": (t_align.main, ["models.txt", "trans.txt", "out.txt"]),
    "recognize": (t_recognize.main, ["--numerics", "fast", "1", "models.txt", "1", "inputs.txt",
                                     "words.txt", "out.txt"]),
    "train": (t_train.main, ["--numerics", "fast", "--device", "cuda", "w", "4", "1", "2", "train.txt",
                             "out.txt"]),
    "train_embedded": (t_train_embedded.main, ["trans.txt", "out.txt"]),
}


@pytest.mark.parametrize("cli", sorted(_REFUSALS))
def test_cli_refuses_a_missing_cuda_device(tmp_path, monkeypatch, capsys, cli):
    """--device cuda (the default) exits non-zero with a message when torch
    sees no CUDA device; nothing runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    _fixture(tmp_path, n=2)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "words.txt").write_text("word0\nword1\n")
    (tmp_path / "train.txt").write_text("u0.perfil\nu1.perfil\n")
    main, argv = _REFUSALS[cli]
    assert main(argv) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "out.txt").exists()
