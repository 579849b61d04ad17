"""srhmm_tpu_torch.io against srhmm_tpu.io: byte-identical .hmm files,
.perfil round trips, equal vocabularies and batches."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srhmm_tpu.io as jio
import srhmm_tpu_torch.io as tio
from srhmm_tpu_torch.io.dataset import load_batch, pack_utterances
from srhmm_tpu_torch.io.native_loader import NativeLoaderUnavailable
from torch_port_utils import assert_same_leaves, both_models, rand_word


@pytest.mark.parametrize("size_t_width", [4, 8])
@pytest.mark.parametrize("cov", ["diag", "full"])
def test_write_hmm_bytes_match_jax_and_read_back(tmp_path, cov, size_t_width):
    trans, streams = rand_word(3, 5, [(2, 4), (1, 3)], cov)
    jmod, tmod = both_models(trans, streams, "palavra")
    jio.write_hmm(tmp_path / "j.hmm", jmod, size_t_width=size_t_width)
    tio.write_hmm(tmp_path / "t.hmm", tmod, size_t_width=size_t_width)
    assert (tmp_path / "j.hmm").read_bytes() == (tmp_path / "t.hmm").read_bytes()

    back_j = jio.read_hmm(tmp_path / "j.hmm")
    back_t = tio.read_hmm(tmp_path / "j.hmm")
    assert back_t.word == back_j.word == "palavra"
    assert [s.cov_type for s in back_t.streams] == [cov, cov]
    assert_same_leaves(back_j, back_t)


def test_read_hmm_rejects_garbage(tmp_path):
    (tmp_path / "bad.hmm").write_bytes(b"\x03\x00\x00\x00abc" + b"\x00" * 5)
    with pytest.raises(ValueError, match="cannot decode"):
        tio.read_hmm(tmp_path / "bad.hmm")


def test_perfil_round_trip(tmp_path):
    frames = np.random.default_rng(0).normal(size=(17, 9))
    tio.write_perfil(tmp_path / "a.perfil", frames)
    np.testing.assert_array_equal(tio.read_perfil(tmp_path / "a.perfil"), frames)
    np.testing.assert_array_equal(jio.read_perfil(tmp_path / "a.perfil"), frames)
    # a trailing partial frame is dropped, as the C reader does
    with open(tmp_path / "a.perfil", "ab") as f:
        f.write(b"\x00" * 16)
    assert tio.read_perfil(tmp_path / "a.perfil").shape == (17, 9)
    with pytest.raises(ValueError):
        (tmp_path / "b.perfil").write_bytes(b"\x00\x00")
        tio.read_perfil(tmp_path / "b.perfil")


def test_read_vocabulary_and_load_batch_match_jax(tmp_path):
    words = ["um", "dois", "tres"]
    for i, w in enumerate(words):
        jmod, _ = both_models(*rand_word(10 + i, 4, [(2, 5)], "diag"), w)
        jio.write_hmm(tmp_path / f"{w}.hmm", jmod)
    (tmp_path / "models.txt").write_text("".join(f"{w}.hmm\n" for w in words))
    vj = jio.read_vocabulary(tmp_path / "models.txt", relative_to=tmp_path)
    vt = tio.read_vocabulary(tmp_path / "models.txt", relative_to=tmp_path)
    assert [m.word for m in vt] == [m.word for m in vj] == words
    for a, b in zip(vj, vt):
        assert_same_leaves(a, b)

    rng = np.random.default_rng(1)
    for i in range(4):
        tio.write_perfil(tmp_path / f"u{i}.perfil", rng.normal(size=(7 + 5 * i, 5)))
    (tmp_path / "utts.txt").write_text("".join(f"u{i}.perfil\n" for i in range(4)))
    bj = jio.load_batch(tmp_path / "utts.txt", relative_to=tmp_path, pad_multiple=8,
                        pad_batch_to=6, dtype=jnp.float64, native=False)
    bt = load_batch(tmp_path / "utts.txt", relative_to=tmp_path, pad_multiple=8,
                    pad_batch_to=6, dtype=torch.float64)
    assert bt.features.dtype == torch.float64 and bt.lengths.dtype == torch.int32
    np.testing.assert_array_equal(bt.features.numpy(), np.asarray(bj.features))
    np.testing.assert_array_equal(bt.lengths.numpy(), np.asarray(bj.lengths))
    np.testing.assert_array_equal(bt.mask().numpy(), np.asarray(bj.mask()))
    # native=True reads through the C++ loader, the same bits; without g++ it raises
    if shutil.which("g++"):
        bn = load_batch(tmp_path / "utts.txt", relative_to=tmp_path, pad_multiple=8, pad_batch_to=6,
                        dtype=torch.float64, native=True)
        assert torch.equal(bn.features, bt.features) and torch.equal(bn.lengths, bt.lengths)
    else:
        with pytest.raises(NativeLoaderUnavailable):
            load_batch(tmp_path / "utts.txt", relative_to=tmp_path, native=True)


def test_pack_utterances_dtype_and_padding():
    utts = [np.ones((3, 2)), np.ones((9, 2))]
    b = pack_utterances(utts, pad_multiple=4, dtype=torch.float32)
    assert b.features.shape == (2, 12, 2) and b.features.dtype == torch.float32
    assert b.lengths.tolist() == [3, 9]
    assert b.batch_size == 2 and b.max_frames == 12
    with pytest.raises(ValueError):
        pack_utterances([])
