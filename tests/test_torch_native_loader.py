"""The native batched .perfil loader (srhmm_tpu_torch/io/native_loader.py,
native/loader.cpp) against srhmm_tpu's and against the Python reader, on
generated .perfil files (CPU).

Every comparison is bitwise, in float32 and float64: scan_perfil and
load_batch_native against the JAX package's and against read_perfil;
truncation at t_max, a strict missing file, a wrong dimension
(tests/test_native_loader.py); load_batch through every route
(native=None / True / False) against the JAX package's load_batch.  The
tests that build the library skip where g++ is absent.  Without the library
load_batch(native=True) raises, where the JAX package reads with Python.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srhmm_tpu.io.dataset as j_dataset
import srhmm_tpu.io.native_loader as jn
import srhmm_tpu_torch.io.native_loader as tn
from srhmm_tpu_torch.io import load_batch, read_perfil, write_perfil

LENGTHS = [103, 57, 213, 1, 130]


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the native loader")


@pytest.fixture
def perfils(tmp_path):
    rng = np.random.default_rng(11)
    paths = []
    for i, n in enumerate(LENGTHS):
        p = tmp_path / f"u{i}.perfil"
        write_perfil(p, rng.normal(size=(n, 9)) * 50.0)
        paths.append(str(p))
    # a trailing partial frame is dropped, as the C reader drops it
    with open(paths[1], "ab") as f:
        f.write(b"\0" * 12)
    (tmp_path / "list.txt").write_text("".join(f"u{i}.perfil\n" for i in range(len(LENGTHS))))
    return paths


def test_native_builds(gxx):
    assert tn.native_available()
    assert tn.LIBRARY.is_file() and tn.LIBRARY.parent.name == "native"
    assert tn.LIBRARY.parent.parent.name == "srhmm_tpu_torch" and tn.LIBRARY.parent.parent.parent.name == "build"


def test_scan_matches_python_and_jax(gxx, perfils, tmp_path):
    paths = perfils + [str(tmp_path / "missing.perfil")]
    info = tn.scan_perfil(paths)
    assert info.dtype == np.int64
    np.testing.assert_array_equal(info, jn.scan_perfil(paths))
    for i, p in enumerate(perfils):
        assert tuple(info[i]) == read_perfil(p).shape
    assert tuple(info[-1]) == (0, 0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_load_batch_native_matches_python_and_jax(gxx, perfils, dtype):
    t_max = 256
    feats, lengths = tn.load_batch_native(perfils, t_max, 9, dtype=dtype, n_threads=3)
    jf, jl = jn.load_batch_native(perfils, t_max, 9, dtype=dtype)
    assert feats.shape == (len(perfils), t_max, 9) and feats.dtype == dtype and lengths.dtype == np.int32
    np.testing.assert_array_equal(feats, jf)
    np.testing.assert_array_equal(lengths, jl)
    for i, p in enumerate(perfils):
        ref = read_perfil(p)
        assert lengths[i] == len(ref)
        np.testing.assert_array_equal(feats[i, : lengths[i]], ref.astype(dtype))
        assert (feats[i, lengths[i]:] == 0).all()


def test_truncation_at_t_max(gxx, perfils):
    feats, lengths = tn.load_batch_native(perfils[:1], 50, 9)
    assert lengths[0] == 50
    np.testing.assert_array_equal(feats[0], read_perfil(perfils[0])[:50].astype(np.float32))


def test_missing_file_strict_raises(gxx, tmp_path):
    with pytest.raises(IOError):
        tn.load_batch_native([str(tmp_path / "nope.perfil")], 10, 9)
    feats, lengths = tn.load_batch_native([str(tmp_path / "nope.perfil")], 10, 9, strict=False)
    assert lengths[0] == 0 and not feats.any()


def test_wrong_dim_and_dtype_are_refused(gxx, perfils):
    with pytest.raises((IOError, ValueError)):
        tn.load_batch_native(perfils[:1], 10, 13)
    with pytest.raises(ValueError, match="float32 or float64"):
        tn.load_batch_native(perfils[:1], 10, 9, dtype=np.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("native", [None, True])
def test_load_batch_routes_give_the_same_bits(gxx, perfils, tmp_path, dtype, native):
    kw = dict(relative_to=tmp_path, pad_multiple=32, pad_batch_to=7)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.float64
    want = j_dataset.load_batch(tmp_path / "list.txt", dtype=jdtype, native=False, **kw)
    py = load_batch(tmp_path / "list.txt", dtype=dtype, native=False, **kw)
    got = load_batch(tmp_path / "list.txt", dtype=dtype, native=native, **kw)
    for b in (py, got):
        assert b.features.dtype == dtype and b.lengths.dtype == torch.int32 and b.features.shape == (7, 224, 9)
        np.testing.assert_array_equal(b.features.numpy(), np.asarray(want.features))
        np.testing.assert_array_equal(b.lengths.numpy(), np.asarray(want.lengths))


def test_without_the_library_native_true_raises(perfils, tmp_path, monkeypatch):
    def unavailable():
        raise tn.NativeLoaderUnavailable("no g++")

    monkeypatch.setattr(tn, "_library", unavailable)
    assert not tn.native_available()
    with pytest.raises(tn.NativeLoaderUnavailable):
        load_batch(tmp_path / "list.txt", relative_to=tmp_path, native=True)
    with pytest.raises(tn.NativeLoaderUnavailable):
        tn.scan_perfil(perfils)
    b = load_batch(tmp_path / "list.txt", relative_to=tmp_path)  # native=None: the Python reader
    assert b.lengths.tolist() == [read_perfil(p).shape[0] for p in perfils]


def test_a_file_without_frames_takes_the_python_reader(gxx, perfils, tmp_path):
    write_perfil(tmp_path / "empty.perfil", np.zeros((0, 9)))
    (tmp_path / "list0.txt").write_text("u0.perfil\nempty.perfil\n")
    with pytest.raises(IOError, match="scan"):
        load_batch(tmp_path / "list0.txt", relative_to=tmp_path, native=True)
    b = load_batch(tmp_path / "list0.txt", relative_to=tmp_path)
    assert b.lengths.tolist() == [LENGTHS[0], 0]
