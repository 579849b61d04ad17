"""The frontend and pipeline CLIs: srhmm_tpu_torch.cli.features and
srhmm_tpu_torch.cli.pipeline against the JAX CLIs (the port with
--device cpu).

features: the same .perfil file names, frame counts and stdout lines;
values within 1e-9 for the float64 frontend (the same products, other
summation orders) and rtol = atol = 2e-3 for --fused (the port's float32
twin against the JAX Pallas kernel in interpret mode, the bound of
tests/test_pallas_kernels.py::test_fused_mfcc_matches_frontend).
pipeline: the JAX CLI's summary keys, WER <= 0.10 on a small clean corpus
(tests/test_pipeline.py's gate); --data-parallel 2 exits 2 without a
launcher of 2 ranks and passes the same gate under one.  No module of the
slice imports jax.
"""

import json
import os
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest

import srhmm_tpu.cli.features as j_features
import srhmm_tpu.cli.pipeline as j_pipeline
import srhmm_tpu.pipeline as jp
import srhmm_tpu_torch.cli.features as t_features
import srhmm_tpu_torch.cli.pipeline as t_pipeline
import srhmm_tpu_torch.io as tio
from srhmm_tpu.eval.metrics import WerCounts

REPO = Path(__file__).resolve().parent.parent


def _write_wav(path: Path, x: np.ndarray, sr: int, channels: int = 1) -> None:
    pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2")
    if channels > 1:
        pcm = np.repeat(pcm[:, None], channels, axis=1).reshape(-1)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def _wavs(root: Path) -> list[str]:
    """Four WAVs from a seed: 16 kHz mono of 4000 and 300 samples (one
    clamped frame), 16 kHz stereo, and 8 kHz mono."""
    rng = np.random.default_rng(21)
    t = np.arange(8000) / 16000.0
    specs = [
        ("a.wav", 0.4 * np.sin(2 * np.pi * 440.0 * t[:4000]) + 0.05 * rng.normal(size=4000), 16000, 1),
        ("short.wav", 0.3 * rng.normal(size=300), 16000, 1),
        ("stereo.wav", 0.2 * rng.normal(size=6000), 16000, 2),
        ("low.wav", 0.3 * np.sin(2 * np.pi * 300.0 * t[:5000]) + 0.02 * rng.normal(size=5000), 8000, 1),
    ]
    names = []
    for name, x, sr, ch in specs:
        _write_wav(root / name, x, sr, ch)
        names.append(name)
    (root / "wavs.txt").write_text("".join(f"{n}\n" for n in names))
    return names


@pytest.mark.parametrize("fused,tol", [(False, 1e-9), (True, 2e-3)])
def test_features_cli_matches_jax(tmp_path, monkeypatch, capsys, fused, tol):
    names = _wavs(tmp_path)
    monkeypatch.chdir(tmp_path)
    flag = ["--fused"] if fused else []
    assert j_features.main(["wavs.txt", "jax", *flag]) == 0
    j_out = capsys.readouterr().out
    assert t_features.main(["wavs.txt", "torch", *flag, "--device", "cpu"]) == 0
    t_out = capsys.readouterr().out
    assert t_out == j_out.replace("jax/", "torch/")
    assert sorted(os.listdir("torch")) == sorted(os.listdir("jax")) == sorted(
        n.replace(".wav", ".perfil") for n in names)
    for n in names:
        stem = n.replace(".wav", ".perfil")
        got, want = tio.read_perfil(f"torch/{stem}"), tio.read_perfil(f"jax/{stem}")
        assert got.shape == want.shape and got.shape[1] == 13
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert tio.read_perfil("torch/short.perfil").shape[0] == 1


def test_fused_default_stays_within_the_float64_gap(tmp_path, monkeypatch, capsys):
    """The port's float32 features (--device cpu --fused, the MFCC kernel's
    twin; the card runs the kernel by default) against the JAX CLI's
    float64 default: within 2e-5 absolute on these WAVs (7.3e-6 measured,
    the figure cli/features.py states)."""
    names = _wavs(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert j_features.main(["wavs.txt", "jax"]) == 0
    assert t_features.main(["wavs.txt", "torch", "--fused", "--device", "cpu"]) == 0
    capsys.readouterr()
    gap = 0.0
    for n in names:
        stem = n.replace(".wav", ".perfil")
        got, want = tio.read_perfil(f"torch/{stem}"), tio.read_perfil(f"jax/{stem}")
        assert got.shape == want.shape
        gap = max(gap, float(np.abs(got - want).max()))
    assert 0.0 < gap <= 2e-5, gap


def test_features_cli_options(tmp_path, monkeypatch, capsys):
    """Non-default widths run the same frontend (float64, 1e-9)."""
    _wavs(tmp_path)
    monkeypatch.chdir(tmp_path)
    opts = ["--n-mfcc", "20", "--n-mels", "40", "--frame-length", "512", "--frame-shift", "128"]
    assert j_features.main(["wavs.txt", "jax", *opts]) == 0
    assert t_features.main(["wavs.txt", "torch", *opts, "--device", "cpu"]) == 0
    capsys.readouterr()
    for n in os.listdir("jax"):
        got, want = tio.read_perfil(f"torch/{n}"), tio.read_perfil(f"jax/{n}")
        assert got.shape == want.shape and got.shape[1] == 20
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_features_cli_featurizes_in_bounded_chunks(tmp_path, monkeypatch, capsys):
    """With --fused, consecutive files of one sample rate share one call of
    mfcc_fused up to CHUNK_SAMPLES samples; a file of another rate or one
    past the limit starts the next chunk.  The files and lines are the
    unchunked run's, in list order."""
    import srhmm_tpu_torch.ops.kernels.mfcc as km

    names = _wavs(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert t_features.main(["wavs.txt", "whole", "--fused", "--device", "cpu"]) == 0
    whole = capsys.readouterr().out
    calls = []
    real = km.mfcc_fused

    def counted(samples, offsets, cfg):
        calls.append((int(samples.shape[0]), cfg.sample_rate))
        return real(samples, offsets, cfg)

    monkeypatch.setattr(km, "mfcc_fused", counted)
    monkeypatch.setattr(t_features, "CHUNK_SAMPLES", 6000)
    assert t_features.main(["wavs.txt", "chunked", "--fused", "--device", "cpu"]) == 0
    assert capsys.readouterr().out == whole.replace("whole/", "chunked/")
    assert calls == [(4300, 16000), (6000, 16000), (5000, 8000)]
    for n in names:
        stem = n.replace(".wav", ".perfil")
        np.testing.assert_array_equal(tio.read_perfil(f"chunked/{stem}"), tio.read_perfil(f"whole/{stem}"))


def _fake_result():
    return jp.PipelineResult(
        wer=WerCounts(1, 0, 0, 10), hyps=[[0]], refs=[[0]], n_senones=5, n_units=4, mono_iterations=1,
        tied_iterations=1, mono_log_prob=-1.0, tied_log_prob=-1.0, stage_seconds={"wer": 0.0},
    )


def test_pipeline_cli_prints_the_jax_summary(tmp_path, monkeypatch, capsys):
    """The port's CLI on a small clean corpus (CPU): the JAX CLI's summary
    keys (read from the JAX CLI run on a stand-in result), WER <= 0.10,
    every stage timed, the same line in --json."""
    monkeypatch.setattr(jp, "run_pipeline", lambda *a, **k: _fake_result())
    assert j_pipeline.main(["--quiet"]) == 0
    jax_keys = set(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    out = tmp_path / "summary.json"
    argv = ["--n-train", "24", "--n-test", "8", "--words", "6", "--phones-per-word", "2",
            "--mono-iters", "4", "--tied-iters", "4", "--device", "cpu", "--json", str(out)]
    assert t_pipeline.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("[pipeline] synthesize:")  # verbose stage lines
    summary = json.loads(lines[-1])
    assert set(summary) == jax_keys
    assert summary["wer"] <= 0.10, summary
    assert summary["num_ref_words"] > 10 and summary["snr_db"] is None
    assert set(summary["stage_seconds"]) == {"synthesize", "mfcc", "lbg_init", "monophone_em", "tree_cluster",
                                             "tied_em", "materialize", "decode", "wer"}
    assert out.read_text() == lines[-1] + "\n"


def test_pipeline_cli_refuses_data_parallel(tmp_path, capsys, monkeypatch):
    """--data-parallel N without a launcher of N ranks exits 2 and names
    the launcher (the JAX CLI's "only k devices" exit)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    out = tmp_path / "s.json"
    assert t_pipeline.main(["--data-parallel", "2", "--device", "cpu", "--json", str(out)]) == 2
    err = capsys.readouterr().err
    assert "--data-parallel 2 needs a launcher of 2 ranks" in err and "torchrun" in err
    assert not out.exists()


def test_pipeline_cli_data_parallel_under_the_launcher(tmp_path):
    """--data-parallel 2 under torch.distributed.run (2 CPU ranks): one
    summary line, from the coordinator, at the gate of the one-process
    CLI."""
    import torch_dist_workers as w

    out = tmp_path / "s.json"
    rc, stdout, err = w.launch(["-m", "srhmm_tpu_torch.cli.pipeline", "--n-train", "24", "--n-test", "8",
                                "--words", "6", "--phones-per-word", "2", "--mono-iters", "4", "--tied-iters",
                                "4", "--device", "cpu", "--quiet", "--data-parallel", "2", "--json", str(out)],
                               tmp_path)
    assert rc == 0, err[-4000:]
    lines = [line for line in stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1, stdout
    summary = json.loads(lines[0])
    assert summary["data_parallel"] == 2 and summary["wer"] <= 0.10, summary
    assert out.read_text() == lines[0] + "\n"


def test_frontend_and_pipeline_slice_imports_no_jax():
    code = (
        "import sys\n"
        "import srhmm_tpu_torch.cli.features, srhmm_tpu_torch.cli.pipeline, srhmm_tpu_torch.pipeline\n"
        "import srhmm_tpu_torch.features, srhmm_tpu_torch.ops.kernels.mfcc, srhmm_tpu_torch.models\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'srhmm_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
