"""The recognition slice as a whole: the port's CLI writes the same report
as the JAX CLI (byte for byte apart from the date and timing lines), the
library path load_batch -> score_batch -> rank ranks like the JAX one, and
no srhmm_tpu_torch module imports jax."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srhmm_tpu.cli.recognize as j_cli
import srhmm_tpu.io as jio
import srhmm_tpu_torch.cli.recognize as t_cli
import srhmm_tpu_torch.io as tio
from srhmm_tpu.decode.scorer import rank as j_rank
from srhmm_tpu.decode.scorer import score_batch as j_score_batch
from srhmm_tpu.models import stack_models as j_stack
from srhmm_tpu_torch.decode.scorer import rank, score_batch
from srhmm_tpu_torch.models import gmm_hmm_from_numpy, stack_models
from torch_port_utils import rand_word, sample_utterance

REPO = Path(__file__).resolve().parent.parent
VOLATILE = ("Date and time", "Average recognition time")


def _fixture(tmp_path, cov, shapes, D=4, utts_per_word=2, T=30):
    """Write a vocabulary (.hmm), sampled utterances (.perfil) and the list
    files of the reference argv contract; returns the CLI positionals."""
    rng = np.random.default_rng(11)
    words = [f"w{i}" for i in range(len(shapes))]
    model_paths, perfil_paths, spoken = [], [], []
    for i, (w, (S, M)) in enumerate(zip(words, shapes)):
        trans, streams = rand_word(40 + i, S, [(M, D)], cov, scale=1.5)
        tio.write_hmm(tmp_path / f"{w}.hmm", gmm_hmm_from_numpy(trans, streams, w))
        model_paths.append(f"{w}.hmm")
        for u in range(utts_per_word):
            (frames,) = sample_utterance(rng, trans, streams, T + 3 * u)
            tio.write_perfil(tmp_path / f"{w}_{u}.perfil", frames)
            perfil_paths.append(f"{w}_{u}.perfil")
            spoken.append(w)
    (tmp_path / "models.txt").write_text("\n".join(model_paths) + "\n")
    (tmp_path / "inputs.txt").write_text("\n".join(perfil_paths) + "\n")
    (tmp_path / "words.txt").write_text("\n".join(spoken) + "\n")
    return ["1", "models.txt", "1", "inputs.txt", "words.txt"]


def _report(path):
    lines = Path(path).read_text().splitlines(keepends=True)
    return "".join(l for l in lines if not l.startswith(VOLATILE))


@pytest.mark.parametrize(
    "cov,shapes,mode",
    [
        ("diag", [(5, 2)] * 4, None),
        ("full", [(6, 1)] * 4, None),
        ("diag", [(5, 1), (8, 3), (6, 2), (3, 4)], "final"),
    ],
)
@pytest.mark.parametrize("numerics", ["parity", "fast"])
def test_cli_report_matches_jax(tmp_path, monkeypatch, capsys, cov, shapes, mode, numerics):
    args = _fixture(tmp_path, cov, shapes)
    monkeypatch.chdir(tmp_path)
    flags = ["--numerics", numerics] + (["--mode", mode] if mode else [])
    assert j_cli.main(flags + args + ["jax.txt"]) == 0
    out_j = capsys.readouterr().out
    # the port runs --numerics fast on --device (default cuda): the CPU here
    device = ["--device", "cpu"] if numerics == "fast" else []
    assert t_cli.main(flags + device + args + ["torch.txt"]) == 0
    out_t = capsys.readouterr().out
    assert _report("torch.txt") == _report("jax.txt")
    order = [[l.split(" :")[0] for l in out.splitlines() if " :  " in l] for out in (out_j, out_t)]
    assert order[1] == order[0]


def test_library_path_ranks_like_jax(tmp_path):
    _fixture(tmp_path, "diag", [(5, 2)] * 4, utts_per_word=3)
    vj = j_stack(jio.read_vocabulary(tmp_path / "models.txt", relative_to=tmp_path)).astype(jnp.float32)
    vt = stack_models(tio.read_vocabulary(tmp_path / "models.txt", relative_to=tmp_path)).astype(torch.float32)
    bj = jio.load_batch(tmp_path / "inputs.txt", relative_to=tmp_path, pad_multiple=8, native=False)
    bt = tio.load_batch(tmp_path / "inputs.txt", relative_to=tmp_path, pad_multiple=8)
    sj = np.asarray(j_score_batch(vj, bj))
    for impl in (None, "fused"):
        st = score_batch(vt, bt, impl=impl).numpy()
        np.testing.assert_allclose(st, sj, rtol=1e-5)
        for a, b in zip(sj, st):
            np.testing.assert_array_equal(rank(b), j_rank(a))
    spoken = (tmp_path / "words.txt").read_text().split()
    hyps = [vt.word[i] for i in st.argmax(1)]
    assert sum(h == s for h, s in zip(hyps, spoken)) >= len(spoken) - 1


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import srhmm_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(srhmm_tpu_torch.__path__, 'srhmm_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'srhmm_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'srhmm_tpu_torch.cli.recognize' in names and 'srhmm_tpu_torch.ops.kernels.scoring' in names\n"
        "assert {'srhmm_tpu_torch.decode.continuous', 'srhmm_tpu_torch.ops.kernels.decode',\n"
        "        'srhmm_tpu_torch.cli.decode', 'srhmm_tpu_torch.cli.align'} <= set(names)\n"
        "assert {'srhmm_tpu_torch.train.checkpoint', 'srhmm_tpu_torch.train.streaming',\n"
        "        'srhmm_tpu_torch.utils.profiling', 'srhmm_tpu_torch.io.native_loader',\n"
        "        'srhmm_tpu_torch.io.pipeline'} <= set(names)\n"
        "assert {'srhmm_tpu_torch.parallel.distributed', 'srhmm_tpu_torch.parallel.mesh',\n"
        "        'srhmm_tpu_torch.parallel.sequence', 'srhmm_tpu_torch.parallel.dryrun'} <= set(names)\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 20
