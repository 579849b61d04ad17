"""srhmm_tpu_torch/parallel/distributed.py: the process-group bootstrap
under a real launcher, the backend rule, checkpoints under a mesh, and
dryrun_multichip (CPU).

Two ranks under ``python -m torch.distributed.run --standalone
--nproc-per-node 2`` (its own free port; killed after
torch_dist_workers.TIMEOUT_S) initialize from the launcher's environment;
an e_step on each rank's half of tests/test_distributed.py's utterances,
all-reduced, equals JAX's e_step on the whole batch at that test's bounds
(log prob rtol 1e-5, num_valid exact, den_mix rtol 1e-4 / atol 1e-5).  The
same ranks train_embedded on a 2-rank mesh with checkpoints: only the
coordinator writes, and a run stopped after two iterations and resumed to
four equals an uninterrupted run of four bitwise.  The same ranks run
train_fast(data_mesh=) and train_fast(time_mesh=) in float64 with an
absolute variance floor and a zero-det threshold that both bind: each run
equals JAX's unsharded train_fast with the same floors at
test_torch_sequence_parallel.py's trajectory bounds (histories rtol 1e-9,
models rtol 1e-8 / atol 1e-10), and JAX's run without them differs.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as w
from srhmm_tpu.io.dataset import pack_utterances
from srhmm_tpu_torch.parallel import distributed
from torch_port_utils import jax_model, leaves_jax



@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("launch")
    rc, out, err = w.launch([str(w.REPO / "tests" / "torch_dist_workers.py"), "distributed", str(d / "res.pt")], d)
    assert rc == 0, err[-4000:]
    return torch.load(d / "res.pt", weights_only=False)


def test_launcher_environment_initializes_two_ranks(two_ranks):
    assert two_ranks["world"] == 2 and two_ranks["initialized"] and two_ranks["rank"] == 0
    assert two_ranks["backend"] == "gloo"  # the rule on the CPU


def test_e_step_on_rank_local_halves_matches_jax(two_ranks):
    from srhmm_tpu.train.em import e_step

    trans, streams, utts = w.dist_inputs()
    ref = e_step(jax_model(trans, streams).astype(jnp.float32),
                 pack_utterances(utts, pad_multiple=8, dtype=jnp.float32))
    got = two_ranks["e_step"]
    np.testing.assert_allclose(got["log_prob"], float(ref.log_prob), rtol=1e-5)
    assert got["num_valid"] == float(ref.num_valid)
    np.testing.assert_allclose(got["den_mix"], np.asarray(ref.den_mix), rtol=1e-4, atol=1e-5)


def test_checkpoint_under_a_mesh_resumes_the_same_trajectory(two_ranks):
    ck = two_ranks["checkpoint"]
    assert ck["writers"] == [True, False]  # the coordinator alone writes
    assert ck["files_first"] == ["ckpt_000002.json", "ckpt_000002.pt"]
    assert ck["files_again"] == ["ckpt_000002.json", "ckpt_000002.pt", "ckpt_000004.json", "ckpt_000004.pt"]
    assert ck["first"]["iterations"] == 2
    whole, again = ck["whole"], ck["again"]
    assert again[0]["iterations"] == whole[0]["iterations"] == 4
    np.testing.assert_array_equal(again[0]["history"], whole[0]["history"])
    np.testing.assert_array_equal(again[0]["history"][:2], ck["first"]["history"])
    for a, b in zip(again[1], whole[1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["data", "time"])
def test_train_fast_mesh_applies_the_floors_as_jax_unsharded(two_ranks, kind):
    """Both mesh paths apply abs_floors and zero_det_thresholds, as the
    unsharded train_fast of both packages does (the JAX package's mesh
    paths drop them: ROADMAP Queue 3, deliberate differences)."""
    from srhmm_tpu.train.em import train_fast

    trans, streams, utts, pad, floors, zd = w.floor_inputs(kind)
    model, batch = jax_model(trans, streams), pack_utterances(utts, pad_multiple=pad, dtype=jnp.float64)
    ref = train_fast(model, batch, max_iterations=w.FLOOR_ITERS, abs_floors=[jnp.asarray(f) for f in floors],
                     zero_det_thresholds=zd)
    free = train_fast(model, batch, max_iterations=w.FLOOR_ITERS)
    # the floors bind: some variance sits on the floor, and the run differs
    var = 1.0 / np.asarray(ref.model.streams[0].inv_cov)
    assert np.isclose(var, floors[0], rtol=1e-12).any()
    assert not np.allclose(np.asarray(free.model.streams[0].means), np.asarray(ref.model.streams[0].means))
    hist, leaves = two_ranks["floors"][kind]
    assert hist["iterations"] == ref.iterations
    np.testing.assert_allclose(hist["history"], ref.log_prob_history, rtol=1e-9)
    for a, b in zip(leaves_jax(ref.model), leaves):
        np.testing.assert_allclose(b, a, rtol=1e-8, atol=1e-10)


def test_backend_rule_and_single_process_no_op(monkeypatch):
    assert distributed.backend_for("cpu", 4) == "gloo"
    if torch.cuda.device_count() == 0:
        # ranks that would share a card (there is none here) get gloo, and
        # nccl is refused before any rendezvous
        assert distributed.backend_for("cuda", 2) == "gloo"
        with pytest.raises(ValueError, match="nccl"):
            distributed.initialize(backend="nccl", init_method="file:///nonexistent", rank=0, world_size=2)
        with pytest.raises(RuntimeError, match="CUDA"):
            distributed.local_device("cuda")
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    distributed.initialize(device="cpu")  # one process: nothing to join
    assert not torch.distributed.is_initialized()
    assert distributed.world_size() == 1 and distributed.rank() == 0 and distributed.is_coordinator()
    assert distributed.local_device("cpu") == torch.device("cpu")


def test_spawn_reports_a_failed_rank(tmp_path):
    """Rank 1 raises while rank 0 waits in a collective: spawn fails at
    once (rank 0 is killed, or fails on the closed connection first), long
    before the group's time limit."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"ranks of failing_case exited \[-?\d+, -?\d+\]"):
        distributed.spawn(w.failing_case, 2, device="cpu", timeout_s=60, workdir=tmp_path)
    assert time.monotonic() - t0 < 30


def test_dryrun_multichip_on_four_cpu_ranks():
    from srhmm_tpu_torch.parallel.dryrun import dryrun_multichip

    summary = dryrun_multichip(4, device="cpu", timeout_s=w.TIMEOUT_S)
    assert summary["mesh"] == {"data": 2, "model": 2} and summary["time_mesh"] == {"time": 4}
    assert summary["valid"] == 4 and np.isfinite(summary["log_prob"])
