"""srhmm_tpu_torch/utils/profiling.py against srhmm_tpu/utils/profiling.py
(CPU): Throughput's counters equal the JAX package's (tests/test_utils.py:19),
timed records the block's wall time, and trace exports a Chrome trace of the
block that names the ops it ran.  On a card, timed synchronizes before it
stops the clock (tests/test_torch_cuda.py); chip_smoke.py's production
phase traces a streamed EM iteration there."""

import json
import time

import pytest
import torch

import srhmm_tpu.utils as ju
import srhmm_tpu_torch.utils as tu


@pytest.mark.parametrize("frames,seconds,shift", [(1000, 0.5, 0.01), (0, 0.0, 0.01), (48000, 1.5, 0.02)])
def test_throughput_matches_jax(frames, seconds, shift):
    a, b = ju.Throughput(frame_shift_s=shift), tu.Throughput(frame_shift_s=shift)
    for tp in (a, b):
        tp.add(num_frames=frames, seconds=seconds)
        tp.add(num_frames=frames // 2, seconds=seconds / 4)
    assert (b.frames, b.seconds) == (a.frames, a.seconds)
    assert (b.frames_per_sec, b.audio_seconds_per_sec, b.rtf) == (a.frames_per_sec, a.audio_seconds_per_sec, a.rtf)
    if frames == 1000:
        t = tu.Throughput(frame_shift_s=0.01)
        t.add(num_frames=1000, seconds=0.5)
        assert abs(t.frames_per_sec - 2000) < 1e-9
        assert abs(t.audio_seconds_per_sec - 20.0) < 1e-9
        assert abs(t.rtf - 0.05) < 1e-9


def test_timed_records_the_block():
    out = {}
    x = torch.ones(4)
    with tu.timed(out, "step", sync=x * 2):
        time.sleep(0.02)
    with tu.timed(out):
        pass
    assert 0.02 <= out["step"] < 1.0 and 0.0 <= out["seconds"] < out["step"]
    assert set(tu.__all__) == set(ju.__all__)


def test_trace_exports_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64)
    with tu.trace(tmp_path / "tr") as prof:
        torch.mm(a, a)
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())
