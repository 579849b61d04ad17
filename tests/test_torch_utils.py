"""srhmm_tpu_torch.utils.logging against srhmm_tpu.utils.logging: the same
JSONL records (mirrors tests/test_utils.py's EventLog case), the echo to
stderr and the silent NULL_LOG."""

import json

from srhmm_tpu.utils import EventLog as JEventLog
from srhmm_tpu_torch.utils import NULL_LOG, EventLog


def test_event_log_jsonl(tmp_path, capsys):
    log = EventLog(tmp_path / "ev.jsonl", echo=False)
    log.emit("hello", a=1)
    with log.span("work", tag="x"):
        pass
    log.close()
    lines = [json.loads(l) for l in (tmp_path / "ev.jsonl").read_text().splitlines()]
    assert lines[0]["event"] == "hello" and lines[0]["a"] == 1
    assert lines[1]["event"] == "work" and "seconds" in lines[1] and lines[1]["tag"] == "x"
    assert capsys.readouterr().err == ""


def test_records_have_the_jax_keys(capsys):
    """Both packages echo one JSON object a line to stderr, with the same
    keys in the same order."""
    for cls in (JEventLog, EventLog):
        log = cls()
        log.emit("converged", iterations=3, mean_log_prob=-1.5)
        with log.span("train_fast", word="w"):
            pass
    recs = [json.loads(l) for l in capsys.readouterr().err.splitlines()]
    assert len(recs) == 4
    assert [list(r) for r in recs[:2]] == [list(r) for r in recs[2:]]
    assert recs[2]["iterations"] == 3 and recs[3]["word"] == "w"


def test_null_log_is_silent(capsys):
    NULL_LOG.emit("anything", x=1)
    with NULL_LOG.span("work"):
        pass
    assert capsys.readouterr().err == ""
