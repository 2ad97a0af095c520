"""The readers of the per-layer metrics that read the program's spans
inside the checkpoint restore, the apply path, the reads and the DocSet
fast tier, on a hand-built Reading: what each returns, and None where
the program has no such span (a program without them)."""

from types import SimpleNamespace

import pytest

from portbench import spec
from portbench.harness import Reading

MS = 1_000_000


def reading(bench_spans, obs_spans, device=None) -> Reading:
    runner = SimpleNamespace(n_ops=1000, spans=bench_spans)
    r = Reading(None, runner, setup_s=1.0, window_s=10.0)
    r.obs_spans = obs_spans
    r.device = device
    return r


def agg(count, total_ms):
    return {"count": count, "total_ns": int(total_ms * MS)}


SESSIONS = [(n, k * 100 * MS + a * MS, k * 100 * MS + b * MS)
            for k in range(4)
            for n, a, b in (("session/open", 0, 10), ("session/merge", 10, 60),
                            ("session/read", 60, 90))]
ROUNDS = [(n, k * 100 * MS + a * MS, k * 100 * MS + b * MS)
          for k in range(5)
          for n, a, b in (("round/apply", 0, 70), ("round/texts", 70, 95),
                          ("round", 0, 95))]


def test_session_readers():
    r = reading(SESSIONS, {"ckpt.restore": agg(4, 36.0),
                           "apply.batch": agg(4, 180.0),
                           "pull.wait": agg(12, 20.0)})
    assert spec.reader("ckpt.restore_ms_per_session.merge")(r) == \
        pytest.approx(9.0)
    assert spec.reader("apply.batch_ms_per_session.merge")(r) == \
        pytest.approx(45.0)
    assert spec.reader("pull.wait_ms_per_session.merge")(r) == \
        pytest.approx(5.0)


def test_round_readers():
    r = reading(ROUNDS, {"docset.plan": agg(5, 250.0),
                         "read.wait": agg(10, 15.0)})
    assert spec.reader("docset.fast_plan_ms_per_round")(r) == \
        pytest.approx(50.0)
    assert spec.reader("read.wait_ms_per_round.docset")(r) == \
        pytest.approx(3.0)


@pytest.mark.parametrize("name", [
    "ckpt.restore_ms_per_session.merge", "apply.batch_ms_per_session.merge",
    "pull.wait_ms_per_session.merge", "pull.plan_ms_per_session.merge",
    "docset.fast_plan_ms_per_round", "read.wait_ms_per_round.docset",
    "read.plan_ms_per_round.docset", "read.check_ms_per_round.docset",
    "docset.detect_runs_ms_per_round", "docset.index_merge_ms_per_round",
    "docset.lookup_ms_per_round", "docset.mirror_ms_per_round"])
def test_readers_find_nothing_without_the_programs_spans(name):
    """A program without the spans (the untraced run, or one from before
    them) reads None, and no reader raises."""
    assert spec.reader(name)(reading(SESSIONS + ROUNDS, {})) is None
    assert spec.reader(name)(reading([], {})) is None


@pytest.mark.parametrize("name, key", [
    ("docset.detect_runs_ms_per_round", "plan.detect_runs"),
    ("docset.index_merge_ms_per_round", "plan.index_merge"),
    ("docset.lookup_ms_per_round", "docset.lookup"),
    ("docset.mirror_ms_per_round", "docset.mirror"),
    ("read.plan_ms_per_round.docset", "read.plan"),
    ("read.check_ms_per_round.docset", "read.check")])
def test_stage_readers_read_their_span_alone(name, key):
    """Each stage reader reads its own span's total per round, whatever
    the other stages hold: 5 rounds, 1,000 spans of 120 ms in all."""
    others = {k: agg(1000, 999.0) for k in (
        "plan.detect_runs", "plan.index_merge", "docset.lookup",
        "docset.mirror", "read.plan", "read.check", "docset.plan")
        if k != key}
    r = reading(ROUNDS, dict(others, **{key: agg(1000, 120.0)}))
    assert spec.reader(name)(r) == pytest.approx(24.0)


def test_pull_plan_reads_per_session():
    r = reading(SESSIONS, {"pull.plan": agg(8, 60.0),
                           "pull.text": agg(4, 100.0)})
    assert spec.reader("pull.plan_ms_per_session.merge")(r) == \
        pytest.approx(15.0)
