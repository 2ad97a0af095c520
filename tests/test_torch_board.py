"""The Trellis board (`portbench` family `board_merge`) on the CPU at a
small size: the generator writes what a frontend mints, the plain
reference (`portbench/reference/board.py`) gives the JAX package's
oracle's board, conflicts and clock, the port's public API on its CPU
binding gives the reference's, the cell runs `correct` through the
harness, its control fails, a program that drops a change whose ops
leave the board as it was fails the checks, and the API's, backend's and
frontend's spans are recorded and read by the cell's readers (with
tracing off no site reads the clock).
"""

import json
import time
from types import SimpleNamespace

import pytest
import torch

import automerge_tpu
import automerge_tpu_torch as am
from automerge_tpu.backend import facade as jax_oracle
from automerge_tpu_torch import _uuid, obs
from automerge_tpu_torch.backend import device as device_backend
from automerge_tpu_torch.backend import facade as port_oracle
from portbench import control, drive, harness, spec
from portbench.families import board_merge
from portbench.reference.board import BoardReference

CELL = "trellis_1k.board_merge"
SMALL = {"actors": 60, "cards": 4, "tasks_per_card": 3}
SEEDS = [3, 2**31 + 11, 2**40 + 77]
CPU = torch.device("cpu")

STAGES = ("backend/admit", "backend/distribute", "backend/diffs",
          "frontend/patch")
READERS = ("api.merge_ms_per_session.board",
           "backend.admit_ms_per_session.board",
           "backend.distribute_ms_per_session.board",
           "backend.diffs_ms_per_session.board",
           "frontend.patch_ms_per_session.board",
           "stacked.ms_per_session.board")
# the accepted readers the cell reports too: the session's open and read
# (benchmark-side spans), the card's idle share and multi_scan's roofline
SHARED = ("open.ms_per_session.merge", "read.ms_per_session.merge",
          "device.idle_pct.merge", "multi_scan.roofline_pct.merge")
CHECKS = ("wrong_boards", "wrong_conflicts", "wrong_clocks",
          "graduated_sessions")


@pytest.fixture(autouse=True)
def _tracing_off():
    obs.disable()
    yield
    obs.disable()


def board(seed, **size):
    return board_merge.Board(dict(SMALL, **size), seed)


def small_cell():
    c = spec.cell(CELL)
    c.config.update(SMALL)
    return c


def cpu_merge(gen):
    """The saved base board loaded on the port's CPU binding, every
    change merged in one apply_changes."""
    options = {"actorId": gen.merger,
               "backend": am.backend.backend_for("cpu")}
    base = am.apply_changes(am.init(options), [gen.base_change()])
    doc = am.load(am.save(base), options)
    return am.apply_changes(doc, gen.changes())


def read_back(api, doc):
    """What a session reads back from `doc` through the API `api`."""
    return board_merge.read_back(
        api.to_json(doc), board_merge.conflicts_of(api, doc),
        api.frontend.get_backend_state(doc).clock)


# --- the generator -------------------------------------------------------------

def test_generator_writes_what_a_frontend_mints():
    """The base board and each kind of edit, minted by the port's
    frontend on its oracle with the generator's ids, are the generator's
    change dicts."""
    gen = board(5, actors=6, cards=3)
    ids = [gen.cards_list]
    for i in range(gen.n_cards):
        ids += [gen.card_maps[i], gen.task_lists[i]]
    it = iter(ids)
    _uuid.set_factory(lambda: next(it))
    try:
        base = am.change(
            am.init({"actorId": gen.base_actor,
                     "backend": port_oracle.Backend}),
            lambda d: d.update({"cards": [
                {"title": f"card{i}", "tasks": [f"t{j}" for j in range(3)]}
                for i in range(gen.n_cards)]}))
    finally:
        _uuid.reset()
    base_changes = am.get_all_changes(base)
    assert base_changes == [gen.base_change()]
    edits = [lambda d, k, a: d["cards"][k]["tasks"].append(f"new-{a}"),
             lambda d, k, a: d["cards"][k].__setitem__("title",
                                                       f"retitled-{a}"),
             lambda d, k, a: d["cards"][k]["tasks"].__delitem__(0)]
    want = gen.changes()
    for a, actor in enumerate(gen.actors):
        peer = am.apply_changes(
            am.init({"actorId": actor, "backend": port_oracle.Backend}),
            base_changes)
        edited = am.change(peer, lambda d: edits[a % 3](
            d, a % gen.n_cards, a))
        assert am.get_changes(base, edited) == [want[a]], a


def test_a_session_is_1334_ops_at_the_cells_size_for_every_seed():
    config = spec.cell(CELL).config
    assert [board_merge.Board(config, s).n_ops for s in SEEDS] == [1334] * 3
    gen = board_merge.Board(config, SEEDS[0])
    assert len(gen.changes()) == 1000
    assert len(set(gen.actors) | {gen.base_actor, gen.merger}) == 1002


def test_each_call_makes_fresh_change_dicts():
    gen = board(1)
    a, b = gen.changes(), gen.changes()
    assert a == b
    assert all(x is not y and x["ops"][0] is not y["ops"][0]
               for x, y in zip(a, b))


# --- the reference ---------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_reference_is_the_jax_oracles_board(seed):
    gen = board(seed)
    doc = automerge_tpu.apply_changes(
        automerge_tpu.init({"actorId": gen.merger,
                            "backend": jax_oracle.Backend}),
        [gen.base_change()] + gen.changes())
    got, want = read_back(automerge_tpu, doc), gen.want(gen.changes())
    assert got == want
    # every card's retitles but the winner are conflicts, and every actor
    # is in the clock at seq 1
    conflicts, clock = json.loads(want[1]), json.loads(want[2])
    assert len(conflicts) == gen.n_cards
    assert sum(len(v) for v in conflicts.values()) == \
        sum(1 for a in range(gen.n_actors) if a % 3 == 1) - gen.n_cards
    assert clock == {a: 1 for a in [gen.base_actor] + gen.actors}


@pytest.mark.parametrize("seed", SEEDS)
def test_port_api_merge_on_the_cpu_is_the_references_board(seed):
    gen = board(seed)
    device_backend.GRADUATION_STATS.clear()
    merged = cpu_merge(gen)
    assert isinstance(am.frontend.get_backend_state(merged),
                      device_backend.DeviceBackendState)
    assert not device_backend.GRADUATION_STATS
    assert read_back(am, merged) == gen.want(gen.changes())
    got = am.to_json(merged)
    # the ties the seed decides: concurrent retitles of one card (every
    # one on the same counter) go to the greatest actor id, and a card's
    # concurrent appends after the same task come in descending actor id
    changes = gen.changes()
    for k in range(gen.n_cards):
        titles = [(c["actor"], c["ops"][0]["value"]) for c in changes
                  if c["ops"][0]["action"] == "set"
                  and c["ops"][0]["obj"] == gen.card_maps[k]]
        assert len(titles) >= 2
        assert got["cards"][k]["title"] == max(titles)[1]
        appends = sorted((c["actor"], c["ops"][1]["value"])
                         for c in changes if c["ops"][0]["action"] == "ins"
                         and c["ops"][0]["obj"] == gen.task_lists[k])
        assert got["cards"][k]["tasks"] == \
            ["t1", "t2"] + [v for _, v in reversed(appends)]


def test_reference_keeps_the_losers_and_reads_a_tombstone_as_gone():
    gen = board(9)
    ref = BoardReference()
    ref.apply([gen.base_change()] + gen.changes())
    card = ref.objects[gen.card_maps[0]]
    n_titles = sum(1 for c in gen.changes()
                   if c["ops"][0]["action"] == "set"
                   and c["ops"][0]["obj"] == gen.card_maps[0])
    assert len(card.fields["title"]) == n_titles      # winner + conflicts
    tasks = ref.objects[gen.task_lists[0]]
    assert tasks.fields[f"{gen.base_actor}:1"] == []  # deleted task 0
    assert f"{gen.base_actor}:1" in [e for _, _, e in tasks.order]


def test_reference_waits_for_a_change_whose_deps_are_missing():
    gen = board(4)
    ref = BoardReference()
    ref.apply(gen.changes())
    assert len(ref.queue) == len(gen.changes()) and ref.to_json() == {}
    ref.apply([gen.base_change()])
    assert ref.queue == []
    assert board_merge.canonical(ref.to_json()) == \
        gen.want(gen.changes())[0]


# --- the cell -----------------------------------------------------------------

def test_the_cell_runs_correct_on_the_cpu():
    res = harness.run_cell(drive.program(), torch, small_cell(), 2**33 + 5,
                           1.5, False, CPU, time.time_ns())
    assert res["correct"], res["checks"]
    assert res["checks"] == {k: {"value": 0, "limit": 0} for k in CHECKS}
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "merge_ops_per_s"}
    json.dumps(res)


@pytest.mark.parametrize("seed", [1, 2, 3, 2**35 + 9])
def test_control_fails_on_every_seed(seed):
    res = control.run_control(spec.cell(CELL), seed, units=3)
    assert not res["correct"]
    assert res["checks"]["wrong_boards"]["value"] == 3
    assert res["checks"]["wrong_clocks"]["value"] == 3


def test_a_wrong_read_or_a_graduation_fails_the_checks():
    runner = board_merge.Sessions(None, CPU, {}, {}, 8)
    runner.gen = board(8)
    board_, conflicts, clock = runner.gen.want(runner.gen.changes())
    runner.reads = {(board_, conflicts, clock): 3,
                    (board_.replace("t1", "t9"), conflicts, clock): 1,
                    (board_, conflicts.replace("retitled", "x", 1), clock): 2,
                    (board_, conflicts, clock.replace(":1", ":2", 1)): 4}
    runner.graduated = 2
    checks, failed = runner.check()
    assert checks == {"wrong_boards": (1, 0), "wrong_conflicts": (2, 0),
                      "wrong_clocks": (4, 0), "graduated_sessions": (2, 0)}
    assert failed == 7


def _losing_retitle(gen, changes):
    ref = BoardReference()
    ref.apply([gen.base_change()] + changes)
    loser = ref.objects[gen.card_maps[0]].fields["title"][-1]["actor"]
    return next(i for i, c in enumerate(changes) if c["actor"] == loser)


def _redundant_delete(gen, changes):
    return next(i for i, c in enumerate(changes)
                if c["ops"][0]["action"] == "del")


def _drop_change(find):
    def fault(gen, changes):
        del changes[find(gen, changes)]
    return fault


def _drop_ops(find):
    def fault(gen, changes):
        changes[find(gen, changes)]["ops"] = []
    return fault


@pytest.mark.parametrize("fault, caught", [
    (_drop_change(_redundant_delete), {"wrong_clocks"}),
    (_drop_change(_losing_retitle), {"wrong_conflicts", "wrong_clocks"}),
    (_drop_ops(_losing_retitle), {"wrong_conflicts"}),
], ids=["redundant_delete_dropped", "losing_retitle_dropped",
        "losing_retitle_ops_dropped"])
def test_a_dropped_change_that_leaves_the_board_as_it_was_fails(fault,
                                                                caught):
    """A planted fault in the program's input: the board read back is
    the reference's, and only the conflicts or the clock show what was
    lost."""
    class Faulty(board_merge.Sessions):
        def next_changes(self):
            changes = super().next_changes()
            fault(self.gen, changes)
            return changes

    c = small_cell()
    runner = Faulty(drive.program(), CPU, c.config, c.traffic, 2**32 + 21)
    runner.setup(0.0)
    runner.unit()
    runner.unit()
    checks, failed = runner.check()
    assert failed == 2
    assert {k for k, (v, _) in checks.items() if v} == caught
    assert all(checks[k] == (2, 0) for k in caught)


# --- the spans and their readers -------------------------------------------------

@pytest.fixture(scope="module")
def traced_sessions():
    """Two traced sessions of the small cell on the CPU: the window's
    spans, the ring's records and the runner."""
    c = small_cell()
    runner = board_merge.Sessions(drive.program(), CPU, c.config, c.traffic,
                                  2**31 + 3)
    runner.setup(0.0)
    runner.spans.clear()
    with obs.tracing():
        obs.clear()
        runner.unit()
        runner.unit()
        spans = obs.metrics_snapshot()["spans"]
        recs = [(f"{r[2]}/{r[3]}", r[0], r[0] + r[1], r[4])
                for r in obs.snapshot() if r[1] >= 0]
    obs.disable()
    return c, runner, spans, recs


def test_each_new_span_is_recorded(traced_sessions):
    _c, _r, spans, _recs = traced_sessions
    for k in ("api.load", "api.merge", "api.to_json"):
        assert spans[k]["count"] == 2, k
    # the load's replay and the merge each admit, distribute, diff and
    # patch once
    for k in ("backend.admit", "backend.distribute", "backend.diffs",
              "frontend.patch"):
        assert spans[k]["count"] == 4, k
    assert spans["plan.stack"]["count"] >= 2
    assert spans["commit.stacked_round"]["count"] >= 2


def test_stage_spans_lie_inside_the_api_calls(traced_sessions):
    _c, _r, _spans, recs = traced_sessions

    def inside(child, parent):
        return (parent[1] <= child[1] and child[2] <= parent[2]
                and child[3] == parent[3])

    calls = [r for r in recs if r[0] in ("api/load", "api/merge")]
    for name in STAGES + ("plan/stack", "commit/stacked_round"):
        kids = [r for r in recs if r[0] == name]
        assert kids, name
        assert all(any(inside(k, p) for p in calls) for k in kids), name
    for p in calls:
        inner = sorted((k for k in recs if k[0] in STAGES and inside(k, p)),
                       key=lambda k: k[1])
        assert [k[0] for k in inner] == list(STAGES)
        for a, b in zip(inner, inner[1:]):
            assert a[2] <= b[1]


def test_each_new_reader_reads_the_recording(traced_sessions):
    c, runner, spans, _recs = traced_sessions
    reading = harness.Reading(c, runner, 1.0, 1.0)
    reading.obs_spans = spans
    reading.device = SimpleNamespace(busy_s=0.25, window_s=1.0)
    names = [m["name"] for m in c.per_layer]
    assert sorted(names) == sorted(READERS + SHARED)
    for name in READERS + SHARED[:2]:
        value = spec.reader(name)(reading)
        assert value is not None and value > 0, name
    assert spec.reader("device.idle_pct.merge")(reading) == 75.0
    assert spec.reader("api.merge_ms_per_session.board")(reading) == \
        pytest.approx(spans["api.merge"]["total_ns"] / 1e6 / 2)


def test_readers_read_nothing_from_a_program_without_the_spans(
        traced_sessions):
    c, runner, spans, _recs = traced_sessions
    reading = harness.Reading(c, runner, 1.0, 1.0)
    reading.obs_spans = {k: v for k, v in spans.items()
                         if k.split(".")[0] not in ("api", "backend",
                                                    "frontend", "plan",
                                                    "commit")}
    for name in READERS:
        assert spec.reader(name)(reading) is None, name


def test_off_path_reads_no_clock(monkeypatch):
    gen = board(6)
    calls = []
    real = obs.now

    def counted():
        calls.append(1)
        return real()

    monkeypatch.setattr(obs, "now", counted)
    assert not obs.ENABLED
    am.to_json(cpu_merge(gen))
    assert calls == []
