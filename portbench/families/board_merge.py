"""Family `board_merge`: a Trellis-style board replica that reconnects and
merges its collaborators' concurrent card and task edits through the
public API (benchmarks/run_all.py trellis_changes and config4_trellis).

The generator: a board of `cards` cards, each a map holding a `title`
and a `tasks` list of `tasks_per_card` strings, made by one base change
(ops in the order a frontend mints them), and one concurrent change
(seq 1, deps the base) by each of `actors` actors on card a % cards: a
task appended after the card's last task (a % 3 == 0), the card retitled
(a % 3 == 1), or the card's task 0 deleted (otherwise). Actor and object
ids are UUID-form strings drawn from the seed: the work is the same for
every seed, and the seed decides which retitle of a card wins and the
order of a card's concurrent appends.

The runner: set-up makes the base board on the runner's device through
the API and saves it, and makes each session's changes ahead, fresh
dicts a session. Each session loads the saved board (`am.load`), merges
every change with one `am.apply_changes` and reads `am.to_json`; after
the session it reads the merged board's conflicts (`am.get_conflicts` on
every field) and its clock. The checks hold all three to the reference:
a change whose ops leave the board as it was (a losing retitle, a delete
of a task another actor deleted too) shows only in the conflicts or the
clock.
"""

from __future__ import annotations

import collections
import json

from portbench.drive import Runner, now, rng_for
from portbench.reference.board import ROOT_ID, BoardReference

def uuid_from(rng) -> str:
    """A version-4 UUID string from 16 bytes of `rng`."""
    b = bytearray(rng.bytes(16))
    b[6] = (b[6] & 0x0F) | 0x40
    b[8] = (b[8] & 0x3F) | 0x80
    h = b.hex()
    return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"


def canonical(board) -> str:
    """A board's `to_json` as one JSON text, keys sorted."""
    return json.dumps(board, sort_keys=True, separators=(",", ":"))


def read_back(board, conflicts: dict, clock: dict) -> tuple:
    """What a session reads back, as canonical texts: the board, the
    losers of its fields by path, and the clock."""
    return canonical(board), canonical(conflicts), canonical(clock)


def conflicts_of(am, obj, path: str = "") -> dict:
    """`am.get_conflicts` of every field of a document (or of one of its
    maps or lists), by the field's path from it ("cards/3/title");
    fields with no loser are left out."""
    out: dict = {}
    keys = obj.keys() if isinstance(obj, dict) else range(len(obj))
    for key in keys:
        at = f"{path}{key}"
        losers = am.get_conflicts(obj, key)
        if losers:
            out[at] = dict(losers)
        child = obj[key]
        if isinstance(child, (dict, list)):
            out.update(conflicts_of(am, child, at + "/"))
    return out


class Board:
    """The base board and the concurrent changes, as plain data."""

    def __init__(self, config: dict, seed: int):
        self.n_actors = int(config["actors"])
        self.n_cards = int(config["cards"])
        self.n_tasks = int(config["tasks_per_card"])
        rng = rng_for(seed, 1)
        names = [uuid_from(rng) for _ in range(self.n_actors + 2)]
        self.base_actor, self.merger = names[:2]
        self.actors = names[2:]
        rng = rng_for(seed, 2)
        objs = [uuid_from(rng) for _ in range(1 + 2 * self.n_cards)]
        self.cards_list = objs[0]
        self.card_maps = objs[1: 1 + self.n_cards]
        self.task_lists = objs[1 + self.n_cards:]
        self.n_ops = sum(len(c["ops"]) for c in self.changes())

    def _elem(self, n: int) -> str:
        return f"{self.base_actor}:{n}"

    def base_change(self) -> dict:
        """The board typed by the base actor in one change."""
        cards, ops = self.cards_list, [{"action": "makeList",
                                        "obj": self.cards_list}]
        for i in range(self.n_cards):
            card, tasks = self.card_maps[i], self.task_lists[i]
            ops.append({"action": "ins", "obj": cards,
                        "key": self._elem(i) if i else "_head",
                        "elem": i + 1})
            ops.append({"action": "makeMap", "obj": card})
            ops.append({"action": "set", "obj": card, "key": "title",
                        "value": f"card{i}"})
            ops.append({"action": "makeList", "obj": tasks})
            for j in range(self.n_tasks):
                ops.append({"action": "ins", "obj": tasks,
                            "key": self._elem(j) if j else "_head",
                            "elem": j + 1})
                ops.append({"action": "set", "obj": tasks,
                            "key": self._elem(j + 1), "value": f"t{j}"})
            ops.append({"action": "link", "obj": card, "key": "tasks",
                        "value": tasks})
            ops.append({"action": "link", "obj": cards,
                        "key": self._elem(i + 1), "value": card})
        ops.append({"action": "link", "obj": ROOT_ID, "key": "cards",
                    "value": cards})
        return {"actor": self.base_actor, "seq": 1, "deps": {}, "ops": ops}

    def changes(self) -> list:
        """Every actor's change, as new dicts on each call."""
        out, deps = [], {self.base_actor: 1}
        last = self._elem(self.n_tasks)
        for a, actor in enumerate(self.actors):
            k = a % self.n_cards
            tasks = self.task_lists[k]
            if a % 3 == 0:
                elem = self.n_tasks + 1
                ops = [{"action": "ins", "obj": tasks, "key": last,
                        "elem": elem},
                       {"action": "set", "obj": tasks,
                        "key": f"{actor}:{elem}", "value": f"new-{a}"}]
            elif a % 3 == 1:
                ops = [{"action": "set", "obj": self.card_maps[k],
                        "key": "title", "value": f"retitled-{a}"}]
            else:
                ops = [{"action": "del", "obj": tasks,
                        "key": self._elem(1)}]
            out.append({"actor": actor, "seq": 1, "deps": dict(deps),
                        "ops": ops})
        return out

    def want(self, changes: list) -> tuple:
        """The reference's `read_back` after the base and `changes`."""
        ref = BoardReference()
        ref.apply([self.base_change()] + changes)
        return read_back(ref.to_json(), ref.conflicts(), ref.clock)


class Sessions(Runner):
    WARM = 3            # sessions before the window
    MAX_AHEAD = 400     # sessions' changes made before the window, at most

    def setup(self, seconds: float):
        import automerge_tpu_torch as am
        from automerge_tpu_torch.backend import device as backend
        from automerge_tpu_torch.engine import accounting, stacked
        self.am, self.backend = am, backend
        self.accounting, self.stacked = accounting, stacked
        self.gen = Board(self.config, self.seed)
        self.options = {"actorId": self.gen.merger,
                        "backend": backend.backend_for(self.device)}
        base = am.apply_changes(am.init(self.options),
                                [self.gen.base_change()])
        self.saved = am.save(base)
        del base
        self.reads = collections.Counter()    # read_back -> sessions
        self.graduated = 0
        self.counters["inline_sessions"] = 0
        for _ in range(self.WARM):
            self.unit(self.gen.changes(), keep=False)
        warm_s = min(b - a for name, a, b in self.spans
                     if name == "session") / 1e9
        self.spans.clear()
        # the sessions the window takes, their changes made before it: a
        # fifth more than the fastest warm session's pace fills it, at
        # most MAX_AHEAD (more are made inline, and counted)
        n = min(int(1.2 * seconds / max(warm_s, 1e-3)) + 8, self.MAX_AHEAD)
        self.queue = collections.deque(self.gen.changes() for _ in range(n))

    def next_changes(self) -> list:
        if self.queue:
            return self.queue.popleft()
        self.counters["inline_sessions"] += 1
        return self.gen.changes()

    def unit(self, changes: list = None, keep: bool = True):
        am, backend = self.am, self.backend
        if changes is None:
            changes = self.next_changes()
        backend.GRADUATION_STATS.clear()
        with self.accounting.track() as tr:
            t0 = now()
            doc = am.load(self.saved, self.options)
            t1 = now()
            self.stacked.LAST_STATS.clear()
            merged = am.apply_changes(doc, changes)
            t2 = now()
            board = am.to_json(merged)
            t3 = now()
        self.span("session/open", t0, t1)
        self.span("session/merge", t1, t2)
        self.span("session/read", t2, t3)
        self.span("session", t0, t3)
        state = am.frontend.get_backend_state(merged)
        if keep:
            self.reads[read_back(board, conflicts_of(am, merged),
                                 state.clock)] += 1
            self.graduated += bool(backend.GRADUATION_STATS) or not \
                isinstance(state, backend.DeviceBackendState)
            self.n_ops += self.gen.n_ops
        # the last session's merge, printed with the window's counters
        # (empty where the merge did not stack)
        st = self.stacked.LAST_STATS
        self.counters["stacked"] = {k: st[k] for k in
                                    ("passes", "rounds", "dispatches")
                                    if k in st}
        self.counters["syncs"] = tr.thread_stats.get("syncs", 0)

    def release(self):
        del self.saved, self.queue

    def check(self) -> tuple:
        want = self.gen.want(self.gen.changes())
        wrong = [sum(n for got, n in self.reads.items() if got[i] != want[i])
                 for i in range(3)]
        failed = sum(n for got, n in self.reads.items() if got != want)
        return ({"wrong_boards": (wrong[0], 0),
                 "wrong_conflicts": (wrong[1], 0),
                 "wrong_clocks": (wrong[2], 0),
                 "graduated_sessions": (self.graduated, 0)}, failed)


class Control(Sessions):
    """The reference in the program's place, with the last acknowledged
    change of each session's backlog left out of what it reads back."""

    def setup(self, seconds: float):
        self.gen = Board(self.config, self.seed)
        self.read = self.gen.want(self.gen.changes()[:-1])
        self.reads = collections.Counter()
        self.graduated = 0

    def unit(self, changes: list = None, keep: bool = True):
        self.reads[self.read] += 1
        self.n_ops += self.gen.n_ops

    def release(self):
        pass


RUNNER, CONTROL = Sessions, Control
