"""Chrome trace-event JSON export (Perfetto-loadable) + schema validator.

The port of the JAX package's ``obs/export.py``: the same trace schema
and the same validator.

The flight recorder's tuples map onto the Trace Event Format's complete
("X") and instant ("i") events:

- span  (dur >= 0) -> {"ph": "X", "name", "cat", "ts", "dur", "pid",
                       "tid", "args"}
- event (dur == -1)-> {"ph": "i", "name", "cat", "ts", "s": "t", ...}

Timestamps are microseconds relative to the recorder's session origin, so
a trace opens at t=0 in https://ui.perfetto.dev regardless of process
uptime. Thread names ride along as metadata ("M") events when known.
Given the origin on the wall clock too (`obs.write_trace` passes the
recorder's), the trace's ``otherData`` carries it on both clocks
(``origin_perf_counter_ns``, ``origin_unix_ns``): add
``origin_unix_ns / 1000`` to a span's ``ts`` to lay it beside a
wall-clock trace such as torch.profiler's.

`validate_chrome_trace` is the ONE schema check the tests and
`chip_smoke.py` share: every span must carry
category/ts/dur, the trace must be non-empty, and (when the trace came
from `bench.py --trace`) every pipeline-ring span must nest inside a
`bench/stream` span on the timeline — the structural guarantee that ring
work is attributable to its stream.

Lineage flow events (INTERNALS §18.5): ``lineage``-category hop events
carry ``{actor, seq, site}`` args; the exporter stitches every sampled
change's hops into ONE Chrome flow — a start ("s") at the first hop,
steps ("t") at each intermediate hop, a finish ("f") at the last —
whose ``id`` is the change's deterministic sample hash.  Loading the
trace in https://ui.perfetto.dev draws one change's journey across
actors/threads as a single connected arrow chain.  Flow pairing (every
started flow finishes, monotone timestamps) is part of the validator's
schema; ``require_flows`` additionally demands at least one flow (the
CI lineage smoke's contract).
"""

from __future__ import annotations

import json
from typing import Optional

from .recorder import ARGS, CAT, DUR, NAME, TID, TS


def _flow_id(actor: str, seq) -> int:
    """Deterministic flow id for one change: THE sampler's content hash
    (`lineage.sample_key`), truncated to 48 bits — traces from two
    replicas of the same run stitch on identical flow ids by
    construction, and a sampler-keying change can never silently
    diverge from the exporter."""
    from .lineage import sample_key
    return sample_key(actor, seq) >> 16


def lineage_flow_events(records, t0_ns: int, pid: int = 1) -> list:
    """Flow events stitching ``lineage``-category hop records into one
    timeline per sampled change (>= 2 hops; a single-hop chain has no
    edge to draw)."""
    chains: dict = {}
    for r in records:
        if r[CAT] != "lineage" or not r[ARGS]:
            continue
        actor, seq = r[ARGS].get("actor"), r[ARGS].get("seq")
        if actor is None or seq is None:
            continue
        chains.setdefault((actor, seq), []).append(r)
    out = []
    for (actor, seq), hops in sorted(chains.items()):
        if len(hops) < 2:
            continue
        hops.sort(key=lambda r: r[TS])
        fid = _flow_id(actor, seq)
        name = f"change {actor}:{seq}"
        for i, r in enumerate(hops):
            ph = "s" if i == 0 else ("f" if i == len(hops) - 1 else "t")
            ev = {"ph": ph, "id": fid, "name": name, "cat": "lineage",
                  "ts": (r[TS] - t0_ns) / 1000.0, "pid": pid,
                  "tid": r[TID]}
            if ph == "f":
                ev["bp"] = "e"
            out.append(ev)
    return out


def to_chrome_trace(records, t0_ns: Optional[int] = None,
                    pid: int = 1, t0_unix_ns: Optional[int] = None) -> dict:
    """Records -> Chrome trace-event JSON object. `t0_unix_ns`: the
    origin `t0_ns` on the wall clock (time.time_ns), written into the
    trace's ``otherData``."""
    if t0_ns is None:
        t0_ns = min((r[TS] for r in records), default=0)
    events = []
    tids = set()
    for r in records:
        ts_us = (r[TS] - t0_ns) / 1000.0
        tids.add(r[TID])
        ev = {"name": r[NAME], "cat": r[CAT], "ts": ts_us,
              "pid": pid, "tid": r[TID]}
        if r[ARGS]:
            ev["args"] = dict(r[ARGS])
        if r[DUR] >= 0:
            ev["ph"] = "X"
            ev["dur"] = r[DUR] / 1000.0
        else:
            ev["ph"] = "i"
            ev["s"] = "t"
        events.append(ev)
    events += lineage_flow_events(records, t0_ns, pid)
    # device-truth counter tracks: library builds/loads and
    # device-resident bytes as "C"-phase samples on the same timeline —
    # Perfetto draws them as counter lanes under the span tracks
    from .device_truth import REGISTRY as _dt_registry
    events += _dt_registry.counter_events(t0_ns, pid)
    meta = [{"ph": "M", "name": "process_name", "pid": pid, "ts": 0,
             "args": {"name": "automerge_tpu_torch"}}]
    meta += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": t,
              "ts": 0, "args": {"name": f"thread-{t}"}}
             for t in sorted(tids)]
    out = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
    if t0_unix_ns is not None:
        out["otherData"] = {"origin_perf_counter_ns": t0_ns,
                            "origin_unix_ns": t0_unix_ns}
    return out


def write_trace(path: str, records, t0_ns: Optional[int] = None,
                t0_unix_ns: Optional[int] = None) -> str:
    with open(path, "w") as fh:
        json.dump(to_chrome_trace(records, t0_ns, t0_unix_ns=t0_unix_ns), fh)
    return path


class TraceValidationError(ValueError):
    """The emitted trace JSON violates the INTERNALS §11 schema."""


def validate_chrome_trace(obj, require_stream_nesting: bool = False,
                          require_flows: bool = False) -> dict:
    """Validate a trace JSON object (or a path to one). Raises
    :class:`TraceValidationError`; returns summary counts on success.

    Checks:
    - the trace holds at least one non-metadata event (an empty trace
      FAILS — a --trace run that recorded nothing is a wiring bug);
    - every "X" span carries name/cat/ts/dur with dur >= 0;
    - every "i" instant carries name/cat/ts;
    - every "C" counter sample carries name/cat/ts plus a numeric
      args value (the device-truth counter tracks);
    - flow events ("s"/"t"/"f") PAIR UP: every flow id with a start has
      exactly one finish, steps/finishes never appear without a start,
      and each flow's timestamps are monotone — a dangling flow is a
      stitching bug, not a rendering quirk;
    - with `require_stream_nesting` (bench traces): every `ring`-category
      span's [ts, ts+dur] interval lies inside some `bench`/`stream`
      span's interval (thread-agnostic containment — the ring's worker
      thread is a different tid by design);
    - with `require_flows` (the lineage smoke): at least one complete
      flow must be present.
    """
    if isinstance(obj, (str, bytes)):
        with open(obj) as fh:
            obj = json.load(fh)
    if not isinstance(obj, dict) or not isinstance(
            obj.get("traceEvents"), list):
        raise TraceValidationError("trace must be an object with a "
                                   "traceEvents list")
    spans, instants, streams, rings = [], [], [], []
    counters: list = []
    flows: dict = {}    # id -> {"s": [...], "t": [...], "f": [...]}
    for ev in obj["traceEvents"]:
        ph = ev.get("ph")
        if ph == "M":
            continue
        for fld in ("name", "cat", "ts"):
            if fld not in ev:
                raise TraceValidationError(
                    f"event missing `{fld}`: {ev!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise TraceValidationError(
                    f"span without a valid `dur`: {ev!r}")
            spans.append(ev)
            if ev["cat"] == "bench" and ev["name"] == "stream":
                streams.append((ev["ts"], ev["ts"] + dur))
            elif ev["cat"] == "ring":
                rings.append(ev)
        elif ph == "i":
            instants.append(ev)
        elif ph == "C":
            vals = ev.get("args")
            if not isinstance(vals, dict) or not vals or any(
                    not isinstance(v, (int, float)) for v in vals.values()):
                raise TraceValidationError(
                    f"counter sample without numeric args: {ev!r}")
            counters.append(ev)
        elif ph in ("s", "t", "f"):
            if "id" not in ev:
                raise TraceValidationError(f"flow event without an "
                                           f"`id`: {ev!r}")
            flows.setdefault(ev["id"], {"s": [], "t": [], "f": []}
                             )[ph].append(ev["ts"])
        else:
            raise TraceValidationError(f"unsupported phase {ph!r}: {ev!r}")
    if not spans and not instants:
        raise TraceValidationError("empty trace: no spans or events "
                                   "recorded")
    for fid, parts in flows.items():
        if len(parts["s"]) != 1 or len(parts["f"]) != 1:
            raise TraceValidationError(
                f"flow {fid} does not pair up: {len(parts['s'])} starts, "
                f"{len(parts['f'])} finishes")
        lo, hi = parts["s"][0], parts["f"][0]
        if hi < lo or any(not lo <= t <= hi for t in parts["t"]):
            raise TraceValidationError(
                f"flow {fid} has non-monotone step timestamps")
    if require_flows and not flows:
        raise TraceValidationError("no lineage flow events recorded (a "
                                   "lineage smoke that stitched nothing "
                                   "is a wiring bug)")
    if require_stream_nesting:
        if not streams:
            raise TraceValidationError("no bench/stream spans to nest "
                                       "ring spans under")
        # microsecond float rounding at the edges gets a 1 us grace
        for ev in rings:
            lo, hi = ev["ts"], ev["ts"] + ev["dur"]
            if not any(a - 1 <= lo and hi <= b + 1 for a, b in streams):
                raise TraceValidationError(
                    "ring span does not nest inside any bench/stream "
                    f"span: {ev!r}")
    return {"n_spans": len(spans), "n_events": len(instants),
            "n_streams": len(streams), "n_ring_spans": len(rings),
            "n_flows": len(flows), "n_counter_samples": len(counters)}
