"""The port's binary wire (automerge_tpu_torch/engine/wire_format.py),
its outbound side and the inbound gate's use of it, against the JAX
package's, on the CPU.

The same seeded change streams (tests/test_columnar_plan.py
`rand_text_changes`) go through both packages. Tolerance is zero: frames
minted by `encode_changes`, `split_outgoing` and the hub are compared byte
for byte, `combine_frames` deliveries by their decoded columns and their
canonical dicts, every typed rejection by its type and message, and the
committed documents by `save()` bytes.

- Twins of tests/test_wire_format.py: round trip, dep order, map frames,
  zero-copy views, the outbound split and its min-ops gate, malformed
  frames (bit flips, truncations, versions, lengths, envelope guards),
  the gate's wire fast lane against the dict path, premature and poison
  frames, combined frames, the hub's binary wire, snapshot bootstrap with
  a binary tail, cached retransmits, dep order under combine, the
  snapshot cache, and lineage trace context on the wire.
- The group token (fault F2): a frame minted with a `group` token by the
  JAX package decodes in the port with an equal `_group`; a resealed
  frame with a malformed token raises `WireFormatError` in both packages
  with the same message; tests/test_federation.py's wire-format twins.
- A twin of tests/test_types_surface.py: the public surface and the wire
  objects the port emits against the schemas in `types.py`.

The JAX tests that exist only for its `AMTPU_WIRE_BINARY=0` dict-mint
switch (the dict legs of `test_hub_flag_matrix_byte_identical`,
`test_mixed_binary_dict_peers_one_hub`,
`test_service_binary_vs_dict_byte_identical`) have no twin: the port does
not have that switch. The dict leg of a session is taken here by raising
`AMTPU_WIRE_MIN_OPS` instead, which both packages read.
"""

import json
import random
import struct
import typing

import numpy as np
import pytest

from automerge_tpu.engine import wire_format as jwf
from automerge_tpu_torch.engine import wire_format as twf

from test_columnar_plan import rand_text_changes
from test_torch_sync import (  # noqa: F401  (pinned_uuids: a fixture)
    JP, TP, norm, pinned_uuids, same,
)

OBJ = "t"


def _frame_scoped(changes):
    """Give every empty-ops change a fresh ins (tests/test_wire_format.py
    `_frame_scoped`)."""
    elems = {}
    for c in changes:
        for op in c["ops"]:
            if op["action"] == "ins":
                elems[c["actor"]] = max(elems.get(c["actor"], 0),
                                        op["elem"])
    for c in changes:
        if not c["ops"]:
            e = elems.get(c["actor"], 0) + 1000 + c["seq"]
            c["ops"].append({"action": "ins", "obj": OBJ, "key": "_head",
                             "elem": e})
    return changes


def _stream(seed, n, **kw):
    return _frame_scoped(rand_text_changes(random.Random(seed),
                                           n_changes=n, **kw))


def _valid_frame_bytes(n_changes=12, seed=3):
    changes = _stream(seed, n_changes, premature=False, dups=False)
    trace = [[changes[0]["actor"], changes[0]["seq"], 123456, "origin-A"]]
    data = twf.encode_changes(changes, trace=trace)
    assert data == jwf.encode_changes(changes, trace=trace)
    return data


def _reject(wf, data):
    """The typed rejection of `data` by `wf.decode`: its message."""
    with pytest.raises(wf.WireFormatError) as info:
        wf.decode(data)
    return str(info.value)


# ---------------------------------------------------------------------------
# round trip and the outbound split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_round_trip_byte_identity(seed):
    changes = _stream(seed, 12 + 6 * seed)
    data = twf.encode_changes(changes)
    assert data == jwf.encode_changes(changes), "frame bytes differ"
    assert twf.encode_changes(changes) == data
    batch = twf.decode(data)
    assert json.dumps(twf.materialize_changes(batch)) == json.dumps(changes)
    assert twf.encode_batch(batch) == data


def test_dep_insertion_order_preserved():
    changes = [
        {"actor": "a", "seq": 1, "deps": {},
         "ops": [{"action": "ins", "obj": OBJ, "key": "_head", "elem": 1}]},
        {"actor": "b", "seq": 1, "deps": {},
         "ops": [{"action": "ins", "obj": OBJ, "key": "_head", "elem": 1}]},
        {"actor": "c", "seq": 1, "deps": {"a": 1, "b": 1},
         "ops": [{"action": "set", "obj": OBJ, "key": "a:1", "value": "x"}]},
        {"actor": "d", "seq": 1, "deps": {"b": 1, "a": 1},
         "ops": [{"action": "set", "obj": OBJ, "key": "b:1", "value": "y"}]},
    ]
    data = twf.encode_changes(changes)
    assert data == jwf.encode_changes(changes)
    assert json.dumps(twf.materialize_changes(twf.decode(data))) == \
        json.dumps(changes)


def test_map_frame_round_trip():
    changes = [{"actor": "a", "seq": 1, "deps": {}, "ops": [
        {"action": "set", "obj": "m", "key": "k1", "value": 7},
        {"action": "set", "obj": "m", "key": "k2", "value": "wide string"},
        {"action": "set", "obj": "m", "key": "k3", "value": 3.5,
         "datatype": "float64"},
        {"action": "inc", "obj": "m", "key": "k1", "value": -2},
        {"action": "del", "obj": "m", "key": "k2"},
        {"action": "link", "obj": "m", "key": "k4", "value": "child-1"},
    ]}]
    data = twf.encode_changes(changes)
    assert data == jwf.encode_changes(changes)
    batch = twf.decode(data)
    assert json.dumps(twf.materialize_changes(batch)) == json.dumps(changes)
    assert twf.encode_batch(batch) == data


def test_zero_copy_views_and_columns():
    batch = twf.decode(twf.encode_changes(_stream(1, 20)))
    for col in (batch.op_change, batch.op_kind, batch.op_value,
                batch.op_target_actor, batch.op_target_ctr):
        assert col.base is not None and not col.flags.writeable
    cols = batch._change_columns
    assert cols is not None and cols.n_changes == batch.n_changes
    assert not cols.actor_idx.flags.writeable


def _split_view(parts):
    prefix, frame = parts
    return prefix, None if frame is None else (
        frame.data, frame.n_changes, frame.trace, frame.group)


def test_split_outgoing_peels_creation_prefix():
    tail = _stream(2, 18, premature=False, dups=False)
    mk = {"actor": "root", "seq": 1, "deps": {},
          "ops": [{"action": "makeText", "obj": OBJ}]}
    for wf in (jwf, twf):
        prefix, frame = wf.split_outgoing([mk] + tail, min_ops=1)
        assert prefix == [mk] and frame.n_changes == len(tail)
        assert frame.changes() == tail
        prefix, frame = wf.split_outgoing([mk], min_ops=1)
        assert prefix == [mk] and frame is None
    assert _split_view(twf.split_outgoing([mk] + tail, min_ops=1)) == \
        _split_view(jwf.split_outgoing([mk] + tail, min_ops=1))


def test_min_ops_gate(monkeypatch):
    ch = [{"actor": "a", "seq": 1, "deps": {},
           "ops": [{"action": "ins", "obj": OBJ, "key": "_head",
                    "elem": 1}]}]
    monkeypatch.delenv("AMTPU_WIRE_MIN_OPS", raising=False)
    assert twf.wire_min_ops() == jwf.wire_min_ops() == 64
    prefix, frame = twf.split_outgoing(ch)
    assert frame is None and prefix == ch
    _, frame = twf.split_outgoing(ch, min_ops=1)
    assert frame is not None
    monkeypatch.setenv("AMTPU_WIRE_MIN_OPS", "1")     # read at each call
    assert twf.wire_min_ops() == 1
    assert twf.split_outgoing(ch)[1].data == jwf.split_outgoing(ch)[1].data
    monkeypatch.setenv("AMTPU_WIRE_MIN_OPS", "junk")
    assert twf.wire_min_ops() == jwf.wire_min_ops() == 64


@pytest.mark.parametrize("seed", range(4))
def test_split_outgoing_frames_byte_equal_over_streams(seed):
    """Chunked rand_text_changes streams: every chunk splits into the
    same dict prefix and the same frame bytes in both packages, with and
    without lineage trace context."""
    rng = random.Random(200 + seed)
    stream = _frame_scoped(rand_text_changes(rng, n_changes=40))
    mk = {"actor": "root", "seq": 1, "deps": {},
          "ops": [{"action": "makeText", "obj": OBJ}]}
    i, n_frames = 0, 0
    while i < len(stream):
        n = rng.randrange(1, 9)
        chunk = ([mk] if i == 0 else []) + stream[i:i + n]
        trace = [[chunk[-1]["actor"], chunk[-1]["seq"], 7, "s"]] \
            if n % 2 else None
        t = _split_view(twf.split_outgoing(chunk, min_ops=1, trace=trace))
        assert t == _split_view(jwf.split_outgoing(chunk, min_ops=1,
                                                   trace=trace))
        n_frames += t[1] is not None
        i += n
    assert n_frames


@pytest.mark.parametrize("seed", range(4))
def test_combine_frames_equal_over_streams(seed):
    """Frames of one object combined into one delivery: the port's
    combined batch has the JAX package's columns, tables and canonical
    dicts, from frames decoded from raw bytes and from sender-side
    frames alike."""
    rng = random.Random(300 + seed)
    stream = _frame_scoped(rand_text_changes(rng, n_changes=30))
    chunks, i = [], 0
    while i < len(stream):
        n = rng.randrange(1, 7)
        chunks.append(stream[i:i + n])
        i += n
    for raw in (True, False):
        combined = []
        for wf in (jwf, twf):
            frames = [wf.WireFrame(wf.encode_changes(c)) if raw
                      else wf.split_outgoing(c, min_ops=1)[1]
                      for c in chunks]
            combined.append(wf.combine_frames(frames))
        jc, tc = combined
        jb, tb = jc.batch(), tc.batch()
        for k in ("op_change", "op_kind", "op_value", "op_target_actor",
                  "op_target_ctr", "op_parent_actor", "op_parent_ctr",
                  "seqs"):
            np.testing.assert_array_equal(getattr(tb, k), getattr(jb, k))
        assert (tb.actors, tb.actor_table, tb.deps, tb.value_pool) == \
            (jb.actors, jb.actor_table, jb.deps, jb.value_pool)
        out = [c.changes() if c._changes is not None else
               wf.materialize_changes(c.batch())
               for c, wf in ((jc, jwf), (tc, twf))]
        assert json.dumps(out[1]) == json.dumps(out[0]) == json.dumps(
            [c for ch in chunks for c in ch])
        assert tc.n_ops == jc.n_ops and tc.data == b""


def test_combine_frames_declines_mixed_objects():
    a = [{"actor": "a", "seq": 1, "deps": {}, "ops": [
        {"action": "ins", "obj": "o1", "key": "_head", "elem": 1}]}]
    b = [{"actor": "b", "seq": 1, "deps": {}, "ops": [
        {"action": "ins", "obj": "o2", "key": "_head", "elem": 1}]}]
    m = [{"actor": "c", "seq": 1, "deps": {}, "ops": [
        {"action": "set", "obj": "o1", "key": "k", "value": 1}]}]
    for wf in (jwf, twf):
        fa, fb, fm = (wf.WireFrame(wf.encode_changes(x)) for x in (a, b, m))
        assert wf.combine_frames([fa, fb]) is None
        assert wf.combine_frames([fa, fm]) is None
        assert wf.combine_frames([fa]) is fa


def test_combine_frames_preserves_dep_order():
    obj = "o"
    ch_a = [{"actor": "a", "seq": 1, "deps": {"X": 3, "Y": 4},
             "ops": [{"action": "ins", "obj": obj, "key": "_head",
                      "elem": 1}]}]
    ch_b = [{"actor": "b", "seq": 1, "deps": {"Y": 4, "X": 3},
             "ops": [{"action": "ins", "obj": obj, "key": "_head",
                      "elem": 1}]}]
    fa = twf.WireFrame(twf.encode_changes(ch_a))
    fb = twf.WireFrame(twf.encode_changes(ch_b))
    combined = twf.combine_frames([fa, fb])
    out = twf.materialize_changes(combined.batch()) \
        if combined._changes is None else combined.changes()
    assert json.dumps(out) == json.dumps(ch_a + ch_b)


# ---------------------------------------------------------------------------
# malformed-frame hardening (same rejection, same message)
# ---------------------------------------------------------------------------


def test_bit_flips_reject_typed():
    data = _valid_frame_bytes()
    rng = random.Random(0)
    for _ in range(400):
        raw = bytearray(data)
        raw[rng.randrange(len(raw))] ^= 1 << rng.randrange(8)
        assert _reject(twf, bytes(raw)) == _reject(jwf, bytes(raw))


def test_truncations_reject_typed():
    data = _valid_frame_bytes()
    for cut in list(range(0, 64)) + list(range(64, len(data), 61)):
        assert _reject(twf, data[:cut]) == _reject(jwf, data[:cut])


def test_wrong_version_and_magic_reject(monkeypatch):
    data = _valid_frame_bytes()
    bad = b"AMTPUWIRE2\n" + data[len(twf.MAGIC):]
    assert _reject(twf, bad) == _reject(jwf, bad)
    monkeypatch.setattr(twf, "VERSION", 99)
    future = twf.encode_changes(_stream(3, 12, premature=False, dups=False))
    monkeypatch.undo()
    with pytest.raises(twf.WireFormatError, match="version"):
        twf.decode(future)
    assert _reject(twf, future) == _reject(jwf, future)


def test_oversize_length_rejects():
    raw = bytearray(_valid_frame_bytes())
    struct.pack_into("<Q", raw, len(twf.MAGIC), 2**62)
    for bad in (bytes(raw), b"", None):
        assert _reject(twf, bad) == _reject(jwf, bad)


def _tampered(wf, mutate):
    manifest, sections = wf._unpack(_valid_frame_bytes())
    arrays = {k: np.array(v) for k, v in sections.items()}
    mutate(arrays)
    man = {k: manifest[k] for k in ("kind", "obj_id", "n_changes", "n_ops",
                                    "n_change_actors")}
    return wf._pack(man, arrays)


@pytest.mark.parametrize("mutate, why", [
    (lambda a: a["seqs"].__setitem__(0, 0), "seq below 1"),
    (lambda a: a["seqs"].__setitem__(0, -3), "negative seq"),
    (lambda a: a["actor_idx"].__setitem__(0, 10_000), "actor idx OOB"),
    (lambda a: a["dep_gid"].__setitem__(0, 999), "dep group OOB"),
    (lambda a: a["g_off"].__setitem__(0, 7), "non-CSR offsets"),
    (lambda a: a["op_change"].__setitem__(0, 30_000), "op row OOB"),
    (lambda a: a["op_kind"].__setitem__(0, 9), "unknown op kind"),
    (lambda a: a["op_target_actor"].__setitem__(0, 4_000), "target OOB"),
    (lambda a: a["op_target_ctr"].__setitem__(0, 0), "elem ctr below 1"),
    (lambda a: a["op_parent_actor"].__setitem__(0, -7), "bad parent rank"),
], ids=lambda x: x if isinstance(x, str) else "")
def test_envelope_and_bounds_guards(mutate, why):
    t = _tampered(twf, mutate)
    assert t == _tampered(jwf, mutate)
    assert _reject(twf, t) == _reject(jwf, t)


def test_validate_msg_and_gate_reject_malformed_frames():
    data = _valid_frame_bytes()
    corrupt = bytearray(data)
    corrupt[len(data) // 2] ^= 0x10

    def run(P):
        whys = []
        for msg in ({"docId": "d", "clock": {}, "wire": bytes(corrupt)},
                    {"docId": "d", "clock": {}, "wire": 12345}):
            with pytest.raises(P.res.ProtocolError) as info:
                P.res.validate_msg(msg)
            whys.append(str(info.value))
        ds = P.DocSet()
        gate = P.inbound.inbound_gate(ds)
        with pytest.raises(P.res.ProtocolError) as info:
            gate.deliver_wire("d", [(P.wf.WireFrame(bytes(corrupt)), "p1")])
        assert ds.get_doc("d") is None and gate.quarantined("d") == 0
        return whys + [str(info.value)]
    same(run)


# ---------------------------------------------------------------------------
# the group token (fault F2) and tests/test_federation.py's wire twins
# ---------------------------------------------------------------------------


def _reseal(data, group):
    """`data` with its manifest's group entry replaced (fresh hashes, so
    only the token's own validation can reject it)."""
    manifest, sections = jwf._unpack(data)
    man = {k: v for k, v in manifest.items()
           if k not in ("format", "version", "sections", "body_sha256")}
    man["group"] = group
    return jwf._pack(man, {k: np.array(v) for k, v in sections.items()})


def _federation_changes(P, n=3):
    doc = P.init("wire-actor")
    for i in range(n):
        doc = P.am.change(doc, lambda d, i=i: d.__setitem__(f"k{i}", i))
    return P.am.get_all_changes(doc)


def test_jax_minted_group_token_decodes_in_the_port():
    """F2: the port used to drop the manifest's group token. A frame the
    JAX package minted with a token decodes in the port with the same
    `_group`, and its WireFrame reports it."""
    changes = _stream(5, 10, premature=False, dups=False)
    _, jframe = jwf.split_outgoing(changes, min_ops=1,
                                   group=["us", "room0", 7])
    batch = twf.decode(jframe.data)
    assert batch._group == ["us", "room0", 7] == jwf.decode(
        jframe.data)._group
    assert twf.WireFrame(jframe.data).validate().group == ["us", "room0", 7]
    _, tframe = twf.split_outgoing(changes, min_ops=1,
                                   group=["us", "room0", 7])
    assert tframe.data == jframe.data and tframe.group == ["us", "room0", 7]
    assert twf.decode(twf.encode_changes(changes))._group is None


@pytest.mark.parametrize("group", [
    ["us", "", -1], ["us", "room0", 0], ["", "room0", 1], ["us", "r"],
    ["us", "room0", True], ["us", "room0", 2 ** 63], "us/room0/1",
    ["us", "room0", "1"]], ids=range(8))
def test_resealed_malformed_group_token_rejects_in_both(group):
    """F2: a frame resealed with a malformed token raises WireFormatError
    in both packages with the same message (the port used to accept
    it)."""
    data = _reseal(_valid_frame_bytes(), group)
    why = _reject(jwf, data)
    assert _reject(twf, data) == why
    assert "group" in why
    with pytest.raises(twf.WireFormatError):
        TP.res.validate_msg({"docId": "d", "clock": {}, "wire": data})
    with pytest.raises(TP.res.ProtocolError):
        TP.inbound.inbound_gate(TP.DocSet()).deliver_wire(
            "d", [(twf.WireFrame(data), "p")])


def test_group_token_rides_the_manifest():
    def run(P):
        wf = P.wf
        prefix, frame = wf.split_outgoing(_federation_changes(P),
                                          min_ops=0,
                                          group=["us", "room0", 7])
        assert frame is not None and frame.group == ["us", "room0", 7]
        assert wf.decode(frame.data)._group == ["us", "room0", 7]
        _, bare = wf.split_outgoing(_federation_changes(P), min_ops=0)
        assert bare.group is None
        assert getattr(wf.decode(bare.data), "_group", None) is None
        return prefix, frame.data, bare.data
    same(run)


def test_group_token_validation_is_typed():
    good = ["us", "room0", 1]
    assert twf.validate_group_token(list(good)) == good
    for bad in (["us", "room0"], ["us", "room0", 0], ["us", "room0", True],
                ["", "room0", 1], ["us", "", 1], ["us", "room0", 2 ** 63],
                "us/room0/1", ["us", "room0", "1"]):
        msgs = []
        for wf in (jwf, twf):
            with pytest.raises(wf.WireFormatError) as info:
                wf.validate_group_token(bad)
            msgs.append(str(info.value))
        assert msgs[0] == msgs[1]

    def run(P):
        prefix, frame = P.wf.split_outgoing(_federation_changes(P),
                                            min_ops=0,
                                            group=["us", "room0", 0])
        assert frame is None and len(prefix) == 3
        return prefix
    same(run)


def test_combined_group_token_keeps_the_highest():
    ch = [[{"actor": a, "seq": 1, "deps": {}, "ops": [
        {"action": "ins", "obj": "o", "key": "_head", "elem": 1}]}]
        for a in ("a", "b", "c")]
    groups = (["us", "r", 3], ["us", "r", 9], ["us", "r", 5])
    out = []
    for wf in (jwf, twf):
        frames = [wf.WireFrame(wf.encode_changes(c)) for c in ch]
        for f, g in zip(frames, groups):
            f._group = g
        mixed = [wf.WireFrame(wf.encode_changes(ch[0]), group=["eu", "r", 1]),
                 wf.WireFrame(wf.encode_changes(ch[1]), group=["us", "r", 2])]
        out.append((wf.combine_frames(frames).group,
                    wf.combine_frames(mixed).group))
    assert out[0] == out[1] == (["us", "r", 9], None)


# ---------------------------------------------------------------------------
# gate semantics: fast lane, quarantine, poison
# ---------------------------------------------------------------------------


def _seed_base(P):
    am = P.am
    doc = am.change(P.init("origin"), lambda d: d.__setitem__(
        "t", am.Text("Z")))
    base = P.default.get_missing_changes(P.Frontend.get_backend_state(doc),
                                         {})
    obj_id = next(op["obj"] for c in base for op in c["ops"]
                  if op["action"] == "makeText")
    return base, obj_id


def _seeded_doc_set(P, base):
    ds = P.DocSet()
    ds.set_doc("d", P.am.apply_changes(P.init("replica"), base))
    return ds


def _rewrite(changes, obj_id):
    return [dict(c, ops=[{**op, "obj": obj_id} for op in c["ops"]])
            for c in changes]


@pytest.mark.parametrize("seed", range(4))
def test_gate_wire_vs_dict_parity(seed):
    def run(P):
        am = P.am
        rng = random.Random(100 + seed)
        base, obj_id = _seed_base(P)
        stream = _rewrite(rand_text_changes(rng, n_changes=30, obj=OBJ),
                          obj_id)
        ds_a, ds_b = _seeded_doc_set(P, base), _seeded_doc_set(P, base)
        ga, gb = P.inbound.inbound_gate(ds_a), P.inbound.inbound_gate(ds_b)
        chunks, i = [], 0
        while i < len(stream):
            n = rng.randrange(1, 7)
            chunks.append(stream[i:i + n])
            i += n
        for chunk in chunks:
            prefix, frame = P.wf.split_outgoing(chunk, min_ops=1)
            if frame is not None:
                ga.deliver_wire("d", [(frame, "p")], changes=prefix,
                                validated=False)
            else:
                ga.deliver("d", chunk, sender="p")
            gb.deliver("d", chunk, sender="p")
        assert am.to_json(ds_a.get_doc("d")) == am.to_json(ds_b.get_doc("d"))
        assert am.save(ds_a.get_doc("d")) == am.save(ds_b.get_doc("d"))
        assert ga.stats["delivered"] == gb.stats["delivered"]
        assert ga.stats["applied_ops"] == gb.stats["applied_ops"]
        return am.save(ds_a.get_doc("d")), ga.stats, gb.stats, \
            ga.quarantine_items()
    same(run)


def test_wire_fast_lane_is_taken_and_equals_the_dict_path():
    """A ready frame goes through the gate's fast lane (one backend apply
    of the decoded batch, the obs event `gate/wire_fast`), and commits
    the bytes the dict path commits."""
    def run(P):
        am, obs = P.am, P.obs
        base, obj_id = _seed_base(P)
        ds_a, ds_b = _seeded_doc_set(P, base), _seeded_doc_set(P, base)
        clock = dict(P.Frontend.get_backend_state(ds_a.get_doc("d")).clock)
        ch = [{"actor": "x", "seq": 1, "deps": clock, "ops": [
            {"action": "ins", "obj": obj_id, "key": "_head", "elem": e}
            for e in range(1, 9)]}]
        frame = P.wf.WireFrame(P.wf.encode_changes(ch))
        assert frame.ready_under(clock)
        assert not frame.ready_under({})
        with obs.tracing():
            obs.clear()
            P.inbound.inbound_gate(ds_a).deliver_wire("d", [(frame, "p")])
            fast = [e[5] for e in obs.snapshot()
                    if e[2:4] == ("gate", "wire_fast")]
        assert fast == [{"doc": "d", "n_ops": 8}]
        P.inbound.inbound_gate(ds_b).deliver("d", ch)
        assert am.save(ds_a.get_doc("d")) == am.save(ds_b.get_doc("d"))
        return am.save(ds_a.get_doc("d"))
    same(run)


def test_fast_lane_rejection_leaves_the_document_untouched():
    """A frame the backend rejects in the fast lane (a change whose
    element parent does not exist) leaves the document and clock as
    they were, then goes round the dict path and raises typed."""
    def run(P):
        am = P.am
        base, obj_id = _seed_base(P)
        ds = _seeded_doc_set(P, base)
        before = am.save(ds.get_doc("d"))
        clock = dict(P.Frontend.get_backend_state(ds.get_doc("d")).clock)
        bad = [{"actor": "x", "seq": 1, "deps": clock, "ops": [
            {"action": "ins", "obj": obj_id, "key": "nobody:9", "elem": 1}]}]
        frame = P.wf.WireFrame(P.wf.encode_changes(bad))
        with pytest.raises(P.res.ProtocolError) as info:
            P.inbound.inbound_gate(ds).deliver_wire("d", [(frame, "p")])
        assert am.save(ds.get_doc("d")) == before
        state = P.Frontend.get_backend_state(ds.get_doc("d"))
        assert dict(state.clock) == clock
        return str(info.value).split(":")[0]
    same(run)


def test_premature_frame_parks_and_releases():
    def run(P):
        base, obj_id = _seed_base(P)
        ds = _seeded_doc_set(P, base)
        gate = P.inbound.inbound_gate(ds)
        dep = [{"actor": "x", "seq": 1, "deps": {},
                "ops": [{"action": "ins", "obj": obj_id, "key": "_head",
                         "elem": 1},
                        {"action": "set", "obj": obj_id, "key": "x:1",
                         "value": "a"}]}]
        late = [{"actor": "y", "seq": 1, "deps": {"x": 1},
                 "ops": [{"action": "set", "obj": obj_id, "key": "x:1",
                          "value": "b"}]}]
        gate.deliver_wire("d", [(P.wf.WireFrame(P.wf.encode_changes(late)),
                                 "py")])
        assert gate.quarantined("d") == 1
        gate.deliver_wire("d", [(P.wf.WireFrame(P.wf.encode_changes(dep)),
                                 "px")])
        assert gate.quarantined("d") == 0
        return P.am.save(ds.get_doc("d")), gate.stats
    same(run)


def test_poison_frame_rejects_typed_and_atomic():
    def run(P):
        ds = _seeded_doc_set(P, _seed_base(P)[0])
        gate = P.inbound.inbound_gate(ds)
        before = P.am.save(ds.get_doc("d"))
        poison = [{"actor": "x", "seq": 1, "deps": {},
                   "ops": [{"action": "set", "obj": "no-such-object",
                            "key": "a:1", "value": "!"}]}]
        with pytest.raises(P.res.ProtocolError) as info:
            gate.deliver_wire("d", [(P.wf.WireFrame(
                P.wf.encode_changes(poison)), "px")])
        assert P.am.save(ds.get_doc("d")) == before
        return str(info.value)
    same(run)


def test_combined_frames_one_apply():
    def run(P):
        base, obj_id = _seed_base(P)
        ds = _seeded_doc_set(P, base)
        gate = P.inbound.inbound_gate(ds)
        frames = [P.wf.WireFrame(P.wf.encode_changes(
            [{"actor": a, "seq": 1, "deps": {},
              "ops": [{"action": "ins", "obj": obj_id, "key": "_head",
                       "elem": 1},
                      {"action": "set", "obj": obj_id, "key": f"{a}:1",
                       "value": v}]}])) for a, v in (("x", "1"), ("y", "2"))]
        gate.deliver_wire("d", [(frames[0], "tx"), (frames[1], "ty")])
        txt = P.am.to_json(ds.get_doc("d"))["t"]
        assert "1" in txt and "2" in txt
        assert gate.stats["delivered"] == 2
        assert gate.stats["applied_ops"] == 4
        return P.am.save(ds.get_doc("d"))
    same(run)


# ---------------------------------------------------------------------------
# hub integration
# ---------------------------------------------------------------------------


def _pair(P):
    a, b = P.DocSet(), P.DocSet()
    qa, qb = [], []
    ca, cb = P.Connection(a, qa.append), P.Connection(b, qb.append)
    ca.open()
    cb.open()
    return a, b, ca, cb, qa, qb


def _bulk_edit(P, doc, text):
    return P.am.change(doc, lambda d: d["t"].insert_at(0, *list(text)))


@pytest.mark.parametrize("leg", ["binary", "dict by min_ops"])
def test_hub_session_byte_identical(leg, monkeypatch):
    """tests/test_wire_format.py `test_hub_flag_matrix_byte_identical`'s
    binary leg, and a dict leg taken by raising AMTPU_WIRE_MIN_OPS: the
    same seeded session gives the same messages in both packages, and
    both legs commit the same bytes."""
    if leg != "binary":
        monkeypatch.setenv("AMTPU_WIRE_MIN_OPS", "100000")

    def run(P):
        am = P.am
        doc = am.change(P.init("author"), lambda d: d.__setitem__(
            "t", am.Text("seed")))
        base = P.default.get_missing_changes(
            P.Frontend.get_backend_state(doc), {})
        a, b, ca, cb, qa, qb = _pair(P)
        log = []

        def pump():
            for _ in range(80):
                if not qa and not qb:
                    return
                while qa:
                    m = qa.pop(0)
                    log.append(("a", norm(m)))
                    cb.receive_msg(m)
                while qb:
                    m = qb.pop(0)
                    log.append(("b", norm(m)))
                    ca.receive_msg(m)
            raise AssertionError("never quiesced")

        a.set_doc("doc", am.apply_changes(P.init("author"), base))
        pump()
        b.set_doc("doc", P.Frontend.set_actor_id(b.get_doc("doc"), "peer-b"))
        rng = random.Random(7)
        for r in range(4):
            ds = a if r % 2 == 0 else b
            text = "".join(chr(97 + rng.randrange(26)) for _ in range(48))
            ds.set_doc("doc", _bulk_edit(P, ds.get_doc("doc"), text))
            pump()
        assert am.save(a.get_doc("doc")) == am.save(b.get_doc("doc"))
        n_wire = sum(1 for _, m in log if m.get("wire") is not None)
        assert (n_wire > 0) == (leg == "binary")
        return log, am.save(a.get_doc("doc"))
    _, save = same(run)
    _RESULTS.setdefault("save", save)
    assert _RESULTS["save"] == save


_RESULTS: dict = {}


def test_snapshot_bootstrap_tail_rides_wire(monkeypatch):
    monkeypatch.setenv("AMTPU_WIRE_MIN_OPS", "1")

    def run(P):
        am = P.am
        monkeypatch.setattr(P.SyncHub, "snapshot_min_changes", 16)
        a, b, ca, cb, qa, qb = _pair(P)
        doc = am.change(P.init("author"), lambda d: d.__setitem__(
            "t", am.Text("x")))
        for r in range(20):
            doc = _bulk_edit(P, doc, f"r{r:02d}")
        a.set_doc("doc", doc)
        saw = [0]
        log = []

        def move(q, conn, tag):
            while q:
                m = q.pop(0)
                if m.get("checkpoint") is not None \
                        and m.get("wire") is not None:
                    saw[0] += 1
                log.append((tag, norm(m)))
                conn.receive_msg(m)

        for _ in range(120):
            if not qa and not qb:
                break
            move(qa, cb, "ab")
            move(qb, ca, "ba")
        assert am.save(a.get_doc("doc")) == am.save(b.get_doc("doc"))
        a.set_doc("doc", _bulk_edit(P, a.get_doc("doc"), "tail"))
        c_ds = P.DocSet()
        qc, q_s3 = [], []
        s3 = P.Connection(a, q_s3.append)
        cc = P.Connection(c_ds, qc.append)
        s3.open()
        cc.open()
        for _ in range(120):
            if not qc and not q_s3 and not qa and not qb:
                break
            move(q_s3, cc, "s3")
            move(qc, s3, "c")
            move(qa, cb, "ab")
            move(qb, ca, "ba")
        assert saw[0] >= 1
        assert am.save(a.get_doc("doc")) == am.save(c_ds.get_doc("doc"))
        return log
    same(run)


def test_snapshot_cache_survives_repeated_tail_serves(monkeypatch):
    monkeypatch.setenv("AMTPU_WIRE_MIN_OPS", "1")

    def run(P):
        am = P.am
        monkeypatch.setattr(P.SyncHub, "snapshot_min_changes", 8)
        server = P.DocSet()
        doc = am.change(P.init("author"), lambda d: d.__setitem__(
            "t", am.Text("x")))
        for r in range(12):
            doc = _bulk_edit(P, doc, f"r{r}")
        server.set_doc("doc", doc)
        saves = []
        for i in range(3):
            peer = P.DocSet()
            q_s, q_c = [], []
            s_conn = P.Connection(server, q_s.append)
            c_conn = P.Connection(peer, q_c.append)
            s_conn.open()
            c_conn.open()
            for _ in range(80):
                if not q_s and not q_c:
                    break
                while q_s:
                    c_conn.receive_msg(q_s.pop(0))
                while q_c:
                    s_conn.receive_msg(q_c.pop(0))
            assert am.save(peer.get_doc("doc")) == am.save(
                server.get_doc("doc"))
            saves.append(am.save(peer.get_doc("doc")))
            s_conn.close()
            c_conn.close()
            server.set_doc("doc", _bulk_edit(P, server.get_doc("doc"),
                                             f"tail{i}"))
        return saves
    same(run)


def test_channel_retransmits_cached_bytes():
    frame_bytes = _valid_frame_bytes()

    def run(P):
        sent = []
        chan = P.res.ResilientChannel(sent.append, lambda p: None,
                                      base_rto=1)
        frame = P.wf.WireFrame(frame_bytes)
        msg = {"docId": "d", "clock": {}, "wire": frame}
        chan.send(msg)
        n0 = chan.stats["bytes_sent"]
        assert n0 > frame.nbytes and chan.stats["bytes_resent"] == 0
        for _ in range(6):
            chan.tick()
        assert chan.stats["retransmits"] >= 1
        assert chan.stats["bytes_resent"] == chan.stats["retransmits"] * n0
        payloads = [env["payload"] for env in sent if env["kind"] == "data"]
        assert all(p is msg for p in payloads)
        assert all(p["wire"].data is frame.data for p in payloads)
        return chan.stats
    same(run)


# ---------------------------------------------------------------------------
# lineage trace context on the wire
# ---------------------------------------------------------------------------


def test_trace_section_round_trip_and_absent():
    changes = _stream(7, 8, premature=False, dups=False)
    ctx = [[changes[0]["actor"], changes[0]["seq"], 987654321, "site-A"],
           [changes[1]["actor"], changes[1]["seq"], 0, ""]]
    with_ctx = twf.encode_changes(changes, trace=ctx)
    without = twf.encode_changes(changes)
    assert with_ctx == jwf.encode_changes(changes, trace=ctx)
    assert with_ctx != without
    batch = twf.decode(with_ctx)
    assert batch._trace == ctx and twf.decode(without)._trace is None
    assert json.dumps(twf.materialize_changes(batch)) == \
        json.dumps(twf.materialize_changes(twf.decode(without)))
    lineage = TP.lineage
    was = lineage.ENABLED
    lineage.disable()
    try:
        assert twf.WireFrame(with_ctx).validate().trace == ctx
        msg = TP.res.validate_msg({"docId": "d", "clock": {},
                                   "wire": with_ctx})
        assert msg["wire"].trace == ctx
    finally:
        if was:
            lineage.enable()


def test_trace_context_malformed_rejects_typed():
    bads = ["not-a-list", [["a", 1, 2]], [["", 1, 2, "s"]],
            [["a", 0, 2, "s"]], [["a", 1, -5, "s"]], [["a", 1, 2, 7]],
            [["a", True, 2, "s"]], [["a", 1, 0, "s"]] * 9000]
    for bad in bads:
        msgs = []
        for P in (JP, TP):
            with pytest.raises(P.res.ProtocolError) as info:
                P.wf.validate_trace_context(bad)
            msgs.append(str(info.value))
            if len(bad) < 9000:
                with pytest.raises(P.res.ProtocolError):
                    P.res.validate_msg({"docId": "d", "clock": {},
                                        "changes": [], "trace": bad})
        assert msgs[0] == msgs[1]
    changes = _stream(8, 4, premature=False, dups=False)
    with pytest.raises(twf.WireFormatError):
        twf.encode_changes(changes, trace=[["a", 1]])


@pytest.mark.parametrize("leg", ["binary", "dict by min_ops"])
def test_peers_converge_with_context_attached(leg, monkeypatch):
    """tests/test_wire_format.py `test_mixed_peers_converge_with_context_
    attached` per leg: lineage sampling everything, the receiving
    replica's chains carry the origin context adopted from the wire (the
    frame manifest on the binary leg, the message field on the dict
    leg), identically in both packages."""
    monkeypatch.setenv("AMTPU_WIRE_MIN_OPS",
                       "8" if leg == "binary" else "100000")

    def run(P):
        am, lin = P.am, P.lineage
        led = lin.enable(rate=1, capacity=512)
        led.clear()
        try:
            a, b, ca, cb, qa, qb = _pair(P)
            a._lineage_site, b._lineage_site = "site-a", "site-b"

            def pump():
                for _ in range(80):
                    if not qa and not qb:
                        return
                    while qa:
                        cb.receive_msg(qa.pop(0))
                    while qb:
                        ca.receive_msg(qb.pop(0))
            a.set_doc("d", am.change(P.init("author"), lambda d:
                                     d.__setitem__("t", am.Text("x"))))
            pump()
            a.set_doc("d", _bulk_edit(P, a.get_doc("d"), "first-leg " * 8))
            pump()
            b.set_doc("d", _bulk_edit(P, b.get_doc("d"), "second-leg " * 8))
            pump()
            assert am.save(a.get_doc("d")) == am.save(b.get_doc("d"))
            committed = [c for c in led.chains()
                         if {"site-a", "site-b"} & led.visible_sites(c)]
            assert committed
            for c in committed:
                assert c["origin_ns"] is not None
            on_b = [c for c in committed if "site-b" in led.visible_sites(c)
                    and c["actor"] == "author"]
            assert on_b and all(c["origin_site"] == "author" for c in on_b)
            return am.save(a.get_doc("d")), sorted(
                (c["actor"], c["seq"], c["origin_site"],
                 tuple(sorted(led.visible_sites(c)))) for c in committed)
        finally:
            lin.disable()
            lin.clear()
    same(run)


# ---------------------------------------------------------------------------
# tests/test_types_surface.py
# ---------------------------------------------------------------------------


def _allowed_keys(td) -> set:
    return set(typing.get_type_hints(td))


def _check_keys(obj: dict, td, ctx: str):
    extra = set(obj) - _allowed_keys(td)
    assert not extra, f"{ctx}: keys outside the wire schema: {extra}"


def test_facade_surface_complete():
    import automerge_tpu as J
    import automerge_tpu_torch as am
    for name in ("init", "from_", "change", "empty_change", "undo",
                 "redo", "can_undo", "can_redo", "load", "save", "merge",
                 "diff", "get_changes", "get_all_changes", "apply_changes",
                 "get_missing_deps", "equals", "get_history", "to_json",
                 "get_conflicts", "get_actor_id", "set_actor_id",
                 "get_object_id", "uuid", "ROOT_ID"):
        assert hasattr(am, name), f"facade missing {name}"
    for cls in ("Text", "Table", "Counter", "Connection", "DocSet",
                "WatchableDoc", "SyncHub", "ClockMatrix"):
        assert hasattr(am, cls), f"facade missing class {cls}"
        assert hasattr(J, cls)
    assert am.DocSet is am.sync.DocSet and am.SyncHub is am.sync.SyncHub


def test_frontend_backend_namespaces():
    from automerge_tpu_torch import frontend as Frontend
    from automerge_tpu_torch.backend import default as Backend
    for name in ("init", "change", "empty_change", "apply_patch",
                 "can_undo", "undo", "can_redo", "redo", "get_object_id",
                 "get_actor_id", "set_actor_id", "get_conflicts",
                 "get_backend_state"):
        assert hasattr(Frontend, name), f"Frontend missing {name}"
    for name in ("init", "apply_changes", "apply_local_change",
                 "get_patch", "get_changes", "get_changes_for_actor",
                 "get_missing_changes", "get_missing_deps", "merge",
                 "undo", "redo"):
        assert hasattr(Backend, name), f"Backend missing {name}"


def _sample_doc(P):
    am = P.am
    doc = am.change(P.init("aaaa"), lambda d: d.update(
        {"t": am.Text("hi"), "n": am.Counter(1), "k": 1}))
    return am.change(doc, lambda d: [d["t"].insert_at(2, "!"),
                                     d["n"].increment(2)])


def test_emitted_changes_validate():
    from automerge_tpu_torch import types as Ty

    def run(P):
        changes = P.am.get_all_changes(_sample_doc(P))
        assert changes
        for ch in changes:
            _check_keys(ch, Ty.Change, "change")
            assert isinstance(ch["actor"], str) and \
                isinstance(ch["seq"], int)
            for op in ch["ops"]:
                _check_keys(op, Ty.Op, f"op in seq {ch['seq']}")
                assert op["action"] in typing.get_args(Ty.OpAction)
        return changes
    same(run)


def test_emitted_patches_validate():
    from automerge_tpu_torch import types as Ty

    def run(P):
        state = P.Frontend.get_backend_state(_sample_doc(P))
        patch = P.default.get_patch(state)
        _check_keys(patch, Ty.Patch, "patch")
        for diff in patch["diffs"]:
            _check_keys(diff, Ty.Diff, "diff")
            assert diff["action"] in typing.get_args(Ty.DiffAction)
            if "type" in diff:
                assert diff["type"] in typing.get_args(Ty.CollectionType)
            for c in diff.get("conflicts", []):
                _check_keys(c, Ty.Conflict, "conflict")
        return patch
    same(run)


def test_sync_messages_validate():
    from automerge_tpu_torch import types as Ty

    def run(P):
        am = P.am
        ds_a, ds_b = P.DocSet(), P.DocSet()
        sent = []
        conn_a = P.Connection(ds_a, sent.append)
        conn_b = P.Connection(ds_b, lambda m: conn_a.receive_msg(m))
        ds_a.set_doc("d", _sample_doc(P))
        conn_a.open()
        conn_b.open()
        crossed = []
        for _ in range(4):
            pending, sent[:] = list(sent), []
            for m in pending:
                crossed.append(norm(m))
                conn_b.receive_msg(m)
        assert am.to_json(ds_b.get_doc("d")) == am.to_json(ds_a.get_doc("d"))
        ds_c = P.DocSet()
        msgs = []
        conn_c = P.Connection(ds_c, msgs.append)
        conn_c.open()
        conn_c.receive_msg({"docId": "d", "clock": dict(
            P.Frontend.get_backend_state(ds_a.get_doc("d")).clock)})
        for m in msgs + crossed:
            _check_keys(m, Ty.Message, "sync message")
            json.dumps(m, default=lambda o: "frame")
        return crossed, [norm(m) for m in msgs]
    same(run)


def test_changes_survive_json_round_trip():
    def run(P):
        am = P.am
        doc = _sample_doc(P)
        wire = json.dumps(am.get_all_changes(doc))
        rebuilt = am.apply_changes(P.init("bbbb"), json.loads(wire))
        assert am.to_json(rebuilt) == am.to_json(doc)
        assert [e["elemId"] for e in rebuilt["t"].elems] == \
            [e["elemId"] for e in doc["t"].elems]
        return am.save(rebuilt)
    same(run)


def test_save_load_framing_is_json():
    def run(P):
        am = P.am
        doc = _sample_doc(P)
        blob = am.save(doc)
        assert isinstance(json.loads(blob), (list, dict))
        loaded = am.load(blob, P.where()) if P.port else am.load(blob)
        assert am.to_json(loaded) == am.to_json(doc)
        return blob
    same(run)
